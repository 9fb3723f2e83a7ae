"""Phase timing + progress logging (logger equivalent).

Mirrors the reference's vendored logger API as used by the Polisher
(reference: src/polisher.cpp:144,159,170-509): ``()`` starts/resets a
phase timer, ``("msg")`` prints elapsed time + message, ``["msg"]`` ticks
a 20-step progress bar, ``total("msg")`` prints total runtime. All output
goes to stderr so stdout stays clean FASTA.

Two extensions over the reference:

- When stderr is not a TTY (log files, CI pipes), ``tick`` falls back to
  one plain newline-terminated line per tick instead of ``\\r``-redrawing
  the bar — a redrawn bar in a log file is one garbled mega-line.
- Output is serialized by a per-logger lock so threads can share one
  logger without interleaving mid-line.
- Every completed phase is also a ``phase`` span of the JSONL tracer
  (obs/trace.py), a no-op unless RACON_TPU_TRACE / --trace is set.
"""

from __future__ import annotations

import sys
import threading
import time


class Logger:
    def __init__(self, stream=None):
        self.stream = stream if stream is not None else sys.stderr
        isatty = getattr(self.stream, "isatty", None)
        try:
            self._tty = bool(isatty()) if isatty is not None else False
        except Exception:
            self._tty = False
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._phase_t0 = self._t0
        self._bar = 0          # progress position, 0..20
        self._bar_open = False  # TTY only: a partial '\r' line is on screen

    def begin(self) -> None:
        """Start/reset the phase timer — the reference's ``(*logger)()``."""
        with self._lock:
            self._phase_t0 = time.perf_counter()
            self._bar = 0

    def _close_bar(self) -> None:
        """End a partially drawn '\\r' bar line so the next print starts
        fresh (no-op when the stream gets complete lines)."""
        if self._bar_open:
            print(file=self.stream)
            self._bar_open = False

    def phase(self, msg: str) -> None:
        """Print elapsed phase time — the reference's ``(*logger)("msg")``."""
        with self._lock:
            self._close_bar()
            self._bar = 0
            elapsed = time.perf_counter() - self._phase_t0
            print(f"{msg} {elapsed:.6f} s", file=self.stream)
        from racon_tpu_torch.obs.metrics import record_phase_seconds
        from racon_tpu_torch.obs.trace import get_tracer
        get_tracer().emit("phase", msg, self._phase_t0, elapsed)
        # The always-on counterpart of the span: per-phase seconds feed
        # the fleet model (obs/fleet.py) with tracing off.
        record_phase_seconds(msg, elapsed)

    def tick(self, msg: str) -> None:
        """Advance a 20-step progress bar — ``(*logger)["msg"]``."""
        with self._lock:
            self._bar = min(self._bar + 1, 20)
            bar = "=" * self._bar + " " * (20 - self._bar)
            elapsed = time.perf_counter() - self._phase_t0
            if self._tty:
                end = "\n" if self._bar == 20 else ""
                print(f"\r{msg} [{bar}] {elapsed:.6f} s", end=end,
                      file=self.stream, flush=True)
                self._bar_open = self._bar != 20
            else:
                # Non-TTY: '\r' never erases, so a redrawn bar would land
                # as one garbled mega-line; print a complete line per tick.
                print(f"{msg} [{bar}] {elapsed:.6f} s", file=self.stream,
                      flush=True)
            if self._bar == 20:
                self._bar = 0

    def line(self, msg: str) -> None:
        """Print a plain diagnostic line (closing any partial bar)."""
        with self._lock:
            self._close_bar()
            print(msg, file=self.stream)

    def total(self, msg: str) -> None:
        """Print total wall time — the reference's ``logger->total()``."""
        with self._lock:
            elapsed = time.perf_counter() - self._t0
            print(f"{msg} {elapsed:.6f} s", file=self.stream)


class NullLogger(Logger):
    """Silent logger for tests/library use."""

    def __init__(self):
        super().__init__(stream=_NullStream())

    def begin(self) -> None:
        pass

    def phase(self, msg: str) -> None:
        pass

    def tick(self, msg: str) -> None:
        pass

    def line(self, msg: str) -> None:
        pass

    def total(self, msg: str) -> None:
        pass


class _NullStream:
    """Inert stream so NullLogger never touches a real fd."""

    def isatty(self) -> bool:
        return False

    def write(self, s: str) -> int:
        return len(s)

    def flush(self) -> None:
        pass
