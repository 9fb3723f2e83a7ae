"""Structured run tracer: nested spans as JSONL — port of the JAX
package's ``obs/trace.py``, same schema.

Off by default (the module-level :data:`NULL` tracer is a no-op on every
call: no file handle, no clock reads beyond the caller's own). Turn it on
by pointing ``RACON_TPU_TRACE`` at a file path, or with ``--trace
<path>`` on the CLI (which calls :func:`configure`).

Trace format (one JSON object a line):

- ``{"ev": "begin", "schema": 1, "unix_time": ...}`` — first line.
- ``{"ev": "span", "id": N, "parent": M|null, "kind": ..., "name": ...,
  "t0": seconds-since-begin, "dur_s": ..., ...attrs}`` — one line a
  *closed* span; children therefore appear before their parent. ``kind``
  is one of run/phase/chunk/round/dispatch/transfer/stage/queue/retry/
  fault/watchdog/stall; numeric attrs (bytes, lanes, rounds, ...) ride at
  the top level of the object.
- ``{"ev": "metrics", ...}`` — a snapshot of the counters
  (pipeline/metrics.py), written by :meth:`Tracer.finish` (the CLI calls
  it on exit).

``RACON_TPU_TRACE_XPROF=1`` also wraps every span in an NVTX range
(``torch.cuda.nvtx.range_push`` / ``range_pop``), so spans land in a
device profile beside the kernels — the card's counterpart of the
reference's ``jax.profiler.TraceAnnotation``.

Spans nest per thread (a thread-local stack supplies ``parent``); the
watchdog's guard threads adopt a copy of their caller's stack
(:meth:`Tracer.snapshot_stack` / :meth:`Tracer.install_stack`). File
writes are serialized by a lock. A span costs two ``perf_counter`` calls
and one dict build; spans stream to a ``.part`` file that
:meth:`Tracer.finish` renames onto the path, so a reader of the path
never sees a half-written trace.
"""

from __future__ import annotations

import json
import os
from racon_tpu_torch.utils import env
import threading
import time
from typing import Optional

SCHEMA_VERSION = 1

ENV_TRACE = env.TRACE
ENV_XPROF = env.TRACE_XPROF

# How many hex chars of the JobSpec fingerprint become the trace id.
TRACE_ID_LEN = 16


class TraceContext:
    """Cross-process trace correlation: ``trace_id`` names the job (a
    prefix of the JobSpec fingerprint, so every process that polishes
    the same job derives the same id) and ``parent_id`` is the span id,
    in the minting process, that causally precedes the handoff. The
    encoded form is ``"<trace_id>:<parent_id>"``; :func:`parse_trace_ctx`
    treats anything malformed as absent, so a garbled handoff degrades to
    a fresh root trace instead of crashing the worker."""

    __slots__ = ("trace_id", "parent_id")

    def __init__(self, trace_id: str, parent_id: int):
        self.trace_id = trace_id
        self.parent_id = parent_id

    def encode(self) -> str:
        return f"{self.trace_id}:{self.parent_id}"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"TraceContext({self.trace_id!r}, {self.parent_id})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, TraceContext)
                and other.trace_id == self.trace_id
                and other.parent_id == self.parent_id)


def mint_trace_context(fingerprint: str, parent_id: int = 0) -> TraceContext:
    """Derive a job's trace context from its run fingerprint and the
    span that minted it (the daemon's ``serve submitted`` point)."""
    return TraceContext(str(fingerprint)[:TRACE_ID_LEN], int(parent_id))


def parse_trace_ctx(text) -> Optional[TraceContext]:
    """Decode ``"<trace_id>:<parent_id>"``; None on anything malformed
    (empty, missing separator, non-integer parent, blank id)."""
    if not text or not isinstance(text, str):
        return None
    head, sep, tail = text.strip().partition(":")
    if not sep or not head:
        return None
    try:
        parent = int(tail)
    except ValueError:
        return None
    return TraceContext(head, parent)


def adopt_trace_context(encoded, tracer=None) -> Optional[TraceContext]:
    """Adopt a handed-off trace context (``"<trace_id>:<parent_id>"``)
    into the process tracer's span context. Malformed or absent input is
    not an error: the process keeps a fresh root trace (returns None,
    sets nothing)."""
    ctx = parse_trace_ctx(encoded)
    if ctx is None:
        return None
    tr = tracer if tracer is not None else get_tracer()
    tr.set_context(trace_id=ctx.trace_id, parent_id=ctx.parent_id)
    return ctx


class _NullSpan:
    """Shared no-op span: context manager with inert add/end."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **attrs) -> "_NullSpan":
        return self

    def end(self) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every operation is a no-op."""

    enabled = False

    def span(self, kind: str, name: str, **attrs):
        return _NULL_SPAN

    def emit(self, kind: str, name: str, t0_perf: float, dur_s: float,
             **attrs) -> int:
        return 0

    def point(self, kind: str, name: str, dur_s: float = 0.0,
              **attrs) -> int:
        return 0

    def set_context(self, **attrs) -> None:
        pass

    def snapshot_stack(self) -> list:
        return []

    def install_stack(self, stack: list) -> None:
        pass

    def finish(self, metrics: Optional[dict] = None) -> None:
        pass


NULL = NullTracer()


class _Span:
    __slots__ = ("tracer", "id", "parent", "kind", "name", "attrs",
                 "t0", "_xprof", "_done")

    def __init__(self, tracer: "Tracer", kind: str, name: str, attrs: dict):
        self.tracer = tracer
        self.kind = kind
        self.name = name
        self.attrs = attrs
        self._xprof = None
        self._done = False
        self.id, self.parent = tracer._push(self)
        self.t0 = time.perf_counter()
        if tracer._xprof:
            try:
                import torch
                torch.cuda.nvtx.range_push(f"{kind}:{name}")
                self._xprof = torch.cuda.nvtx
            except Exception:
                self._xprof = None

    def add(self, **attrs) -> "_Span":
        """Attach counters to the span (merged into its JSONL record)."""
        self.attrs.update(attrs)
        return self

    def end(self) -> None:
        if self._done:
            return
        self._done = True
        dur = time.perf_counter() - self.t0
        if self._xprof is not None:
            try:
                self._xprof.range_pop()
            except Exception:
                pass
        self.tracer._pop(self, dur)

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False


class Tracer:
    """JSONL span writer (see module docstring for the format)."""

    enabled = True

    def __init__(self, path: str):
        self.path = path
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._local = threading.local()
        # Ids start at 1: a TraceContext's parent_id of 0 means "no
        # parent span" (fresh root), so no real span may claim it.
        self._next_id = 1                 # guarded-by: _lock
        # Process-wide span attributes (worker_id/shard/run_fp) merged
        # into every span record; explicit span attrs win on key clash.
        self._context: dict = {}          # guarded-by: _lock
        self._xprof = env.read(ENV_XPROF) not in ("", "0", "false")
        # Spans stream to a ``.part`` sidecar; finish() promotes it to
        # ``path`` atomically, so readers of ``path`` never observe a
        # half-written trace (a killed run leaves only the sidecar).
        self._part = path + ".part"
        self._fh = open(self._part, "w", encoding="utf-8")
        self._write({"ev": "begin", "schema": SCHEMA_VERSION,
                     "unix_time": time.time()})

    # ------------------------------------------------------------- internals

    def _stack(self):
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _write(self, obj: dict) -> None:
        line = json.dumps(obj, separators=(",", ":"))
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(line + "\n")
            self._fh.flush()

    def _push(self, span: _Span):
        st = self._stack()
        parent = st[-1].id if st else None
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        st.append(span)
        return sid, parent

    def _pop(self, span: _Span, dur: float) -> None:
        st = self._stack()
        # Tolerate out-of-order ends (manual .end() mixed with with-blocks):
        # remove the span wherever it sits.
        if span in st:
            st.remove(span)
        self._write({"ev": "span", "id": span.id, "parent": span.parent,
                     "kind": span.kind, "name": span.name,
                     "t0": round(span.t0 - self._t0, 6),
                     "dur_s": round(dur, 6),
                     **self._context, **span.attrs})

    # ------------------------------------------------------------ public API

    def span(self, kind: str, name: str, **attrs) -> _Span:
        """Open a nested span; close with ``with`` or ``.end()``."""
        return _Span(self, kind, name, attrs)

    def emit(self, kind: str, name: str, t0_perf: float, dur_s: float,
             **attrs) -> int:
        """Record a span that already ran, from its own perf_counter
        start (utils/logger.py phases use this: the logger only learns
        the phase name when the phase ends). Returns the span id so
        callers can mint a :class:`TraceContext` parented on it."""
        st = self._stack()
        parent = st[-1].id if st else None
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        self._write({"ev": "span", "id": sid, "parent": parent,
                     "kind": kind, "name": name,
                     "t0": round(max(t0_perf - self._t0, 0.0), 6),
                     "dur_s": round(max(dur_s, 0.0), 6),
                     **self._context, **attrs})
        return sid

    def point(self, kind: str, name: str, dur_s: float = 0.0,
              **attrs) -> int:
        """Record an instantaneous-ish event (e.g. one transfer) ending
        now, with ``dur_s`` of lead time. Returns the span id."""
        return self.emit(kind, name, time.perf_counter() - dur_s, dur_s,
                         **attrs)

    def set_context(self, **attrs) -> None:
        """Merge process-wide attributes (``worker_id``/``shard``/
        ``run_fp``) into every subsequent span record. ``None`` values
        drop the key — workers call ``set_context(shard=None)`` when a
        lease is released. Explicit per-span attrs shadow the context
        on clashes, so recorders keep full control of their own keys."""
        with self._lock:
            for k, v in attrs.items():
                if v is None:
                    self._context.pop(k, None)
                else:
                    self._context[k] = v

    def snapshot_stack(self) -> list:
        """A COPY of the calling thread's open-span stack, for handing
        to a helper thread (watchdog guard workers) so spans it emits
        keep their parents."""
        return list(self._stack())

    def install_stack(self, stack: list) -> None:
        """Adopt ``stack`` (from :meth:`snapshot_stack`) as THIS
        thread's span stack. The list is copied, so a thread abandoned
        mid-job can never corrupt the donor's stack; spans opened and
        closed on this thread pop themselves as usual, and spans from
        the donor stack are parent references only — this thread must
        not close them."""
        self._local.stack = list(stack)

    @property
    def closed(self) -> bool:
        return self._fh is None

    def finish(self, metrics: Optional[dict] = None) -> None:
        """Write a final metrics snapshot, then atomically promote the
        ``.part`` sidecar to the configured path."""
        if metrics:
            self._write({"ev": "metrics", **metrics})
        with self._lock:
            if self._fh is None:
                return
            self._fh.close()
            self._fh = None
        os.replace(self._part, self.path)


_tracer: Optional[object] = None


def configure(path: Optional[str] = None):
    """Install the process tracer. ``path=None`` reads RACON_TPU_TRACE;
    empty/unset keeps tracing off. Idempotent for the same path while
    that tracer is open; a new path replaces (and finishes) the previous
    tracer, and a finished tracer gives way to the null tracer."""
    global _tracer
    path = path or env.read(ENV_TRACE)
    live = isinstance(_tracer, Tracer) and not _tracer.closed
    if not path:
        if not live:
            _tracer = NULL
        return _tracer
    if live:
        if _tracer.path == path:
            return _tracer
        _tracer.finish()
    _tracer = Tracer(path)
    return _tracer


def get_tracer():
    """The process tracer; configured from the environment on first use,
    so library runs honour RACON_TPU_TRACE without the CLI."""
    if _tracer is None:
        return configure()
    return _tracer
