"""Thread stages and the pipeline that runs them — port of the JAX package's
``pipeline/stages.py``.

A :class:`Pipeline` is a linear chain of single-thread stages connected
by :class:`~racon_tpu_torch.pipeline.queues.BoundedQueue` edges. One
thread per stage keeps per-stage work strictly ordered (the streaming
polish path needs deterministic chunk planning and one launching thread a
stage); overlap comes from *different* stages running concurrently,
bounded by the queue capacities. ``thread_context`` (optional) is entered
by every stage thread for its whole life: the streaming executor uses it
to put each thread on the engine's device and CUDA stream, since PyTorch's
current device and stream are per thread.

Failure semantics:

- A stage that raises reports the exception to the pipeline, which aborts
  every queue; all other stages unblock, observe the abort, and exit.
- The consumer's :meth:`Pipeline.drain` re-raises the first failure as
  :class:`StageError` with the original exception chained (``raise ...
  from exc``), so tracebacks survive the thread hop.
- ``with pipeline:`` guarantees every stage thread is joined on exit —
  including when the consumer abandons the drain loop early (generator
  close), in which case the pipeline aborts the queues first so no
  producer can hang on a full edge.
- The stall detector (``RACON_TPU_STALL_S``, default 300 s, 0 turns it
  off) fails the pipeline with :class:`PipelineStalled` when no stage
  made progress and the consumer drained nothing for a whole window
  (and tells the watchdog's health view, watchdog.note_stall). The
  streaming executor recovers from that one failure
  (pipeline/streaming.py); every other failure reaches the caller.
- Each stage consults the fault site ``pipe/<stage>`` once an item,
  before its work function (or before the source's next item), so a
  ``hang`` there models a wedged stage body.

Accounting: every stage records busy seconds (time in its work
function), stall seconds (blocked on its input or output queue) and an
item count into the pipeline's counters (pipeline/metrics.py,
``pipe_stage_*`` keys) and a ``stage`` trace span when it exits; every
queue records peak depth and blocked time (``pipe_queue_*`` keys) and a
``queue`` trace span at shutdown.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Callable, Iterable, List, Optional, Tuple

from racon_tpu_torch.obs.trace import get_tracer
from racon_tpu_torch.pipeline import metrics
from racon_tpu_torch.pipeline.queues import (BoundedQueue, PipelineAborted,
                                             QueueClosed)
from racon_tpu_torch.resilience import watchdog
from racon_tpu_torch.resilience.faults import maybe_fault
from racon_tpu_torch.utils import env

#: Stall-detector window, seconds: no stage progressing AND no item
#: drained for this long converts a silent deadlock into an abort
#: cascade with a diagnostic dump. 0 disables the detector.
ENV_STALL = env.STALL_S
_STALL_DEFAULT_S = 300.0


def stall_window_s() -> float:
    txt = env.read(ENV_STALL).strip()
    if not txt:
        return _STALL_DEFAULT_S
    try:
        return float(txt)
    except ValueError:
        raise ValueError(
            f"[racon_tpu_torch::pipeline] invalid {ENV_STALL}={txt!r} "
            "(expected a number of seconds, 0 to disable)")


class StageError(RuntimeError):
    """A pipeline stage failed; ``__cause__`` is the original exception."""

    def __init__(self, stage: str, exc: BaseException):
        super().__init__(
            f"[racon_tpu_torch::pipeline] stage {stage!r} failed: {exc!r}")
        self.stage = stage


class PipelineStalled(RuntimeError):
    """The stall detector fired: every live stage sat silent for a full
    window while the consumer drained nothing — a deadlock or a wedged
    body that no per-call deadline covers. ``dump`` carries the
    per-stage/per-queue diagnostic the detector printed to stderr;
    ``running`` names the stages that were inside their body (state
    ``run``) when it fired."""

    def __init__(self, window_s: float, dump: str,
                 running: Tuple[str, ...] = ()):
        super().__init__(
            f"[racon_tpu_torch::pipeline] no stage progressed for "
            f"{window_s:g}s — pipeline stalled\n{dump}")
        self.window_s = window_s
        self.dump = dump
        self.running = tuple(running)


class _Stage(threading.Thread):
    """One worker thread: pull from ``inq`` (or iterate ``source``),
    apply ``fn``, push to ``outq``; close ``outq`` on clean exit."""

    def __init__(self, pipe: "Pipeline", name: str,
                 fn: Optional[Callable] = None,
                 source: Optional[Callable[[], Iterable]] = None,
                 inq: Optional[BoundedQueue] = None,
                 outq: Optional[BoundedQueue] = None):
        super().__init__(name=f"racon-pipe-{name}", daemon=True)
        self.pipe = pipe
        self.stage_name = name
        self.fn = fn
        self.source = source
        self.inq = inq
        self.outq = outq
        self.busy_s = 0.0
        self.stall_in_s = 0.0
        self.stall_out_s = 0.0
        self.items = 0
        # Heartbeat for the stall detector: monotonic time of the last
        # loop transition, plus what the stage is doing right now.
        # Written by this thread only; torn reads are harmless (the
        # detector re-polls).
        self.last_progress = time.monotonic()
        self.state = "init"

    def _beat(self, state: str) -> None:
        self.last_progress = time.monotonic()
        self.state = state

    def run(self) -> None:
        failed = False
        t_start = time.perf_counter()
        try:
            with self.pipe.thread_context():
                if self.source is not None:
                    self._run_source()
                else:
                    self._run_worker()
        except (QueueClosed, PipelineAborted):
            pass  # a peer ended the stream or tore the pipeline down
        except BaseException as exc:  # noqa: BLE001 — must cross threads
            failed = True
            self.pipe._fail(self.stage_name, exc)
        finally:
            if self.outq is not None and not failed:
                self.outq.close()
            metrics.record_stage(self.stage_name, self.busy_s,
                                 self.stall_in_s, self.stall_out_s,
                                 self.items)
            get_tracer().emit(
                "stage", self.stage_name, t_start,
                time.perf_counter() - t_start, items=self.items,
                busy_s=round(self.busy_s, 6),
                stall_s=round(self.stall_in_s + self.stall_out_s, 6))

    def _run_source(self) -> None:
        it = iter(self.source())
        while True:
            self._beat("run")
            t0 = time.perf_counter()
            try:
                maybe_fault(f"pipe/{self.stage_name}")
                item = next(it)
            except StopIteration:
                self.busy_s += time.perf_counter() - t0
                return
            self.busy_s += time.perf_counter() - t0
            self._beat("put")
            t1 = time.perf_counter()
            self.outq.put(item)
            self.stall_out_s += time.perf_counter() - t1
            self.items += 1

    def _run_worker(self) -> None:
        while True:
            self._beat("get")
            t0 = time.perf_counter()
            item = self.inq.get()            # QueueClosed ends the loop
            self.stall_in_s += time.perf_counter() - t0
            self._beat("run")
            t1 = time.perf_counter()
            # Before the work function: a ``hang`` here is a wedged stage
            # body with its item still unprocessed — the stall detector,
            # not a call deadline, is the recovery under test.
            maybe_fault(f"pipe/{self.stage_name}")
            out = self.fn(item)
            self.busy_s += time.perf_counter() - t1
            if self.outq is not None and out is not None:
                self._beat("put")
                t2 = time.perf_counter()
                self.outq.put(out)
                self.stall_out_s += time.perf_counter() - t2
            self.items += 1


class Pipeline:
    """Linear stage chain; see the module docstring for semantics."""

    def __init__(self, name: str, thread_context=None):
        self.name = name
        self.thread_context = thread_context or contextlib.nullcontext
        self._queues: List[BoundedQueue] = []
        self._stages: List[_Stage] = []
        self._error: Optional[Tuple[str, BaseException]] = None
        self._error_lock = threading.Lock()
        self._started = False
        self._last_drain = time.monotonic()
        self._detector: Optional[_StallDetector] = None

    # ----------------------------------------------------------- assembly

    def queue(self, name: str, capacity: int) -> BoundedQueue:
        q = BoundedQueue(name, capacity)
        self._queues.append(q)
        return q

    def source(self, name: str, gen_fn: Callable[[], Iterable],
               outq: BoundedQueue) -> None:
        """First stage: iterate ``gen_fn()`` into ``outq``."""
        self._stages.append(_Stage(self, name, source=gen_fn, outq=outq))

    def stage(self, name: str, fn: Callable, inq: BoundedQueue,
              outq: Optional[BoundedQueue] = None) -> None:
        """Worker stage: ``outq.put(fn(item))`` per ``inq`` item. A fn
        returning None consumes the item (nothing is forwarded — e.g.
        after routing it to a side queue itself)."""
        self._stages.append(_Stage(self, name, fn=fn, inq=inq, outq=outq))

    # ---------------------------------------------------------- execution

    def _fail(self, stage: str, exc: BaseException) -> None:
        with self._error_lock:
            if self._error is None:
                self._error = (stage, exc)
        for q in self._queues:
            q.abort()

    def raise_if_failed(self) -> None:
        with self._error_lock:
            err = self._error
        if err is not None:
            stage, exc = err
            raise StageError(stage, exc) from exc

    def start(self) -> "Pipeline":
        if self._started:
            raise RuntimeError(
                f"[racon_tpu_torch::pipeline] pipeline {self.name!r} already "
                "started")
        self._started = True
        self._last_drain = time.monotonic()
        for s in self._stages:
            s.start()
        window = stall_window_s()
        if window > 0:
            self._detector = _StallDetector(self, window)
            self._detector.start()
        return self

    def drain(self, q: BoundedQueue):
        """Yield items from the terminal queue until the stream ends;
        re-raise the first stage failure (if any) when it does."""
        while True:
            try:
                item = q.get()
            except (QueueClosed, PipelineAborted):
                break
            self._last_drain = time.monotonic()
            yield item
        self.raise_if_failed()

    def shutdown(self, timeout: float = 30.0) -> None:
        """Abort queues (no-op after a clean drain — every stage already
        exited) and join all stage threads; publishes queue gauges."""
        if self._detector is not None:
            self._detector.stop()
        for q in self._queues:
            q.abort()
        for s in self._stages:
            s.join(timeout=timeout)
        tracer = get_tracer()
        for q in self._queues:
            m = q.metrics()
            metrics.record_queue(q.name, m["peak"], float(m["put_wait_s"]),
                                 float(m["get_wait_s"]))
            tracer.point("queue", q.name, peak=m["peak"],
                         capacity=m["capacity"], items=m["items"],
                         put_wait_s=m["put_wait_s"],
                         get_wait_s=m["get_wait_s"])

    def __enter__(self) -> "Pipeline":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.shutdown()
        return False

    @property
    def alive(self) -> bool:
        return any(s.is_alive() for s in self._stages)

    # ------------------------------------------------------ stall dump

    def _stall_dump(self) -> str:
        now = time.monotonic()
        lines = ["stage dump (name alive items busy_s state age_s):"]
        for s in self._stages:
            lines.append(
                f"  {s.stage_name:<10} alive={int(s.is_alive())} "
                f"items={s.items} busy={s.busy_s:.2f}s "
                f"state={s.state:<4} "
                f"age={now - s.last_progress:.1f}s")
        lines.append("queue dump (name depth/capacity):")
        for q in self._queues:
            lines.append(f"  {q.name:<10} {q.depth}/{q.capacity}")
        return "\n".join(lines)


class _StallDetector(threading.Thread):
    """Converts a silent pipeline deadlock into a fail-fast abort.

    Polls stage heartbeats and the consumer's drain timestamp; when the
    pipeline has live stages yet NOTHING — no stage loop transition, no
    drained item — moved for a full window, it dumps per-stage/per-queue
    state to stderr, records ``pipe_stall_events`` + a ``stall`` span,
    and fails the pipeline with :class:`PipelineStalled` so the abort
    cascade unblocks every queue instead of hanging forever.
    """

    def __init__(self, pipe: Pipeline, window_s: float):
        super().__init__(name=f"racon-stall-{pipe.name}", daemon=True)
        self.pipe = pipe
        self.window_s = window_s
        self._stop = threading.Event()

    def stop(self) -> None:
        self._stop.set()

    def run(self) -> None:
        poll = min(self.window_s / 4.0, 0.5)
        while not self._stop.wait(poll):
            pipe = self.pipe
            if not pipe.alive:
                continue
            now = time.monotonic()
            newest = max([s.last_progress for s in pipe._stages]
                         + [pipe._last_drain])
            if now - newest < self.window_s:
                continue
            dump = pipe._stall_dump()
            running = tuple(s.stage_name for s in pipe._stages
                            if s.is_alive() and s.state == "run")
            print(f"[racon_tpu_torch::pipeline] stall detected: no progress "
                  f"for {now - newest:.1f}s (window {self.window_s:g}s)"
                  f"\n{dump}", file=sys.stderr, flush=True)
            metrics.record_stall(self.window_s, len(pipe._stages))
            watchdog.note_stall(len(pipe._stages))
            pipe._fail("stall", PipelineStalled(self.window_s, dump,
                                                running))
            return
