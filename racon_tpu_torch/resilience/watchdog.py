"""Monotonic-clock deadline watchdog for the fail-slow failure class —
port of the JAX package's ``resilience/watchdog.py``.

The retry ladder (retry.py) only fires when a choke point *raises*; a
wedged call — a copy that never completes, a ``.cpu()`` that never
returns — would hang the process. :func:`guard` turns that silence into
an exception within a bounded deadline:

- the guarded body runs on a reusable daemon worker thread
  (``racon-watchdog``); the caller waits at most ``deadline_s`` on the
  monotonic clock;
- a breach raises :class:`DispatchTimeout` (a ``TimeoutError``, so
  retry.call's transient filter accepts it) into the retry ladder: a
  slow call is retried; past the budget, only a breach of an injected
  sleep or at an upload degrades to the host path
  (retry.RetryExhausted.degradable);
- once the process-wide breach count reaches
  ``RACON_TPU_WATCHDOG_TERMINAL=N`` (default 0 = never), a breach raises
  :class:`WatchdogTerminal` instead — not transient, so it propagates.

Per-site deadlines come from ops/budget.py (``transfer_deadline_s`` /
``dispatch_deadline_s``, ``RACON_TPU_DEADLINE_*``); :func:`site_deadline`
gives the geometry-free class default of a site that passes none. A
deadline of 0 turns the guard off (the body runs inline on the caller).

Where PyTorch differs from JAX. A JAX dispatch is functional and can
start from any thread; a CUDA launch goes to the launching thread's
current stream and device, and the port's launch counters are per thread
too. So a job carries the caller's state into the worker:

- the caller's current CUDA device and stream, which the worker enters
  for the job (when CUDA is initialized in the process), so the body's
  copies and launches land where the caller's would;
- the caller's tracer span stack (a copy), so spans keep their parents;
- back the other way, the kernel launches the body made
  (``ops/kernels.thread_launches``) are credited to the caller's thread
  when the job returns, so the stage clock and every per-thread count
  read as if the body had run inline. The host clock
  (device_poa.host_part) is process-wide and needs no bridge.

An abandoned attempt must not run its body. The injected ``hang`` sleeps
in retry.py's attempt before the body starts; after a breach the worker
wakes with its job flagged (:func:`abandoned`), and the attempt returns
without calling the body, so no second set of kernels goes out on the
same stream for a chunk that was retried or degraded meanwhile. An
organic wedge — a body already inside a ``.cpu()`` that never returns —
cannot be recalled: there is no safe cross-thread kill in CPython. Its
worker is daemonic, flagged to retire instead of rejoining the pool, and
the process never waits on it; its launches are not credited to anyone.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, List, Optional

from racon_tpu_torch.utils import env

ENV_TERMINAL = env.WATCHDOG_TERMINAL

#: Exit code of a run that stopped on a terminal watchdog breach
#: (EX_TEMPFAIL: the input is fine, this host is not — retry elsewhere).
EXIT_SELF_EVICT = 75


class DispatchTimeout(TimeoutError):
    """A guarded call site exceeded its deadline.

    A ``TimeoutError``, so retry.py treats a breach like any transient
    failure. ``injected``: the body was sleeping in an injected
    ``hang``/``stall`` (faults.py) when the deadline passed.
    """

    def __init__(self, site: str, deadline_s: float, waited_s: float,
                 injected: bool = False):
        super().__init__(
            f"[racon_tpu_torch::watchdog] {site} exceeded its "
            f"{deadline_s:.3f}s deadline (waited {waited_s:.3f}s); the "
            "call keeps running on an abandoned thread")
        self.site = site
        self.deadline_s = deadline_s
        self.waited_s = waited_s
        self.injected = injected


class WatchdogTerminal(RuntimeError):
    """The process crossed its terminal breach budget: this host is
    considered wedged. Not transient: it must reach the CLI (exit 75),
    not the retry loop."""

    def __init__(self, site: str, breaches: int, limit: int):
        super().__init__(
            f"[racon_tpu_torch::watchdog] terminal: {breaches} deadline "
            f"breach(es) (limit {limit}, last at {site}) — this worker "
            "is wedged and should hand its work back")
        self.site = site
        self.breaches = breaches
        self.limit = limit


def terminal_limit() -> int:
    """Breach count at which a breach becomes terminal; 0 turns it off."""
    txt = env.read(ENV_TERMINAL)
    if not txt:
        return 0
    try:
        v = int(txt)
    except ValueError:
        raise ValueError(
            f"[racon_tpu_torch::watchdog] invalid {ENV_TERMINAL}={txt!r} "
            "(expected an integer breach count, 0 to disable)")
    if v < 0:
        raise ValueError(
            f"[racon_tpu_torch::watchdog] invalid {ENV_TERMINAL}={v} "
            "(must be >= 0)")
    return v


def is_terminal(exc: BaseException) -> bool:
    """True when ``exc`` is (or was caused by, at any depth) a
    :class:`WatchdogTerminal` — a pipeline stage wraps it in StageError,
    so callers check the cause chain, not the type."""
    seen = set()
    cur: Optional[BaseException] = exc
    while cur is not None and id(cur) not in seen:
        if isinstance(cur, WatchdogTerminal):
            return True
        seen.add(id(cur))
        cur = cur.__cause__ or cur.__context__
    return False


# ----------------------------------------------------------- guard pool

class _Job:
    __slots__ = ("fn", "args", "kwargs", "done", "result", "exc", "stack",
                 "deadline_s", "cuda", "abandoned", "injected", "launches")

    def __init__(self, fn, args, kwargs, stack, deadline_s, cuda):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.done = threading.Event()
        self.result = None
        self.exc: Optional[BaseException] = None
        self.stack = stack          # caller's tracer span stack (copy)
        self.deadline_s = deadline_s
        self.cuda = cuda            # caller's (device index, stream) or None
        self.abandoned = False      # set by guard() on a breach
        self.injected = False       # set by note_injected_sleep()
        self.launches: Dict[str, int] = {}   # the body's kernel launches


def _caller_cuda():
    """The calling thread's current CUDA device and stream, when CUDA is
    initialized in this process (else None: the body needs no stream)."""
    import torch
    if not torch.cuda.is_initialized():
        return None
    idx = torch.cuda.current_device()
    return idx, torch.cuda.current_stream(idx)


@contextlib.contextmanager
def _enter_cuda(cuda):
    if cuda is None:
        yield
        return
    import torch
    idx, stream = cuda
    with torch.cuda.device(idx), torch.cuda.stream(stream):
        yield


class _GuardWorker(threading.Thread):
    """One reusable guard thread: jobs arrive through a condition
    variable, results ride on the job object (never on the worker, so a
    late result from an abandoned job cannot be taken for a new one)."""

    def __init__(self):
        super().__init__(name="racon-watchdog", daemon=True)
        self.cv = threading.Condition()
        self.job: Optional[_Job] = None
        self.abandoned = False
        self.start()

    def submit(self, job: _Job) -> None:
        with self.cv:
            self.job = job
            self.cv.notify()

    def run(self) -> None:
        from racon_tpu_torch.obs.trace import get_tracer
        from racon_tpu_torch.ops import kernels
        while True:
            with self.cv:
                while self.job is None:
                    self.cv.wait()
                job = self.job
            tracer = get_tracer()
            # The caller's span stack (a COPY — an abandoned worker that
            # finishes late must not corrupt the caller's), so spans
            # opened inside the body keep their parents.
            tracer.install_stack(job.stack)
            _local.deadline = job.deadline_s
            _local.job = job
            before = kernels.thread_launches()
            try:
                with _enter_cuda(job.cuda):
                    job.result = job.fn(*job.args, **job.kwargs)
            except BaseException as exc:  # noqa: BLE001 — re-raised by guard()
                job.exc = exc
            finally:
                after = kernels.thread_launches()
                job.launches = {k: n - before.get(k, 0)
                                for k, n in after.items()
                                if n != before.get(k, 0)}
                _local.deadline = 0.0
                _local.job = None
                tracer.install_stack([])
            with self.cv:
                self.job = None
                retire = self.abandoned
            job.done.set()
            if retire:
                return              # never rejoin the pool
            with _pool_lock:
                _pool.append(self)


_pool_lock = threading.Lock()
_pool: List[_GuardWorker] = []
_local = threading.local()

_state_lock = threading.Lock()
_breaches: Dict[str, int] = {}
_breach_total = 0
_terminal_total = 0
_last_breach: Optional[Dict[str, object]] = None
_stall_total = 0


def ambient_deadline() -> float:
    """The deadline armed on the CURRENT thread (a guarded body sees its
    own; everything else sees 0). The ``hang`` fault action sleeps past
    it."""
    return getattr(_local, "deadline", 0.0)


def abandoned() -> bool:
    """True inside a guarded body whose caller already gave up on it (a
    breach): the body must not start its work."""
    job = getattr(_local, "job", None)
    return job is not None and job.abandoned


def note_injected_sleep() -> None:
    """The fault injector calls this before an injected ``hang`` or
    ``stall`` sleeps: a breach of the current guarded body is then
    injected, not a slow kernel or transfer."""
    job = getattr(_local, "job", None)
    if job is not None:
        job.injected = True


def site_deadline(site: str) -> float:
    """Geometry-free class default for a retry site, by prefix. Sites
    outside the transfer/dispatch families get no deadline (0)."""
    from racon_tpu_torch.ops.budget import (dispatch_deadline_s,
                                            transfer_deadline_s)
    if site.startswith("h2d/"):
        return transfer_deadline_s(0, "h2d")
    if site.startswith("d2h/"):
        return transfer_deadline_s(0, "d2h")
    if site.startswith(("dispatch/", "sched/")):
        # Flag pulls wait on compute, so they share the dispatch budget.
        return dispatch_deadline_s(0)
    return 0.0


def _checkout() -> _GuardWorker:
    with _pool_lock:
        if _pool:
            return _pool.pop()
    return _GuardWorker()


def _record_breach(site: str, deadline_s: float, waited_s: float,
                   terminal: bool) -> int:
    global _breach_total, _terminal_total, _last_breach
    with _state_lock:
        _breach_total += 1
        _breaches[site] = _breaches.get(site, 0) + 1
        if terminal:
            _terminal_total += 1
        _last_breach = {"site": site, "deadline_s": deadline_s,
                        "waited_s": round(waited_s, 3),
                        "unix_time": time.time()}
        total = _breach_total
    from racon_tpu_torch.pipeline.metrics import record_watchdog_breach
    record_watchdog_breach(site, deadline_s, waited_s, terminal=terminal)
    return total


def guard(site: str, deadline_s: Optional[float], fn: Callable,
          *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a monotonic deadline.

    ``deadline_s=None`` resolves :func:`site_deadline`; a resolved
    deadline <= 0 runs the body inline (guard off). On a breach the job
    is flagged abandoned, its worker retires, and :class:`DispatchTimeout`
    — or :class:`WatchdogTerminal` once the process-wide breach count
    reaches ``RACON_TPU_WATCHDOG_TERMINAL`` — is raised on the caller.
    """
    if deadline_s is None:
        deadline_s = site_deadline(site)
    if not deadline_s or deadline_s <= 0:
        return fn(*args, **kwargs)
    from racon_tpu_torch.obs.trace import get_tracer
    job = _Job(fn, args, kwargs, get_tracer().snapshot_stack(),
               float(deadline_s), _caller_cuda())
    worker = _checkout()
    t0 = time.monotonic()
    worker.submit(job)
    if not job.done.wait(deadline_s):
        waited = time.monotonic() - t0
        completed = False
        with worker.cv:
            if worker.job is job:
                worker.abandoned = True     # retires after the late job
                job.abandoned = True
            else:
                completed = True            # finished a hair past deadline
        if not completed:
            limit = terminal_limit()
            # Whether THIS breach crosses the limit, read before it is
            # recorded, so the terminal flag lands on the right record.
            with _state_lock:
                will_be = _breach_total + 1
            terminal = bool(limit) and will_be >= limit
            total = _record_breach(site, deadline_s, waited, terminal)
            if terminal:
                raise WatchdogTerminal(site, total, limit)
            raise DispatchTimeout(site, deadline_s, waited, job.injected)
        job.done.wait()
    if job.launches:
        from racon_tpu_torch.ops import kernels
        kernels.credit_thread_launches(job.launches)
    if job.exc is not None:
        raise job.exc
    return job.result


# -------------------------------------------------------------- health

def note_stall(n_stages: int) -> None:
    """The pipeline's stall detector calls this: stall state for
    :func:`health_snapshot`."""
    global _stall_total
    with _state_lock:
        _stall_total += 1


def health_snapshot() -> Dict[str, object]:
    """Liveness view: ``status`` is ``"ok"`` until a terminal breach or a
    pipeline stall has been seen; breach counters ride along."""
    with _state_lock:
        status = "ok"
        if _terminal_total:
            status = "terminal"
        elif _stall_total:
            status = "stalled"
        return {
            "status": status,
            "watchdog_breaches": _breach_total,
            "watchdog_terminal": _terminal_total,
            "pipeline_stalls": _stall_total,
            "breaches_by_site": dict(_breaches),
            "last_breach": dict(_last_breach) if _last_breach else None,
        }


def reset() -> None:
    """Clear the process-wide breach and stall state (tests)."""
    global _breach_total, _terminal_total, _last_breach, _stall_total
    with _state_lock:
        _breaches.clear()
        _breach_total = 0
        _terminal_total = 0
        _last_breach = None
        _stall_total = 0
