"""Admission + cross-request batching for the resident daemon (port of
the JAX package's ``server/batch.py``).

A one-shot CLI run hands the engine 8192-window chunks, so the card's
batch dimension is always full. A service does not get that for free:
individual requests are small (a few contigs → a handful of windows),
and dispatching each job's windows alone would run the device at a few
percent occupancy. This module restores the full batch by packing
windows from EVERY in-flight job into one ``consensus_windows``
dispatch.

Correctness lean: window consensus is per-window deterministic and
independent of batch composition — the invariant the serial-vs-
streaming differential tests pin (the engine
buckets windows by shape internally, exactly as it does for one job's
mixed-size windows). So cross-job mixing can change throughput and
latency, never bytes; the server smoke byte-diffs every job against a
solo CLI run to hold the claim.

Mechanics:

- Job threads split their window chunks into capacity-sized work items
  and push them through one bounded MPMC admission queue
  (``pipeline/queues.py`` — a full queue blocks the submitter, which
  is the admission control), then block on their items' completion.
- A single dispatcher thread — the sole owner of device compute —
  stages arrivals into per-tenant FIFOs and composes batches
  round-robin across tenants (one item per tenant per pass), so a
  tenant flooding the queue cannot starve the others; a batch
  dispatches when full, or once its oldest item has waited
  ``RACON_TPU_SERVE_BATCH_WAIT_S`` (the latency floor a lone request
  pays for the chance to share the card).
- Every dispatch runs under the ``serve/dispatch`` fault site and a
  dispatch-class watchdog deadline scaled by the batch's cell volume
  (ops/budget.py), so a wedged device turns into a typed error on the
  affected jobs instead of a silent hang. The guard runs the engine on a
  watchdog thread in the dispatcher's CUDA device and stream; the
  engine's own ``h2d/chunk``, ``dispatch/chunk``, ``sched/flags`` and
  ``d2h/chunk`` guards nest inside it, and every level credits its
  kernel launches back to its caller, so the dispatcher thread's counts
  (``kernels.thread_launches``) hold each batch's launches
  (:attr:`CrossRequestBatcher.dispatches`).
- A dispatch that fails with a sticky device error — a ``KernelError``
  or ``torch.AcceleratorError`` anywhere in its cause chain — or with a
  watchdog breach no injected fault caused, or a terminal one, leaves the
  device unusable or still busy with an abandoned call: the batch's
  jobs fail, the batcher fails every later item without dispatching
  (:attr:`CrossRequestBatcher.fatal`) and calls ``on_fatal``, which the
  daemon takes as the order to stop admitting and exit non-zero. An
  ``InjectedFault``, an injected breach or any other ``TimeoutError``
  only fails the batch's jobs.
- With a :class:`~racon_tpu_torch.cache.memo.WindowMemo` attached (Tier 2
  of the result cache, docs/CACHE.md), each window is probed by
  content digest *before* it is packed into a work item: hits take
  their memoized consensus in place and never reach the device, so a
  job partially overlapping earlier work dispatches only the delta.
  Misses are memoized after their dispatch retires. ``memo=None``
  (the ``RACON_TPU_CACHE=0`` path) is byte-for-byte today's behavior.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from racon_tpu_torch.pipeline.queues import (BoundedQueue, PipelineAborted,
                                       QueueClosed, QueueTimeout)
from racon_tpu_torch.utils import env

ENV_BATCH = env.SERVE_BATCH
ENV_BATCH_WAIT = env.SERVE_BATCH_WAIT_S
ENV_QUEUE = env.SERVE_QUEUE


class ServeError(RuntimeError):
    """A job's dispatch failed inside the shared batcher."""


def device_lost(exc: BaseException) -> bool:
    """True when ``exc`` leaves this process's CUDA context unusable: a
    ``KernelError`` or ``torch.AcceleratorError`` anywhere in its cause
    chain (sticky, asynchronous CUDA errors: every later launch fails the
    same way), a watchdog breach that no injected fault caused (the timed-
    out call keeps running, and launching, on an abandoned thread while
    the next batch would share its engine), or a terminal breach (the
    host is wedged)."""
    import torch

    from racon_tpu_torch.ops.kernels import KernelError
    from racon_tpu_torch.resilience.watchdog import (DispatchTimeout,
                                                     is_terminal)
    sticky = (KernelError,) + ((torch.AcceleratorError,)
                               if hasattr(torch, "AcceleratorError")
                               else ())
    seen = set()
    cur: Optional[BaseException] = exc
    while cur is not None and id(cur) not in seen:
        if isinstance(cur, sticky):
            return True
        if isinstance(cur, DispatchTimeout) and not cur.injected:
            return True
        seen.add(id(cur))
        cur = cur.__cause__ or cur.__context__
    return is_terminal(exc)


def batch_capacity() -> int:
    cap = int(env.read(ENV_BATCH))
    if cap < 1:
        raise ValueError(
            f"[racon_tpu_torch::serve] {ENV_BATCH} must be >= 1, got {cap}")
    return cap


def batch_wait_s() -> float:
    w = float(env.read(ENV_BATCH_WAIT))
    if w < 0:
        raise ValueError(
            f"[racon_tpu_torch::serve] {ENV_BATCH_WAIT} must be >= 0, "
            f"got {w}")
    return w


def queue_capacity() -> int:
    cap = int(env.read(ENV_QUEUE))
    if cap < 1:
        raise ValueError(
            f"[racon_tpu_torch::serve] {ENV_QUEUE} must be >= 1, got {cap}")
    return cap


class _WorkItem:
    __slots__ = ("job_id", "tenant", "windows", "enq_t", "done",
                 "error", "polished", "trace")

    def __init__(self, job_id: str, tenant: str, windows: List,
                 trace=None):
        self.job_id = job_id
        self.tenant = tenant
        self.windows = windows
        self.enq_t = time.perf_counter()
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.polished = 0
        #: Trace-context rider (obs/trace.TraceContext or None): the
        #: dispatch span names every trace it served.
        self.trace = trace


class CrossRequestBatcher:
    """One dispatcher over one engine, fed by many jobs' threads.

    ``engine`` needs only ``consensus_windows(windows) -> int`` filling
    each window's consensus in place — the real PoaEngine in the
    daemon, a stub in the unit tests. ``on_fatal(exc)`` is called once
    when a dispatch loses the device (:func:`device_lost`).

    ``dispatches`` lists one record a dispatch: its windows, jobs,
    tenants, error (or None) and the kernel launches it made, by kernel
    (the dispatcher thread's counts around it).
    """

    def __init__(self, engine, capacity: Optional[int] = None,
                 wait_s: Optional[float] = None,
                 queue_cap: Optional[int] = None, memo=None,
                 on_fatal: Optional[Callable] = None):
        self.engine = engine
        self.memo = memo
        self.on_fatal = on_fatal
        #: The sticky device error that ended dispatching, or None.
        self.fatal: Optional[BaseException] = None
        self.dispatches: List[dict] = []      # dispatcher-thread only
        self.capacity = capacity if capacity is not None \
            else batch_capacity()
        self.wait_s = wait_s if wait_s is not None else batch_wait_s()
        self._admit = BoundedQueue(
            "serve_admit",
            queue_cap if queue_cap is not None else queue_capacity())
        self._staged: Dict[str, deque] = {}   # dispatcher-thread only
        self._rr: List[str] = []              # dispatcher-thread only
        self._staged_windows = 0              # dispatcher-thread only
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "CrossRequestBatcher":
        self._thread = threading.Thread(target=self._run,
                                        name="serve-batcher",
                                        daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop admitting; the dispatcher drains staged work and
        exits. Blocked submitters see the close as an error."""
        self._admit.close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def abort(self) -> None:
        self._admit.abort()

    # ----------------------------------------------------------- job side

    def consensus(self, job_id: str, tenant: str, windows: List,
                  trace=None) -> int:
        """Blockingly run consensus for one job's window chunk through
        the shared batch stream; returns the number polished. Raises
        :class:`ServeError` if the dispatch carrying any slice failed.
        """
        if not windows:
            return 0
        pending = windows
        n_memo = 0
        if self.memo is not None:
            # Tier-2 probe: memoized windows take their consensus in
            # place and never enter the dispatch stream, so only the
            # delta reaches the device (serve_batch_windows counts it).
            from racon_tpu_torch.obs.metrics import record_cache
            pending, hits = [], []
            for w in windows:
                val = self.memo.get(w)
                if val is None:
                    pending.append(w)
                else:
                    w.consensus, w.polished = val
                    hits.append(w)
            if hits:
                record_cache("window", "hit", n=len(hits))
            if pending:
                record_cache("window", "miss", n=len(pending))
            n_memo = sum(1 for w in hits if w.polished)
            if not pending:
                return n_memo
        items = [_WorkItem(job_id, tenant,
                           pending[s:s + self.capacity], trace=trace)
                 for s in range(0, len(pending), self.capacity)]
        for it in items:
            self._admit.put(it)  # blocks at capacity: admission control
        from racon_tpu_torch.obs.metrics import registry
        registry().max("serve_queue_depth_peak", self._admit.depth)
        n = 0
        for it in items:
            it.done.wait()
            if it.error is not None:
                raise ServeError(
                    f"[racon_tpu_torch::serve] job {it.job_id}: batch "
                    f"dispatch failed: {it.error}") from it.error
            n += it.polished
        if self.memo is not None:
            from racon_tpu_torch.obs.metrics import record_cache
            stored = nbytes = 0
            for w in pending:
                sz = self.memo.put(w)
                if sz is not None:
                    stored += 1
                    nbytes += sz
            if stored:
                record_cache("window", "store", n=stored, nbytes=nbytes)
        return n + n_memo

    # ---------------------------------------------------- dispatcher side

    def _stage(self, item: _WorkItem) -> None:
        dq = self._staged.get(item.tenant)
        if dq is None:
            dq = self._staged[item.tenant] = deque()
            self._rr.append(item.tenant)
        dq.append(item)
        self._staged_windows += len(item.windows)

    def _oldest_enq(self) -> float:
        return min(dq[0].enq_t for dq in self._staged.values() if dq)

    def _compose(self) -> List[_WorkItem]:
        """Round-robin one item per tenant per pass until the batch is
        full — per-tenant fairness by construction: with T tenants
        staged, each is guaranteed ~1/T of every batch regardless of
        queue arrival order."""
        batch: List[_WorkItem] = []
        total = 0
        while total < self.capacity:
            progressed = False
            for tenant in list(self._rr):
                dq = self._staged.get(tenant)
                if not dq:
                    continue
                if batch and total + len(dq[0].windows) > self.capacity:
                    continue
                item = dq.popleft()
                self._staged_windows -= len(item.windows)
                batch.append(item)
                total += len(item.windows)
                progressed = True
                if total >= self.capacity:
                    break
            if not progressed:
                break
        # Rotate the starting tenant so ties don't always favor the
        # earliest joiner.
        if self._rr:
            self._rr.append(self._rr.pop(0))
        return batch

    def _dispatch(self, batch: List[_WorkItem]) -> None:
        from racon_tpu_torch.obs.metrics import record_serve_batch
        from racon_tpu_torch.ops import kernels
        from racon_tpu_torch.ops.budget import dispatch_deadline_s
        from racon_tpu_torch.resilience.faults import maybe_fault
        from racon_tpu_torch.resilience.watchdog import guard

        windows = [w for it in batch for w in it.windows]
        wait_s = sum(time.perf_counter() - it.enq_t for it in batch)
        # Forward-plane cell volume drives the deadline, same model as
        # the engine's own dispatch class (ops/budget.py).
        cells = sum(len(w) * (w.n_layers + 1) for w in windows)
        t0 = time.perf_counter()
        before = kernels.thread_launches()
        error: Optional[BaseException] = None
        try:
            if self.fatal is not None:
                raise ServeError(
                    f"[racon_tpu_torch::serve] the device was lost in an "
                    f"earlier dispatch: {self.fatal}") from self.fatal
            maybe_fault("serve/dispatch")
            guard("serve/dispatch", dispatch_deadline_s(cells),
                  self.engine.consensus_windows, windows)
        except BaseException as exc:  # noqa: BLE001 — fanned out per job
            error = exc
            for it in batch:
                it.error = exc
            if self.fatal is None and device_lost(exc):
                self.fatal = exc
                if self.on_fatal is not None:
                    self.on_fatal(exc)
        else:
            for it in batch:
                it.polished = sum(1 for w in it.windows if w.polished)
        finally:
            after = kernels.thread_launches()
            self.dispatches.append(dict(
                windows=len(windows),
                jobs=sorted({it.job_id for it in batch}),
                tenants=sorted({it.tenant for it in batch}),
                error=None if error is None else repr(error),
                launches={k: n - before.get(k, 0)
                          for k, n in after.items()
                          if n != before.get(k, 0)}))
            for it in batch:
                it.done.set()
        record_serve_batch(
            n_windows=len(windows), capacity=self.capacity,
            jobs=sorted({it.job_id for it in batch}),
            tenants=sorted({it.tenant for it in batch}), wait_s=wait_s,
            round_s=time.perf_counter() - t0,
            trace_ids=[it.trace.trace_id for it in batch if it.trace],
            parent_ids=[it.trace.parent_id for it in batch if it.trace])

    def _run(self) -> None:
        closed = False
        while not (closed and self._staged_windows == 0):
            if self._staged_windows == 0:
                try:
                    self._stage(self._admit.get())
                except QueueClosed:
                    closed = True
                    continue
                except PipelineAborted:
                    return
            # Top up: wait for more work until the batch fills or the
            # oldest staged item's flush deadline lapses.
            while self._staged_windows < self.capacity and not closed:
                left = self._oldest_enq() + self.wait_s \
                    - time.perf_counter()
                if left <= 0:
                    break
                try:
                    self._stage(self._admit.get(timeout=left))
                except QueueTimeout:
                    break
                except QueueClosed:
                    closed = True
                except PipelineAborted:
                    return
            batch = self._compose()
            if batch:
                self._dispatch(batch)


class BatchedEngineProxy:
    """Engine facade handed to each job's Polisher: consensus routes
    through the shared cross-request batcher; everything else (backend
    probing, scheduler telemetry) forwards to the real engine, so the
    Polisher cannot tell it is sharing the card."""

    def __init__(self, batcher: CrossRequestBatcher, job_id: str,
                 tenant: str, trace=None):
        self._batcher = batcher
        self._job_id = job_id
        self._tenant = tenant
        self._trace = trace

    def consensus_windows(self, windows: List) -> int:
        return self._batcher.consensus(self._job_id, self._tenant,
                                       windows, trace=self._trace)

    def __getattr__(self, name: str):
        return getattr(self._batcher.engine, name)
