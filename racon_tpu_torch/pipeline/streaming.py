"""The polish-specific streaming executor — port of the JAX package's
``pipeline/streaming.py``.

:func:`stream_consensus` runs a window list through the serial engine's
own slice decomposition (PoaEngine._partition_device and
_plan_device_slice, so chunk composition and output are the serial
path's), spread over overlapped stages:

    build ──q──▶ pack ──q──▶ h2d ──q──▶ compute ──q──▶ walk ──q──▶ (drain)
                   │                                            ▲
                   └── host-path items ─────────────────────────┘

- **build** (producer): slice the window list by ``chunk``, give trivial
  windows their backbone, partition the rest into device chunk groups
  and host-path windows.
- **pack** builds the next chunk's :class:`ChunkPlan` while the card runs
  the current one, and polishes host-path windows (which then skip to the
  done queue: the source of out-of-order retirement).
- **h2d** packs the plan's byte buffers and starts their copy
  (device_poa.put_chunk_bufs, or the scheduler's put_chunk); the ``run``
  queue's capacity (the depth) bounds how many chunks' inputs sit on the
  card.
- **compute** runs the chunk's rounds (ConvergenceScheduler.run_chunk by
  default; dispatch_chunk + collect_chunk under ``RACON_TPU_SCHED=0``),
  applies the consensus and sends flagged windows to the redo. On the
  decoupled-walk path (fixed rounds, ``RACON_TPU_WALK_ASYNC`` on, not the
  last chunk, the walk queue's budget admits the chunk) it launches only
  the forward half (dispatch_chunk_fwd) and hands the final round's planes
  on.
- **walk** finishes decoupled chunks (device_poa.dispatch_walk, the d2h, the
  consensus applied), so chunk N's final walk and its d2h wait overlap
  chunk N+1's launches on the compute thread; fused items pass through.

The caller drains completed items; :class:`SliceTracker` releases
contiguous leading slices in input order. Host-path work (pack stage) and
the redo (compute and walk stages) share the engine's native aligner, so
one lock serializes them.

On a GPU, every stage thread runs on the engine's device and on one CUDA
stream that stream_consensus creates (a new thread starts on the default
stream of device 0; ChunkBufs.tensors makes the *calling* thread's stream
wait for a chunk's copy). The compute and walk stages launch on that same
stream, so the planes handed from one to the other are ordered by launch
order and need no event.

Faults (the reference's semantics):

- a chunk whose transfer or dispatch exhausts its retries
  (``RetryExhausted`` in the h2d, compute or walk stage) polishes on the
  host path under the host lock (PoaEngine._degrade) and retires
  normally: no slice is lost and the bytes do not change. Only a
  ``degradable`` exhaustion does (an injected fault, or an upload); a
  real breach or out-of-memory where kernels run fails its stage;
- a stall (:class:`~racon_tpu_torch.pipeline.stages.PipelineStalled`)
  tears the pipeline down; every window past the last retired slice is
  then polished on the host path, with the same bytes, and the stream
  goes on to its end — the reference's recovery, held to the fault
  drill: it runs only while a fault plan is armed, never for a compute
  or walk stage stalled on the card (a slow kernel), and only once
  every stage thread has exited (a body still running would write its
  windows beside the recovery's). Otherwise the stall raises;
- any other stage failure — a kernel's error above all — raises
  :class:`StageError` at the consumer. Nothing else falls back to the
  host path.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from racon_tpu_torch.obs.metrics import record_windows
from racon_tpu_torch.obs.trace import get_tracer
from racon_tpu_torch.pipeline import (metrics, pipeline_depth,
                                      walk_async_enabled)
from racon_tpu_torch.pipeline.queues import (BoundedQueue, PipelineAborted,
                                             QueueClosed)
from racon_tpu_torch.pipeline.stages import (Pipeline, PipelineStalled,
                                             StageError)
from racon_tpu_torch.resilience.retry import RetryExhausted
from racon_tpu_torch.utils import env


class IngestPrefetcher:
    """The ingest stage: parse a file's chunks ahead of their consumer on
    a thread of its own, so that the polisher's three input files parse
    at once (and a later chunk parses while an earlier one is consumed).

    One producer thread runs ``parser.reset()`` then chunked
    ``parser.parse(max_bytes)`` into a bounded queue (depth: the pipeline
    depth, at least 2). The consumer iterates :meth:`chunks`; its blocked
    time counts as ``ingest_wait_s``, the producer's parse time as
    ``ingest_parse_s``. A producer-side error (ParseError) re-raises in
    the consumer.

    Always ``close()`` in a finally: an abandoned consumer aborts the
    queue, which unblocks and retires the producer thread.
    """

    def __init__(self, parser, max_bytes: int, label: str = "ingest"):
        self._parser = parser
        self._max_bytes = max_bytes
        self._q = BoundedQueue(f"ingest_{label}", max(pipeline_depth(), 2))
        self._err: List[BaseException] = []
        self._parse_s = 0.0
        self._records = 0
        self._thread = threading.Thread(
            target=self._produce, name=f"racon-ingest-{label}",
            daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        try:
            self._parser.reset()
            while True:
                t0 = time.perf_counter()
                chunk, more = self._parser.parse(self._max_bytes)
                self._parse_s += time.perf_counter() - t0
                self._records += len(chunk)
                self._q.put((chunk, more))
                if not more:
                    break
            self._q.close()
        except PipelineAborted:
            pass                    # consumer went away first
        except BaseException as exc:  # noqa: BLE001 — re-raised by chunks()
            self._err.append(exc)
            self._q.abort()

    def chunks(self) -> Iterator[Tuple[List, bool]]:
        """Yield ``(records, more)`` chunks in parse order."""
        while True:
            t0 = time.perf_counter()
            try:
                chunk, more = self._q.get()
            except QueueClosed:
                return
            except PipelineAborted:
                if self._err:
                    raise self._err[0]
                raise
            finally:
                metrics.record_ingest_wait(time.perf_counter() - t0)
            yield chunk, more
            if not more:
                return

    def close(self) -> None:
        """Tear down (idempotent): abort the queue, join the producer,
        record this file's parse totals."""
        self._q.abort()
        self._thread.join(timeout=30.0)
        if self._records or self._parse_s:
            metrics.record_ingest_parse("prefetch", self._parse_s,
                                        self._records, self._parser._pos)
            self._records = 0
            self._parse_s = 0.0


def serial_chunks(parser, max_bytes: int) -> Iterator[Tuple[List, bool]]:
    """The ingest path without a prefetch thread (``RACON_TPU_INGEST=0``):
    the same ``(records, more)`` protocol; the parse seconds count as
    both parse and wait seconds, since all of it is on the critical
    path."""
    parser.reset()
    parse_s = 0.0
    records = 0
    try:
        while True:
            t0 = time.perf_counter()
            chunk, more = parser.parse(max_bytes)
            parse_s += time.perf_counter() - t0
            records += len(chunk)
            yield chunk, more
            if not more:
                return
    finally:
        if records or parse_s:
            metrics.record_ingest_parse("serial", parse_s, records,
                                        parser._pos)
            metrics.record_ingest_wait(parse_s)


class _Item:
    """One unit of pipeline work: a device chunk group or a host batch."""
    __slots__ = ("kind", "sid", "gid", "windows", "sp", "plan", "bufs",
                 "fwd", "last")

    def __init__(self, kind: str, sid: int, windows, sp=None, gid: int = 0):
        self.kind = kind        # "chunk" | "host"
        self.sid = sid          # slice index (retirement unit)
        self.gid = gid          # chunk group index within the slice
        self.windows = windows
        self.sp = sp            # _DeviceSlicePlan (chunk items)
        self.plan = None        # ChunkPlan, set by the pack stage
        self.bufs = None        # ChunkBufs, set by the h2d stage
        self.fwd = None         # (fwd_out, meta) of a decoupled forward
        #                         (compute stage); None: the fused path.
        self.last = False       # the stream's final chunk item: nothing
        #                         follows to overlap, so it runs fused.


class _WalkOverlapMeter:
    """How much of the decoupled walks' time was hidden.

    A chunk's forward is "in flight" from its forward's dispatch until its
    own walk begins; while a walk runs, every second during which another
    chunk's forward is in flight is overlap. The walk stage is one thread,
    so no forward leaves the in-flight set during a walk; the set only
    grows, and the overlap window is [first moment others exist, walk
    end].
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight: set = set()
        self._cur_key = None
        self._cur_start: Optional[float] = None
        self._cur_overlap_from: Optional[float] = None
        self.walk_s = 0.0
        self.overlap_s = 0.0
        self.dispatches = 0
        self.fused = 0

    def fwd_dispatched(self, key) -> None:
        with self._lock:
            self._inflight.add(key)
            if (self._cur_start is not None
                    and self._cur_overlap_from is None
                    and self._inflight - {self._cur_key}):
                self._cur_overlap_from = time.perf_counter()

    def note_fused(self) -> None:
        with self._lock:
            self.fused += 1

    def walk_begin(self, key) -> None:
        with self._lock:
            self._inflight.discard(key)
            self._cur_key = key
            self._cur_start = time.perf_counter()
            self._cur_overlap_from = \
                self._cur_start if self._inflight else None

    def walk_end(self, key) -> None:
        with self._lock:
            now = time.perf_counter()
            if self._cur_start is not None:
                self.walk_s += now - self._cur_start
                if self._cur_overlap_from is not None:
                    self.overlap_s += now - self._cur_overlap_from
            self._cur_key = None
            self._cur_start = self._cur_overlap_from = None
            self.dispatches += 1


class SliceTracker:
    """Orders retirement: slices complete out of order, ranges release in
    input order.

    The build stage registers each slice (window range + item count)
    before emitting its items; the drain loop retires items as they
    complete. ``retire``/``flush`` return the newly releasable
    ``(slice_id, start, end)`` ranges — always the contiguous leading run
    of completed slices.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._left: Dict[int, int] = {}
        self._bounds: Dict[int, Tuple[int, int]] = {}
        self._next = 0

    def register(self, sid: int, start: int, end: int,
                 n_items: int) -> None:
        with self._lock:
            self._bounds[sid] = (start, end)
            self._left[sid] = n_items

    def retire(self, sid: int) -> List[Tuple[int, int, int]]:
        with self._lock:
            left = self._left.get(sid, 0) - 1
            if left < 0:
                raise RuntimeError(
                    f"[racon_tpu_torch::pipeline] slice {sid} retired more "
                    "items than it registered")
            self._left[sid] = left
            return self._release()

    def flush(self) -> List[Tuple[int, int, int]]:
        """Release whatever completed after the stream drained cleanly; a
        leftover incomplete slice means an item was lost — an executor bug
        that must fail loudly, not truncate output."""
        with self._lock:
            out = self._release()
            if self._bounds:
                raise RuntimeError(
                    f"[racon_tpu_torch::pipeline] {len(self._bounds)} "
                    "slice(s) never completed (lost pipeline item)")
            return out

    def _release(self) -> List[Tuple[int, int, int]]:
        out = []
        while self._next in self._bounds and self._left[self._next] == 0:
            s, e = self._bounds.pop(self._next)
            del self._left[self._next]
            out.append((self._next, s, e))
            self._next += 1
        return out


def _thread_context(device):
    """The stage threads' context: on a GPU, ``device`` and one CUDA stream
    made here for the whole run (nothing on the CPU)."""
    import torch
    if device.type != "cuda":
        return contextlib.nullcontext
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.Stream(idx)

    @contextlib.contextmanager
    def ctx():
        with torch.cuda.device(idx), torch.cuda.stream(stream):
            yield

    return ctx


def _walk_budget(device) -> int:
    """The walk queue's byte budget on ``device`` (budget.walk_queue_bytes
    from the card's memory on a GPU)."""
    from racon_tpu_torch.ops.budget import walk_queue_bytes
    total = 0
    if device.type == "cuda":
        import torch
        total = torch.cuda.get_device_properties(device).total_memory
    return walk_queue_bytes(device.type, total)


def _stall_unrecoverable(stalled: PipelineStalled, pipe: Pipeline,
                         device) -> str:
    """Why a stall must end the run instead of being recovered on the
    host path (module docstring); '' when the recovery may run."""
    import torch
    from racon_tpu_torch.resilience.faults import get_injector
    if get_injector() is None:
        return "no fault plan is armed"
    on_card = {"compute", "walk"} & set(stalled.running)
    if on_card and torch.device(device).type == "cuda":
        return f"the {'/'.join(sorted(on_card))} stage stalled on the card"
    if pipe.alive:
        return "a stage thread is still running"
    return ""


def stream_consensus(engine, windows, chunk: int = 8192,
                     depth: Optional[int] = None,
                     tick=None) -> Iterator[Tuple[int, int]]:
    """Polish ``windows`` through the streaming pipeline.

    Generator yielding ``(start, end)`` index ranges (ascending,
    contiguous, covering ``range(len(windows))``) as windows finalize —
    every window in a yielded range has its consensus. ``depth`` bounds
    in-flight chunks per queue (None reads RACON_TPU_PIPELINE_DEPTH /
    --pipeline-depth); ``tick`` is called once per completed slice.

    Abandoning the generator early tears the pipeline down (queues abort,
    stage threads join). A stall is recovered on the host path (module
    docstring); any other stage failure re-raises here as
    :class:`~racon_tpu_torch.pipeline.stages.StageError`.
    """
    n = len(windows)
    if n == 0:
        return
    if depth is None:
        depth = pipeline_depth()
    depth = max(1, int(depth))
    chunk = max(1, int(chunk))

    tracer = get_tracer()
    host_lock = threading.Lock()
    sched = engine._make_scheduler() if env.sched_enabled() else None
    rounds = engine.refine_rounds + 1
    scales = engine._round_scales(rounds)
    device = engine.device

    # Decoupled walk: the fixed-round path only (the scheduler reads every
    # round's flags on the host). RACON_TPU_WALK_QUEUE=0 also turns it off.
    walk_async = sched is None and walk_async_enabled()
    want_q = 0
    budget = 0
    if walk_async:
        from racon_tpu_torch.ops.budget import walk_queue_env
        want_q = walk_queue_env(depth)
        walk_async = want_q > 0
        budget = _walk_budget(device)
    meter = _WalkOverlapMeter()

    tracker = SliceTracker()
    pipe = Pipeline("polish", thread_context=_thread_context(device))
    q_pack = pipe.queue("pack", depth)
    q_put = pipe.queue("put", depth)
    q_run = pipe.queue("run", depth)
    # The walk stage is always in the graph (fused items pass through);
    # its capacity bounds the decoupled chunks waiting for their walk.
    q_walk = pipe.queue("walk", max(want_q, 1))
    q_done = pipe.queue("done", max(2 * depth, 4))

    n_slices = (n + chunk - 1) // chunk

    def build():
        for sid, s in enumerate(range(0, n, chunk)):
            active = []
            for w in windows[s:s + chunk]:
                if w.n_layers < 2:
                    w.set_backbone_consensus()
                else:
                    active.append(w)
            items: List[_Item] = []
            if active:
                dev, host, lq_max, la_max = engine._partition_device(active)
                if dev:
                    sp = engine._plan_device_slice(dev, lq_max, la_max)
                    if sp.overflow_msg:
                        print(sp.overflow_msg, file=engine.log)
                    host = host + sp.host
                    for gi, ws in enumerate(sp.groups):
                        items.append(_Item("chunk", sid, ws, sp=sp, gid=gi))
                if host:
                    items.append(_Item("host", sid, host))
            # The stream's final chunk item has nothing after it to hide
            # behind: it runs fused.
            if sid == n_slices - 1:
                for it in reversed(items):
                    if it.kind == "chunk":
                        it.last = True
                        break
            # Register BEFORE emitting: an item can only retire after its
            # slice is known to the tracker.
            tracker.register(sid, s, min(s + chunk, n), len(items))
            yield from items

    def pack(item: _Item) -> Optional[_Item]:
        if item.kind == "host":
            # Host consensus runs here so it overlaps device compute; the
            # item then goes straight to done.
            with host_lock:
                engine._consensus_host(item.windows)
            q_done.put(item)
            return None
        item.plan = engine._make_chunk_plan(item.sp, item.windows)
        return item

    def degrade(item: _Item, exc) -> None:
        # A transfer or dispatch exhausted its retries: the chunk's
        # windows polish on the host path and the item retires normally.
        with host_lock:
            engine._degrade(item.windows, exc)
        item.plan = item.bufs = item.fwd = None

    def h2d(item: _Item) -> Optional[_Item]:
        from racon_tpu_torch.ops.device_poa import put_chunk_bufs
        # Returns at once on a GPU: the copy overlaps the current chunk's
        # compute; q_run's capacity bounds the chunks on the card.
        try:
            item.bufs = sched.put_chunk(item.plan) if sched is not None \
                else put_chunk_bufs(item.plan, device)
        except RetryExhausted as exc:
            degrade(item, exc)
            q_done.put(item)        # past compute and walk, retired
            return None
        return item

    def admit_async(item: _Item) -> bool:
        # Never the last chunk; the parked planes of want_q chunks plus
        # the one being walked must fit the walk queue's budget.
        if not walk_async or item.last:
            return False
        from racon_tpu_torch.ops.budget import walk_queue_depth
        from racon_tpu_torch.ops.device_poa import walk_plane_bytes_for
        pb = walk_plane_bytes_for(item.plan, ins_scale=scales,
                                  rounds=rounds)
        return walk_queue_depth(pb, want_q + 1, budget) >= want_q + 1

    def finish(item: _Item, codes, covs) -> None:
        trunc: List = []
        engine._apply_group(item.windows, codes, covs, trunc)
        if trunc:
            with host_lock:
                engine._redo_trunc(trunc)
        item.plan = item.bufs = item.fwd = None   # drop device references

    def compute(item: _Item) -> _Item:
        from racon_tpu_torch.ops.device_poa import (collect_chunk,
                                                    dispatch_chunk,
                                                    dispatch_chunk_fwd)
        span = dict(windows=len(item.windows), lanes=item.plan.B,
                    jobs=item.plan.n_jobs)
        name = f"chunk{item.sid}.{item.gid}"
        if admit_async(item):
            # Launch the forward half only and hand its planes on: this
            # thread is free at once to launch the next chunk.
            try:
                with tracer.span("chunk", name, **span):
                    item.fwd = dispatch_chunk_fwd(
                        item.plan, match=engine.match,
                        mismatch=engine.mismatch, gap=engine.gap,
                        ins_scale=scales, rounds=rounds, device=device,
                        bufs=item.bufs)
            except RetryExhausted as exc:
                degrade(item, exc)
                return item
            item.bufs = None
            meter.fwd_dispatched((item.sid, item.gid))
            return item
        try:
            with tracer.span("chunk", name, **span):
                if sched is not None:
                    codes, covs = sched.run_chunk(item.plan, bufs=item.bufs)
                else:
                    packed = dispatch_chunk(
                        item.plan, match=engine.match,
                        mismatch=engine.mismatch, gap=engine.gap,
                        ins_scale=scales, rounds=rounds, device=device,
                        bufs=item.bufs)
                    codes, covs = collect_chunk(item.plan, packed)
        except RetryExhausted as exc:
            degrade(item, exc)
            return item
        meter.note_fused()
        finish(item, codes, covs)
        return item

    def walk(item: _Item) -> _Item:
        # Fused and host items pass through untouched.
        if item.fwd is None:
            return item
        from racon_tpu_torch.ops.device_poa import (collect_chunk,
                                                    dispatch_walk)
        key = (item.sid, item.gid)
        try:
            meter.walk_begin(key)
            try:
                with tracer.span("walk", f"walk{item.sid}.{item.gid}",
                                 lanes=item.plan.B,
                                 windows=len(item.windows)):
                    fwd_out, meta = item.fwd
                    packed = dispatch_walk(item.plan, fwd_out, meta)
                    codes, covs = collect_chunk(item.plan, packed)
            finally:
                meter.walk_end(key)
        except RetryExhausted as exc:
            degrade(item, exc)
            return item
        finish(item, codes, covs)
        return item

    pipe.source("build", build, q_pack)
    pipe.stage("pack", pack, q_pack, q_put)
    pipe.stage("h2d", h2d, q_put, q_run)
    pipe.stage("compute", compute, q_run, q_walk)
    pipe.stage("walk", walk, q_walk, q_done)

    t0 = time.perf_counter()
    last_end = 0
    try:
        with tracer.span("pipeline", "stream_consensus", windows=n,
                         depth=depth, chunk=chunk):
            try:
                with pipe:
                    for item in pipe.drain(q_done):
                        # The serial path's counter (consensus_windows):
                        # active windows, counted once applied.
                        record_windows(len(item.windows))
                        for _sid, s, e in tracker.retire(item.sid):
                            if tick is not None:
                                tick()
                            last_end = e
                            yield (s, e)
                    for _sid, s, e in tracker.flush():
                        if tick is not None:
                            tick()
                        last_end = e
                        yield (s, e)
            except StageError as err:
                if not isinstance(err.__cause__, PipelineStalled):
                    raise
                why = _stall_unrecoverable(err.__cause__, pipe, device)
                if why:
                    print(f"[racon_tpu_torch::pipeline] stall not "
                          f"recovered: {why}", file=engine.log)
                    raise
                # Stall recovery: the abort cascade tore the pipeline
                # down and every stage thread has exited, so in-flight
                # items are lost and nothing else touches the windows;
                # the host path gives the device path's bytes, so every
                # window past the last retired slice is polished there.
                active = []
                for w in windows[last_end:]:
                    if w.n_layers < 2:
                        w.set_backbone_consensus()
                    else:
                        active.append(w)
                if active:
                    with host_lock:
                        engine._degrade(active, err.__cause__)
                    record_windows(len(active))
                if last_end < n:
                    if tick is not None:
                        tick()
                    yield (last_end, n)
    finally:
        metrics.record_pipeline_wall(time.perf_counter() - t0)
        metrics.record_walk(meter.walk_s, meter.overlap_s, meter.dispatches,
                            meter.fused, q_walk.peak_depth, walk_async)
