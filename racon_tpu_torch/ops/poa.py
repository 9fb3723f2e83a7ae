"""Batched POA consensus engine — port of the JAX package's
``ops/poa.py::PoaEngine`` (device branch and host path).

Every layer is aligned to its window-relative backbone slice, votes merge
per column on the shared backbone coordinates, and refinement rounds
re-align against the previous round's consensus (see the JAX package's
module docstring for the full derivation).

Routes:

- the device engine (ops/device_poa.py): every round of every chunk on
  ``device`` — CUDA kernels on a GPU, their plain versions on the CPU —
  driven by the convergence scheduler (sched/) by default, or by the
  fixed-round engine in a depth-2 pipeline (``RACON_TPU_SCHED=0``);
- the wide-band device redo (ops/redo.py) for flagged windows;
- the host path (numpy merge + native C++ aligner) for jumbo windows,
  windows the redo cannot certify, and anchor overflow.

``PoaEngine._align`` (library entry, not on ``consensus_windows``'s
routes) aligns a round's jobs with the batched aligner (ops/align.py) on
``device``: K4 and T1 on a GPU, their plain versions on the CPU; with an
"sp" mesh axis, jobs past ``sp_cell_budget`` cells align through the
sequence-parallel NW (parallel/dispatch.py::sp_nw_align).

With a ``mesh`` (parallel/dispatch.py), the device engine shards every
chunk's lanes over the mesh's "dp" shards: each round runs K1, W1 and M1
on every shard's lanes, one cross-shard sum of the votes, and M2 on every
shard (ops/device_poa.py::_round_mesh), under both chunk drivers and in
the redo. The overlap alignment runs on the mesh's first device.

A chunk whose retry budget runs out on an injected fault, or at its
upload (resilience/retry.py, ``RetryExhausted.degradable``), polishes on
the host path instead (PoaEngine._degrade), as the reference's does. A
real deadline breach or out-of-memory where kernels run, and any other
device error — a kernel's error above all — raises: there is no quiet
fallback onto the host path.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from racon_tpu_torch.models.window import Window, window_arrays
from racon_tpu_torch.ops.budget import round_up
from racon_tpu_torch.ops.encode import decode_bases, ALPHABET
from racon_tpu_torch.ops.cigar import DIAG, UP, LEFT
from racon_tpu_torch.utils import env
from racon_tpu_torch.utils.device import resolve_device

# Tie-break epsilon, shared by the host (f64) and device (f32) merges.
_EPS = 1e-3


class _Job:
    """One layer-vs-backbone-slice alignment job."""
    __slots__ = ("win", "q", "w", "w_read", "t", "t_off", "ops")

    def __init__(self, win: int, q: np.ndarray, w: np.ndarray,
                 t: np.ndarray, t_off: int):
        self.win = win
        self.q = q
        self.w = w
        # float64 mean so the host and device engines agree exactly.
        self.w_read = float(w.astype(np.float64).mean()) if len(w) else 0.0
        self.t = t
        self.t_off = t_off
        self.ops: Optional[np.ndarray] = None

    @property
    def t_len(self) -> int:
        return len(self.t)


class _DeviceSlicePlan:
    """One consensus slice's device decomposition: balanced chunk groups
    sharing run-level caps, plus the windows that must take the host
    path."""
    __slots__ = ("groups", "host", "lq_cap", "la_cap", "band_cap",
                 "overflow_msg")

    def __init__(self, lq_cap: int, la_cap: int, band_cap: Optional[int]):
        self.groups: List[List[Window]] = []
        self.host: List[Window] = []
        self.lq_cap = lq_cap
        self.la_cap = la_cap
        self.band_cap = band_cap
        self.overflow_msg: Optional[str] = None


class PoaEngine:
    """Batched consensus over windows on ``device`` ("cuda" or "cpu"), or
    on a ``mesh`` (parallel/dispatch.Mesh) of that device type, whose
    first device then stands for ``device``."""

    def __init__(self, match: int = 5, mismatch: int = -4, gap: int = -8,
                 device="cuda", device_batch: int = 4096,
                 refine_rounds: int = 3, ins_scale: float = 0.2,
                 ins_scale_final: Optional[float] = 0.6, mesh=None,
                 log=None, threads: int = 1):
        if gap >= 0:
            raise ValueError(
                "[racon_tpu_torch::PoaEngine] error: gap penalty must be "
                "negative!")
        self.match, self.mismatch, self.gap = match, mismatch, gap
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            if mesh.devices[0].type != self.device.type:
                raise ValueError(
                    f"[racon_tpu_torch::PoaEngine] error: a mesh on "
                    f"{mesh.devices[0].type} for an engine on "
                    f"{self.device.type}")
            self.device = resolve_device(mesh.devices[0])
        # A job whose DP matrix exceeds one device's planes at the
        # minimum chunk routes to the sp aligner when the mesh has an
        # "sp" axis (_align). Overridable for tests.
        from racon_tpu_torch.ops.device_poa import MAX_DIR_ELEMS
        self.sp_cell_budget = MAX_DIR_ELEMS // 128
        self.device_batch = device_batch
        self.refine_rounds = refine_rounds
        self.ins_scale = ins_scale
        self.ins_scale_final = ins_scale_final
        self.log = log if log is not None else sys.stderr
        self.threads = threads
        # Optional dict: chunk counts, rounds executed, redo routing, and
        # the (B, Lq, Lt) of every batch _align_device runs.
        self.stats: Optional[dict] = None
        # The convergence scheduler's counters (sched/telemetry.py),
        # summed over a run's consensus_windows calls; None until the
        # scheduler runs.
        self.sched_telemetry = None
        self._native = None

    # ------------------------------------------------------------ public API

    def consensus_windows(self, windows: List[Window]) -> int:
        """Fill ``consensus`` for every window; returns #polished.

        Windows with fewer than backbone+2 sequences keep their backbone
        and stay unpolished (src/window.cpp:63-66).
        """
        active: List[Window] = []
        for w in windows:
            if w.n_layers < 2:
                w.set_backbone_consensus()
            else:
                active.append(w)
        if not active:
            return 0
        from racon_tpu_torch.obs.metrics import record_windows
        dev, host, lq_max, la_max = self._partition_device(active)
        n = 0
        if dev:
            n += self._consensus_device(dev, lq_max, la_max)
        if host:
            n += self._consensus_host(host)
        record_windows(n)
        return n

    def _count(self, key: str, n: int) -> None:
        if self.stats is not None:
            self.stats[key] = self.stats.get(key, 0) + n

    def _partition_device(self, windows: List[Window]):
        """Split windows into device-engine vs host-path sets: a window
        takes the host path when it alone overflows the chunk's element
        cap, or is a jumbo outlier (>4x the run's median layer/backbone
        length). Returns (dev, host, dev_lq_max, dev_la_max)."""
        from racon_tpu_torch.ops.device_poa import dir_elems, MAX_DIR_ELEMS
        lqs = np.array([max(len(d) for d in w.layer_data)
                        for w in windows])
        las = np.array([len(w.backbone) for w in windows])
        lq_lim = 4 * max(float(np.median(lqs)), 1.0)
        la_lim = 4 * max(float(np.median(las)), 1.0)
        dev, host = [], []
        lq_max = la_max = 1
        for w, lq, la in zip(windows, lqs, las):
            if (dir_elems(w.n_layers, int(lq), int(la)) > MAX_DIR_ELEMS
                    or lq > lq_lim or la > la_lim):
                host.append(w)
            else:
                dev.append(w)
                lq_max = max(lq_max, int(lq))
                la_max = max(la_max, int(la))
        return dev, host, lq_max, la_max

    def _plan_device_slice(self, active: List[Window], lq_max: int,
                           la_max: int) -> "_DeviceSlicePlan":
        """Decompose one slice of device windows into balanced chunk
        groups plus a host-fallback set (the reference's decomposition,
        so both engines pack the same chunks)."""
        from racon_tpu_torch.ops.device_poa import (run_caps, _bucket_b,
                                                    MAX_DIR_ELEMS)
        lq_cap, la_cap = run_caps(lq_max, la_max)
        w_run = self._run_band_width(active, la_cap)
        dirs_cols = la_cap if (env.band_disabled() or not w_run) else w_run
        jobs_cap = self.device_batch
        while jobs_cap > 128 and \
                _bucket_b(jobs_cap) * lq_cap * dirs_cols > MAX_DIR_ELEMS:
            jobs_cap //= 2
        sp = _DeviceSlicePlan(lq_cap, la_cap, w_run or None)
        if _bucket_b(jobs_cap) * lq_cap * dirs_cols > MAX_DIR_ELEMS:
            sp.host = list(active)
            sp.overflow_msg = (
                f"[racon_tpu_torch::PoaEngine] run geometry (Lq={lq_cap}, "
                f"LA={la_cap}) overflows the device index budget even "
                f"at the minimum chunk size; polishing {len(active)} "
                "window(s) on the host path")
            return sp
        sp.host = [w for w in active if w.n_layers > jobs_cap]
        if sp.host:
            active = [w for w in active if w.n_layers <= jobs_cap]
        # Balance jobs across the minimum number of chunks.
        total_jobs = sum(w.n_layers for w in active)
        n_chunks = max(1, -(-total_jobs // jobs_cap))
        target = -(-total_jobs // n_chunks)
        i = 0
        while i < len(active):
            ws: List[Window] = []
            jobs = 0
            while i < len(active) and \
                    (not ws or jobs + active[i].n_layers <= target):
                ws.append(active[i])
                jobs += active[i].n_layers
                i += 1
            sp.groups.append(ws)
        return sp

    def _make_chunk_plan(self, sp: "_DeviceSlicePlan", ws: List[Window]):
        """The ChunkPlan of one chunk group of a slice, at the slice's
        caps, its lanes a multiple of 128 a dp shard (timed as the host
        clock's ``plan`` part)."""
        from racon_tpu_torch.ops.device_poa import ChunkPlan, host_part
        with host_part("plan"):
            return ChunkPlan(ws, lq_cap=sp.lq_cap, la_cap=sp.la_cap,
                             n_shards=self._ndp(), band_cap=sp.band_cap)

    def _ndp(self) -> int:
        """The dp shards a chunk's lanes split over (1 without a mesh)."""
        return 1 if self.mesh is None else self.mesh.shape["dp"]

    def _consensus_host(self, active: List[Window]) -> int:
        """The host path for windows the device engine does not take
        (native aligner, numpy merge). The streaming pipeline calls it
        from its pack stage under one lock, which also covers the redo,
        since both use this engine's one native aligner."""
        self._count("host_windows", len(active))
        return self._consensus_host_impl(active)

    def _apply_group(self, ws: List[Window], codes, covs,
                     trunc: List[Window]) -> None:
        """Apply one collected chunk's consensus; flagged windows collect
        into ``trunc``."""
        for w, c, cv in zip(ws, codes, covs):
            if c is None:
                trunc.append(w)
                continue
            w.apply_consensus(
                decode_bases(np.frombuffer(c, dtype=np.uint8)), cv,
                log=self.log)

    def _redo_trunc(self, trunc: List[Window]) -> None:
        """Flagged windows (anchor overflow / escape failure / saturation)
        re-run through the wide-band device pass (ops/redo.py); what it
        cannot certify takes the host path. With ``RACON_TPU_REDO=0``
        every flagged window takes the host path."""
        if not trunc:
            return
        from racon_tpu_torch.obs.metrics import record_redo
        remaining = trunc
        if env.redo_enabled():
            from racon_tpu_torch.ops.redo import device_redo
            print(f"[racon_tpu_torch::PoaEngine] {len(trunc)} window(s) "
                  "flagged; re-polishing through the wide-band device pass",
                  file=self.log)
            resolved, remaining = device_redo(
                trunc, match=self.match, mismatch=self.mismatch,
                gap=self.gap,
                ins_scale=self._round_scales(self.refine_rounds + 1),
                rounds=self.refine_rounds + 1, device=self.device,
                mesh=self.mesh, jobs_cap=self.device_batch,
                stats=self.stats, on_exhausted=self._note_degraded)
            for w, c, cv in resolved:
                w.apply_consensus(
                    decode_bases(np.frombuffer(c, dtype=np.uint8)), cv,
                    log=self.log)
            self._count("redo_device_windows", len(resolved))
        record_redo(len(trunc) - len(remaining), len(remaining))
        if remaining:
            self._count("redo_host_windows", len(remaining))
            print(f"[racon_tpu_torch::PoaEngine] {len(remaining)} "
                  "window(s) unresolved by the wide-band pass; "
                  "re-polishing on the host path", file=self.log)
            self._consensus_host_impl(remaining)

    def _degrade(self, ws: List[Window], exc) -> None:
        """Last-resort degradation: a transfer or dispatch exhausted its
        retry budget (resilience/retry.py), so this chunk's windows polish
        on the host path instead of ending the run. The host path gives
        the device path's bytes, so the output does not change. A
        RetryExhausted that is not ``degradable`` (a real breach or
        out-of-memory where kernels run) is re-raised instead."""
        self._note_degraded(ws, exc)
        self._consensus_host(ws)

    def _note_degraded(self, ws: List[Window], exc) -> None:
        """The stderr line and ``res_degraded_*`` of a degradation, or the
        re-raise of an exhaustion that must end the run."""
        from racon_tpu_torch.obs.metrics import record_degraded
        from racon_tpu_torch.resilience.retry import RetryExhausted
        if isinstance(exc, RetryExhausted) and not exc.degradable:
            raise exc
        print(f"[racon_tpu_torch::PoaEngine] device path gave up at "
              f"{getattr(exc, 'site', '?')} after retries ({exc}); "
              f"polishing {len(ws)} window(s) on the host path",
              file=self.log)
        record_degraded(len(ws))

    def _make_scheduler(self):
        """A ConvergenceScheduler on this engine's device, wired to its
        run-long telemetry."""
        from racon_tpu_torch.sched import ConvergenceScheduler, SchedTelemetry
        rounds = self.refine_rounds + 1
        if self.sched_telemetry is None or \
                self.sched_telemetry.rounds != rounds:
            self.sched_telemetry = SchedTelemetry(rounds)
        return ConvergenceScheduler(
            match=self.match, mismatch=self.mismatch, gap=self.gap,
            scales=self._round_scales(rounds), device=self.device,
            telemetry=self.sched_telemetry, mesh=self.mesh)

    def _consensus_device(self, active: List[Window], lq_max: int,
                          la_max: int) -> int:
        """Device path: every refinement round of a chunk on ``device``,
        one h2d / one d2h a chunk (ops/device_poa.py). By default the
        convergence scheduler drives each chunk (sched/), with chunk
        i+1's h2d started before chunk i's rounds; ``RACON_TPU_SCHED=0``
        runs the fixed-round engine in a depth-2 pipeline instead."""
        from racon_tpu_torch.ops.device_poa import (collect_chunk,
                                                    dispatch_chunk, host_part)
        sp = self._plan_device_slice(active, lq_max, la_max)
        if sp.overflow_msg:
            print(sp.overflow_msg, file=self.log)
            return self._consensus_host(sp.host)
        n_wide = 0
        if sp.host:
            n_wide = self._consensus_host(sp.host)
        trunc: List[Window] = []
        rounds = self.refine_rounds + 1
        groups = sp.groups

        from racon_tpu_torch.obs.trace import get_tracer
        from racon_tpu_torch.resilience.retry import RetryExhausted
        tracer = get_tracer()

        # A chunk's plan and its result's apply are ``dispatch`` spans
        # (poa_plan, poa_apply) beside its ``chunk`` span, so a trace
        # names the host work between the chunks' rounds.
        def apply(ws, codes, covs) -> None:
            with host_part("apply"), tracer.span(
                    "dispatch", "poa_apply", windows=len(ws)):
                self._apply_group(ws, codes, covs, trunc)

        if env.sched_enabled():
            # The next chunk is planned and its h2d started before this
            # chunk's rounds run (the reference's order).
            sched = self._make_scheduler()

            def prefetch(ws: List[Window]):
                with tracer.span("dispatch", "poa_plan",
                                 windows=len(ws)) as span:
                    plan = self._make_chunk_plan(sp, ws)
                    span.add(lanes=plan.B, jobs=plan.n_jobs)
                    try:
                        return plan, sched.put_chunk(plan)
                    except RetryExhausted as exc:
                        err = exc
                self._degrade(ws, err)      # after the span: host work
                return None

            nxt = prefetch(groups[0]) if groups else None
            for k, ws in enumerate(groups):
                cur = nxt
                nxt = prefetch(groups[k + 1]) if k + 1 < len(groups) \
                    else None
                if cur is None:
                    continue            # degraded at its prefetch
                plan, bufs = cur
                try:
                    with tracer.span("chunk", f"chunk{k}", windows=len(ws),
                                     lanes=plan.B, jobs=plan.n_jobs):
                        codes, covs = sched.run_chunk(plan, bufs=bufs,
                                                      stats=self.stats)
                except RetryExhausted as exc:
                    self._degrade(ws, exc)
                    continue
                apply(ws, codes, covs)
        else:
            # Fixed rounds: chunk i+1's h2d and rounds go out while chunk
            # i still computes (depth 2 bounds the chunks in flight);
            # stats collection runs the chunks one at a time.
            depth = 0 if self.stats is not None else 2
            pending: list = []

            def finish(entry) -> None:
                # Chunks overlap, so a chunk's span is emitted when it is
                # collected, from its dispatch's start: siblings, not a
                # false nesting.
                ws, plan, packed, k, t_disp = entry
                try:
                    codes, covs = collect_chunk(plan, packed,
                                                stats=self.stats)
                except RetryExhausted as exc:
                    self._degrade(ws, exc)
                    return
                tracer.emit("chunk", f"chunk{k}", t_disp,
                            time.perf_counter() - t_disp, windows=len(ws),
                            lanes=plan.B, jobs=plan.n_jobs)
                apply(ws, codes, covs)

            for k, ws in enumerate(groups):
                t_disp = time.perf_counter()
                plan = self._make_chunk_plan(sp, ws)
                try:
                    packed = dispatch_chunk(
                        plan, match=self.match, mismatch=self.mismatch,
                        gap=self.gap, ins_scale=self._round_scales(rounds),
                        rounds=rounds, device=self.device, stats=self.stats,
                        mesh=self.mesh)
                except RetryExhausted as exc:
                    self._degrade(ws, exc)
                    continue
                pending.append((ws, plan, packed, k, t_disp))
                if len(pending) > depth:
                    finish(pending.pop(0))
            for entry in pending:
                finish(entry)
        self._redo_trunc(trunc)
        return sum(len(g) for g in groups) + n_wide

    @staticmethod
    def _run_band_width(active: List[Window], la_cap: int) -> int:
        """Run-level band width (0 when banding will not engage)."""
        from racon_tpu_torch.ops.device_poa import (window_band_delta,
                                                    band_width_for)
        W = band_width_for(max((window_band_delta(w) for w in active),
                               default=0))
        return W if W + 128 <= la_cap else 0

    def _consensus_host_impl(self, active: List[Window]) -> int:
        # Per-window state: current anchor (codes, weights) and layer maps
        # from original window coordinates into the current anchor.
        layers: List[List[Tuple[np.ndarray, np.ndarray, int, int]]] = []
        anchors: List[Tuple[np.ndarray, np.ndarray]] = []
        spans: List[List[Tuple[int, int]]] = []
        for w in active:
            lays, bb, bb_w = window_arrays(w)
            layers.append([(codes, wts) for codes, wts, _, _ in lays])
            spans.append([(b, e) for _, _, b, e in lays])
            anchors.append((bb, bb_w))

        results = None
        scales = self._round_scales(self.refine_rounds + 1)
        for r in range(self.refine_rounds + 1):
            jobs: List[_Job] = []
            for wi in range(len(active)):
                jobs.extend(self._build_jobs(wi, anchors[wi][0],
                                             layers[wi], spans[wi]))
            # The host path aligns on the native aligner, as the
            # reference's force_native host path does; with an "sp" mesh
            # axis, over-budget jobs take the sp aligner as the
            # reference's _align routes them.
            self._align_host(jobs)
            results = self._merge_round(anchors, jobs, scales[r])
            # Next round anchors: the fresh consensus with neutral weights
            # (reads re-vote from scratch); spans mapped through the merge.
            new_anchors = []
            new_spans = []
            for wi, (cons, cov, map_b, map_e) in enumerate(results):
                new_anchors.append(
                    (cons, np.zeros(len(cons), dtype=np.float32)))
                sp = []
                for (b, e) in spans[wi]:
                    nb = int(map_b[b]) if b < len(map_b) else 0
                    ne = int(map_e[e]) if e < len(map_e) else len(cons) - 1
                    sp.append((nb, ne))
                new_spans.append(sp)
            anchors = new_anchors
            spans = new_spans

        for w, (cons, cov, _, _) in zip(active, results):
            w.apply_consensus(decode_bases(cons), cov, log=self.log)
        return len(active)

    # ------------------------------------------------------------- job build

    def _build_jobs(self, wi: int, bb: np.ndarray,
                    lst: List[Tuple[np.ndarray, np.ndarray]],
                    sp: List[Tuple[int, int]]) -> List[_Job]:
        L = len(bb)
        offset = int(0.01 * L)  # reference truncates to uint32
        jobs = []
        for (codes, wts), (begin, end) in zip(lst, sp):
            begin = max(0, min(begin, L - 1))
            end = max(begin, min(end, L - 1))
            # Full-span layers align to the whole backbone, partial layers
            # to the [begin, end] slice (src/window.cpp:82-98: uint32
            # offset = 0.01 * L, strict `end > L - offset`).
            if begin < offset and end > L - offset:
                jobs.append(_Job(wi, codes, wts, bb, 0))
            else:
                jobs.append(_Job(wi, codes, wts, bb[begin:end + 1], begin))
        return jobs

    # ------------------------------------------------------------- alignment

    def _align(self, jobs: List[_Job]) -> None:
        """Set every job's ops with the batched aligner on ``device``. With
        an "sp" mesh axis, jobs whose DP matrix exceeds ``sp_cell_budget``
        align through the sequence-parallel NW (:meth:`_align_sp`)."""
        jobs = self._route_sp(jobs)
        if jobs:
            self._align_device(jobs)

    def _align_host(self, jobs: List[_Job]) -> None:
        """The host path's aligner: the native one, after the sp route."""
        jobs = self._route_sp(jobs)
        if jobs:
            self._align_native(jobs)

    def _route_sp(self, jobs: List[_Job]) -> List[_Job]:
        """Align the over-budget jobs through the sp aligner when the mesh
        has an "sp" axis; returns the jobs left."""
        if jobs and self.mesh is not None and \
                "sp" in self.mesh.axis_names:
            sp_jobs = [j for j in jobs
                       if len(j.q) * j.t_len > self.sp_cell_budget]
            if sp_jobs:
                self._align_sp(sp_jobs)
                jobs = [j for j in jobs if j.ops is None]
        return jobs

    def _align_sp(self, jobs: List[_Job]) -> None:
        """Sequence-parallel alignment for over-budget jobs
        (parallel/dispatch.py::sp_nw_align)."""
        from racon_tpu_torch.parallel.dispatch import sp_nw_align
        q, t, lq, lt = self._pack_jobs(jobs, len(jobs))
        ops, n = sp_nw_align(self.mesh, q, t, lq, lt, match=self.match,
                             mismatch=self.mismatch, gap=self.gap)
        W = ops.shape[1]
        for b, j in enumerate(jobs):
            j.ops = ops[b, W - int(n[b]):]

    @staticmethod
    def _pack_jobs(jobs: List[_Job], B: int):
        """Pad a job list into dense (q, t, lq, lt) batch arrays; rows past
        the jobs are length-1 dummies."""
        Lq = round_up(max(len(j.q) for j in jobs), 128)
        Lt = round_up(max(j.t_len for j in jobs), 128)
        q = np.zeros((B, Lq), np.uint8)
        t = np.zeros((B, Lt), np.uint8)
        lq = np.ones(B, np.int32)
        lt = np.ones(B, np.int32)
        for b, j in enumerate(jobs):
            lq[b] = len(j.q)
            lt[b] = j.t_len
            q[b, :lq[b]] = j.q
            t[b, :lt[b]] = j.t
        return q, t, lq, lt

    def _align_device(self, jobs: List[_Job]) -> None:
        """The reference's ``_align_jax`` on ``device``: jobs bucketed by
        (target, query) length so one long target does not pad a whole
        batch, batches of at most ``device_batch`` jobs padded onto the
        coarse B grid (512, then multiples of 1024), one
        ``align.nw_align_auto`` call a batch."""
        import torch
        from racon_tpu_torch.ops.align import nw_align_auto
        order = np.lexsort((np.asarray([len(j.q) for j in jobs]),
                            np.asarray([j.t_len for j in jobs])))
        bs = self.device_batch
        for s in range(0, len(order), bs):
            chunk = [jobs[i] for i in order[s:s + bs]]
            B = 512 if len(chunk) <= 512 else round_up(len(chunk), 1024)
            q, t, lq, lt = (torch.from_numpy(a).to(self.device)
                            for a in self._pack_jobs(chunk, B))
            ops, n = nw_align_auto(q, t, lq, lt, match=self.match,
                                   mismatch=self.mismatch, gap=self.gap)
            if self.stats is not None:
                self.stats.setdefault("align_shapes", []).append(
                    (B, q.shape[1], t.shape[1]))
            ops = ops.cpu().numpy()
            n = n.cpu().numpy()
            W = ops.shape[1]
            for b, j in enumerate(chunk):
                j.ops = ops[b, W - int(n[b]):]

    def _align_native(self, jobs: List[_Job]) -> None:
        if not jobs:
            return
        from racon_tpu_torch.native.aligner import NativeAligner
        if self._native is None:
            self._native = NativeAligner(self.match, self.mismatch,
                                         self.gap, threads=self.threads)
        pairs = [(j.q, j.t) for j in jobs]
        for j, ops in zip(jobs, self._native.align_batch(pairs)):
            j.ops = ops

    # ----------------------------------------------------------------- merge

    def _round_scales(self, rounds: int) -> Tuple[float, ...]:
        """Per-round insertion-vote scales (see ins_scale_final)."""
        base = self.ins_scale
        last = self.ins_scale_final if self.ins_scale_final is not None \
            else base
        return tuple([base] * (rounds - 1) + [last])

    def _merge_round(self, anchors: List[Tuple[np.ndarray, np.ndarray]],
                     jobs: List[_Job], scale: Optional[float] = None
                     ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     np.ndarray]]:
        """Column-merge every aligned job of a round, all windows at once.

        All scatter work runs as flat numpy adds over concatenated
        per-window column/gap arrays (one ``np.add.at`` per vote class for
        the whole round, instead of per-job Python loops) — the host-side
        analogue of the device batching. Only multi-base insertion runs
        (rare) take a Python path.

        Returns per window (consensus_codes, coverage, map_b, map_e);
        map_b[p] / map_e[p] give, for every anchor position p, the
        consensus index of the first kept column >= p / last kept column
        <= p — the coordinate maps refinement rounds use to re-slice
        layer spans.
        """
        n_win = len(anchors)
        Ls = np.array([len(bb) for bb, _ in anchors], dtype=np.int64)
        col_off = np.concatenate([[0], np.cumsum(Ls)])
        gap_off = np.concatenate([[0], np.cumsum(Ls + 1)])
        total_c = int(col_off[-1])
        total_g = int(gap_off[-1])

        base_w = np.zeros(total_c * ALPHABET, dtype=np.float64)
        base_c = np.zeros(total_c * ALPHABET, dtype=np.int64)
        del_w = np.zeros(total_c, dtype=np.float64)
        # Gap g of window w = insertion point before column g (g in 0..L).
        direct_w = np.zeros(total_g, dtype=np.float64)
        ins1_w = np.zeros(total_g * ALPHABET, dtype=np.float64)
        ins1_c = np.zeros(total_g * ALPHABET, dtype=np.int64)
        ins1_stop = np.zeros(total_g, dtype=np.float64)
        piles: Dict[int, _InsPileup] = {}  # gaps with multi-base runs

        # Backbone votes (sequence 0, src/window.cpp:34-37): epsilon keeps
        # the backbone base winning argmax ties at zero read coverage.
        bb_flat = np.concatenate([bb for bb, _ in anchors])
        bbw_flat = np.concatenate([w for _, w in anchors])
        np.add.at(base_w, np.arange(total_c) * ALPHABET + bb_flat,
                  bbw_flat + _EPS)
        np.add.at(base_c, np.arange(total_c) * ALPHABET + bb_flat, 1)
        for wi, (bb, bw) in enumerate(anchors):
            cross = (np.concatenate([[bw[0]], bw]) +
                     np.concatenate([bw, [bw[-1]]])) * 0.5
            direct_w[gap_off[wi]:gap_off[wi + 1]] += cross + _EPS

        if jobs:
            self._scatter_jobs(jobs, col_off, gap_off, base_w, base_c,
                               del_w, direct_w, ins1_w, ins1_c, ins1_stop,
                               piles)

        # Column votes, flat across all windows.
        base_w2 = base_w.reshape(total_c, ALPHABET)
        best_code = np.argmax(base_w2, axis=1)
        ar_c = np.arange(total_c)
        best_w = base_w2[ar_c, best_code]
        kept_flat = del_w <= best_w
        cov_flat = base_c.reshape(total_c, ALPHABET)[ar_c, best_code]

        # Single-base insertion winners, flat across all gaps; gaps with
        # multi-base runs are re-decided through their pileups below.
        ins1_w2 = ins1_w.reshape(total_g, ALPHABET)
        g_tot = ins1_w2.sum(axis=1)
        g_arg = np.argmax(ins1_w2, axis=1)
        if scale is None:
            scale = self.ins_scale
        emit1 = g_tot > direct_w * scale

        # Hand each window only its own piles (sorted keys + searchsorted,
        # instead of scanning the round-global dict per window).
        pile_keys = np.array(sorted(piles.keys()), dtype=np.int64)
        pile_bounds = np.searchsorted(pile_keys, gap_off)

        results = []
        for wi in range(n_win):
            c0, c1 = int(col_off[wi]), int(col_off[wi + 1])
            g0, g1 = int(gap_off[wi]), int(gap_off[wi + 1])
            L = c1 - c0
            kept = kept_flat[c0:c1]
            codes = best_code[c0:c1]
            cov = cov_flat[c0:c1]

            ins_events: List[Tuple[int, np.ndarray, np.ndarray]] = []
            for g in np.flatnonzero(emit1[g0:g1]):
                gg = g0 + int(g)
                if gg in piles:
                    continue  # full pileup decides below
                ins_events.append((
                    int(g),
                    np.array([g_arg[gg]], dtype=np.uint8),
                    np.array([ins1_c.reshape(total_g, ALPHABET)
                              [gg, g_arg[gg]]], dtype=np.int64)))
            for gg in pile_keys[pile_bounds[wi]:pile_bounds[wi + 1]]:
                gg = int(gg)
                pile = piles[gg]
                seq, cnt = pile.consensus(
                    float(direct_w[gg]) * scale,
                    ins1_w2[gg], ins1_c.reshape(total_g, ALPHABET)[gg],
                    float(ins1_stop[gg]))
                if len(seq):
                    ins_events.append((gg - g0, seq, cnt))
            ins_events.sort(key=lambda e: e[0])

            # Assemble consensus + per-base coverage.
            ins_len_at = np.zeros(L + 1, dtype=np.int64)
            parts: List[np.ndarray] = []
            covs: List[np.ndarray] = []
            last = 0
            for g, seq, cnt in ins_events:
                ins_len_at[g] = len(seq)
                sel = kept[last:g]
                parts.append(codes[last:g][sel])
                covs.append(cov[last:g][sel])
                parts.append(seq)
                covs.append(cnt)
                last = g
            sel = kept[last:]
            parts.append(codes[last:][sel])
            covs.append(cov[last:][sel])
            consensus = np.concatenate(parts).astype(np.uint8)
            coverage = np.concatenate(covs).astype(np.int32)

            # Coordinate maps anchor->consensus for refinement re-slicing.
            kept_excl = np.cumsum(kept) - kept      # kept columns before p
            ins_before = np.cumsum(ins_len_at)[:L]  # inserted bases, g<=p
            new_col = kept_excl + ins_before        # index where p landed
            kept_idx = np.flatnonzero(kept)
            ar = np.arange(L)
            if len(kept_idx) == 0:
                map_b = np.zeros(L, dtype=np.int64)
                map_e = np.zeros(L, dtype=np.int64)
            else:
                nb = np.searchsorted(kept_idx, ar, side="left")
                map_b = new_col[kept_idx[np.minimum(nb, len(kept_idx) - 1)]]
                ne = np.searchsorted(kept_idx, ar, side="right") - 1
                map_e = new_col[kept_idx[np.maximum(ne, 0)]]
            np.clip(map_b, 0, max(len(consensus) - 1, 0), out=map_b)
            np.clip(map_e, 0, max(len(consensus) - 1, 0), out=map_e)
            results.append((consensus, coverage, map_b, map_e))
        return results

    def _scatter_jobs(self, jobs, col_off, gap_off, base_w, base_c, del_w,
                      direct_w, ins1_w, ins1_c, ins1_stop, piles) -> None:
        """Flat scatter of every job's votes into the round accumulators."""
        lens = np.array([len(j.ops) for j in jobs], dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        o = np.concatenate([j.ops for j in jobs])
        q_flat = np.concatenate([j.q for j in jobs])
        w_flat = np.concatenate([j.w for j in jobs]).astype(np.float64)
        q_lens = np.array([len(j.q) for j in jobs], dtype=np.int64)
        q_offs = np.concatenate([[0], np.cumsum(q_lens)[:-1]])

        jid = np.repeat(np.arange(len(jobs)), lens)
        w_read = np.repeat(np.array([j.w_read for j in jobs]), lens)
        # Global column of each op's target position: window column offset
        # + slice offset + within-slice t index (segmented cumsum).
        wins = np.array([j.win for j in jobs], dtype=np.int64)
        t_base = np.repeat(col_off[wins] + [j.t_off for j in jobs], lens)
        g_base = np.repeat(gap_off[wins] + [j.t_off for j in jobs], lens)

        cq = o != LEFT
        ct = o != UP
        c_cq = np.cumsum(cq)
        c_ct = np.cumsum(ct)
        pre_q = c_cq - cq
        pre_t = c_ct - ct
        qpos = pre_q - np.repeat(pre_q[starts], lens)  # q index within job
        tpos = pre_t - np.repeat(pre_t[starts], lens)  # t index within slice
        gq = np.minimum(q_offs[jid] + qpos, q_offs[jid] + q_lens[jid] - 1)
        gcol = t_base + tpos
        ggap = g_base + tpos

        m = o == DIAG
        np.add.at(base_w, gcol[m] * ALPHABET + q_flat[gq[m]], w_flat[gq[m]])
        np.add.at(base_c, gcol[m] * ALPHABET + q_flat[gq[m]], 1)

        d = o == LEFT
        if d.any():
            np.add.at(del_w, gcol[d], w_read[d])

        # Direct crossings, weighted by the *local* flanking base
        # qualities: inserted/uncertain bases carry low Phred scores in
        # long reads, so a gap's "no insertion here" evidence is judged
        # against quality in the same neighbourhood, not the read mean.
        t_idx = np.flatnonzero(ct)
        if len(t_idx) > 1:
            wq = np.where(m, w_flat[gq], w_read)
            same = jid[t_idx[1:]] == jid[t_idx[:-1]]
            adj = (np.diff(t_idx) == 1) & same  # no I ops between
            g_cross = ggap[t_idx[1:]][adj]
            w_cross = 0.5 * (wq[t_idx[:-1]][adj] + wq[t_idx[1:]][adj])
            np.add.at(direct_w, g_cross, w_cross)

        i_mask = o == UP
        if not i_mask.any():
            return
        flat = np.flatnonzero(i_mask)
        brk = (np.diff(flat) > 1) | (jid[flat[1:]] != jid[flat[:-1]])
        run_s = flat[np.concatenate([[True], brk])]
        run_e = flat[np.concatenate([brk, [True]])]
        run_len = run_e - run_s + 1
        one = run_len == 1
        # Single-base runs (the vast majority): fully vectorized.
        s1 = run_s[one]
        g1 = ggap[s1]
        b1 = q_flat[gq[s1]]
        w1 = w_flat[gq[s1]]
        np.add.at(ins1_w, g1 * ALPHABET + b1, w1)
        np.add.at(ins1_c, g1 * ALPHABET + b1, 1)
        np.add.at(ins1_stop, g1, w1)
        # Multi-base runs: per-run pileups (Python path, rare).
        for s, e in zip(run_s[~one], run_e[~one]):
            g = int(ggap[s])
            qs, qe = int(gq[s]), int(gq[e])
            pile = piles.get(g)
            if pile is None:
                pile = piles[g] = _InsPileup()
            pile.add(q_flat[qs:qe + 1], w_flat[qs:qe + 1])


class _InsPileup:
    """Left-justified pileup of inserted segments at one backbone gap.

    Columns are voted independently; emission continues while the weight
    of reads still extending the insertion beats the weight of reads that
    stopped (direct crossings + shorter insertions) — the column-local
    heaviest-path criterion.
    """
    __slots__ = ("col_w", "col_c", "len_w")

    def __init__(self):
        self.col_w: List[np.ndarray] = []
        self.col_c: List[np.ndarray] = []
        self.len_w: Dict[int, float] = {}

    def add(self, seg: np.ndarray, w: np.ndarray) -> None:
        for k in range(len(seg)):
            if k == len(self.col_w):
                self.col_w.append(np.zeros(ALPHABET, dtype=np.float64))
                self.col_c.append(np.zeros(ALPHABET, dtype=np.int32))
            self.col_w[k][seg[k]] += w[k]
            self.col_c[k][seg[k]] += 1
        self.len_w[len(seg)] = self.len_w.get(len(seg), 0.0) + \
            float(w.astype(np.float64).mean())

    def consensus(self, direct: float, extra0_w=None, extra0_c=None,
                  extra_stop1: float = 0.0
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Vote out the insertion columns.

        extra0_w/extra0_c fold in single-base runs at the same gap that
        were accumulated in the round's flat arrays; their weight joins
        the stopped side after column 0 (extra_stop1).
        """
        out: List[int] = []
        cnt: List[int] = []
        stopped = float(direct)
        for k in range(len(self.col_w)):
            cw = self.col_w[k]
            cc = self.col_c[k]
            if k == 0 and extra0_w is not None:
                cw = cw + extra0_w
                cc = cc + extra0_c
            if cw.sum() <= stopped:
                break
            b = int(np.argmax(cw))
            out.append(b)
            cnt.append(int(cc[b]))
            stopped += self.len_w.get(k + 1, 0.0)
            if k == 0:
                stopped += extra_stop1
        return (np.asarray(out, dtype=np.uint8),
                np.asarray(cnt, dtype=np.int32))
