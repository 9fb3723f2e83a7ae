"""Device overlap alignment: PAF/MHAP breaking points on the GPU.

Port of the JAX package's ``ops/ovl_align.py``. The reference racon
aligns every CIGAR-less overlap with edlib on a CPU thread pool and walks
the CIGAR base by base for per-window breaking points
(src/polisher.cpp:351-364, src/overlap.cpp:179-282). Here overlaps batch
through the same banded NW forward as window consensus, the column walk
yields the consuming op and query index per target column, and the
breaking points fall out as per-window first/last-match reductions over
that column grid: no CIGAR is built, and only [B, NW] rows leave the card.

Two routes, by length (admission rules of ops/budget.py, the reference's):

- untiled: 128-lane chunks of whole reads through the banded forward
  (K1, csrc/band_fwd.cu ``racon_band_fwd``);
- tiled: reads too long for that run as T-row query tiles of the
  frontier-carrying forward (K3, ``racon_band_tile_fwd``), with the band
  re-centered between tiles, a staircase escape certificate over the
  running band clearance of the tiles that hold the lane's rows, and one
  stitched column walk.

The admission rules size a chunk (its lanes, W, T and walk depth are the
reference's); the group planner (:func:`plan_groups`) sizes a launch.
Consecutive chunks of one bucket share their geometry ((Lq, LA, W, k),
and T on the tiled route), so a group of them runs as one chunk over
their concatenated lanes: on the untiled route one K1 launch and one
walk, on the tiled route one K3 launch per tile, one re-centering pass
and one walk. A group holds as many chunks as fill one wave of the card
(:func:`group_size`, from the occupancy of the route's kernel) under a
ceiling on the group's planes. Lanes never interact, so each chunk's
rows are what it gives alone.

Both walks run on the CUDA column walk (W1, csrc/col_walk.cu). A lane
whose band optimality is not certified (its edit distance passes what its
band's clearance proves), or whose walk saturated, goes back to the
caller for the host aligner, as do jobs no route admits.
"""

from __future__ import annotations

import sys
import contextlib
import threading
import time
from typing import List

import numpy as np
import torch

from racon_tpu_torch.obs.metrics import record_ovl
from racon_tpu_torch.obs.trace import get_tracer
from racon_tpu_torch.ops import kernels
from racon_tpu_torch.ops.band import (band_geometry, band_targets,
                                      row0_scores, uc_boundary)
from racon_tpu_torch.ops.budget import (GROUP_MEM_FRACTION, VMEM_BUDGET,
                                        max_dir_elems, round_up, tile_plan,
                                        vmem_est, walk_k_for)
from racon_tpu_torch.ops.cigar import DIAG
from racon_tpu_torch.ops.encode import encode_bases
from racon_tpu_torch.ops.flat import NEG
from racon_tpu_torch.utils import env

TB = 128                      # lanes of an untiled chunk
MAX_DIR_ELEMS = max_dir_elems(1)
HUGE = 2 ** 30

# One record a bucket since the last reset_stats(), a list for each
# route: its chunk geometry, chunks, chunks a group (G) and groups. The
# jobs each route took and the tile launches are the registry's
# ``ovl_*`` counters (obs/metrics.record_ovl).
TILED_GROUPS: List[dict] = []
UNTILED_GROUPS: List[dict] = []
# The two above are updated under this lock: the daemon aligns several
# jobs' overlaps at once, one thread a job (server/daemon.py).
_STATS_LOCK = threading.Lock()
# One job's card section (its groups' planes, launches and collects) at a
# time, a lock a device: each sizes its groups to GROUP_MEM_FRACTION of
# the card, so concurrent jobs must not hold their planes together (an
# out-of-memory where kernels run ends the run).
_CARD_LOCKS = {}


def reset_stats() -> None:
    with _STATS_LOCK:
        TILED_GROUPS.clear()
        UNTILED_GROUPS.clear()


def tiled_groups() -> int:
    """Launch groups of the tiled route since the last reset_stats():
    one walk (W1) each."""
    with _STATS_LOCK:
        return sum(g["groups"] for g in TILED_GROUPS)


def untiled_groups() -> int:
    """Launch groups of the untiled route since the last reset_stats():
    one band forward (K1) each."""
    with _STATS_LOCK:
        return sum(g["groups"] for g in UNTILED_GROUPS)


def _card_lock(device: torch.device):
    """The card section's lock for ``device`` (no lock on the CPU)."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    key = torch.device(device.type, device.index if device.index
                       is not None else torch.cuda.current_device())
    with _STATS_LOCK:
        return _CARD_LOCKS.setdefault(key, threading.Lock())


def band_width_for_read(lq: int, lt: int) -> int:
    """Band width that certifies noisy long-read alignments at
    edit-distance scoring: half-width ~ L/13 plus slack, |lt - lq| on
    top. Under-banding is safe (the certificate fails and the host
    aligner takes the job)."""
    return round_up(abs(lt - lq) + 2 * (max(lq, lt) // 13 + 64) + 1, 128)


def untiled_admits(lq: int, lt: int) -> bool:
    """The untiled route's admission: a 128-lane chunk of this job's
    padded geometry fits the cell-plane cap and the reference's VMEM
    model, and its query indices fit the int16 walk emissions."""
    W = round_up(band_width_for_read(lq, lt), 512)
    lqp = round_up(lq, 2048)
    return (TB * lqp * W <= MAX_DIR_ELEMS and
            vmem_est(W, lqp, 4) <= VMEM_BUDGET and max(lq, lt) < 2 ** 14)


def untiled_walk_k(Lq: int, W: int) -> int:
    """Walk depth of a 128-lane untiled chunk at (Lq, W): the requested
    depth, down to 2 where the u16 nxt2 plane breaks the element cap or
    the reference's VMEM model."""
    nxt_k = walk_k_for(TB * Lq * W)
    if nxt_k >= 4 and vmem_est(W, Lq, 4, 4) > VMEM_BUDGET:
        nxt_k = 2
    return nxt_k


def _window_rows(op, qi, lt, t_begin, *, w_len: int, NW: int, LA: int):
    """Per-window first/last match column and their query indices from
    the walk's per-column consumer op / query index [B, LA]."""
    B = op.shape[0]
    dev = op.device
    i32 = torch.int32
    c = torch.arange(LA, dtype=i32, device=dev)[None, :]
    is_m = (c < lt[:, None]) & (op == DIAG)
    widx = (torch.div(t_begin[:, None] + c, w_len, rounding_mode="floor") -
            torch.div(t_begin, w_len, rounding_mode="floor")[:, None])
    wc = torch.clamp(widx, 0, NW - 1).long()
    first_c = torch.full((B, NW), HUGE, dtype=i32, device=dev).scatter_reduce(
        1, wc, torch.where(is_m, c, HUGE).to(i32), reduce="amin")
    last_c = torch.full((B, NW), -1, dtype=i32, device=dev).scatter_reduce(
        1, wc, torch.where(is_m, c, -1).to(i32), reduce="amax")
    valid = last_c >= 0
    qi_f = torch.gather(qi, 1, torch.clamp(first_c, 0, LA - 1).long())
    qi_l = torch.gather(qi, 1, torch.clamp(last_c, 0, LA - 1).long())
    return first_c, qi_f, last_c, qi_l, valid


def _chunk_breaking_points(q, t, lq, lt, t_begin, *, match, mismatch, gap,
                           W, w_len, NW, Lq, LA, nxt_k=2):
    """One untiled chunk: banded forward + column walk + per-window
    reduction, on the device of ``q``.

    q u8[B, Lq], t u8[B, LA], lq/lt/t_begin int32[B]. Returns (first_c,
    qi_f, last_c, qi_l — int32[B, NW], column/query indices relative to
    each lane's slice —, valid bool[B, NW], fail f32[B] nonzero where the
    lane needs the host aligner).
    """
    B = q.shape[0]
    klo, wl = band_geometry(lq, lt, W)
    base = torch.arange(B, dtype=torch.int64, device=q.device) * LA
    tband = band_targets(t.reshape(-1), base, klo, lt, W + Lq)
    cells, nxt, nxt2, hlast = kernels.fw_dirs_band(
        tband, q.t().contiguous(), klo, lq, match=match, mismatch=mismatch,
        gap=gap, W=W, nxt_k=4 if nxt_k >= 4 else 2)
    cols = kernels.col_walk_kernel(cells, lq, lt, klo, torch.zeros_like(lq),
                                   LA=LA, layout="band", nxt=nxt, nxt2=nxt2)
    del cells, nxt, nxt2

    # Tightened escape bound (as in device_poa._lane_fwd).
    xend = torch.clamp(lt - lq - klo, 0, W - 1).long()
    score = torch.gather(hlast, 1, xend[:, None])[:, 0]
    bound = (max(match, 0) * (torch.minimum(lq, lt) - wl - 1) +
             gap * ((lt - lq).abs() + 2 * wl + 2))
    fail = (((score < bound) | (wl < 16)).to(torch.float32) +
            cols["sat"].to(torch.float32))
    op = cols["op_c"][:, 1:LA + 1].to(torch.int32)
    qi = cols["qi_c"][:, 1:LA + 1].to(torch.int32)
    return _window_rows(op, qi, lt, t_begin, w_len=w_len, NW=NW,
                        LA=LA) + (fail,)


def tiled_origin(lq, lt, W: int):
    """The tiled route's first band origin and the legal origin interval
    [klo_lo, klo_hi] that keeps (0, 0) and (lq, lt) in band (int32[B]
    each): ``(klo0, klo_lo, klo_hi)``."""
    delta = lt - lq
    klo_lo = torch.clamp(delta, min=0) - (W - 1)
    klo_hi = torch.clamp(delta, max=0)
    wl = torch.div(W - 1 - delta.abs(), 2, rounding_mode="floor")
    klo = torch.minimum(torch.maximum(klo_hi - wl, klo_lo), klo_hi)
    return klo, klo_lo, klo_hi


def _tiled_chunk_breaking_points(q, t, lq, lt, t_begin, *, match, mismatch,
                                 gap, W, w_len, NW, Lq, LA, T, nxt_k=2):
    """One tiled chunk: the band forward over Lq // T query tiles with the
    frontier carried on the device, then one stitched column walk.

    Per tile: the tile's targets are gathered at the current band origin
    klo; K3 computes rows i0+1 .. i0+T into rows [i0, i0+T) of the
    stitched planes; the running band clearance ``cmin`` is updated; and
    klo re-centers on the frontier argmax with a W/4..3W/4 dead zone,
    clamped to [max(0, d) - W + 1, min(0, d)] (d = lt - lq) so both DP
    corners stay in band. The frontier shifts with klo (score fill NEG,
    metadata fill the boundary word, hlast fill NEG).

    Staircase escape certificate: a path leaving the tiled band crosses a
    band edge with clearance at least cmin, so

        score >= max(m,0)*(min(lq,lt) - cmin - 1)
                 + gap*(|lt - lq| + 2*cmin + 2)

    certifies banded == global; without re-centering cmin == wl and this
    is the untiled bound. A lane's cmin covers only the tiles that hold
    its rows (i0 < lq): its paths lie in rows 0..lq, so a path leaving
    its band crosses an edge of one of those tiles and still pays
    |lt - lq| + 2*cmin + 2 gaps, and the walk reads klos only up to the
    tile that holds row lq. The tiles a longer lane of the chunk adds
    past them hold none of its rows; there the padding rows cost an edit
    a cell, the frontier's maximum spreads into a plateau, and the
    first-maximum re-centering walks klo to the clamp, which a cmin over
    every tile would take for an escape. Only ``fail`` moves, 1 to 0.

    Returns the untiled tuple plus ``klos`` int32[n_tiles, B], the
    per-tile band origins. Walk emissions are int32 (query indices of
    long reads outgrow int16).
    """
    B = q.shape[0]
    dev = q.device
    i32 = torch.int32
    k = 4 if nxt_k >= 4 else 2
    BND = uc_boundary(k)
    n_tiles = Lq // T
    xr = torch.arange(W, dtype=i32, device=dev)[None, :]
    delta = lt - lq
    klo, klo_lo, klo_hi = tiled_origin(lq, lt, W)
    prev = row0_scores(klo, W, gap)
    uc = torch.full((B, W), BND, dtype=i32, device=dev)
    hl = prev.clone()
    cmin = torch.full((B,), HUGE, dtype=i32, device=dev)

    flat = t.reshape(-1)
    base = torch.arange(B, dtype=torch.int64, device=dev) * LA
    qT = q.t().contiguous()
    planes = (torch.empty((Lq, B, W), dtype=torch.uint8, device=dev),
              torch.empty((Lq, B, W), dtype=torch.uint8, device=dev),
              torch.empty((Lq, B, W), dtype=torch.uint16, device=dev)
              if k >= 4 else None)
    klos = torch.empty((n_tiles, B), dtype=i32, device=dev)
    for ti in range(n_tiles):
        i0 = ti * T
        cmin = torch.where(lq > i0, torch.minimum(
            cmin, torch.minimum(klo_hi - klo, klo - klo_lo)), cmin)
        tband = band_targets(flat, base, klo, lt, W + T, origin=i0)
        *_, hl2, prev2, uc2 = kernels.fw_dirs_band_tile(
            tband, qT[i0:i0 + T], klo, lq, i0, prev, uc, hl, match=match,
            mismatch=mismatch, gap=gap, W=W, nxt_k=k, out=planes)
        klos[ti] = klo
        # Dead-zone re-centering on the frontier argmax (first maximum).
        xstar = torch.argmax(prev2, dim=1).to(i32)
        shift = torch.where(xstar < W // 4, xstar - W // 4,
                            torch.where(xstar > (3 * W) // 4,
                                        xstar - (3 * W) // 4, 0))
        klo_n = torch.minimum(torch.maximum(klo + shift, klo_lo), klo_hi)
        xi = xr + (klo_n - klo)[:, None]
        okx = (xi >= 0) & (xi < W)
        xig = torch.clamp(xi, 0, W - 1).long()
        prev = torch.where(okx, torch.gather(prev2, 1, xig), NEG)
        uc = torch.where(okx, torch.gather(uc2, 1, xig), BND)
        hl = torch.where(okx, torch.gather(hl2, 1, xig), NEG)
        klo = klo_n
    cols = kernels.col_walk_kernel(
        planes[0], lq, lt, None, torch.zeros_like(lq), LA=LA, layout="band",
        nxt=planes[1], nxt2=planes[2], tile_klo=klos, tile_len=T,
        emit=torch.int32)
    del planes

    # hl rides the frontier shifts, so the terminal cell is indexed
    # through the final origin; the clamp keeps it in [0, W).
    xend = torch.clamp(lt - lq - klo, 0, W - 1).long()
    score = torch.gather(hl, 1, xend[:, None])[:, 0]
    bound = (max(match, 0) * (torch.minimum(lq, lt) - cmin - 1) +
             gap * (delta.abs() + 2 * cmin + 2))
    fail = (((score < bound) | (cmin < 16)).to(torch.float32) +
            cols["sat"].to(torch.float32))
    op = cols["op_c"][:, 1:LA + 1]
    qi = cols["qi_c"][:, 1:LA + 1]
    return _window_rows(op, qi, lt, t_begin, w_len=w_len, NW=NW,
                        LA=LA) + (fail, klos)


def _split_lanes(out, lanes):
    """A group's chunk tuple split back per chunk (``lanes[c]`` lanes for
    chunk c, in order): the six lane fields on dim 0, the tiled route's
    ``klos`` on dim 1."""
    parts = [a.split(lanes) for a in out[:6]] + [a.split(lanes, dim=1)
                                                 for a in out[6:]]
    return [tuple(p[c] for p in parts) for c in range(len(lanes))]


def _untiled_group_breaking_points(q, t, lq, lt, t_begin, *, lanes, **kw):
    """A group of untiled chunks, their lanes concatenated, as one untiled
    chunk: one K1 launch over every lane, one walk. Returns, per chunk,
    the tuple :func:`_chunk_breaking_points` gives for that chunk alone."""
    return _split_lanes(_chunk_breaking_points(q, t, lq, lt, t_begin, **kw),
                        lanes)


def _tiled_group_breaking_points(q, t, lq, lt, t_begin, *, lanes, **kw):
    """A group of tiled chunks, their lanes concatenated (``lanes[c]``
    lanes for chunk c, in order), as one tiled chunk: one K3 launch a
    tile over every lane, one re-centering pass between tiles, one walk.
    Returns, per chunk, the tuple :func:`_tiled_chunk_breaking_points`
    gives for that chunk alone (lane fields and ``klos`` split back)."""
    return _split_lanes(
        _tiled_chunk_breaking_points(q, t, lq, lt, t_begin, **kw), lanes)


def plan_groups(chunk_lanes, group: int, lane_bytes: int, cap_bytes=None):
    """Consecutive chunks (``chunk_lanes[c]`` lanes each) into launch
    groups of at most ``group`` chunks whose planes, ``lane_bytes`` a
    lane, stay within ``cap_bytes`` (None: no ceiling); a chunk over the
    ceiling alone still forms a group. Returns lists of chunk indices."""
    groups: List[List[int]] = []
    cur: List[int] = []
    n = 0
    for c, lanes in enumerate(chunk_lanes):
        if cur and (len(cur) >= group or (cap_bytes is not None and
                                          (n + lanes) * lane_bytes >
                                          cap_bytes)):
            groups.append(cur)
            cur, n = [], 0
        cur.append(c)
        n += lanes
    if cur:
        groups.append(cur)
    return groups


def group_size(lanes: int, W: int, rows: int, nxt_k: int, device, *,
               tiled: bool = True) -> int:
    """Chunks of ``lanes`` lanes a launch carries: as many as fill one
    wave of the card, ``max(1, blocks_per_SM * SMs // lanes)``, with
    blocks_per_SM the occupancy of the route's band kernel at (W, rows,
    k): K3 at rows = T (``tiled``), K1 at rows = Lq. 1 on the CPU. A
    failed occupancy query raises."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1
    with torch.cuda.device(device):
        occ = kernels.band_occupancy(W, rows, nxt_k, tiled=tiled)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, occ["blocks_per_sm"] * sms // lanes)


def group_mem_cap(device):
    """Ceiling on one group's planes: GROUP_MEM_FRACTION of the card's
    memory; None (no ceiling) on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    total = torch.cuda.get_device_properties(device).total_memory
    return int(GROUP_MEM_FRACTION * total)


def _pack(chunks, Lq, LA, device):
    """Padded lane arrays on ``device`` of consecutive chunks ``[(jobs,
    lanes), ...]``: chunk c's jobs from its first lane, ``lanes`` lanes
    each."""
    n = sum(B for _, B in chunks)
    q = np.zeros((n, Lq), np.uint8)
    t = np.zeros((n, LA), np.uint8)
    lq = np.ones(n, np.int32)
    lt = np.ones(n, np.int32)
    t_begin = np.zeros(n, np.int32)
    off = 0
    for sub, B in chunks:
        for b, job in enumerate(sub, off):
            o, qc, tc = job[0], job[1], job[2]
            q[b, :len(qc)] = qc
            t[b, :len(tc)] = tc
            lq[b] = len(qc)
            lt[b] = len(tc)
            t_begin[b] = o.t_begin
        off += B
    return tuple(torch.from_numpy(a).to(device)
                 for a in (q, t, lq, lt, t_begin))


def device_breaking_points(pending, sequences, window_length: int, *,
                           match: int, mismatch: int, gap: int, device,
                           log=None, tiers=None, group=None) -> List:
    """Compute breaking points on ``device`` for as many overlaps as the
    admission rules take; returns the overlaps that still need the host
    aligner (no route admits them, the escape certificate failed, or the
    walk saturated).

    Sets ``o.breaking_points`` (int64[N, 4], the reference's row format)
    on every handled overlap, so ``find_breaking_points`` then returns at
    once. ``tiers`` replaces budget.TILE_TIERS; ``group`` fixes the
    chunks a launch carries on both routes (default :func:`group_size`).

    Traced as ``dispatch`` spans on the caller's thread, one after the
    other: ``ovl_prep`` (admission, operands and their encoding, buckets,
    groups and their inputs' copies to the device, up to the first
    launch), the launch groups' ``ovl_chunk`` / ``ovl_tiled_chunk``, and
    ``ovl_collect`` (each group's outputs pulled and turned into rows).
    """
    prep = get_tracer().span("dispatch", "ovl_prep", overlaps=len(pending))
    try:
        return _breaking_points(pending, sequences, window_length, prep,
                                match=match, mismatch=mismatch, gap=gap,
                                device=device, log=log, tiers=tiers,
                                group=group)
    finally:
        prep.end()                  # the early returns and errors


def _breaking_points(pending, sequences, window_length: int, prep, *,
                     match: int, mismatch: int, gap: int, device, log,
                     tiers, group) -> List:
    """The body of :func:`device_breaking_points`; ends ``prep`` at the
    first launch."""
    device = torch.device(device)
    tiled_on = env.ovl_tiled()
    jobs = []        # (overlap, q_codes, t_codes, q_start)
    tiled_jobs = []  # (overlap, q_codes, t_codes, q_start, plan)
    fallback = []
    n_budget = 0
    n_uncert = 0
    for o in pending:
        qb, tb = o.alignment_operands(sequences)
        lq, lt = len(qb), len(tb)
        if lq < 1 or lt < 1:
            fallback.append(o)
            n_budget += 1
            continue
        q_start = o.q_begin if not o.strand else o.q_length - o.q_end
        if untiled_admits(lq, lt):
            jobs.append((o, encode_bases(bytes(qb)),
                         encode_bases(bytes(tb)), q_start))
            continue
        plan = tile_plan(lq, lt, tiers) if tiled_on else None
        if plan is not None:
            tiled_jobs.append((o, encode_bases(bytes(qb)),
                               encode_bases(bytes(tb)), q_start, plan))
        else:
            fallback.append(o)
            n_budget += 1
    if not jobs and not tiled_jobs:
        if log is not None and fallback:
            print(f"[racon_tpu_torch::Polisher::initialize] all "
                  f"{len(pending)} overlap alignments exceed the device "
                  "length budget; using the native path", file=log)
        record_ovl(device_jobs=0, native_jobs=len(fallback), tiles=0)
        return fallback

    # Shape buckets (the reference's): jobs sorted by length, buckets
    # grown greedily under the running-maxima budget; each bucket runs in
    # TB-lane chunks at one (Lq, LA, W).
    jobs.sort(key=lambda j: (len(j[1]), len(j[2])))
    buckets = []
    cur: List = []
    Lq = LA = W = 1
    for j in jobs:
        _, qc, tc, _ = j
        tLq = max(Lq, round_up(len(qc), 2048))
        tLA = max(LA, round_up(len(tc), 2048))
        tW = max(W, round_up(band_width_for_read(len(qc), len(tc)), 512))
        if cur and (TB * tLq * tW > MAX_DIR_ELEMS or
                    vmem_est(tW, tLq, 4) > VMEM_BUDGET):
            buckets.append((cur, Lq, LA, W))
            cur = []
            tLq = round_up(len(qc), 2048)
            tLA = round_up(len(tc), 2048)
            tW = round_up(band_width_for_read(len(qc), len(tc)), 512)
        Lq, LA, W = tLq, tLA, tW
        cur.append(j)
    if cur:
        buckets.append((cur, Lq, LA, W))

    # Tiled jobs bucket per tier; LA rides up to Lq so every tile's target
    # gather stays inside the lane's padded row.
    bytier = {}
    for j in tiled_jobs:
        bytier.setdefault(j[4].key(), []).append(j)
    tiled_buckets = []
    for (lanes, W_t, T_t, _ch, k_t), js in sorted(bytier.items()):
        js.sort(key=lambda j: (len(j[1]), len(j[2])))
        Lq_t = max(round_up(len(j[1]), T_t) for j in js)
        LA_t = max(Lq_t, max(round_up(len(j[2]), 2048) for j in js))
        tiled_buckets.append((js, lanes, W_t, T_t, Lq_t, LA_t, k_t))

    # One job's card section at a time on a device (_card_lock).
    ugroups, tgroups = [], []
    with _card_lock(device):
        # Every chunk's inputs go to the device first, then every chunk
        # (and group) is dispatched before any is collected: the host's
        # copies never wait on the card, and a chunk's planes are freed
        # as soon as its walk is queued. RACON_TPU_TIMING=1 prints the
        # dispatch's and the collect's seconds (the reference's lines);
        # the overlap path stays outside the retry envelope, as in the
        # reference.
        verbose = env.timing_enabled()
        tracer = get_tracer()
        t_disp = time.perf_counter()
        sc = dict(match=match, mismatch=mismatch, gap=gap)
        untiled_calls, group_calls = [], []
        mem_cap = group_mem_cap(device)
        for bucket, Lq, LA, W in buckets:
            nxt_k = untiled_walk_k(Lq, W)
            kw = dict(W=W, w_len=window_length,
                      NW=LA // window_length + 2, Lq=Lq, LA=LA,
                      nxt_k=nxt_k, **sc)
            # K1's depth in _chunk_breaking_points, and its planes' bytes
            # a cell (cells and nxt, and the u16 nxt2 at k = 4).
            k = 4 if nxt_k >= 4 else 2
            chunks = [(bucket[s:s + TB], TB)
                      for s in range(0, len(bucket), TB)]
            G = (group_size(TB, W, Lq, k, device, tiled=False)
                 if group is None else group)
            groups = plan_groups([TB] * len(chunks), G, Lq * W * k, mem_cap)
            for idx in groups:
                part = [chunks[c] for c in idx]
                untiled_calls.append(([sub for sub, _ in part],
                                      _pack(part, Lq, LA, device),
                                      dict(kw, lanes=[TB] * len(part))))
            ugroups.append(dict(lanes=TB, W=W, Lq=Lq, LA=LA, nxt_k=nxt_k,
                                chunks=len(chunks), G=G,
                                groups=len(groups)))
        n_tiles_exec = n_tail = 0
        for bucket, lanes, W, T, Lq, LA, nxt_k in tiled_buckets:
            kw = dict(W=W, w_len=window_length,
                      NW=LA // window_length + 2, Lq=Lq, LA=LA, T=T,
                      nxt_k=nxt_k, **sc)
            chunks = []
            for s in range(0, len(bucket), lanes):
                sub = bucket[s:s + lanes]
                # Lanes halve down to the job count (power of two, at
                # least 8): a short tail chunk should not pay a full
                # chunk's work.
                B = lanes
                while B // 2 >= max(8, len(sub)):
                    B //= 2
                chunks.append((sub, B))
            G = (group_size(lanes, W, T, nxt_k, device) if group is None
                 else group)
            groups = plan_groups([B for _, B in chunks], G,
                                 Lq * W * (4 if nxt_k >= 4 else 2), mem_cap)
            for idx in groups:
                part = [chunks[c] for c in idx]
                # Lanes whose rows end at least a tile before the group's
                # last tile (their certificate skips those tiles).
                tail = sum(round_up(len(j[1]), T) < Lq
                           for sub, _ in part for j in sub)
                group_calls.append(([sub for sub, _ in part],
                                    _pack(part, Lq, LA, device),
                                    dict(kw, lanes=[B for _, B in part]),
                                    tail))
                n_tail += tail
            n_tiles_exec += len(groups) * (Lq // T)
            tgroups.append(dict(lanes=lanes, W=W, T=T, Lq=Lq, nxt_k=nxt_k,
                                chunks=len(chunks), G=G,
                                groups=len(groups)))
        prep.add(jobs=len(jobs) + len(tiled_jobs), native=len(fallback),
                 groups=len(untiled_calls) + len(group_calls)).end()
        outs = []
        for subs, args, kw in untiled_calls:
            with tracer.span("dispatch", "ovl_chunk",
                             lanes=sum(kw["lanes"]), W=kw["W"],
                             chunks=len(subs)):
                outs.extend(zip(subs,
                                _untiled_group_breaking_points(*args, **kw)))
        for subs, args, kw, tail in group_calls:
            with tracer.span("dispatch", "ovl_tiled_chunk",
                             lanes=sum(kw["lanes"]), W=kw["W"],
                             tiles=kw["Lq"] // kw["T"], chunks=len(subs),
                             tail_lanes=tail):
                # A ``tile`` point a tile launch of the group.
                for ti in range(kw["Lq"] // kw["T"]):
                    tracer.point("tile", f"t{ti}", index=ti, rows=kw["T"],
                                 W=kw["W"])
                outs.extend(zip(subs,
                                _tiled_group_breaking_points(*args, **kw)))
        if verbose:
            print(f"[racon_tpu_torch::ovl_align] dispatch {len(outs)} "
                  f"chunks ({len(buckets)} shape buckets, "
                  f"{len(tiled_buckets)} tiled tiers): "
                  f"{time.perf_counter() - t_disp:.2f}s", file=sys.stderr)
            t_disp = time.perf_counter()

        with tracer.span("dispatch", "ovl_collect", chunks=len(outs),
                         jobs=sum(len(sub) for sub, _ in outs)) as span:
            for sub, out in outs:
                first_c, qi_f, last_c, qi_l, valid, fail = (
                    a.cpu().numpy() for a in out[:6])
                for b, job in enumerate(sub):
                    o, q_start = job[0], job[3]
                    if fail[b]:
                        fallback.append(o)
                        n_uncert += 1
                        continue
                    v = valid[b]
                    o.breaking_points = np.stack([
                        o.t_begin + first_c[b][v].astype(np.int64),
                        q_start + qi_f[b][v].astype(np.int64),
                        o.t_begin + last_c[b][v].astype(np.int64) + 1,
                        q_start + qi_l[b][v].astype(np.int64) + 1,
                    ], axis=1)
            span.add(uncertified=n_uncert)
        if verbose:
            print(f"[racon_tpu_torch::ovl_align] collect: "
                  f"{time.perf_counter() - t_disp:.2f}s", file=sys.stderr)
    with _STATS_LOCK:
        UNTILED_GROUPS.extend(ugroups)
        TILED_GROUPS.extend(tgroups)
    record_ovl(device_jobs=len(jobs) + len(tiled_jobs) - n_uncert,
               native_jobs=len(fallback), tiles=n_tiles_exec,
               tail_lanes=n_tail)
    if log is not None and fallback:
        print(f"[racon_tpu_torch::Polisher::initialize] {len(fallback)} of "
              f"{len(pending)} overlap alignments fall back to the "
              f"native path ({n_budget} over the device length budget, "
              f"{n_uncert} uncertified)", file=log)
    return fallback
