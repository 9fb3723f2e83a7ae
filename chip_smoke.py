"""Chip smoke of the PyTorch/CUDA port (racon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line with the card's name and power limit;
any failure exits non-zero and prints no result):

1. build      the CUDA kernels (csrc/*.cu, one nvcc per source, started
              together) and the host C++ aligner, from this checkout;
              then each band kernel instantiation the paths launch, with
              its registers, spills (local-memory bytes) and resident
              blocks an SM on this card;
2. kernels    each kernel against its plain PyTorch version on the card,
              bitwise, at the main path's shapes; kernel and plain times
              from CUDA events: band_fwd (K1) at the consensus shape, on
              an untiled overlap chunk as phase 3 runs it (128 lanes,
              Lq=6144, W=1024, k=4) and on the main path's untiled
              bucket as the path launches it (3 chunks of 128 lanes at
              Lq=8192, W=1536, k=2, in the group planner's launch groups
              of G chunks; each chunk launched alone must give its slice
              of its group's outputs, and the groups are timed in turns
              against the chunks launched one at a time), band_tile_fwd
              (K3) on tile 1 of an overlap group of G chunks of 64 lanes
              (G from the group planner, as the main path launches it)
              from tile 0's frontier and on its first 64 lanes, flat_fwd
              (K2), and col_walk (W1) on the group's stitched planes
              (tiled, int32), on the untiled chunk and the untiled
              bucket's groups (int16; timed in turns against its chunks'
              walks), at the consensus shape (k=4, int16) on K1's planes
              of random inputs and of 8%-error reads, and on K2's
              full-width planes (flat layout, k=1). Each walk's bound is
              the larger of its bytes bound and its serial floor, its
              chain_len dependent loads through shared memory; beside it
              the chain floor (the same loads through device memory at
              the walk's addresses: csrc/probe.cu in both modes), the
              windows and misses a lane from the kernel's refill counter,
              and its launch plan's registers and shared memory a block.
              Then the op-string route's kernels: nw_fwd (K4) at the
              route's batch shapes ([4096, 512, 512], [3072, 640, 512])
              and at [4096, 640, 512], the warp kernel timed in turns
              against the wide kernel forced at the same shape (both
              bitwise, with registers, spills and blocks an SM);
              nw_traceback (T1, with its chain floor) on K4's planes at
              [4096, 640, 512]; monotone_count (K5) at the merge's shape
              [14965, 532, 510] on route-like block keys and at [4096,
              1152, 514] on T1's op strings, in turns with
              torch.searchsorted (20 repetitions); K4 and K5 times are
              device times from CUDA graphs of several calls;
3. small      the CLI on a ~20 kb synthetic input with --device cuda and
              --device cpu: the FASTA must be byte-identical (the cuda run
              aligns the overlaps on the card, untiled; the cpu run with
              the host aligner);
4. main       the main path at full size through the CLI entry point: a
              1 Mbp synthetic draft (20 contigs x 50 kb), 10 kb reads at
              30x, PAF overlaps aligned on the card (tiled route), w=500.
              Launch counts reset just before and read just after;
              band_fwd, band_tile_fwd and col_walk must have launched,
              band_tile_fwd once a tile of each launch group, band_fwd
              once for each untiled launch group beside the consensus
              forward's launches, every bucket of more than one chunk
              (tiled or untiled) in groups of G > 1, the
              consensus engine must have walked on the card (col_walk
              launches inside the stage clock's walk stage) and the
              overlap aligner must have handled jobs on the card. The
              host phases are split from the logger's phase lines.
              Polished edit distance to the truth must be at most a third
              of the draft's;
5. flat path  the band-off route (RACON_TPU_NO_BAND=1, the full-width
              forward) through the CLI on a 100 kb input, with its own
              launch counts; flat_fwd must have launched and the
              consensus engine must have walked on the card (flat layout);
6. op strings the batched aligner's route at full size: the windows of
              phase 4's first 5 contigs (Polisher.initialize), round 0's
              ~15k jobs through PoaEngine._align on the card (K4 and T1 in
              batches of up to 4096 lanes), then extract_votes (K5) and
              the device merge. Every path must score what the native
              aligner's path scores, and every window's consensus,
              coverage and coordinate maps must equal the host
              _merge_round's on the same op strings, except windows with
              an insertion run longer than K_INS (the device merge keeps
              K_INS pileup columns by design), which are counted.

The line before the last holds the kernel records, the line before it
the card's name and power limit, the last line the ok record.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM rates used for the bounds: HBM 3.35 TB/s; int32
# 16.7 TOP/s = 132 SMs x 64 INT32 lanes x 1.98 GHz (the 67 TFLOP/s fp32
# figure counts 128 lanes and an FMA as two operations).
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9
# Integer operations per DP cell, counted from the kernel sources (the
# tiled entry runs the same row body as band_fwd). nw_fwd counts what one
# pass over a row needs: the substitution's compare and select (2), diag
# and up (2), their max (1), the column's gap offset taken off and put
# back (2), the prefix max (1), h == diag and h == up (2), two selects
# (2) and the code packed into its stored word (2); the second sweep over
# a row that both K4 variants make, which recomputes diag and up after
# the scan, is not counted.
OPS_PER_CELL = {("band_fwd", 4): 50, ("band_fwd", 2): 40,
                ("band_fwd", 1): 30, ("flat_fwd", 0): 25,
                ("nw_fwd", 0): 14}
# Integer operations per traceback step (nw_traceback.cu) and, for the
# monotone count (count.cu), per X element and per output bin.
OPS_PER_STEP = 14
OPS_PER_X, OPS_PER_BIN = 5, 7
REPLACES = {
    "band_fwd": "racon_tpu/ops/pallas/band_kernel.py:96",
    "band_tile_fwd": "racon_tpu/ops/pallas/band_kernel.py:428",
    "flat_fwd": "racon_tpu/ops/pallas/flat_kernel.py:31",
    "col_walk": "racon_tpu/ops/colwalk.py:66",
    "nw_fwd": "racon_tpu/ops/pallas/nw_kernel.py:42",
    "nw_fwd_wide": "racon_tpu/ops/pallas/nw_kernel.py:42",
    "nw_traceback": "racon_tpu/ops/align.py:75",
    "monotone_count": "racon_tpu/ops/pallas/count_kernel.py:33",
}
SOURCE = {"band_fwd": "band_fwd.cu", "band_tile_fwd": "band_fwd.cu",
          "flat_fwd": "flat_fwd.cu", "col_walk": "col_walk.cu",
          "nw_fwd": "nw_fwd.cu", "nw_fwd_wide": "nw_fwd.cu",
          "nw_traceback": "nw_traceback.cu",
          "monotone_count": "count.cu"}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, "card": CARD, **kw}), flush=True)


def time_turns(fns, reps: int = 5):
    """Warm medians of ``reps`` timed calls of each function (CUDA
    events), taken in turns: in order, then in reverse."""
    import torch
    for fn in fns:
        fn()
    ts = [[] for _ in fns]
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    for _ in range(reps):
        for i in order:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fns[i]()
            b.record()
            torch.cuda.synchronize()
            ts[i].append(a.elapsed_time(b))
    return [float(np.median(t)) for t in ts]


def time_graph_turns(fns, reps: int = 20, calls: int = 20):
    """Device time of one call of each function: ``calls`` calls captured
    in a CUDA graph, the graph's replays timed with CUDA events and
    divided by ``calls``; warm medians of ``reps`` replays, taken in
    turns (in order, then in reverse). For kernels of a few microseconds,
    whose eager call costs the host more than the card: events around an
    eager call time the host's launch."""
    import torch
    graphs = []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
        graphs.append(g)
    return [ms / calls for ms in time_turns([g.replay for g in graphs],
                                            reps)]


def time_ms(fn, reps: int = 5) -> float:
    """Warm median of ``reps`` timed calls (CUDA events)."""
    import torch
    fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def timed_once(fn):
    """(result, ms) of one call (CUDA events): for the plain versions,
    whose single run takes seconds."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by) from bytes over HBM and int32 ops over the
    int32 throughput."""
    b_ms = nbytes / HBM_BYTES_S * 1e3
    o_ms = ops / INT32_OPS_S * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def max_abs_err(ref, out, block: int = 1 << 27) -> int:
    """Largest |ref - out| over pairs of tensors (u8/u16/i16 compared as
    unsigned), a block of about ``block`` elements at a time along dim 0,
    so that a group's planes (billions of elements) need little scratch."""
    import torch
    err = 0
    for r, o in zip(ref, out):
        if r is None or o is None:
            if (r is None) != (o is None):
                return 1 << 30
            continue
        if r.dtype == torch.uint16:
            r, o = r.view(torch.int16), o.view(torch.int16)
        mask = {torch.int16: 0xFFFF, torch.uint8: 0xFF}.get(r.dtype)
        if r.dim() == 0:
            r, o = r.reshape(1), o.reshape(1)
        step = max(1, block // max(1, r[0].numel()))
        for i in range(0, r.shape[0], step):
            a = r[i:i + step].to(torch.int64)
            b = o[i:i + step].to(torch.int64)
            if mask is not None:
                a, b = a & mask, b & mask
            err = max(err, int((a - b).abs().max().item()))
    return err


def band_inputs(device, B, Lq, W, seed=1):
    """Main-path-like band inputs: query lengths ~ w=500 windows, target
    slices within the band, tband filled with 7 outside the slice."""
    import torch
    from racon_tpu_torch.ops.band import band_geometry
    rng = np.random.default_rng(seed)
    lq = rng.integers(Lq * 3 // 4, Lq - 8, B).astype(np.int32)
    lt = (lq + rng.integers(-40, 41, B)).astype(np.int32)
    klo, _ = band_geometry(torch.from_numpy(lq), torch.from_numpy(lt), W)
    y = np.arange(W + Lq)[None, :]
    rel = klo.numpy()[:, None] + y
    tband = rng.integers(0, 4, (B, W + Lq)).astype(np.uint8)
    tband[(rel < 0) | (rel >= lt[:, None])] = 7
    qT = rng.integers(0, 4, (Lq, B)).astype(np.uint8)
    return (torch.from_numpy(tband).to(device), torch.from_numpy(qT).to(device),
            klo.to(device), torch.from_numpy(lq).to(device),
            torch.from_numpy(lt).to(device))


def consensus_reads(device, B, Lq, W, seed=8):
    """Band inputs as a consensus chunk's lanes give them: targets of
    window-slice lengths (3/4 of Lq to Lq - 8 bases), queries 8%-error
    reads of them cut to Lq rows, the band origin of band_geometry and the
    target band of band_targets. Returns (tband, qT, klo, lq, lt)."""
    import torch
    from racon_tpu_torch.ops.band import band_geometry, band_targets
    from racon_tpu_torch.ops.encode import encode_bases
    from racon_tpu_torch.utils.synth import _BASES, mutate
    rng = np.random.default_rng(seed)
    q = np.zeros((B, Lq), np.uint8)
    t = np.zeros((B, Lq), np.uint8)
    lq = np.zeros(B, np.int32)
    lt = np.zeros(B, np.int32)
    for b in range(B):
        tt = _BASES[rng.integers(0, 4, int(rng.integers(Lq * 3 // 4,
                                                         Lq - 8)))]
        qq = mutate(rng, tt, 0.08)[0][:Lq]
        q[b, :len(qq)] = encode_bases(qq.tobytes())
        t[b, :len(tt)] = encode_bases(tt.tobytes())
        lq[b], lt[b] = len(qq), len(tt)
    lq_t, lt_t = torch.from_numpy(lq), torch.from_numpy(lt)
    klo = band_geometry(lq_t, lt_t, W)[0]
    base = torch.arange(B, dtype=torch.int64) * Lq
    tband = band_targets(torch.from_numpy(t).reshape(-1), base, klo, lt_t,
                         W + Lq)
    return tuple(a.to(device) for a in (
        tband, torch.from_numpy(q).t().contiguous(), klo, lq_t, lt_t))


def band_bound(B, rows, W, k, tiled=False):
    """bound() of the banded forward over B lanes, ``rows`` query rows and
    W band slots at walk depth k: the target window, query and klo/lq
    read; cells (+ nxt at k >= 2, + u16 nxt2 at k = 4) and hlast written;
    on the tiled entry also the frontier read and written."""
    cells = B * rows * W
    return bound(B * (W + rows) + rows * B + 8 * B +
                 cells * (1 + (k >= 2) + 2 * (k >= 4)) +
                 (24 if tiled else 4) * B * W,
                 cells * OPS_PER_CELL[("band_fwd", k)])


def overlap_chunk(device, B=64, L=9900, W=1536, T=2048, tiled=True,
                  seed=3):
    """An overlap chunk as the main path builds it: B lanes of L-base
    targets and 8%-error reads of them, padded to Lq = LA, a multiple of
    T, with the band origin of the tiled route's first tile (``tiled``)
    or of the untiled route."""
    import torch
    from racon_tpu_torch.ops.band import band_geometry
    from racon_tpu_torch.ops.encode import encode_bases
    from racon_tpu_torch.ops.ovl_align import tiled_origin
    from racon_tpu_torch.utils.synth import _BASES, mutate
    rng = np.random.default_rng(seed)
    ts = [_BASES[rng.integers(0, 4, L)] for _ in range(B)]
    qs = [mutate(rng, tt, 0.08)[0] for tt in ts]
    Lq = -(-max(L, *(len(qq) for qq in qs)) // T) * T
    q = np.zeros((B, Lq), np.uint8)
    t = np.zeros((B, Lq), np.uint8)
    lq = np.zeros(B, np.int32)
    lt = np.zeros(B, np.int32)
    for b, (tt, qq) in enumerate(zip(ts, qs)):
        q[b, :len(qq)] = encode_bases(qq.tobytes())
        t[b, :L] = encode_bases(tt.tobytes())
        lq[b], lt[b] = len(qq), L
    lq_t, lt_t = torch.from_numpy(lq), torch.from_numpy(lt)
    klo = (tiled_origin(lq_t, lt_t, W) if tiled else
           band_geometry(lq_t, lt_t, W))[0]
    return dict(q=torch.from_numpy(q).to(device), t=torch.from_numpy(t).to(
        device), lq=lq_t.to(device), lt=lt_t.to(device), klo=klo.to(device),
        B=B, Lq=Lq, W=W, T=T)


WALK_FIELDS = ("ins_len", "qstart", "op_c", "qi_c", "sat")


def chain_floor_ms(device, steps, step_bytes, lanes, lane_bytes) -> float:
    """Time of ``steps`` dependent loads ``step_bytes`` apart, one chain a
    lane with lanes ``lane_bytes`` apart, and no other work: the latency
    probe (csrc/probe.cu) on int32 entries at a walk's addresses."""
    import torch
    from racon_tpu_torch.ops import kernels
    probe = dict(lanes=lanes, lane_stride=lane_bytes // 4)
    loads = kernels.chain_of_loads(steps, step_bytes // 4, device, **probe)
    ends = kernels.chase(loads, steps, **probe)
    want = torch.arange(lanes - 1, -1, -1, device=device) * (lane_bytes // 4)
    if not torch.equal(ends.long(), want):
        fail("the latency probe did not reach the ends of its chains")
    return time_ms(lambda: kernels.chase(loads, steps, **probe))


@functools.lru_cache(maxsize=None)
def shared_step_ms(device) -> float:
    """Time of one dependent load through shared memory: the latency
    probe's shared mode, 2^20 loads down a chain of its most entries."""
    from racon_tpu_torch.ops import kernels
    loads = kernels.chain_of_loads(kernels.CHASE_SHARED_ENTRIES - 1, 1,
                                   device)
    steps = 1 << 20
    if kernels.chase(loads, steps, shared=True).item() != 0:
        fail("the shared-memory probe did not reach the end of its chain")
    return time_ms(lambda: kernels.chase(loads, steps, shared=True)) / steps


def walk_case(case, cells, lq, lt, klo, t_off, extra_bytes=0, **wk):
    """W1 against its plain version (bitwise) on one walk, with its time,
    the plain time and its bound: the larger of the bytes bound and the
    serial floor, chain_len dependent loads through shared memory (the
    probe's shared mode; bound_by "operations"). Beside it the chain
    floor, the same loads through device memory at the walk's addresses
    (the floor of a walk that loads every step from there), the windows
    and misses a lane (the kernel's refill counter), and what the launch
    plan gets on this card. Returns the record."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.colwalk import chain_len, col_walk
    B = lq.shape[0]
    W = cells.shape[2]
    k = 4 if wk.get("nxt2") is not None else (
        2 if wk.get("nxt") is not None else 1)
    LA = wk["LA"]
    ref, plain_ms = timed_once(lambda: col_walk(cells, lq, lt, klo, t_off,
                                                **wk))
    out = kernels.col_walk_kernel(cells, lq, lt, klo, t_off, **wk)
    err = max_abs_err([ref[n] for n in WALK_FIELDS],
                      [out[n] for n in WALK_FIELDS])
    esize = out["op_c"].element_size()
    del ref, out
    ms = time_ms(lambda: kernels.col_walk_kernel(cells, lq, lt, klo, t_off,
                                                 **wk))
    chain = chain_len(LA, k)
    bytes_ms, _ = bound(B * chain * k + B * (LA + 2) * 4 * esize + 16 * B +
                        extra_bytes, 0)
    serial_ms = chain * shared_step_ms(cells.device)
    bms, by = ((bytes_ms, "bytes") if bytes_ms >= serial_ms else
               (serial_ms, "operations"))
    # The old design's addresses: lanes W bytes apart, k plane rows a step.
    floor_ms = chain_floor_ms(cells.device, chain, k * B * W, B, W)
    refills = torch.zeros((B, 2), dtype=torch.int32, device=cells.device)
    kernels.col_walk_kernel(cells, lq, lt, klo, t_off, refills=refills,
                            **wk)
    per_lane = refills.to(torch.float64).mean(dim=0).tolist()
    n_tiles = 0 if wk.get("tile_klo") is None else wk["tile_klo"].shape[0]
    plan = kernels.walk_plan(
        B, k, layout=wk["layout"], n_tiles=n_tiles,
        sms=torch.cuda.get_device_properties(
            cells.device).multi_processor_count)
    occ = kernels.walk_occupancy(k, layout=wk["layout"],
                                 emit=wk.get("emit", torch.int16), plan=plan)
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, bytes_bound_ms=bytes_ms,
               serial_floor_ms=serial_ms, chain_floor_ms=floor_ms,
               windows_per_lane=per_lane[0], misses_per_lane=per_lane[1],
               regs=occ["regs"], spills=occ["spills"],
               blocks_per_sm=occ["blocks_per_sm"], smem_per_block=plan["smem"])
    emit("kernels", kernel="col_walk", case=case, nxt_k=k,
         shape=[B, cells.shape[0], W], LA=LA, emit=f"int{8 * esize}",
         chain_len=chain, plan=plan, threads=occ["threads"], **rec)
    if err:
        fail(f"col_walk ({case}) disagrees with its plain version "
             f"(max_abs_err={err})")
    return rec


def band_occ(W, rows, k, tiled):
    """Registers, spills and resident blocks an SM of the band kernel
    instantiation for (W, rows, k) on this card."""
    from racon_tpu_torch.ops import kernels
    occ = kernels.band_occupancy(W, rows, k, tiled=tiled)
    return {n: occ[n] for n in ("regs", "spills", "blocks_per_sm")}


def phase_build_occupancy():
    """Phase 1's record of every band kernel instantiation the paths
    launch: K1 at the consensus shape and the untiled overlap chunk, K3
    at each tiled tier (ops/budget.py TILE_TIERS) and walk depth."""
    from racon_tpu_torch.ops.budget import TILE_TIERS
    cases = [("band_fwd", 256, 640, 4), ("band_fwd", 256, 640, 2),
             ("band_fwd", 1024, 6144, 4), ("band_fwd", 1536, 8192, 2)]
    cases += sorted({("band_tile_fwd", W, T, k) for _, W, T, _ in TILE_TIERS
                     for k in (2, 4)})
    return [dict(kernel=n, W=W, rows=rows, nxt_k=k,
                 **band_occ(W, rows, k, n == "band_tile_fwd"))
            for n, W, rows, k in cases]


def phase_overlap_kernels(device, lanes=64, L=9900, W=1536, T=2048):
    """K3 on tile 1 of an overlap group (G chunks of 64 lanes, G from the
    group planner as the main path launches it; T=2048, W=1536, k=2) from
    tile 0's frontier, and on the group's first 64 lanes; then W1 over
    the group's stitched 5-tile planes (LA = 10240, tiled, int32); all
    bitwise against their plain versions. Returns the group's records."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.band import (band_targets,
                                          fw_dirs_band_tile_plain,
                                          row0_scores, uc_boundary)
    from racon_tpu_torch.ops.ovl_align import group_size
    k = 2
    G = group_size(lanes, W, T, k, device)
    B = G * lanes
    c = overlap_chunk(device, B, L, W, T)
    Lq = c["Lq"]
    sc = dict(match=0, mismatch=-1, gap=-1, W=W, nxt_k=k)
    qT = c["q"].t().contiguous()
    base = torch.arange(B, dtype=torch.int64, device=device) * Lq
    planes = (torch.empty((Lq, B, W), dtype=torch.uint8, device=device),
              torch.empty((Lq, B, W), dtype=torch.uint8, device=device),
              None)
    prev = row0_scores(c["klo"], W, -1)
    front = (prev, torch.full((B, W), uc_boundary(k), dtype=torch.int32,
                              device=device), prev.clone())
    occ = band_occ(W, T, k, True)

    def check(case, args, front, out_planes, n):
        """One tile over the first n lanes: kernel vs plain, time, bound."""
        out = kernels.fw_dirs_band_tile(*args, *front, out=out_planes, **sc)
        ref, plain_ms = timed_once(lambda: fw_dirs_band_tile_plain(
            *args, *front, **sc))
        err = max_abs_err(ref, out)
        del ref
        ms = time_ms(lambda: kernels.fw_dirs_band_tile(
            *args, *front, out=out_planes, **sc))
        bms, by = band_bound(n, T, W, k, tiled=True)
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                   bound_by=by, **occ)
        emit("kernels", kernel="band_tile_fwd", case=case, nxt_k=k,
             shape=[n, T, W], i0=args[4], G=G, **rec)
        if err:
            fail(f"band_tile_fwd ({case}) disagrees with its plain version "
                 f"(max_abs_err={err})")
        return out, rec

    recs = {}
    for ti in range(Lq // T):
        args = (band_targets(c["t"].reshape(-1), base, c["klo"], c["lt"],
                             W + T, origin=ti * T),
                qT[ti * T:(ti + 1) * T], c["klo"], c["lq"], ti * T)
        if ti == 1:
            # Tile 1 starts from tile 0's frontier, as on the main path:
            # first the group, then its first 64 lanes alone.
            out, recs["band_tile_fwd"] = check(f"group of {G} chunks", args,
                                               front, planes, B)
            tb, q1, klo, lq, i0 = args
            sub = (tb[:lanes], q1[:, :lanes].contiguous(), klo[:lanes],
                   lq[:lanes], i0)
            own = tuple(torch.empty((2 * T, lanes, W), dtype=torch.uint8,
                                    device=device) for _ in range(2))
            check(f"{lanes} lanes", sub, tuple(f[:lanes] for f in front),
                  own + (None,), lanes)
            del own
        else:
            out = kernels.fw_dirs_band_tile(*args, *front, out=planes, **sc)
        hl, p, u = out[3:]
        front = (p, u, hl)
    klos = c["klo"][None, :].repeat(Lq // T, 1).contiguous()
    recs["col_walk"] = walk_case(
        f"overlap group of {G} chunks", planes[0], c["lq"], c["lt"], None,
        torch.zeros_like(c["lq"]), extra_bytes=4 * klos.numel(), LA=Lq,
        layout="band", nxt=planes[1], tile_klo=klos, tile_len=T,
        emit=torch.int32)
    return recs


def phase_untiled_overlap_kernels(device, B=128, L=5400, W=1024):
    """K1 and W1 on an untiled overlap chunk as phase 3 runs it (128 lanes
    of ~5.4 kb, W=1024, Lq = LA = 6144, the untiled route's walk depth,
    int16 emission): both bitwise against their plain versions. Then the
    main path's untiled launch group (:func:`untiled_group_kernels`),
    whose records it returns."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.band import band_targets, fw_dirs_band_plain
    from racon_tpu_torch.ops.ovl_align import untiled_walk_k
    c = overlap_chunk(device, B, L, W, T=2048, tiled=False, seed=6)
    Lq = c["Lq"]
    k = untiled_walk_k(Lq, W)
    base = torch.arange(B, dtype=torch.int64, device=device) * Lq
    args = (band_targets(c["t"].reshape(-1), base, c["klo"], c["lt"],
                         W + Lq), c["q"].t().contiguous(), c["klo"], c["lq"])
    sc = dict(match=0, mismatch=-1, gap=-1, W=W, nxt_k=k)
    out = kernels.fw_dirs_band(*args, **sc)
    ref, plain_ms = timed_once(lambda: fw_dirs_band_plain(*args, **sc))
    err = max_abs_err(ref, out)
    del ref
    ms = time_ms(lambda: kernels.fw_dirs_band(*args, **sc))
    bms, by = band_bound(B, Lq, W, k)
    emit("kernels", kernel="band_fwd", case="overlap untiled", nxt_k=k,
         shape=[B, Lq, W], max_abs_err=err, ms=ms, plain_ms=plain_ms,
         bound_ms=bms, bound_by=by, **band_occ(W, Lq, k, False))
    if err:
        fail(f"band_fwd (overlap untiled) disagrees with its plain version "
             f"(max_abs_err={err})")
    cells, nxt, nxt2, _ = out
    walk_case("overlap untiled", cells, c["lq"], c["lt"], c["klo"],
              torch.zeros_like(c["lq"]), LA=Lq, layout="band", nxt=nxt,
              nxt2=nxt2)
    del out, cells, nxt, nxt2
    return untiled_group_kernels(device)


def untiled_group_kernels(device, n_chunks=3, L=7500, W=1536, Lq=8192,
                          LA=10240):
    """K1 and W1 on the main path's untiled bucket as the path launches it:
    ``n_chunks`` chunks of 128 lanes of reads up to ~8 kb (those at
    contig ends: Lq = 8192, LA = 10240, W = 1536, the route's walk depth),
    in the group planner's launch groups (G chunks a group from K1's
    occupancy, one wave of the card), one K1 launch and one walk a group.
    Each group is held bitwise against the plain versions, and each chunk
    launched alone must give its slice of its group's outputs. The
    records' ms is the first group's launch (G x 128 lanes, beside its
    bound); ``bucket_ms`` is every group of the bucket and ``chunks_ms``
    the bucket's chunks launched one at a time, timed in turns in this
    call. Returns the K1 and W1 records."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.band import band_targets, fw_dirs_band_plain
    from racon_tpu_torch.ops.ovl_align import (TB, group_mem_cap, group_size,
                                               plan_groups, untiled_walk_k)
    k = 4 if untiled_walk_k(Lq, W) >= 4 else 2
    G = group_size(TB, W, Lq, k, device, tiled=False)
    groups = plan_groups([TB] * n_chunks, G, Lq * W * (4 if k >= 4 else 2),
                         group_mem_cap(device))
    B = n_chunks * TB
    c = overlap_chunk(device, B, L, W, T=2048, tiled=False, seed=12)
    if c["Lq"] != Lq:
        fail(f"untiled bucket: reads padded to {c['Lq']} rows, not {Lq}")
    base = torch.arange(B, dtype=torch.int64, device=device) * Lq
    tband = band_targets(c["t"].reshape(-1), base, c["klo"], c["lt"], W + Lq)
    qT = c["q"].t().contiguous()
    zeros = torch.zeros_like(c["lq"])
    sc = dict(match=0, mismatch=-1, gap=-1, W=W, nxt_k=k)

    def lanes(s):
        """(K1 arguments, walk lane arguments) of the lanes in slice s."""
        return ((tband[s], qT[:, s].contiguous(), c["klo"][s], c["lq"][s]),
                (c["lq"][s], c["lt"][s], c["klo"][s], zeros[s]))
    g_lanes = [lanes(slice(g[0] * TB, (g[-1] + 1) * TB)) for g in groups]
    c_lanes = [lanes(slice(i * TB, (i + 1) * TB)) for i in range(n_chunks)]
    case = f"untiled overlap group of {len(groups[0])} chunks"
    outs, plain_ms, err = [], [], 0
    for ka, _ in g_lanes:
        outs.append(kernels.fw_dirs_band(*ka, **sc))
        ref, ms_plain = timed_once(lambda: fw_dirs_band_plain(*ka, **sc))
        plain_ms.append(ms_plain)
        err = max(err, max_abs_err(ref, outs[-1]))
        del ref
    alone = [kernels.fw_dirs_band(*ka, **sc) for ka, _ in c_lanes]
    for g, out in zip(groups, outs):
        for j, ci in enumerate(g):
            s = slice(j * TB, (j + 1) * TB)
            err = max(err, max_abs_err(
                [None if p is None else p[:, s] for p in out[:3]] +
                [out[3][s]], alone[ci]))
    ms, bucket_ms, chunks_ms = time_turns(
        [lambda: kernels.fw_dirs_band(*g_lanes[0][0], **sc),
         lambda: [kernels.fw_dirs_band(*ka, **sc) for ka, _ in g_lanes],
         lambda: [kernels.fw_dirs_band(*ka, **sc) for ka, _ in c_lanes]])
    bms, by = band_bound(len(groups[0]) * TB, Lq, W, k)
    k1 = dict(max_abs_err=err, ms=ms, bucket_ms=bucket_ms,
              chunks_ms=chunks_ms, plain_ms=plain_ms[0], bound_ms=bms,
              bound_by=by, G=G, **band_occ(W, Lq, k, False))
    emit("kernels", kernel="band_fwd", case=case, nxt_k=k,
         shape=[len(groups[0]) * TB, Lq, W], groups=groups, **k1)
    if err:
        fail(f"band_fwd ({case}) disagrees with its plain version or with "
             f"its chunks launched alone (max_abs_err={err})")

    def walks(planes, lane_args):
        return [kernels.col_walk_kernel(p[0], *wa, LA=LA, layout="band",
                                        nxt=p[1], nxt2=p[2])
                for p, (_, wa) in zip(planes, lane_args)]
    w1 = [walk_case(f"{case} (group {gi})", out[0], *wa, LA=LA,
                    layout="band", nxt=out[1], nxt2=out[2])
          for gi, (out, (_, wa)) in enumerate(zip(outs, g_lanes))][0]
    for g, got in zip(groups, walks(outs, g_lanes)):
        for j, want in enumerate(walks([alone[ci] for ci in g],
                                       [c_lanes[ci] for ci in g])):
            s = slice(j * TB, (j + 1) * TB)
            err = max_abs_err([got[n][s] for n in WALK_FIELDS],
                              [want[n] for n in WALK_FIELDS])
            if err:
                fail(f"col_walk ({case}): a chunk walked alone differs from "
                     f"its slice of its group's walk (max_abs_err={err})")
    w1["ms"], w1["bucket_ms"], w1["chunks_ms"] = time_turns(
        [lambda: walks(outs[:1], g_lanes[:1]), lambda: walks(outs, g_lanes),
         lambda: walks(alone, c_lanes)])
    w1["G"] = G
    emit("untiled_bucket", chunks=n_chunks, G=G, groups=groups,
         shape=[B, Lq, W], LA=LA, nxt_k=k, band_fwd_ms=ms,
         band_fwd_bucket_ms=bucket_ms, band_fwd_chunks_ms=chunks_ms,
         col_walk_ms=w1["ms"], col_walk_bucket_ms=w1["bucket_ms"],
         col_walk_chunks_ms=w1["chunks_ms"])
    return {("band_fwd", "untiled"): k1, ("col_walk", "untiled"): w1}


def phase_kernels(device, B=4096, Lq=640, W=256, Bf=1024, Lt=640):
    """Each kernel against its plain version on the card, bitwise."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.band import fw_dirs_band_plain
    from racon_tpu_torch.ops.flat import fw_dirs_flat_plain
    sc = dict(match=5, mismatch=-4, gap=-8)
    recs = {}
    *args, lt = band_inputs(device, B, Lq, W)
    for k in (4, 2):
        def run_k():
            return kernels.fw_dirs_band(*args, W=W, nxt_k=k, **sc)

        def run_p():
            return fw_dirs_band_plain(*args, W=W, nxt_k=k, **sc)
        out = run_k()
        ref = run_p()
        err = max_abs_err(ref, out)
        del ref
        if k == 4:
            # W1 at the consensus shape (k=4, int16) on these random
            # planes, whose paths wander off the diagonal.
            rng = np.random.default_rng(4)
            t_off = torch.from_numpy(rng.integers(0, 48, B).astype(
                np.int32)).to(device)
            walk_case("consensus random", out[0], args[3], lt, args[2],
                      t_off, LA=int(lt.max().item()) + 48, layout="band",
                      nxt=out[1], nxt2=out[2])
        del out
        ms = time_ms(run_k)
        plain_ms = time_ms(run_p, reps=1)
        bms, by = band_bound(B, Lq, W, k)
        recs[("band_fwd", k)] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bms,
                                     bound_by=by, **band_occ(W, Lq, k, False))
        emit("kernels", kernel="band_fwd", case="consensus", nxt_k=k,
             shape=[B, Lq, W], **recs[("band_fwd", k)])
        if err:
            fail(f"band_fwd k={k} disagrees with its plain version "
                 f"(max_abs_err={err})")
    del args
    # W1 at the consensus shape on a forward of 8%-error reads of their
    # targets, whose paths stay near the diagonal as the main path's do.
    tb, qT, klo, lq, lt = consensus_reads(device, B, Lq, W)
    cells, nxt, nxt2, _ = kernels.fw_dirs_band(tb, qT, klo, lq, W=W,
                                               nxt_k=4, **sc)
    t_off = torch.from_numpy(np.random.default_rng(4).integers(
        0, 48, B).astype(np.int32)).to(device)
    recs[("col_walk", "consensus")] = walk_case(
        "consensus 8%-error reads", cells, lq, lt, klo, t_off,
        LA=int(lt.max().item()) + 48, layout="band", nxt=nxt, nxt2=nxt2)
    del tb, qT, cells, nxt, nxt2
    rng = np.random.default_rng(2)
    tbuf = torch.from_numpy(rng.integers(0, 4, (Bf, Lt)).astype(
        np.uint8)).to(device)
    qT = torch.from_numpy(rng.integers(0, 4, (Lq, Bf)).astype(
        np.uint8)).to(device)

    def run_fk():
        return kernels.fw_dirs_flat(tbuf, qT, **sc)

    def run_fp():
        return fw_dirs_flat_plain(tbuf, qT, **sc)
    err = max_abs_err([run_fp()], [run_fk()])
    ms = time_ms(run_fk)
    plain_ms = time_ms(run_fp, reps=1)
    cells = Bf * Lq * Lt
    bms, by = bound(Bf * Lt + Lq * Bf + cells,
                    cells * OPS_PER_CELL[("flat_fwd", 0)])
    recs[("flat_fwd", 0)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bms, bound_by=by)
    emit("kernels", kernel="flat_fwd", shape=[Bf, Lq, Lt],
         **recs[("flat_fwd", 0)])
    if err:
        fail(f"flat_fwd disagrees with its plain version (max_abs_err={err})")
    # W1 on K2's planes, as the band-off consensus path and the
    # full-width redo walk them (flat layout, k=1, LA = Lt).
    rng = np.random.default_rng(6)
    t_off = rng.integers(0, 48, Bf).astype(np.int32)
    lt_f = rng.integers(Lt * 3 // 4, Lt - 47, Bf).astype(np.int32)
    lq_f = rng.integers(Lq * 3 // 4, Lq + 1, Bf).astype(np.int32)
    recs[("col_walk", "flat")] = walk_case(
        "consensus flat", run_fk(), *(torch.from_numpy(a).to(device)
                                      for a in (lq_f, lt_f)), None,
        torch.from_numpy(t_off).to(device), LA=Lt, layout="flat")
    return recs


def nw_pairs(device, B, Lq, Lt, seed=10):
    """Pairs as the op-string route packs them: targets of window-slice
    lengths (up to Lt - 12 bases), queries 8%-error copies of them, codes
    zero-padded to (Lq, Lt)."""
    import torch
    from racon_tpu_torch.ops.encode import encode_bases
    from racon_tpu_torch.utils.synth import _BASES, mutate
    rng = np.random.default_rng(seed)
    q = np.zeros((B, Lq), np.uint8)
    t = np.zeros((B, Lt), np.uint8)
    lq = np.zeros(B, np.int32)
    lt = np.zeros(B, np.int32)
    for b in range(B):
        tt = _BASES[rng.integers(0, 4, int(rng.integers(Lt * 3 // 4,
                                                         Lt - 11)))]
        qq = mutate(rng, tt, 0.08)[0][:Lq]
        t[b, :len(tt)] = encode_bases(tt.tobytes())
        q[b, :len(qq)] = encode_bases(qq.tobytes())
        lq[b], lt[b] = len(qq), len(tt)
    return tuple(torch.from_numpy(a).to(device) for a in (q, t, lq, lt))


def route_keys(device, B=14965, S=532, LA=508, seed=12):
    """Block keys as the op-string route's merge gives K5 (its shape
    [14965, 532, 510] in phase 6): right-aligned op strings of 8%-error
    alignments (4% insertions, 3% deletions) of window slices (3/4 of LA
    to LA - 12 columns) behind a PAD_OP prefix, at slice offsets that keep
    every slice inside the anchor, through device_merge.block_keys."""
    import torch
    from racon_tpu_torch.ops.align import PAD_OP
    from racon_tpu_torch.ops.cigar import DIAG, LEFT, UP
    from racon_tpu_torch.ops.device_merge import block_keys
    rng = np.random.default_rng(seed)
    lt = rng.integers(LA * 3 // 4, LA - 11, B)
    u = rng.random((B, S))
    ops = np.where(u < 0.04, UP, np.where(u < 0.07, LEFT, DIAG)).astype(
        np.uint8)
    ct = np.cumsum(ops != UP, axis=1)
    reached = ct[:, -1] >= lt
    n = np.where(reached, np.argmax(ct >= lt[:, None], axis=1) + 1, S)
    idx = np.arange(S)[None, :] - (S - n)[:, None]
    ops = np.where(idx >= 0, np.take_along_axis(ops, np.clip(idx, 0, None),
                                                axis=1), PAD_OP)
    t_off = rng.integers(0, LA - 8 - lt + 1).astype(np.int32)
    return block_keys(torch.from_numpy(ops.astype(np.uint8)).to(device),
                      torch.from_numpy(t_off).to(device))


def nw_case(device, B, Lq, Lt, sc):
    """K4 at one shape: the warp kernel (the planner's pick) and the wide
    kernel forced at the same shape, each bitwise against the plain
    version, timed in turns (warp, wide, wide, warp; device time a call
    from CUDA graphs of 5 calls, median of 10 replays).
    Returns (record, the warp kernel's planes, lq, lt)."""
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.align import nw_dirs_plain
    q, t, lq, lt = nw_pairs(device, B, Lq, Lt)
    ref, plain_ms = timed_once(lambda: nw_dirs_plain(q, t, **sc))
    err = max_abs_err([ref], [kernels.nw_dirs(q, t, **sc)])
    wide_err = max_abs_err([ref], [kernels.nw_dirs(q, t, variant="wide",
                                                   **sc)])
    del ref
    ms, wide_ms = time_graph_turns(
        [lambda: kernels.nw_dirs(q, t, **sc),
         lambda: kernels.nw_dirs(q, t, variant="wide", **sc)], reps=10,
        calls=5)
    cells = B * Lq * Lt
    bms, by = bound(B * (Lq + Lt) + cells,
                    cells * OPS_PER_CELL[("nw_fwd", 0)])
    rec = dict(shape=[B, Lq, Lt], max_abs_err=err, wide_max_abs_err=wide_err,
               ms=ms, wide_ms=wide_ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, warp=kernels.nw_occupancy(Lq, Lt),
               wide=kernels.nw_occupancy(Lq, Lt, "wide"))
    emit("kernels", kernel="nw_fwd", **rec)
    if err or wide_err:
        fail(f"nw_fwd at {[B, Lq, Lt]} disagrees with its plain version "
             f"(warp max_abs_err={err}, wide {wide_err})")
    return rec, kernels.nw_dirs(q, t, **sc), lq, lt


def count_case(case, Xs, P):
    """K5 on keys Xs at P bins, bitwise against the plain version, timed
    in turns with torch.searchsorted (which computes the same counts on
    these non-decreasing keys): device time a call from CUDA graphs of 20
    calls (median of 20 replays), and beside it ``eager_ms``, events
    around one eager call (median of 20), which the host's launch cost
    dominates."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.device_merge import monotone_count_plain
    B, S = Xs.shape
    ref, plain_ms = timed_once(lambda: monotone_count_plain(Xs, P))
    err = max_abs_err([ref], [kernels.monotone_count(Xs, P)])
    pa = torch.arange(P, dtype=torch.int32, device=Xs.device).expand(
        B, P).contiguous()
    lib_same = torch.equal(torch.searchsorted(Xs, pa).to(torch.int32), ref)
    del ref
    fns = [lambda: kernels.monotone_count(Xs, P),
           lambda: torch.searchsorted(Xs, pa)]
    ms, lib_ms = time_graph_turns(fns, reps=20)
    eager_ms, eager_lib_ms = time_turns(fns, reps=20)
    bms, by = bound(4 * B * (S + P), B * (OPS_PER_X * S + OPS_PER_BIN * P))
    occ = kernels.count_occupancy(P)
    rec = dict(case=case, shape=[B, S, P], max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               library_ms=lib_ms, library_equal=lib_same,
               eager_ms=eager_ms, eager_library_ms=eager_lib_ms,
               **{n: occ[n] for n in ("regs", "spills", "blocks_per_sm",
                                      "lanes_per_block")})
    emit("kernels", kernel="monotone_count", **rec)
    if err:
        fail(f"monotone_count ({case}) disagrees with its plain version "
             f"(max_abs_err {err})")
    if not lib_same:
        fail(f"torch.searchsorted disagrees with monotone_count ({case}) "
             "on non-decreasing keys")
    return rec


def phase_op_string_kernels(device, B=4096, Lq=640, Lt=512):
    """K4, T1 and K5 at the op-string route's shapes, each bitwise against
    its plain version. K4 (both variants, in turns) at [4096, 640, 512]
    and at the route's batch shapes [4096, 512, 512] and [3072, 640,
    512]; T1 on K4's planes at [4096, 640, 512] (with its chain floor);
    K5 on the block keys of T1's op strings with P = LA + 2 (LA = Lt),
    [4096, 1152, 514], and on route keys at the merge's shape [14965,
    532, 510], in turns with torch.searchsorted."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.align import PAD_OP, traceback_plain
    from racon_tpu_torch.ops.device_merge import block_keys
    sc = dict(match=5, mismatch=-4, gap=-8)
    recs = {}
    shapes = [nw_case(device, 4096, 512, Lt, sc)[0],
              nw_case(device, 3072, 640, Lt, sc)[0]]
    rec, dirs, lq, lt = nw_case(device, B, Lq, Lt, sc)
    shapes.append(rec)
    # The rows: both variants at the route's first batch shape.
    route = shapes[0]
    occ_keys = ("regs", "spills", "blocks_per_sm")
    recs["nw_fwd", 0] = dict(
        route, library_ms=None, C=route["warp"]["C"],
        shapes=[{n: r[n] for n in ("shape", "ms", "wide_ms", "plain_ms",
                                   "bound_ms")} for r in shapes],
        **{n: route["warp"][n] for n in occ_keys})
    recs["nw_fwd_wide", 0] = dict(
        shape=route["shape"], max_abs_err=route["wide_max_abs_err"],
        ms=route["wide_ms"], plain_ms=route["plain_ms"],
        bound_ms=route["bound_ms"], bound_by=route["bound_by"],
        library_ms=None, **{n: route["wide"][n] for n in occ_keys})

    L = Lq + Lt
    ops, n = kernels.nw_traceback(dirs, lq, lt, L)

    def plain_tb():
        rev = traceback_plain(dirs, lq, lt, L)
        return (torch.flip(rev, dims=[1]),
                (rev != PAD_OP).sum(dim=1, dtype=torch.int32))
    ref, plain_ms = timed_once(plain_tb)
    err = max_abs_err(ref, (ops, n))
    del ref
    ms = time_ms(lambda: kernels.nw_traceback(dirs, lq, lt, L))
    steps = int(n.sum().item())
    bms, by = bound(steps + B * L + 12 * B, steps * OPS_PER_STEP)
    # Chain floor: the longest lane's row moves (lq of them), each a
    # dependent load one plane row (B * Lt bytes) below the last.
    rows = int(lq.max().item())
    floor_ms = chain_floor_ms(dirs.device, rows, B * Lt, B, Lt)
    recs["nw_traceback", 0] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None, chain_floor_ms=floor_ms,
        shape=[B, Lq, Lt], steps=steps, max_n=int(n.max().item()))
    emit("kernels", kernel="nw_traceback", **recs["nw_traceback", 0])
    if err:
        fail(f"nw_traceback disagrees with its plain version "
             f"(max_abs_err={err})")
    del dirs

    rng = np.random.default_rng(11)
    t_off = torch.from_numpy((rng.random(B) * (Lt - lt.cpu().numpy() + 1))
                             .astype(np.int32)).to(device)
    LA = 508    # phase 6's merge shape: P = LA + 2 = 510
    recs["monotone_count", "merge"] = count_case(
        "route merge shape", route_keys(device, LA=LA), LA + 2)
    recs["monotone_count", "T1"] = count_case(
        "T1 op strings", block_keys(ops, t_off), Lt + 2)
    return recs


def run_cli(argv):
    """racon_tpu_torch.cli.main in this process; returns (rc, stdout
    bytes, stderr text, wall seconds)."""
    from racon_tpu_torch import cli
    out_b = io.BytesIO()
    out_t = io.TextIOWrapper(out_b, encoding="utf-8")
    err_t = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out_t), contextlib.redirect_stderr(err_t):
        rc = cli.main(argv)
        out_t.flush()
    return rc, out_b.getvalue(), err_t.getvalue(), time.perf_counter() - t0


def fasta_records(blob: bytes):
    lines = blob.split(b"\n")
    return {lines[i][1:].split(b" ")[0].decode(): lines[i + 1]
            for i in range(0, len(lines) - 1, 2)}


def phase_small(device, tmp):
    from racon_tpu_torch.ops import kernels, ovl_align
    from racon_tpu_torch.utils.synth import write_dataset
    ds = write_dataset(os.path.join(tmp, "small"), seed=5, contig_len=20000,
                       read_len=5000, coverage=20)
    p = ds["paths"]
    argv = [p["reads"], p["overlaps"], p["draft"], "-t", "8"]
    kernels.reset_launches()
    ovl_align.reset_stats()
    rc_g, out_g, err_g, wall_g = run_cli(argv + ["--device", device])
    launches = dict(kernels.LAUNCHES)
    ovl = dict(ovl_align.STATS)
    rc_c, out_c, err_c, wall_c = run_cli(argv + ["--device", "cpu"])
    if rc_g or rc_c:
        fail(f"small CLI run failed: {err_g[-2000:]} {err_c[-2000:]}")
    same = out_g == out_c and len(out_g) > 0
    emit("small", bytes=len(out_g), identical=same, wall_s_gpu=wall_g,
         wall_s_cpu=wall_c, launches=launches, ovl=ovl)
    if not same:
        fail("small run: --device cuda and --device cpu FASTA differ")
    if ovl["device_jobs"] <= 0:
        fail("small run: no overlap was aligned on the card")


def consensus_seconds(err: str) -> float:
    m = re.findall(r"generated consensus ([0-9.]+) s", err)
    return float(m[-1]) if m else float("nan")


def phase_seconds(err: str) -> dict:
    """Seconds of each logger phase line (``[...] <phase> <s> s``)."""
    return {name: float(sec) for name, sec in re.findall(
        r"^\[racon_tpu_torch::Polisher::\w+\] ([a-z ]+?) ([0-9.]+) s$",
        err, flags=re.M)}


def routed(err: str):
    flagged = sum(int(x) for x in re.findall(
        r"(\d+) window\(s\) flagged", err))
    host = sum(int(x) for x in re.findall(
        r"(\d+) window\(s\) unresolved", err))
    return flagged, host


def phase_main(device, tmp, n_contigs=20, contig_len=50000,
               read_len=10000, coverage=30):
    import torch
    from racon_tpu_torch.ops import device_poa, kernels, ovl_align
    from racon_tpu_torch.utils.synth import edit_distance, write_dataset
    t0 = time.perf_counter()
    ds = write_dataset(os.path.join(tmp, "main"), seed=7,
                       n_contigs=n_contigs, contig_len=contig_len,
                       read_len=read_len, coverage=coverage,
                       draft_err=0.03, read_err=0.08)
    synth_s = time.perf_counter() - t0
    p = ds["paths"]
    n_windows = sum(-(-len(d) // 500) for d in ds["drafts"])
    argv = [p["reads"], p["overlaps"], p["draft"], "-t",
            str(os.cpu_count() or 1), "--device", device]
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    clock = device_poa.set_stage_clock(True)
    ovl_align.reset_stats()
    kernels.reset_launches()
    rc, out, err, wall = run_cli(argv)
    launches = dict(kernels.LAUNCHES)
    ovl = dict(ovl_align.STATS)
    groups = [dict(g) for g in ovl_align.TILED_GROUPS]
    ugroups = [dict(g) for g in ovl_align.UNTILED_GROUPS]
    stages = clock.ms()
    walks = clock.launches().get("walk", {}).get("col_walk", 0)
    k1_consensus = clock.launches().get("forward", {}).get("band_fwd", 0)
    device_poa.set_stage_clock(False)
    if rc:
        fail(f"main run failed: {err[-3000:]}")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    recs = fasta_records(out)
    ed_draft = ed_pol = 0
    for c, (t, d) in enumerate(zip(ds["truth"], ds["drafts"])):
        pol = recs.get(f"ctg{c}")
        if pol is None or len(pol) == 0:
            fail(f"main run: contig ctg{c} missing from the output")
        ed_draft += edit_distance(d, t)
        ed_pol += edit_distance(pol, t)
    cons_s = consensus_seconds(err)
    phases = phase_seconds(err)
    flagged, host = routed(err)
    emit("main", draft_bp=sum(len(d) for d in ds["drafts"]),
         windows=n_windows, synth_s=synth_s, wall_s=wall,
         consensus_s=cons_s, windows_per_s=n_windows / cons_s,
         windows_per_s_end_to_end=n_windows / wall,
         align_s=phases.get("aligned overlaps"), phase_s=phases,
         ovl=ovl, tiled_groups=groups, untiled_groups=ugroups,
         stage_ms=stages,
         max_memory_allocated=peak,
         launches=launches, consensus_walks=walks, redo_windows=flagged,
         host_windows=host,
         ed_draft=ed_draft, ed_polished=ed_pol)
    for name in ("band_fwd", "band_tile_fwd", "col_walk"):
        if launches[name] <= 0:
            fail(f"main run: {name} never launched")
    if walks <= 0:
        fail("main run: the consensus engine never launched col_walk")
    if ovl["device_jobs"] <= 0:
        fail("main run: no overlap was aligned on the card")
    # One K3 launch a tile of each group; a bucket of several chunks runs
    # in groups of more than one.
    tile_launches = sum(g["groups"] * (g["Lq"] // g["T"]) for g in groups)
    if not launches["band_tile_fwd"] == ovl["tiles"] == tile_launches:
        fail(f"main run: band_tile_fwd launched {launches['band_tile_fwd']} "
             f"times, not groups x tiles = {tile_launches}")
    for g in groups + ugroups:
        if g["chunks"] > 1 and (g["G"] <= 1 or g["groups"] >= g["chunks"]):
            fail(f"main run: bucket {g} was not grouped")
    # One K1 launch and one walk for each untiled group, beside the
    # consensus forward's K1 launches.
    untiled = sum(g["groups"] for g in ugroups)
    if launches["band_fwd"] != k1_consensus + untiled:
        fail(f"main run: band_fwd launched {launches['band_fwd']} times, not "
             f"{k1_consensus} consensus + {untiled} untiled groups")
    if "aligned overlaps" not in phases:
        fail("main run: the logger printed no 'aligned overlaps' phase")
    if not ed_pol * 3 <= ed_draft:
        fail(f"main run: polished ED {ed_pol} > draft ED {ed_draft} / 3")
    # W1's launches by case: the tiled groups, the consensus walks and the
    # untiled groups; K1's: the consensus forward and the untiled groups.
    tiled = sum(g["groups"] for g in groups)
    if launches["col_walk"] != tiled + walks + untiled:
        fail(f"main run: col_walk launched {launches['col_walk']} times, not "
             f"{tiled} tiled + {walks} consensus + {untiled} untiled")
    by_case = {("col_walk", 0): tiled, ("col_walk", "consensus"): walks,
               ("col_walk", "untiled"): untiled,
               ("band_fwd", 4): k1_consensus, ("band_fwd", "untiled"): untiled}
    return launches, by_case, p


def phase_flat(device, tmp, contig_len=100000):
    from racon_tpu_torch.ops import device_poa, kernels
    from racon_tpu_torch.utils.synth import write_dataset
    ds = write_dataset(os.path.join(tmp, "flat"), seed=9,
                       contig_len=contig_len, read_len=10000, coverage=30,
                       draft_err=0.03)
    p = ds["paths"]
    os.environ["RACON_TPU_NO_BAND"] = "1"
    clock = device_poa.set_stage_clock(True)
    try:
        kernels.reset_launches()
        rc, out, err, wall = run_cli([p["reads"], p["overlaps"], p["draft"],
                                      "-t", str(os.cpu_count() or 1),
                                      "--device", device])
        launches = dict(kernels.LAUNCHES)
    finally:
        del os.environ["RACON_TPU_NO_BAND"]
        device_poa.set_stage_clock(False)
    if rc or not out:
        fail(f"flat-path run failed: {err[-3000:]}")
    # The overlap chunks walk the band layout; the consensus, the flat one.
    walks = clock.launches().get("walk", {}).get("col_walk", 0)
    emit("flat_path", wall_s=wall, consensus_s=consensus_seconds(err),
         launches=launches, consensus_walks=walks)
    if launches["flat_fwd"] <= 0:
        fail("flat-path run: flat_fwd never launched")
    if walks <= 0:
        fail("flat-path run: the consensus engine never launched col_walk")
    return dict(launches, col_walk_flat=walks)


def path_score(q, t, ops, m, x, g):
    """Score of an op string, or None when it does not consume exactly q
    and t."""
    cq = ops != 2
    ct = ops != 1
    if int(cq.sum()) != len(q) or int(ct.sum()) != len(t):
        return None
    d = ops == 0
    qi = (np.cumsum(cq) - cq)[d]
    ti = (np.cumsum(ct) - ct)[d]
    eq = int((q[qi] == t[ti]).sum())
    nd = int(d.sum())
    return m * eq + x * (nd - eq) + g * (len(ops) - nd)


def longest_insertion(ops) -> int:
    edges = np.diff(np.concatenate([[0], (ops == 1).astype(np.int8), [0]]))
    starts, ends = np.flatnonzero(edges == 1), np.flatnonzero(edges == -1)
    return int((ends - starts).max()) if len(starts) else 0


def phase_op_strings(device, paths, n_contigs=5, device_batch=4096):
    """The batched aligner's route at full size (see the module
    docstring, phase 6). Returns its launch counts."""
    import torch
    from racon_tpu_torch.models.polisher import PolisherType, create_polisher
    from racon_tpu_torch.models.window import window_arrays
    from racon_tpu_torch.native.aligner import NativeAligner
    from racon_tpu_torch.ops import device_merge as dm
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.align import PAD_OP
    from racon_tpu_torch.ops.poa import PoaEngine
    m, x, g = 5, -4, -8
    threads = os.cpu_count() or 1
    t0 = time.perf_counter()
    pol = create_polisher(paths["reads"], paths["overlaps"], paths["draft"],
                          PolisherType.kC, 500, 10.0, 0.3, m, x, g,
                          device=device, threads=threads)
    pol.initialize()
    windows = [w for w in pol.windows if w.id < n_contigs and
               w.n_layers >= 2]
    eng = PoaEngine(m, x, g, device=device, device_batch=device_batch,
                    threads=threads)
    eng.stats = {}
    anchors, jobs = [], []
    for wi, w in enumerate(windows):
        lays, bb, bw = window_arrays(w)
        anchors.append((bb, bw))
        jobs.extend(eng._build_jobs(wi, bb, [(c, wt) for c, wt, _, _ in lays],
                                    [(b, e) for _, _, b, e in lays]))
    setup_s = time.perf_counter() - t0

    kernels.reset_launches()
    t0 = time.perf_counter()
    eng._align(jobs)
    torch.cuda.synchronize()
    align_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    B = len(jobs)
    S = max(len(j.ops) for j in jobs)
    Lq = max(len(j.q) for j in jobs)
    LA = max(len(bb) for bb, _ in anchors) + 8
    ops = np.full((B, S), PAD_OP, np.uint8)
    q = np.zeros((B, Lq), np.uint8)
    qw = np.zeros((B, Lq), np.float32)
    for b, j in enumerate(jobs):
        ops[b, S - len(j.ops):] = j.ops
        q[b, :len(j.q)] = j.q
        qw[b, :len(j.q)] = j.w
    col = [np.array([getattr(j, a) for j in jobs], dt) for a, dt in (
        ("w_read", np.float32), ("t_len", np.int32), ("t_off", np.int32),
        ("win", np.int32))]
    Nw = len(anchors)
    bb_pad = np.zeros((Nw, LA), np.uint8)
    bbw_pad = np.zeros((Nw, LA), np.float32)
    alen = np.array([len(bb) for bb, _ in anchors], np.int32)
    for wi, (bb, bw) in enumerate(anchors):
        bb_pad[wi, :len(bb)] = bb
        bbw_pad[wi, :len(bb)] = bw
    dv = [torch.from_numpy(a).to(device) for a in (ops, q, qw, *col)]
    bb_d, bbw_d, alen_d = (torch.from_numpy(a).to(device)
                           for a in (bb_pad, bbw_pad, alen))
    votes = dm.extract_votes(*dv[:6], LA)
    acc = dm.aggregate_votes(votes, dv[6], Nw)
    del votes
    acc = dm.add_backbone(acc, bb_d, bbw_d, alen_d)
    asm = dm.assemble(acc, alen_d, eng.ins_scale)
    codes, cov, total = (a.cpu().numpy() for a in dm.compact(asm, LA + 64))
    map_b, map_e = (a.cpu().numpy() for a in dm.coord_maps(asm, alen_d, LA))
    merge_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    del acc, asm, dv

    nat = NativeAligner(m, x, g, threads=threads).align_batch(
        [(j.q, j.t) for j in jobs])
    bad_paths = 0
    for j, o in zip(jobs, nat):
        sc = path_score(j.q, j.t, j.ops, m, x, g)
        bad_paths += sc is None or sc != path_score(j.q, j.t, o, m, x, g)
    host = eng._merge_round(anchors, jobs)
    long_ins = {j.win for j in jobs if longest_insertion(j.ops) > dm.K_INS}
    differ = []
    for wi, (cons, hcov, mb, me) in enumerate(host):
        L = len(cons)
        if not (total[wi] == L and np.array_equal(codes[wi, :L], cons) and
                np.array_equal(cov[wi, :L], hcov) and
                np.array_equal(map_b[wi, :len(mb)], mb) and
                np.array_equal(map_e[wi, :len(me)], me)):
            differ.append(wi)
    unexplained = [wi for wi in differ if wi not in long_ins]
    shapes = eng.stats["align_shapes"]
    emit("op_strings", contigs=n_contigs, windows=Nw, jobs=B,
         batches=len(shapes), batch_shapes=shapes, launches=launches,
         setup_s=setup_s, align_s=align_s, merge_s=merge_s,
         route_s=align_s + merge_s, merge_shape=[B, S, LA + 2],
         path_score_mismatches=bad_paths,
         windows_equal=Nw - len(differ),
         long_insertion_windows=sorted(long_ins),
         long_insertion_windows_differing=sorted(set(differ) & long_ins),
         windows_differing_unexplained=unexplained)
    if bad_paths:
        fail(f"op strings: {bad_paths} of {B} paths do not score what the "
             "native aligner's path scores")
    if unexplained:
        fail(f"op strings: windows {unexplained[:20]} differ from the host "
             "merge without an insertion run longer than K_INS")
    for name in ("nw_fwd", "nw_traceback", "monotone_count"):
        if launches[name] <= 0:
            fail(f"op strings: {name} never launched")
    if max(sh[0] for sh in shapes) < eng.device_batch:
        fail(f"op strings: no batch of {eng.device_batch} lanes ({shapes})")
    return launches


def main() -> int:
    global CARD
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    try:
        from racon_tpu_torch.native.build import shared_library_path
        from racon_tpu_torch.ops import kernels
    except ImportError as exc:
        fail(f"racon_tpu_torch is not importable here ({exc})")
    CARD = card()
    t0 = time.perf_counter()
    kernels.build()
    shared_library_path()
    build_s = time.perf_counter() - t0
    emit("build", seconds=build_s, band_kernels=phase_build_occupancy())

    recs = phase_kernels("cuda")
    recs.update({(n, 0): r for n, r in phase_overlap_kernels("cuda").items()})
    recs.update(phase_untiled_overlap_kernels("cuda"))
    recs.update(phase_op_string_kernels("cuda"))
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        phase_small("cuda", tmp)
        main_launches, main_by_case, main_paths = phase_main("cuda", tmp)
        flat_launches = phase_flat("cuda", tmp)
        op_launches = phase_op_strings("cuda", main_paths)

    rows = []
    for (name, k), r in recs.items():
        if (name, k) == ("band_fwd", 2):
            continue
        # Each kernel's launches on the path that runs it: the band-off
        # path for K2 and the flat walk, the op-string route for K4 (each
        # variant its own count), T1 and K5 (at the merge's shape; the
        # T1 op-string shape is not one the route launches), the main
        # path for the rest; K1's and W1's by case.
        if k == "flat":
            launches = flat_launches["col_walk_flat"]
        elif (name, k) in main_by_case:
            launches = main_by_case[(name, k)]
        elif (name, k) == ("monotone_count", "T1"):
            launches = 0
        else:
            launches = (flat_launches if name == "flat_fwd" else
                        op_launches if name in ("nw_fwd", "nw_fwd_wide",
                                                "nw_traceback",
                                                "monotone_count")
                        else main_launches)[name]
        label = {"flat": "flat layout", "untiled": "untiled overlap group",
                 "consensus": "consensus", 4: "consensus",
                 0: "tiled overlap group", "merge": "route merge shape",
                 "T1": "T1 op strings"}
        rows.append({
            "name": (f"{name} ({label[k]})"
                     if name in ("col_walk", "band_fwd", "monotone_count")
                     else name),
            "route": "cuda",
            "source": f"racon_tpu_torch/csrc/{SOURCE[name]}",
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            **{n: r[n] for n in ("shape", "bucket_ms", "chunks_ms", "G",
                                 "chain_floor_ms", "serial_floor_ms",
                                 "windows_per_lane", "misses_per_lane",
                                 "wide_ms", "eager_ms", "eager_library_ms",
                                 "C", "regs", "spills", "blocks_per_sm",
                                 "smem_per_block") if n in r}})
    print(json.dumps({"kernels": rows}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


CARD = ""

if __name__ == "__main__":
    sys.exit(main())
