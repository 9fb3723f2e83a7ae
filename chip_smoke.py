"""Chip smoke of the PyTorch/CUDA port (racon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line with the card's name and power limit;
any failure exits non-zero and prints no result):

1. build      the CUDA kernels (csrc/*.cu, one nvcc per source, started
              together) and the host C++ aligner, from this checkout;
2. kernels    each kernel against its plain PyTorch version on the card,
              bitwise, at the main path's shapes; kernel and plain times
              from CUDA events: band_fwd (K1) at the consensus shape and
              on an untiled overlap chunk (128 lanes, Lq=6144, W=1024,
              k=4), band_tile_fwd (K3) at the overlap tile shape from a
              previous tile's frontier, flat_fwd (K2), and col_walk (W1)
              on a stitched overlap chunk (tiled, int32), on the untiled
              chunk (int16), at the consensus shape (k=4, int16) and on
              K2's full-width planes (flat layout, k=1). Each walk also
              prints its chain floor: its chain_len dependent loads timed
              alone (csrc/probe.cu). Then the op-string route's kernels
              at its batch shape: nw_fwd (K4), nw_traceback (T1, with its
              chain floor) on K4's planes, and monotone_count (K5) on
              T1's op strings, timed beside torch.searchsorted;
3. small      the CLI on a ~20 kb synthetic input with --device cuda and
              --device cpu: the FASTA must be byte-identical (the cuda run
              aligns the overlaps on the card, untiled; the cpu run with
              the host aligner);
4. main       the main path at full size through the CLI entry point: a
              1 Mbp synthetic draft (20 contigs x 50 kb), 10 kb reads at
              30x, PAF overlaps aligned on the card (tiled route), w=500.
              Launch counts reset just before and read just after;
              band_fwd, band_tile_fwd and col_walk must have launched, the
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
# (2) and the code packed into its stored word (2); the kernel's second
# pass, which recomputes diag and up after the scan, is not counted.
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
    "nw_traceback": "racon_tpu/ops/align.py:75",
    "monotone_count": "racon_tpu/ops/pallas/count_kernel.py:33",
}
SOURCE = {"band_fwd": "band_fwd.cu", "band_tile_fwd": "band_fwd.cu",
          "flat_fwd": "flat_fwd.cu", "col_walk": "col_walk.cu",
          "nw_fwd": "nw_fwd.cu", "nw_traceback": "nw_traceback.cu",
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


def max_abs_err(ref, out) -> int:
    import torch
    err = 0
    for r, o in zip(ref, out):
        if r is None or o is None:
            if (r is None) != (o is None):
                return 1 << 30
            continue
        if r.dtype == torch.uint16:
            r, o = r.view(torch.int16), o.view(torch.int16)
        if r.dtype in (torch.int16, torch.uint8):
            r = r.to(torch.int32) & (0xFFFF if r.dtype == torch.int16
                                     else 0xFF)
            o = o.to(torch.int32) & (0xFFFF if o.dtype == torch.int16
                                     else 0xFF)
        d = (r.to(torch.int64) - o.to(torch.int64)).abs().max().item()
        err = max(err, int(d))
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


def walk_case(case, cells, lq, lt, klo, t_off, extra_bytes=0, **wk):
    """W1 against its plain version (bitwise) on one walk, with its time,
    the plain time, the bytes bound and the chain floor: every lane's
    chain_len dependent loads, k plane rows apart, made with no other
    work by the latency probe (csrc/probe.cu) in this run. Returns the
    record."""
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
    bms, by = bound(B * chain * k + B * (LA + 2) * 4 * esize + 16 * B +
                    extra_bytes, 0)
    # The walk's addresses: lanes W bytes apart, k plane rows a step.
    floor_ms = chain_floor_ms(cells.device, chain, k * B * W, B, W)
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, chain_floor_ms=floor_ms)
    emit("kernels", kernel="col_walk", case=case, nxt_k=k,
         shape=[B, cells.shape[0], W], LA=LA, emit=f"int{8 * esize}",
         chain_len=chain, **rec)
    if err:
        fail(f"col_walk ({case}) disagrees with its plain version "
             f"(max_abs_err={err})")
    return rec


def phase_overlap_kernels(device, B=64, L=9900, W=1536, T=2048):
    """K3 at the main-path tile (64 lanes, T=2048, W=1536, k=2) from a
    previous tile's frontier, then W1 over the stitched 5-tile planes
    (LA = 10240, tiled, int32); both bitwise against their plain
    versions."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.band import (band_targets,
                                          fw_dirs_band_tile_plain,
                                          row0_scores, uc_boundary)
    c = overlap_chunk(device, B, L, W, T)
    Lq = c["Lq"]
    k = 2
    sc = dict(match=0, mismatch=-1, gap=-1, W=W, nxt_k=k)
    qT = c["q"].t().contiguous()
    base = torch.arange(B, dtype=torch.int64, device=device) * Lq
    planes = (torch.empty((Lq, B, W), dtype=torch.uint8, device=device),
              torch.empty((Lq, B, W), dtype=torch.uint8, device=device),
              None)
    prev = row0_scores(c["klo"], W, -1)
    front = (prev, torch.full((B, W), uc_boundary(k), dtype=torch.int32,
                              device=device), prev.clone())

    def tile_args(ti):
        tb = band_targets(c["t"].reshape(-1), base, c["klo"], c["lt"],
                          W + T, origin=ti * T)
        return (tb, qT[ti * T:(ti + 1) * T], c["klo"], c["lq"], ti * T)

    recs = {}
    for ti in range(Lq // T):
        args = tile_args(ti)
        out = kernels.fw_dirs_band_tile(*args, *front, out=planes, **sc)
        if ti == 1:
            # Tile 1 starts from tile 0's frontier, as on the main path.
            ref, plain_ms = timed_once(lambda: fw_dirs_band_tile_plain(
                *args, *front, **sc))
            err = max_abs_err(ref, out)
            del ref
            ms = time_ms(lambda: kernels.fw_dirs_band_tile(
                *args, *front, out=planes, **sc))
            bms, by = band_bound(B, T, W, k, tiled=True)
            recs["band_tile_fwd"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by)
            emit("kernels", kernel="band_tile_fwd", nxt_k=k, shape=[B, T, W],
                 i0=ti * T, **recs["band_tile_fwd"])
            if err:
                fail(f"band_tile_fwd disagrees with its plain version "
                     f"(max_abs_err={err})")
        front = out[3:]
    klos = c["klo"][None, :].repeat(Lq // T, 1).contiguous()
    recs["col_walk"] = walk_case(
        "overlap tiled", planes[0], c["lq"], c["lt"], None,
        torch.zeros_like(c["lq"]), extra_bytes=4 * klos.numel(), LA=Lq,
        layout="band", nxt=planes[1], tile_klo=klos, tile_len=T,
        emit=torch.int32)
    return recs


def phase_untiled_overlap_kernels(device, B=128, L=5400, W=1024):
    """K1 and W1 on an untiled overlap chunk as phase 3 and the main
    path's short reads run it (128 lanes of ~5.4 kb, W=1024, Lq = LA =
    6144, the untiled route's walk depth, int16 emission): both bitwise
    against their plain versions."""
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
         bound_ms=bms, bound_by=by)
    if err:
        fail(f"band_fwd (overlap untiled) disagrees with its plain version "
             f"(max_abs_err={err})")
    cells, nxt, nxt2, _ = out
    walk_case("overlap untiled", cells, c["lq"], c["lt"], c["klo"],
              torch.zeros_like(c["lq"]), LA=Lq, layout="band", nxt=nxt,
              nxt2=nxt2)


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
            # W1 at the consensus shape (k=4, int16) on these planes.
            rng = np.random.default_rng(4)
            t_off = torch.from_numpy(rng.integers(0, 48, B).astype(
                np.int32)).to(device)
            walk_case("consensus", out[0], args[3], lt, args[2], t_off,
                      LA=int(lt.max().item()) + 48, layout="band",
                      nxt=out[1], nxt2=out[2])
        del out
        ms = time_ms(run_k)
        plain_ms = time_ms(run_p, reps=1)
        bms, by = band_bound(B, Lq, W, k)
        recs[("band_fwd", k)] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bms,
                                     bound_by=by)
        emit("kernels", kernel="band_fwd", case="consensus", nxt_k=k,
             shape=[B, Lq, W], **recs[("band_fwd", k)])
        if err:
            fail(f"band_fwd k={k} disagrees with its plain version "
                 f"(max_abs_err={err})")
    del args
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


def phase_op_string_kernels(device, B=4096, Lq=640, Lt=512):
    """K4, T1 and K5 at the op-string route's batch shape, each bitwise
    against its plain version: K4 on route-like pairs, T1 on K4's planes
    (with its chain floor), K5 on the block keys of T1's op strings with
    P = LA + 2 (LA = Lt), timed beside torch.searchsorted, which computes
    the same counts on these non-decreasing keys."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.align import (PAD_OP, nw_dirs_plain,
                                           traceback_plain)
    from racon_tpu_torch.ops.device_merge import (block_keys,
                                                  monotone_count_plain)
    q, t, lq, lt = nw_pairs(device, B, Lq, Lt)
    sc = dict(match=5, mismatch=-4, gap=-8)
    recs = {}

    def record(name, err, **kw):
        recs[name] = dict(max_abs_err=err, **kw)
        emit("kernels", kernel=name, max_abs_err=err, **kw)
        if err:
            fail(f"{name} disagrees with its plain version "
                 f"(max_abs_err={err})")

    dirs = kernels.nw_dirs(q, t, **sc)
    ref, plain_ms = timed_once(lambda: nw_dirs_plain(q, t, **sc))
    err = max_abs_err([ref], [dirs])
    del ref
    ms = time_ms(lambda: kernels.nw_dirs(q, t, **sc))
    cells = B * Lq * Lt
    bms, by = bound(B * (Lq + Lt) + cells,
                    cells * OPS_PER_CELL[("nw_fwd", 0)])
    record("nw_fwd", err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
           bound_by=by, library_ms=None, shape=[B, Lq, Lt])

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
    record("nw_traceback", err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
           bound_by=by, library_ms=None, chain_floor_ms=floor_ms,
           shape=[B, Lq, Lt], steps=steps, max_n=int(n.max().item()))
    del dirs

    rng = np.random.default_rng(11)
    t_off = torch.from_numpy((rng.random(B) * (Lt - lt.cpu().numpy() + 1))
                             .astype(np.int32)).to(device)
    Xs = block_keys(ops, t_off)
    P = Lt + 2
    S = Xs.shape[1]
    F = kernels.monotone_count(Xs, P)
    ref, plain_ms = timed_once(lambda: monotone_count_plain(Xs, P))
    err = max_abs_err([ref], [F])
    del ref
    ms = time_ms(lambda: kernels.monotone_count(Xs, P))
    pa = torch.arange(P, dtype=torch.int32, device=device).expand(
        B, P).contiguous()
    lib_same = torch.equal(torch.searchsorted(Xs, pa).to(torch.int32), F)
    lib_ms = time_ms(lambda: torch.searchsorted(Xs, pa))
    bms, by = bound(4 * B * (S + P), B * (OPS_PER_X * S + OPS_PER_BIN * P))
    record("monotone_count", err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
           bound_by=by, library_ms=lib_ms, shape=[B, S, P],
           library_equal=lib_same)
    if not lib_same:
        fail("torch.searchsorted disagrees with monotone_count on "
             "non-decreasing keys")
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
    stages = clock.ms()
    walks = clock.launches().get("walk", {}).get("col_walk", 0)
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
         ovl=ovl, stage_ms=stages, max_memory_allocated=peak,
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
    if "aligned overlaps" not in phases:
        fail("main run: the logger printed no 'aligned overlaps' phase")
    if not ed_pol * 3 <= ed_draft:
        fail(f"main run: polished ED {ed_pol} > draft ED {ed_draft} / 3")
    return launches, p


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
    emit("build", seconds=time.perf_counter() - t0)

    recs = phase_kernels("cuda")
    recs.update({(n, 0): r for n, r in phase_overlap_kernels("cuda").items()})
    phase_untiled_overlap_kernels("cuda")
    recs.update({(n, 0): r for n, r in
                 phase_op_string_kernels("cuda").items()})
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        phase_small("cuda", tmp)
        main_launches, main_paths = phase_main("cuda", tmp)
        flat_launches = phase_flat("cuda", tmp)
        op_launches = phase_op_strings("cuda", main_paths)

    rows = []
    for (name, k), r in recs.items():
        if name == "band_fwd" and k != 4:
            continue
        # Each kernel's launches on the path that runs it: the band-off
        # path for K2 and the flat walk, the op-string route for K4, T1
        # and K5, the main path for the rest.
        if k == "flat":
            launches = flat_launches["col_walk_flat"]
        else:
            launches = (flat_launches if name == "flat_fwd" else
                        op_launches if name in ("nw_fwd", "nw_traceback",
                                                "monotone_count")
                        else main_launches)[name]
        rows.append({
            "name": name if k != "flat" else f"{name} (flat layout)",
            "route": "cuda",
            "source": f"racon_tpu_torch/csrc/{SOURCE[name]}",
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            **({"chain_floor_ms": r["chain_floor_ms"]}
               if "chain_floor_ms" in r else {})})
    print(json.dumps({"kernels": rows}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


CARD = ""

if __name__ == "__main__":
    sys.exit(main())
