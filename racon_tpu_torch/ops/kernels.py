"""The port's CUDA kernels: build, binding and wrappers.

Hand-written Hopper kernels replace the JAX package's Pallas kernels and
its column-walk scan:

- ``band_fwd`` (csrc/band_fwd.cu) — racon_tpu/ops/pallas/band_kernel.py
  ``_kernel``; plain version ops/band.py::fw_dirs_band_plain;
- ``band_tile_fwd`` (csrc/band_fwd.cu, same body) — band_kernel.py
  ``_kernel_tile``; plain version ops/band.py::fw_dirs_band_tile_plain;
- ``flat_fwd`` (csrc/flat_fwd.cu) — racon_tpu/ops/pallas/flat_kernel.py
  ``_kernel``; plain version ops/flat.py::fw_dirs_flat_plain;
- ``col_walk`` (csrc/col_walk.cu) — the XLA scan racon_tpu/ops/colwalk.py
  ``col_walk``; plain version ops/colwalk.py::col_walk. The overlap
  aligner (ops/ovl_align.py) and the consensus engine (ops/device_poa.py,
  band and flat layouts) run it;
- ``nw_fwd`` (csrc/nw_fwd.cu) — racon_tpu/ops/pallas/nw_kernel.py
  ``_kernel``; plain version ops/align.py::nw_dirs_plain. Two variants,
  the warp kernel (``nw_fwd``) and the wide kernel (``nw_fwd_wide`` in
  ``LAUNCHES``), picked by shape by ``nw_plan``;
- ``nw_traceback`` (csrc/nw_traceback.cu) — the XLA scan
  racon_tpu/ops/align.py ``_traceback_flat``; plain version
  ops/align.py::traceback_plain. One warp a lane walks windows of the
  plane staged in shared memory, planned by ``traceback_plan``;
- ``monotone_count`` (csrc/count.cu) — racon_tpu/ops/pallas/
  count_kernel.py ``_kernel``; plain version
  ops/device_merge.py::monotone_count_plain;
- ``merge_votes`` (M1) and ``merge_windows`` (M2) (csrc/merge.cu) — the
  XLA ops of the reference's round merge, racon_tpu/ops/device_merge.py
  (extract_votes_cols, aggregate_votes; add_backbone, assemble, compact,
  coord_maps) and the remap of racon_tpu/ops/device_poa.py; plain
  versions ops/device_merge.py::merge_votes_plain and
  ::merge_windows_plain. ``merge_windows_sched`` is M2's sched mode, the
  convergence scheduler's round merge (the reference's
  racon_tpu/sched/rounds.py ``_sched_core`` and ``sched_rounds``'
  scatter); plain version ::merge_windows_sched_plain.

``chase`` (csrc/probe.cu) ports nothing: it times a chain of dependent
loads, through device memory (the floor of a walk that loads every step
from there) or through shared memory (one on-chip step of the windowed
walk's serial chain), for chip_smoke.py.
``band_occupancy`` reads what a band kernel instantiation gets on the
card (resident blocks an SM, registers, spills); the overlap aligner's
group planner sizes a tiled launch from it. ``walk_plan`` sizes a walk
launch (threads a lane, window shape, lanes a block) from the lane count,
the walk depth and the SM count, and ``walk_occupancy`` reads what a plan
gets on the card. ``nw_plan``, ``traceback_plan`` and ``count_plan`` size
the K4, T1 and K5 launches from the shape; ``nw_occupancy``,
``traceback_occupancy`` and ``count_occupancy`` read what they get on the
card, and ``merge_occupancy`` what M1 and M2 get.

The sources compile on first use with ``nvcc`` (one process per source,
started together, then one link) into a shared library with a plain C
interface in the port's build directory, keyed by a hash of the sources
and flags; ctypes loads it. Nothing is built or imported at module
import time.

Each wrapper sends a CPU tensor to the plain version and a CUDA tensor
to its kernel (or raises: there is no fallback). ``LAUNCHES`` counts
kernel launches per wrapper of a port kernel and is touched nowhere
else.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import torch

from racon_tpu_torch.native.build import (build_dir, content_tag,
                                          run_build)
from racon_tpu_torch.ops.align import PAD_OP, nw_dirs_plain, traceback_plain
from racon_tpu_torch.ops.band import (fw_dirs_band_plain,
                                      fw_dirs_band_tile_plain)
from racon_tpu_torch.ops.colwalk import col_walk
from racon_tpu_torch.ops.device_merge import (EPS, VOTE_CH,
                                              merge_votes_plain,
                                              merge_windows_plain,
                                              merge_windows_sched_plain,
                                              monotone_count_plain)
from racon_tpu_torch.ops.flat import fw_dirs_flat_plain

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
SOURCES = ("band_fwd.cu", "flat_fwd.cu", "col_walk.cu", "nw_fwd.cu",
           "nw_traceback.cu", "count.cu", "merge.cu", "probe.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

LAUNCHES = {"band_fwd": 0, "band_tile_fwd": 0, "flat_fwd": 0,
            "col_walk": 0, "nw_fwd": 0, "nw_fwd_wide": 0, "nw_traceback": 0,
            "monotone_count": 0, "merge_votes": 0, "merge_windows": 0,
            "merge_windows_sched": 0}
# Shared memory a block may use on an H100 (opt-in maximum).
SMEM_MAX = 232448

_LOCK = threading.Lock()
_LIB = None


class KernelError(RuntimeError):
    pass


# LAUNCHES is updated under this lock: the streaming pipeline launches
# from two threads (its compute and walk stages). Each thread also keeps
# its own counts, which the stage clock reads (thread_launches).
_COUNT_LOCK = threading.Lock()
_THREAD = threading.local()


def _launched(name: str) -> None:
    """Count one launch of kernel ``name`` (every wrapper calls this right
    after its kernel launched, and nowhere else)."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
    own = getattr(_THREAD, "launches", None)
    if own is None:
        own = _THREAD.launches = {}
    own[name] = own.get(name, 0) + 1


def thread_launches() -> dict:
    """The calling thread's launches so far, by kernel (never reset)."""
    return dict(getattr(_THREAD, "launches", {}))


def credit_thread_launches(counts: dict) -> None:
    """Add launches another thread made on this thread's behalf to this
    thread's own counts (the watchdog's guard runs a body on a worker
    thread; LAUNCHES already holds them)."""
    own = getattr(_THREAD, "launches", None)
    if own is None:
        own = _THREAD.launches = {}
    for name, n in counts.items():
        own[name] = own.get(name, 0) + n


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build() -> str:
    """Compile the kernels (if the hashed library is missing); returns
    the library path."""
    srcs = [os.path.join(_CSRC, s) for s in SOURCES]
    tag = content_tag(srcs, NVCC_FLAGS)
    out = build_dir()
    lib = os.path.join(out, f"libracon_kernels.{tag}.so")
    if os.path.isfile(lib):
        return lib
    nvcc = _nvcc()
    pid = os.getpid()
    objs = [os.path.join(out, f"{os.path.splitext(s)[0]}.{tag}.{pid}.o")
            for s in SOURCES]
    run_build([[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
               for src, obj in zip(srcs, objs)])
    tmp = f"{lib}.{pid}.tmp"
    run_build([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                "-shared", *objs, "-o", tmp]])
    os.replace(tmp, lib)
    for o in objs:
        os.unlink(o)
    return lib


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.racon_band_fwd.restype = ci
            lib.racon_band_fwd.argtypes = [vp] * 8 + [ci] * 7 + [vp]
            lib.racon_band_tile_fwd.restype = ci
            lib.racon_band_tile_fwd.argtypes = [vp] * 13 + [ci] * 8 + [vp]
            lib.racon_band_occupancy.restype = ci
            lib.racon_band_occupancy.argtypes = [ci] * 4 + [vp]
            lib.racon_flat_fwd.restype = ci
            lib.racon_flat_fwd.argtypes = [vp] * 3 + [ci] * 6 + [vp]
            lib.racon_col_walk.restype = ci
            lib.racon_col_walk.argtypes = [vp] * 11 + [ci] * 13 + [vp]
            lib.racon_col_walk_occupancy.restype = ci
            lib.racon_col_walk_occupancy.argtypes = [ci] * 5 + [vp]
            lib.racon_nw_fwd.restype = ci
            lib.racon_nw_fwd.argtypes = [vp] * 3 + [ci] * 7 + [vp]
            lib.racon_nw_occupancy.restype = ci
            lib.racon_nw_occupancy.argtypes = [ci] * 3 + [vp]
            lib.racon_nw_traceback.restype = ci
            lib.racon_nw_traceback.argtypes = [vp] * 6 + [ci] * 5 + [vp]
            lib.racon_nw_traceback_occupancy.restype = ci
            lib.racon_nw_traceback_occupancy.argtypes = [ci, vp]
            lib.racon_monotone_count.restype = ci
            lib.racon_monotone_count.argtypes = [vp] * 2 + [ci] * 4 + [vp]
            lib.racon_monotone_count_occupancy.restype = ci
            lib.racon_monotone_count_occupancy.argtypes = [ci] * 2 + [vp]
            lib.racon_merge_votes.restype = ci
            lib.racon_merge_votes.argtypes = ([vp, ctypes.c_longlong] +
                                              [vp] * 11 + [ci] * 5 + [vp])
            lib.racon_merge_windows.restype = ci
            lib.racon_merge_windows.argtypes = ([vp] * 21 + [ci] * 3 +
                                                [ctypes.c_float] * 2 +
                                                [ci] * 3 + [vp] * 5 + [ci] +
                                                [ctypes.c_float] +
                                                [ci] * 2 + [vp])
            lib.racon_merge_windows_scratch.restype = ctypes.c_longlong
            lib.racon_merge_windows_scratch.argtypes = [ci]
            lib.racon_merge_occupancy.restype = ci
            lib.racon_merge_occupancy.argtypes = [ci] * 3 + [vp]
            lib.racon_chase.restype = ci
            lib.racon_chase.argtypes = [vp] + [ci] * 5 + [vp, vp]
            _LIB = lib
    return _LIB


def _check(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if t.device != dev:
        raise KernelError(f"[racon_tpu_torch::kernels] {name} on {t.device}, "
                          f"expected {dev}")
    if t.dtype != dtype:
        raise KernelError(f"[racon_tpu_torch::kernels] {name} dtype "
                          f"{t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise KernelError(f"[racon_tpu_torch::kernels] {name} shape "
                          f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise KernelError(f"[racon_tpu_torch::kernels] {name} must be "
                          "contiguous")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def fw_dirs_band(tband: torch.Tensor, qT: torch.Tensor, klo: torch.Tensor,
                 lq: torch.Tensor, *, match: int, mismatch: int, gap: int,
                 W: int, nxt_k: int = 2):
    """Banded forward: ``(cells u8[Lq,B,W], nxt u8 | None, nxt2 u16 |
    None, hlast i32[B,W])`` (see ops/band.py for the contract).

    tband u8[B, W+Lq], qT u8[Lq, B], klo/lq i32[B]."""
    if tband.device.type == "cpu":
        return fw_dirs_band_plain(tband, qT, klo, lq, match=match,
                                  mismatch=mismatch, gap=gap, W=W,
                                  nxt_k=nxt_k)
    if tband.device.type != "cuda":
        raise KernelError("[racon_tpu_torch::kernels] band_fwd needs a "
                          "CPU or CUDA tensor")
    B = tband.shape[0]
    Lq = qT.shape[0]
    dev = tband.device
    _check(tband, "tband", torch.uint8, (B, W + Lq), dev)
    _check(qT, "qT", torch.uint8, (Lq, B), dev)
    _check(klo, "klo", torch.int32, (B,), dev)
    _check(lq, "lq", torch.int32, (B,), dev)
    _band_block_check(W, Lq, tiled=False)
    k = int(nxt_k)
    cells = torch.empty((Lq, B, W), dtype=torch.uint8, device=dev)
    nxt = (torch.empty((Lq, B, W), dtype=torch.uint8, device=dev)
           if k >= 2 else None)
    nxt2 = (torch.empty((Lq, B, W), dtype=torch.uint16, device=dev)
            if k >= 4 else None)
    hlast = torch.empty((B, W), dtype=torch.int32, device=dev)
    rc = _lib().racon_band_fwd(
        tband.data_ptr(), qT.data_ptr(), klo.data_ptr(), lq.data_ptr(),
        cells.data_ptr(), nxt.data_ptr() if nxt is not None else None,
        nxt2.data_ptr() if nxt2 is not None else None, hlast.data_ptr(),
        B, Lq, W, match, mismatch, gap, k, _stream(dev))
    if rc != 0:
        raise KernelError(f"[racon_tpu_torch::kernels] band_fwd launch "
                          f"failed (cudaError {rc})")
    _launched("band_fwd")
    return cells, nxt, nxt2, hlast


def _band_slots(W: int, *, tiled: bool) -> int:
    """Band slots a thread of the band kernel instantiation for (W, tiled)
    (csrc/band_fwd.cu ``band_spt``): 4 when W % 4 == 0, else 1; the
    untiled kernel (K1) takes 2 at 1024 <= W <= 2048."""
    if not tiled and 1024 <= W <= 2048 and W % 2 == 0:
        return 2
    return 4 if W % 4 == 0 else 1


def _band_block_check(W: int, rows: int, *, tiled: bool) -> None:
    """The band kernels' launch limits: W / _band_slots threads a block,
    and the shared memory of two score rows, the scan scratch and the
    lane's target window and query column."""
    nthr = W // _band_slots(W, tiled=tiled)
    if nthr > 1024:
        raise KernelError(f"[racon_tpu_torch::kernels] band width {W} "
                          "exceeds the kernel's 1024-thread block")
    nthr = -(-nthr // 32) * 32
    shm = 4 * (2 * (W + 1) + 32 + 3 * nthr) + (W + rows) + rows
    if shm > SMEM_MAX:
        raise KernelError(f"[racon_tpu_torch::kernels] band tile of {rows} "
                          f"rows at W={W} needs {shm} bytes of shared "
                          "memory")


def band_occupancy(W: int, rows: int, nxt_k: int, *, tiled: bool) -> dict:
    """What the band kernel instantiation for (W, rows, nxt_k) gets on the
    current card: ``blocks_per_sm`` resident blocks an SM at the launch's
    threads and shared memory, ``regs`` registers a thread, ``spills``
    local-memory bytes a thread (where spills go; 0 means none) and
    ``threads`` a block. Raises KernelError when the query fails or no
    block fits."""
    _band_block_check(W, rows, tiled=tiled)
    out = (ctypes.c_int * 4)()
    rc = _lib().racon_band_occupancy(int(tiled), W, rows, int(nxt_k), out)
    if rc != 0 or out[0] < 1:
        raise KernelError(f"[racon_tpu_torch::kernels] occupancy query of "
                          f"the band kernel (tiled={tiled}, W={W}, "
                          f"rows={rows}, k={nxt_k}) failed (cudaError {rc}, "
                          f"{out[0]} blocks an SM)")
    return {"blocks_per_sm": out[0], "regs": out[1], "spills": out[2],
            "threads": out[3]}


def fw_dirs_band_tile(tband: torch.Tensor, qT: torch.Tensor,
                      klo: torch.Tensor, lq: torch.Tensor, i0: int,
                      prev: torch.Tensor, uc: torch.Tensor,
                      hlast: torch.Tensor, *, match: int, mismatch: int,
                      gap: int, W: int, nxt_k: int, out):
    """One T-row tile of the banded forward with an explicit frontier,
    written in place into rows [i0, i0+T) of the stitched planes ``out =
    (cells, nxt, nxt2)`` [Lq, B, W]. Returns ``(cells, nxt, nxt2, hlast,
    prev, uc)`` (see ops/band.py::fw_dirs_band_tile_plain)."""
    if tband.device.type == "cpu":
        return fw_dirs_band_tile_plain(
            tband, qT, klo, lq, i0, prev, uc, hlast, match=match,
            mismatch=mismatch, gap=gap, W=W, nxt_k=nxt_k, out=out)
    if tband.device.type != "cuda":
        raise KernelError("[racon_tpu_torch::kernels] band_tile_fwd needs a "
                          "CPU or CUDA tensor")
    k = int(nxt_k)
    if k not in (2, 4):
        raise KernelError("[racon_tpu_torch::kernels] band_tile_fwd depth "
                          f"must be 2 or 4, got {k}")
    B = tband.shape[0]
    T = qT.shape[0]
    dev = tband.device
    _check(tband, "tband", torch.uint8, (B, W + T), dev)
    _check(qT, "qT", torch.uint8, (T, B), dev)
    _check(klo, "klo", torch.int32, (B,), dev)
    _check(lq, "lq", torch.int32, (B,), dev)
    for name, t in (("prev", prev), ("uc", uc), ("hlast", hlast)):
        _check(t, name, torch.int32, (B, W), dev)
    _band_block_check(W, T, tiled=True)
    cells, nxt, nxt2 = out
    rows = cells.shape[0]
    if i0 < 0 or i0 + T > rows:
        raise KernelError(f"[racon_tpu_torch::kernels] tile rows "
                          f"[{i0}, {i0 + T}) outside the {rows}-row plane")
    _check(cells, "cells", torch.uint8, (rows, B, W), dev)
    _check(nxt, "nxt", torch.uint8, (rows, B, W), dev)
    if k >= 4:
        _check(nxt2, "nxt2", torch.uint16, (rows, B, W), dev)
    hl_out = torch.empty((B, W), dtype=torch.int32, device=dev)
    p_out = torch.empty_like(hl_out)
    uc_out = torch.empty_like(hl_out)
    rc = _lib().racon_band_tile_fwd(
        tband.data_ptr(), qT.data_ptr(), klo.data_ptr(), lq.data_ptr(),
        prev.data_ptr(), uc.data_ptr(), hlast.data_ptr(), cells.data_ptr(),
        nxt.data_ptr(), nxt2.data_ptr() if k >= 4 else None,
        hl_out.data_ptr(), p_out.data_ptr(), uc_out.data_ptr(), B, T,
        int(i0), W, match, mismatch, gap, k, _stream(dev))
    if rc != 0:
        raise KernelError(f"[racon_tpu_torch::kernels] band_tile_fwd launch "
                          f"failed (cudaError {rc})")
    _launched("band_tile_fwd")
    return tuple(None if p is None else p[i0:i0 + T] for p in out) + (
        hl_out, p_out, uc_out)


# The walk's plan (csrc/col_walk.cu): G threads a lane, windows of R rows
# by S slots, two windows a lane in shared memory. A window costs a DRAM
# page opened for each of its rows and planes, and hides the latency of
# the steps it serves. With few lanes an SM (at most WALK_FEW_LANES) the
# latency is what bounds the walk: a warp a lane and tall windows
# (WALK_WINDOWS, the first whose buffers for an SM's lanes fit
# WALK_SMEM_SM). With more, the pages opened bound it: 4 threads a lane
# and a one-row window (WALK_ONE_ROW), which opens the pages of the rows
# the walk reads and no others (measured with walk_bench.py on an H100).
# WALK_SMS is the SM count the plan assumes off the card (an H100 SXM).
WALK_FEW_LANES = 8
WALK_SMEM_SM = 200 * 1024
WALK_SMS = 132
WALK_WINDOWS = {"band": ((128, 64), (64, 64), (32, 32)),
                "flat": ((32, 64), (16, 48))}
WALK_ONE_ROW = (1, 16)


def walk_lane_bytes(k: int, R: int, S: int, n_tiles: int = 0) -> int:
    """Shared memory of one walk lane: two windows of R x S slots of the
    planes read at depth k (1, 2 or 4 bytes a slot) and the lane's tile
    origins (int32, rounded up to 16 bytes)."""
    per_slot = 1 + (k >= 2) + 2 * (k >= 4)
    return 2 * R * S * per_slot + (4 * n_tiles + 15) // 16 * 16


def walk_plan(B: int, k: int, *, layout: str = "band", n_tiles: int = 0,
              sms: int = WALK_SMS) -> dict:
    """Plan of one column-walk launch over B lanes at depth k on ``sms``
    SMs: ``G`` threads a lane and an R x S window (see WALK_FEW_LANES),
    and ``lanes_per_block`` (at most 128 threads a block, and no more
    lanes a block than an SM's share, so that small launches spread over
    the SMs). ``lane_bytes`` is a lane's shared memory, ``smem`` a
    block's."""
    if layout not in WALK_WINDOWS:
        raise KernelError(f"[racon_tpu_torch::kernels] bad layout {layout!r}")
    lanes_sm = max(1, -(-int(B) // int(sms)))
    if lanes_sm <= WALK_FEW_LANES:
        G = 32
        for R, S in WALK_WINDOWS[layout]:
            lane = walk_lane_bytes(k, R, S, n_tiles)
            if lanes_sm * lane <= WALK_SMEM_SM:
                break
    else:
        G = 4
        R, S = WALK_ONE_ROW
        lane = walk_lane_bytes(k, R, S, n_tiles)
    lpb = max(1, min(128 // G, lanes_sm))
    while lpb > 1 and lpb * lane > SMEM_MAX:
        lpb -= 1
    return {"G": G, "R": R, "S": S, "lanes_per_block": lpb,
            "lane_bytes": lane, "smem": lpb * lane}


def walk_occupancy(k: int, *, layout: str = "band", emit=torch.int16,
                   plan: dict) -> dict:
    """What the walk instantiation for (k, layout, emit) gets on the
    current card under ``plan``: ``blocks_per_sm``, ``regs`` a thread,
    ``spills`` (local-memory bytes a thread), ``threads`` and ``smem`` a
    block. Raises KernelError when the query fails or no block fits."""
    esize = torch.empty((), dtype=emit).element_size()
    threads = plan["lanes_per_block"] * plan["G"]
    out = (ctypes.c_int * 4)()
    rc = _lib().racon_col_walk_occupancy(int(k), int(layout == "flat"),
                                         esize, threads, plan["smem"], out)
    if rc != 0 or out[0] < 1:
        raise KernelError(f"[racon_tpu_torch::kernels] occupancy query of "
                          f"the walk (k={k}, {layout}, plan {plan}) failed "
                          f"(cudaError {rc}, {out[0]} blocks an SM)")
    return {"blocks_per_sm": out[0], "regs": out[1], "spills": out[2],
            "threads": threads, "smem": plan["smem"]}


def col_walk_kernel(cells, lq, lt, klo, t_off, *, LA: int, layout: str,
                    nxt=None, nxt2=None, tile_klo=None, tile_len: int = 0,
                    emit=torch.int16, plan=None, refills=None):
    """Column walk (ops/colwalk.py::col_walk's contract), on the "band"
    and "flat" layouts; the flat layout (the full-width forward's planes)
    has no nxt planes and no tiles, so it walks at k = 1. The kernel
    takes plane widths W that are multiples of 16 (the port's are
    multiples of 128) and 16-byte aligned planes.

    On the card: ``plan`` (default :func:`walk_plan`) sets threads a
    lane, window shape and lanes a block, which change the time and never
    the outputs; ``refills``, an int32 [B, 2] tensor on the card, receives
    each lane's windows entered and misses (windows loaded while the walk
    waited). Neither is taken on the CPU."""
    if cells.device.type == "cpu":
        if refills is not None:
            raise KernelError("[racon_tpu_torch::kernels] col_walk counts "
                              "refills on the card only")
        return col_walk(cells, lq, lt, klo, t_off, LA=LA, layout=layout,
                        nxt=nxt, nxt2=nxt2, tile_klo=tile_klo,
                        tile_len=tile_len, emit=emit)
    if cells.device.type != "cuda":
        raise KernelError("[racon_tpu_torch::kernels] col_walk needs a CPU "
                          "or CUDA tensor")
    if layout not in ("band", "flat"):
        raise KernelError(f"[racon_tpu_torch::kernels] col_walk kernel takes "
                          f"the band or flat layout, got {layout!r}")
    flat = layout == "flat"
    if flat and (nxt is not None or nxt2 is not None or
                 tile_klo is not None):
        raise KernelError("[racon_tpu_torch::kernels] the flat layout walks "
                          "at k = 1: no nxt, nxt2 or tile_klo")
    if emit not in (torch.int16, torch.int32):
        raise KernelError(f"[racon_tpu_torch::kernels] col_walk emits int16 "
                          f"or int32, got {emit}")
    if nxt2 is not None and nxt is None:
        raise KernelError("[racon_tpu_torch::kernels] nxt2 requires nxt")
    Lq, B, W = cells.shape
    dev = cells.device
    _check(cells, "cells", torch.uint8, (Lq, B, W), dev)
    if nxt is not None:
        _check(nxt, "nxt", torch.uint8, (Lq, B, W), dev)
    if nxt2 is not None:
        _check(nxt2, "nxt2", torch.uint16, (Lq, B, W), dev)
    for name, t in (("lq", lq), ("lt", lt), ("t_off", t_off)):
        _check(t, name, torch.int32, (B,), dev)
    if refills is not None:
        _check(refills, "refills", torch.int32, (B, 2), dev)
    if flat:
        n_tiles, klo_p = 0, None
    elif tile_klo is not None:
        if tile_len <= 0:
            raise KernelError("[racon_tpu_torch::kernels] tile_klo needs "
                              "tile_len")
        n_tiles = tile_klo.shape[0]
        _check(tile_klo, "tile_klo", torch.int32, (n_tiles, B), dev)
        klo_p = None
    else:
        _check(klo, "klo", torch.int32, (B,), dev)
        n_tiles, klo_p = 0, klo.data_ptr()
    k = 4 if nxt2 is not None else (2 if nxt is not None else 1)
    if plan is None:
        plan = walk_plan(B, k, layout=layout, n_tiles=n_tiles,
                         sms=torch.cuda.get_device_properties(
                             dev).multi_processor_count)
    if W % 16 or any(p is not None and p.data_ptr() % 16
                     for p in (cells, nxt, nxt2)):
        raise KernelError(f"[racon_tpu_torch::kernels] col_walk stages rows "
                          f"as 16-byte pieces: W={W} must be a multiple of "
                          "16 and the planes 16-byte aligned")
    out = torch.empty((B, LA + 2, 4), dtype=emit, device=dev)
    sat = torch.empty((B,), dtype=torch.bool, device=dev)
    rc = _lib().racon_col_walk(
        cells.data_ptr(), None if nxt is None else nxt.data_ptr(),
        None if nxt2 is None else nxt2.data_ptr(), lq.data_ptr(),
        lt.data_ptr(), klo_p, t_off.data_ptr(),
        None if tile_klo is None else tile_klo.data_ptr(), out.data_ptr(),
        sat.data_ptr(), None if refills is None else refills.data_ptr(), B,
        Lq, W, LA, n_tiles, int(tile_len), k, out.element_size(), int(flat),
        plan["G"], plan["R"], plan["S"], plan["lanes_per_block"],
        _stream(dev))
    if rc != 0:
        raise KernelError(f"[racon_tpu_torch::kernels] col_walk launch "
                          f"failed (cudaError {rc}, plan {plan})")
    _launched("col_walk")
    return {"ins_len": out[..., 0], "qstart": out[..., 1],
            "op_c": out[..., 2], "qi_c": out[..., 3], "sat": sat}


def fw_dirs_flat(tbuf: torch.Tensor, qT: torch.Tensor, *, match: int,
                 mismatch: int, gap: int) -> torch.Tensor:
    """Full-width forward: packed cells u8[Lq, B, Lt] from tbuf u8[B, Lt]
    and qT u8[Lq, B]."""
    if tbuf.device.type == "cpu":
        return fw_dirs_flat_plain(tbuf, qT, match=match, mismatch=mismatch,
                                  gap=gap)
    if tbuf.device.type != "cuda":
        raise KernelError("[racon_tpu_torch::kernels] flat_fwd needs a "
                          "CPU or CUDA tensor")
    B, Lt = tbuf.shape
    Lq = qT.shape[0]
    dev = tbuf.device
    _check(tbuf, "tbuf", torch.uint8, (B, Lt), dev)
    _check(qT, "qT", torch.uint8, (Lq, B), dev)
    if (Lt // 4 if Lt % 4 == 0 else Lt) > 1024:
        raise KernelError(f"[racon_tpu_torch::kernels] target width {Lt} "
                          "exceeds the kernel's 1024-thread block")
    cells = torch.empty((Lq, B, Lt), dtype=torch.uint8, device=dev)
    rc = _lib().racon_flat_fwd(tbuf.data_ptr(), qT.data_ptr(),
                               cells.data_ptr(), B, Lq, Lt, match, mismatch,
                               gap, _stream(dev))
    if rc != 0:
        raise KernelError(f"[racon_tpu_torch::kernels] flat_fwd launch "
                          f"failed (cudaError {rc})")
    _launched("flat_fwd")
    return cells


def nw_smem(Lq: int, Lt: int) -> int:
    """Shared memory of one block of the wide nw_fwd kernel: the score row
    and the 32 warp totals (int32), the lane's target and query codes."""
    return 4 * (Lt + 32) + Lt + Lq


# K4's variants (csrc/nw_fwd.cu). The warp kernel runs one warp a lane,
# NW_WARP_LANES lanes a block, and holds the lane's score row in
# registers: C columns a thread, C = ceil(Lt / 32) rounded up to a
# multiple of 4, so it takes Lt <= NW_WARP_MAX_LT. The wide kernel runs
# one block a lane with the row in shared memory, at any Lt whose row
# fits (nw_smem).
NW_WARP_LANES = 4
NW_WARP_MAX_LT = 1024


def nw_plan(Lq: int, Lt: int, variant: str | None = None) -> dict:
    """The K4 launch for a query of Lq rows against a target of Lt
    columns: ``variant`` "warp" (the default up to NW_WARP_MAX_LT) or
    "wide" (past it), ``C`` columns a thread (0 for the wide kernel),
    ``lanes_per_block``, ``threads`` and ``smem`` a block. A variant may
    be asked for by name (to time one against the other); a shape the
    variant cannot take raises KernelError."""
    Lq, Lt = int(Lq), int(Lt)
    if Lq <= 0 or Lt <= 0:
        raise KernelError(f"[racon_tpu_torch::kernels] nw_fwd needs Lq and "
                          f"Lt of at least 1, got {Lq}, {Lt}")
    if variant is None:
        variant = "warp" if Lt <= NW_WARP_MAX_LT else "wide"
    if variant == "warp":
        if Lt > NW_WARP_MAX_LT:
            raise KernelError(f"[racon_tpu_torch::kernels] the warp nw_fwd "
                              f"kernel takes Lt <= {NW_WARP_MAX_LT}, got "
                              f"{Lt}")
        cols = -(-Lt // 32)
        C = -(-cols // 4) * 4
        return {"variant": "warp", "C": C, "lanes_per_block": NW_WARP_LANES,
                "threads": 32 * NW_WARP_LANES, "smem": 0}
    if variant == "wide":
        smem = nw_smem(Lq, Lt)
        if smem > SMEM_MAX:
            raise KernelError(f"[racon_tpu_torch::kernels] nw_fwd at "
                              f"Lq={Lq}, Lt={Lt} needs {smem} bytes of "
                              f"shared memory, past the block's {SMEM_MAX}")
        groups = -(-Lt // 4)
        threads = min(1024, -(-groups // 32) * 32)
        return {"variant": "wide", "C": 0, "lanes_per_block": 1,
                "threads": threads, "smem": smem}
    raise KernelError(f"[racon_tpu_torch::kernels] unknown nw_fwd variant "
                      f"{variant!r}")


def nw_occupancy(Lq: int, Lt: int, variant: str | None = None) -> dict:
    """What the K4 launch :func:`nw_plan` makes gets on the current card:
    the plan with ``blocks_per_sm``, ``regs`` a thread and ``spills``
    (local-memory bytes a thread). Raises KernelError when the query
    fails or no block fits."""
    plan = nw_plan(Lq, Lt, variant)
    out = (ctypes.c_int * 4)()
    rc = _lib().racon_nw_occupancy(int(Lq), int(Lt), plan["C"], out)
    if rc != 0 or out[0] < 1:
        raise KernelError(f"[racon_tpu_torch::kernels] occupancy query of "
                          f"nw_fwd ({plan}) failed (cudaError {rc}, "
                          f"{out[0]} blocks an SM)")
    return {**plan, "blocks_per_sm": out[0], "regs": out[1],
            "spills": out[2]}


def nw_dirs(q: torch.Tensor, t: torch.Tensor, *, match: int, mismatch: int,
            gap: int, variant: str | None = None) -> torch.Tensor:
    """NW direction codes u8 [Lq, B, Lt] of q u8 [B, Lq] against t u8
    [B, Lt] (ops/align.py::nw_dirs_plain's contract).

    On the card, K4 (csrc/nw_fwd.cu, replacing racon_tpu/ops/pallas/
    nw_kernel.py::_kernel) in the variant :func:`nw_plan` picks, or in
    ``variant`` where one is named: the warp kernel (one warp a lane, the
    score row in registers, one pass a row, no block barrier; Lt <= 1024)
    or the wide kernel (one block a lane, the row in shared memory).
    Bound: 14 integer operations a cell against the int32 rate
    (operations bound at every shape of the op-string route). The warp
    kernel counts its launches under "nw_fwd", the wide one under
    "nw_fwd_wide". ``variant`` is not taken on the CPU."""
    if q.device.type == "cpu":
        if variant is not None:
            raise KernelError("[racon_tpu_torch::kernels] nw_fwd variants "
                              "are the card's")
        return nw_dirs_plain(q, t, match=match, mismatch=mismatch, gap=gap)
    if q.device.type != "cuda":
        raise KernelError("[racon_tpu_torch::kernels] nw_fwd needs a CPU or "
                          "CUDA tensor")
    B, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    _check(q, "q", torch.uint8, (B, Lq), dev)
    _check(t, "t", torch.uint8, (B, Lt), dev)
    plan = nw_plan(Lq, Lt, variant)
    dirs = torch.empty((Lq, B, Lt), dtype=torch.uint8, device=dev)
    rc = _lib().racon_nw_fwd(q.data_ptr(), t.data_ptr(), dirs.data_ptr(), B,
                             Lq, Lt, match, mismatch, gap, plan["C"],
                             _stream(dev))
    if rc != 0:
        raise KernelError(f"[racon_tpu_torch::kernels] nw_fwd launch failed "
                          f"(cudaError {rc}, plan {plan})")
    _launched("nw_fwd" if plan["variant"] == "warp" else "nw_fwd_wide")
    return dirs


# T1's plan (csrc/nw_traceback.cu): one warp a lane walks windows of the
# plane staged in shared memory, the next window prefetched. The window is
# the kernel's: TB_WINDOW = (R rows, C band bytes, M margin) mirrors its
# kR, kC, kM, TB_LANE_BYTES its kLaneBytes (two windows with their R + 2
# int32 first columns, and the TB_RING-byte op ring). The plan sets lanes
# a block: an SM's share of the lanes, ceil(B / sms), as one block of up
# to TB_LANES lanes (as few blocks as that takes, evenly filled), so that
# neighbouring lanes, whose paths cross the same rows once the route has
# sorted its jobs by length, share an SM. Measured with walk_bench.py
# --traceback --plans at the op-string route's shapes on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md keeps the times): blocks of an SM's share
# ran 2-7% faster than blocks of 1, 4 or 8 lanes; blocks of at most 16
# lanes tied them at 4096 lanes (within 1%) and lost 1-2% at 3072.
# TB_SMS is the SM count the plan assumes off the card (an H100 SXM).
TB_WINDOW = (32, 64, 16)
TB_LANES = 32
TB_RING = 256
TB_LANE_BYTES = 2 * (32 * 64 + 4 * (32 + 2)) + TB_RING  # 4624
TB_SMS = 132


def traceback_plan(B: int, Lq: int, Lt: int, sms: int = TB_SMS) -> dict:
    """Plan of one T1 launch over B lanes of an [Lq, B, Lt] plane on
    ``sms`` SMs: the kernel's window ``R``, ``C``, ``M`` (TB_WINDOW;
    :func:`traceback_band` places it), ``lanes_per_block`` (see TB_LANES)
    and ``smem`` a block."""
    B, Lq, Lt = int(B), int(Lq), int(Lt)
    if B < 1 or Lq < 1 or Lt < 1:
        raise KernelError(f"[racon_tpu_torch::kernels] nw_traceback needs "
                          f"B, Lq and Lt of at least 1, got {B}, {Lq}, {Lt}")
    R, C, M = TB_WINDOW
    lanes_sm = -(-B // int(sms))
    lpb = -(-lanes_sm // -(-lanes_sm // TB_LANES))
    return {"R": R, "C": C, "M": M, "lanes_per_block": lpb,
            "smem": lpb * TB_LANE_BYTES}


def traceback_band(j0: int, row_starts) -> list:
    """First plane column of each row's band in a T1 window anchored at
    column j0: row r (``row_starts[r]`` the address of its column 0,
    modulo 32 or whole) starts at the 32-byte sector boundary at or below
    column j0 - 1 - r - M, and holds C bytes (TB_WINDOW)."""
    M = TB_WINDOW[2]
    return [((a + j0 - 1 - r - M) & ~31) - a
            for r, a in enumerate(row_starts)]


def _traceback_lanes(plan: dict, lanes_per_block) -> int:
    """Lanes a block of a T1 launch: the plan's, or ``lanes_per_block``
    (1 to TB_LANES; KernelError otherwise)."""
    if lanes_per_block is None:
        return plan["lanes_per_block"]
    if not 1 <= int(lanes_per_block) <= TB_LANES:
        raise KernelError(f"[racon_tpu_torch::kernels] nw_traceback needs 1 "
                          f"to {TB_LANES} lanes a block, got "
                          f"{lanes_per_block}")
    return int(lanes_per_block)


def traceback_occupancy(B: int, Lq: int, Lt: int,
                        lanes_per_block=None) -> dict:
    """What a T1 launch gets on the current card at ``lanes_per_block``
    (default :func:`traceback_plan`'s for this card's SM count): the plan
    with ``smem`` a block as the kernel sizes it, ``blocks_per_sm``,
    ``regs`` a thread, ``spills`` (local-memory bytes a thread) and
    ``threads`` a block. Raises KernelError when the query fails or no
    block fits."""
    plan = traceback_plan(B, Lq, Lt, sms=torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count)
    lpb = _traceback_lanes(plan, lanes_per_block)
    out = (ctypes.c_int * 5)()
    rc = _lib().racon_nw_traceback_occupancy(lpb, out)
    if rc != 0 or out[0] < 1:
        raise KernelError(f"[racon_tpu_torch::kernels] occupancy query of "
                          f"nw_traceback ({lpb} lanes a block) failed "
                          f"(cudaError {rc}, {out[0]} blocks an SM)")
    return {**plan, "lanes_per_block": lpb, "smem": out[4],
            "blocks_per_sm": out[0], "regs": out[1], "spills": out[2],
            "threads": 32 * lpb}


def nw_traceback(dirs: torch.Tensor, lq: torch.Tensor, lt: torch.Tensor,
                 L: int, *, lanes_per_block=None, refills=None):
    """Op strings of every lane from its direction codes u8 [Lq, B, Lt]:
    ``(ops u8[B, L], n i32[B])``, each path right-aligned behind PAD_OP in
    start-to-end order (ops/align.py::nw_align_batch's contract).

    On the card, T1 (csrc/nw_traceback.cu, replacing the XLA scan
    racon_tpu/ops/align.py::_traceback_flat): one warp a lane walks
    windows of the plane staged in shared memory. ``lanes_per_block``
    (default :func:`traceback_plan`'s) changes the time and never the
    outputs; ``refills``, an int32 [B, 2] tensor on the card, receives
    each lane's windows entered and misses (windows left through a band
    edge). Neither is taken on the CPU."""
    if dirs.device.type == "cpu":
        if lanes_per_block is not None or refills is not None:
            raise KernelError("[racon_tpu_torch::kernels] nw_traceback "
                              "lanes a block and refills are the card's")
        rev = traceback_plain(dirs, lq, lt, L)
        n = (rev != PAD_OP).sum(dim=1, dtype=torch.int32)
        return torch.flip(rev, dims=[1]), n
    if dirs.device.type != "cuda":
        raise KernelError("[racon_tpu_torch::kernels] nw_traceback needs a "
                          "CPU or CUDA tensor")
    Lq, B, Lt = dirs.shape
    dev = dirs.device
    _check(dirs, "dirs", torch.uint8, (Lq, B, Lt), dev)
    _check(lq, "lq", torch.int32, (B,), dev)
    _check(lt, "lt", torch.int32, (B,), dev)
    if refills is not None:
        _check(refills, "refills", torch.int32, (B, 2), dev)
    if int(L) < 0:
        raise KernelError(f"[racon_tpu_torch::kernels] nw_traceback needs "
                          f"L >= 0, got {L}")
    lpb = _traceback_lanes(traceback_plan(
        B, Lq, Lt, sms=torch.cuda.get_device_properties(
            dev).multi_processor_count), lanes_per_block)
    ops = torch.empty((B, L), dtype=torch.uint8, device=dev)
    n = torch.empty((B,), dtype=torch.int32, device=dev)
    rc = _lib().racon_nw_traceback(
        dirs.data_ptr(), lq.data_ptr(), lt.data_ptr(), ops.data_ptr(),
        n.data_ptr(), None if refills is None else refills.data_ptr(), B, Lq,
        Lt, int(L), lpb, _stream(dev))
    if rc != 0:
        raise KernelError(f"[racon_tpu_torch::kernels] nw_traceback launch "
                          f"failed (cudaError {rc}, {lpb} lanes a block)")
    _launched("nw_traceback")
    return ops, n


# K5 (csrc/count.cu) runs one warp a lane with the lane's histogram of P
# bins (rounded up to whole 16-byte pieces) in shared memory: COUNT_LANES
# lanes a block, fewer where their histograms pass SMEM_MAX.
COUNT_LANES = 8


def count_plan(P: int) -> dict:
    """The K5 launch for P output bins: ``lanes_per_block`` (warps a
    block, one a lane) and ``smem`` a block. Raises KernelError for P < 1
    or a histogram past the block's shared memory."""
    P = int(P)
    if P < 1:
        raise KernelError(f"[racon_tpu_torch::kernels] monotone_count needs "
                          f"P >= 1, got {P}")
    lane = 4 * (-(-P // 4) * 4)
    lanes = min(COUNT_LANES, SMEM_MAX // lane)
    if lanes < 1:
        raise KernelError(f"[racon_tpu_torch::kernels] monotone_count at "
                          f"P={P} needs {lane} bytes of shared memory, past "
                          f"the block's {SMEM_MAX}")
    return {"lanes_per_block": lanes, "smem": lanes * lane}


def count_occupancy(P: int) -> dict:
    """What the K5 launch :func:`count_plan` makes gets on the current
    card: the plan with ``blocks_per_sm``, ``regs`` a thread, ``spills``
    and ``threads`` a block. Raises KernelError when the query fails."""
    plan = count_plan(P)
    out = (ctypes.c_int * 4)()
    rc = _lib().racon_monotone_count_occupancy(int(P),
                                               plan["lanes_per_block"], out)
    if rc != 0 or out[0] < 1:
        raise KernelError(f"[racon_tpu_torch::kernels] occupancy query of "
                          f"monotone_count ({plan}) failed (cudaError {rc}, "
                          f"{out[0]} blocks an SM)")
    return {**plan, "blocks_per_sm": out[0], "regs": out[1],
            "spills": out[2], "threads": out[3]}


def monotone_count(X: torch.Tensor, P: int) -> torch.Tensor:
    """``F[b, p] = #{s : X[b, s] < p}``, int32 [B, P], from X int32 [B, S]
    (ops/device_merge.py::monotone_count_plain's contract), for any X,
    sorted or not.

    On the card, K5 (csrc/count.cu, replacing racon_tpu/ops/pallas/
    count_kernel.py::_kernel): one warp a lane, a shared-memory histogram
    and a warp scan, no block barrier, lanes a block from
    :func:`count_plan`. Bound: 4*B*(S + P) bytes against the memory rate
    (bytes bound)."""
    if X.device.type == "cpu":
        return monotone_count_plain(X, P)
    if X.device.type != "cuda":
        raise KernelError("[racon_tpu_torch::kernels] monotone_count needs a "
                          "CPU or CUDA tensor")
    B, S = X.shape
    dev = X.device
    _check(X, "X", torch.int32, (B, S), dev)
    plan = count_plan(P)
    F = torch.empty((B, P), dtype=torch.int32, device=dev)
    rc = _lib().racon_monotone_count(X.data_ptr(), F.data_ptr(), B, S, int(P),
                                     plan["lanes_per_block"], _stream(dev))
    if rc != 0:
        raise KernelError(f"[racon_tpu_torch::kernels] monotone_count launch "
                          f"failed (cudaError {rc}, plan {plan})")
    _launched("monotone_count")
    return F


WALK_FIELDS = ("ins_len", "qstart", "op_c", "qi_c")


def _walk_words(cols, B: int, LA: int, dev):
    """The walk's four int16 channels as M1 reads them, in place:
    ``(tensor, row stride)``, a tensor whose storage holds each lane's
    [LA+2, 4] entries (ins_len, qstart, op_c, qi_c) and the int16s between
    two lanes' rows. Raises KernelError for columns that are not views of
    one such interleaved tensor, col_walk_kernel's layout."""
    ts = [cols[n] for n in WALK_FIELDS]
    for n, t in zip(WALK_FIELDS, ts):
        if t.device != dev or t.dtype != torch.int16 or \
                tuple(t.shape) != (B, LA + 2):
            raise KernelError(f"[racon_tpu_torch::kernels] merge_votes takes "
                              f"the walk's {n} as int16 [{B}, {LA + 2}] on "
                              f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                              f"{t.device}")
    base = ts[0]
    if base.stride(1) == 4 and base.stride(0) % 4 == 0 and \
            base.data_ptr() % 8 == 0 and all(
                t.stride() == base.stride() and
                t.data_ptr() == base.data_ptr() + 2 * i
                for i, t in enumerate(ts)):
        return base, base.stride(0)
    raise KernelError("[racon_tpu_torch::kernels] merge_votes takes the "
                      "walk's columns as views of one interleaved int16 "
                      "[B, LA+2, 4] tensor (col_walk_kernel's layout)")


def _members(members, n_win: int, B: int, dev):
    """The membership tensors (order, starts, counts) of a merge launch,
    device_merge.window_members' output, checked."""
    order, starts, counts = members
    _check(order, "order", torch.int32, (B,), dev)
    _check(starts, "starts", torch.int32, (n_win,), dev)
    _check(counts, "counts", torch.int32, (n_win,), dev)
    return order, starts, counts


# M1's plan (csrc/merge.cu): a block a (tile, window), a thread a gap, at
# most MERGE_TILE gaps a tile and the gaps split evenly among as few
# tiles as that takes, so that no tile runs nearly empty; threads a block
# the tile's gaps rounded up to whole warps. The kernel's register cap
# (its launch bounds) leaves room for MERGE_VOTES_BLOCKS blocks of
# MERGE_TILE threads an SM: the main path's grid (6 tiles x 160 windows)
# fits 132 SMs in one wave. MERGE_WIN_THREADS mirrors the narrow M2's
# kWinMaxThreads (a gap a thread up to LA + 1 = 1024), MERGE_WIDE_THREADS
# the wide M2's kWinThreads.
MERGE_TILE = 128
MERGE_VOTES_BLOCKS = 8
MERGE_WIN_THREADS = 1024
MERGE_WIDE_THREADS = 256


def merge_votes_plan(LA: int) -> dict:
    """M1's launch at anchor width LA: ``tiles`` a window, ``gaps`` a
    tile and ``threads`` a block."""
    LA = int(LA)
    if LA < 1:
        raise KernelError(f"[racon_tpu_torch::kernels] merge_votes needs LA "
                          f"of at least 1, got {LA}")
    tiles = -(-(LA + 1) // MERGE_TILE)
    gaps = -(-(LA + 1) // tiles)
    return {"tiles": tiles, "gaps": gaps, "threads": -(-gaps // 32) * 32}


def grid_waves(blocks: int, blocks_per_sm: int, sms: int) -> int:
    """Waves a grid of ``blocks`` takes on ``sms`` SMs that each hold
    ``blocks_per_sm`` of its blocks at once."""
    return -(-int(blocks) // (int(blocks_per_sm) * int(sms)))


def merge_windows_plan(LA: int, variant: str | None = None) -> dict:
    """M2's launch at anchor width LA: ``variant`` "narrow" (the default
    while LA + 1 <= MERGE_WIN_THREADS: a gap a thread, its state in
    registers, the maps in ``smem`` bytes of shared memory) or "wide"
    (past it: MERGE_WIDE_THREADS threads, the state in
    merge_windows_scratch(LA) bytes of device memory a window);
    ``threads`` a block. A variant may be asked for by name (to time one
    against the other); a width the variant cannot take raises
    KernelError."""
    LA = int(LA)
    if LA < 1:
        raise KernelError(f"[racon_tpu_torch::kernels] merge_windows needs "
                          f"LA of at least 1, got {LA}")
    if variant is None:
        variant = "narrow" if LA + 1 <= MERGE_WIN_THREADS else "wide"
    if variant == "narrow":
        if LA + 1 > MERGE_WIN_THREADS:
            raise KernelError(f"[racon_tpu_torch::kernels] the narrow "
                              f"merge_windows kernel takes LA + 1 <= "
                              f"{MERGE_WIN_THREADS}, got LA={LA}")
        return {"variant": "narrow", "threads": -(-(LA + 1) // 32) * 32,
                "smem": 8 * LA}
    if variant == "wide":
        return {"variant": "wide", "threads": MERGE_WIDE_THREADS, "smem": 0}
    raise KernelError(f"[racon_tpu_torch::kernels] unknown merge_windows "
                      f"variant {variant!r}")


def merge_votes(cols, q, qw8, w_read, lt, t_off, esc_w, win, members, *,
                n_win: int, LA: int):
    """M1: the vote extraction fused with the per-window sums of one
    round (device_merge.merge_votes_plain's contract): ``(votes f32
    [n_win, VOTE_CH, LA+1], wesc f32 [n_win])`` from the walk's columns
    ``cols`` (int16 [B, LA+2]), q and qw8 u8 [B, Lq], w_read and esc_w f32
    [B], lt, t_off and win i32 [B], and ``members``,
    device_merge.window_members(win, n_win) (the plain version on the CPU
    does not read it). Query codes must be below 8 (the reference packs
    them as 3-bit fields).

    On the card, csrc/merge.cu ``racon_merge_votes`` at
    :func:`merge_votes_plan`'s tiles: a thread a gap adding its window's
    jobs' contributions in job order, the jobs staged in shared
    memory, the next jobs' loads in flight, 23 channels summed in
    registers and the insertion runs' 109 in the output; bitwise the plain
    sums. Bound: the walk's columns and the queries read, the sums written
    (bytes bound)."""
    if q.device.type == "cpu":
        return merge_votes_plain(cols, q, qw8, w_read, lt, t_off, esc_w, win,
                                 n_win=n_win, LA=LA)
    if q.device.type != "cuda":
        raise KernelError("[racon_tpu_torch::kernels] merge_votes needs a CPU "
                          "or CUDA tensor")
    B, Lq = q.shape
    dev = q.device
    if n_win < 1 or LA < 1:
        raise KernelError(f"[racon_tpu_torch::kernels] merge_votes needs "
                          f"n_win and LA of at least 1, got {n_win}, {LA}")
    _check(q, "q", torch.uint8, (B, Lq), dev)
    _check(qw8, "qw8", torch.uint8, (B, Lq), dev)
    for name, t, dt in (("w_read", w_read, torch.float32),
                        ("esc_w", esc_w, torch.float32),
                        ("lt", lt, torch.int32), ("t_off", t_off, torch.int32),
                        ("win", win, torch.int32)):
        _check(t, name, dt, (B,), dev)
    walk, row = _walk_words(cols, B, LA, dev)
    order, starts, counts = _members(members, n_win, B, dev)
    plan = merge_votes_plan(LA)
    votes = torch.empty((n_win, VOTE_CH, LA + 1), dtype=torch.float32,
                        device=dev)
    wesc = torch.empty((n_win,), dtype=torch.float32, device=dev)
    rc = _lib().racon_merge_votes(
        walk.data_ptr(), row, q.data_ptr(), qw8.data_ptr(), w_read.data_ptr(),
        lt.data_ptr(), t_off.data_ptr(), esc_w.data_ptr(), order.data_ptr(),
        starts.data_ptr(), counts.data_ptr(), votes.data_ptr(),
        wesc.data_ptr(), n_win, Lq, LA, plan["gaps"], plan["threads"],
        _stream(dev))
    if rc != 0:
        raise KernelError(f"[racon_tpu_torch::kernels] merge_votes launch "
                          f"failed (cudaError {rc}, plan {plan})")
    _launched("merge_votes")
    return votes, wesc


def merge_occupancy(which: str, LA: int, variant: str | None = None,
                    n_win: int | None = None) -> dict:
    """What M1 (``which`` "votes") or M2 ("windows", or its sched mode
    "windows_sched", in ``variant`` or the one :func:`merge_windows_plan`
    picks) gets on the current card at
    anchor width LA: the plan with ``blocks_per_sm``, ``regs`` a thread,
    ``spills`` (local-memory bytes a thread), ``threads`` and ``smem`` a
    block; given ``n_win``, the grid's ``blocks`` and its ``waves`` on the
    card's SMs at that occupancy (:func:`grid_waves`). Raises KernelError
    when the query fails or no block fits."""
    if which == "votes":
        plan = merge_votes_plan(LA)
        code, smem = 0, 0
    elif which in ("windows", "windows_sched"):
        plan = merge_windows_plan(LA, variant)
        code = (1 if plan["variant"] == "narrow" else 2) + \
            (2 if which == "windows_sched" else 0)
        smem = plan["smem"]
    else:
        raise KernelError(f"[racon_tpu_torch::kernels] unknown merge kernel "
                          f"{which!r}")
    out = (ctypes.c_int * 5)()
    rc = _lib().racon_merge_occupancy(code, plan["threads"], smem, out)
    if rc != 0 or out[0] < 1:
        raise KernelError(f"[racon_tpu_torch::kernels] occupancy query of "
                          f"merge_{which} ({plan}) failed (cudaError {rc}, "
                          f"{out[0]} blocks an SM)")
    occ = {**plan, "blocks_per_sm": out[0], "regs": out[1],
           "spills": out[2], "threads": out[3], "smem": out[4]}
    if n_win is not None:
        occ["blocks"] = plan.get("tiles", 1) * int(n_win)
        occ["waves"] = grid_waves(occ["blocks"], out[0],
                                  torch.cuda.get_device_properties(
                                      torch.cuda.current_device())
                                  .multi_processor_count)
    return occ


def merge_windows_scratch(LA: int) -> int:
    """Bytes of the wide M2's device-memory scratch a window at anchor
    width LA (its per-gap state, about 70 bytes a gap), as the kernel
    library computes it."""
    n = _lib().racon_merge_windows_scratch(int(LA))
    if n < 0:
        raise KernelError(f"[racon_tpu_torch::kernels] merge_windows needs "
                          f"LA of at least 1, got {LA}")
    return n


def merge_windows(votes, wesc, bb, bbw, alen, begin, end, win, ovf, members,
                  *, ins_scale: float, n_win: int, LA: int,
                  detect: bool = False, variant: str | None = None):
    """M2: the per-window vote-out of one round and the next round's state
    (device_merge.merge_windows_plain's contract): ``(new_bb u8 [n_win+1,
    LA], new_bbw f32 [n_win+1, LA], new_alen i32 [n_win+1], new_begin,
    new_end i32 [B], cov i32 [n_win, LA], ovf bool [n_win], conv bool
    [n_win])`` from M1's ``votes`` and ``wesc``, the anchors bb u8 / bbw
    f32 [n_win+1, LA] and alen i32 [n_win+1] (with the dummy row), the
    spans begin, end and the window ids win i32 [B] (in [0, n_win]) and
    the sticky flags ovf bool [n_win]; ``members`` as merge_votes'.

    On the card, csrc/merge.cu ``racon_merge_windows``, one block a
    window, no host sync, in the variant :func:`merge_windows_plan` picks
    or in ``variant`` where one is named (not taken on the CPU): the
    narrow kernel (a gap a thread, its state in registers, LA + 1 <=
    1024) or the wide one (any LA: the state in a device-memory scratch
    of merge_windows_scratch(LA) bytes a window). Both count their
    launches under "merge_windows". Bound: the sums and anchors read, the
    state written (bytes bound)."""
    if votes.device.type == "cpu":
        if variant is not None:
            raise KernelError("[racon_tpu_torch::kernels] merge_windows "
                              "variants are the card's")
        return merge_windows_plain(votes, wesc, bb, bbw, alen, begin, end,
                                   win, ovf, ins_scale=ins_scale, n_win=n_win,
                                   LA=LA, detect=detect)
    out = _merge_windows_launch(
        votes, wesc, bb, bbw, alen, begin, end, win, ovf, members, None,
        ins_scale=ins_scale, n_win=n_win, LA=LA, detect=detect,
        variant=variant)
    _launched("merge_windows")
    return out


def merge_windows_sched(votes, wesc, bb, bbw, alen, begin, end, win, ovf,
                        members, orig_ids, out, *, ins_scale: float,
                        scale_final: float, last: bool, n_win: int, LA: int,
                        detect: bool = False, variant: str | None = None):
    """M2's sched mode (device_merge.merge_windows_sched_plain's
    contract): merge_windows' round and, for every window that freezes
    (converged, flagged or ``last``), its output at ``scale_final``
    written in place into row ``orig_ids[w]`` (i32 [n_win]) of the
    scheduler's accumulators ``out`` = (codes u8 [R+1, LA], cov i32 [R+1,
    LA], total i32 [R+1], ovf bool [R+1]); row R, the trash row, is never
    written. Returns merge_windows' tuple.

    On the card, the same launch as merge_windows in the same variants
    (the kernels' Sched instances): a freezing window's block votes its
    insertion ranks out again at the final scale, scans and scatters them
    into its output row; the others write nothing more. Launches count
    under "merge_windows_sched". Bound: merge_windows' bytes and the
    freezing windows' output rows (bytes bound)."""
    if votes.device.type == "cpu":
        if variant is not None:
            raise KernelError("[racon_tpu_torch::kernels] merge_windows "
                              "variants are the card's")
        return merge_windows_sched_plain(
            votes, wesc, bb, bbw, alen, begin, end, win, ovf, orig_ids, out,
            ins_scale=ins_scale, scale_final=scale_final, last=last,
            n_win=n_win, LA=LA, detect=detect)
    res = _merge_windows_launch(
        votes, wesc, bb, bbw, alen, begin, end, win, ovf, members,
        (orig_ids, out, float(scale_final), bool(last)),
        ins_scale=ins_scale, n_win=n_win, LA=LA, detect=detect,
        variant=variant)
    _launched("merge_windows_sched")
    return res


def _merge_windows_launch(votes, wesc, bb, bbw, alen, begin, end, win, ovf,
                          members, sched, *, ins_scale, n_win, LA, detect,
                          variant):
    """One racon_merge_windows launch (the base mode, or with ``sched`` =
    (orig_ids, out, scale_final, last) the sched mode)."""
    if votes.device.type != "cuda":
        raise KernelError("[racon_tpu_torch::kernels] merge_windows needs a "
                          "CPU or CUDA tensor")
    B = begin.shape[0]
    dev = votes.device
    if n_win < 1 or LA < 1:
        raise KernelError(f"[racon_tpu_torch::kernels] merge_windows needs "
                          f"n_win and LA of at least 1, got {n_win}, {LA}")
    _check(votes, "votes", torch.float32, (n_win, VOTE_CH, LA + 1), dev)
    _check(wesc, "wesc", torch.float32, (n_win,), dev)
    _check(bb, "bb", torch.uint8, (n_win + 1, LA), dev)
    _check(bbw, "bbw", torch.float32, (n_win + 1, LA), dev)
    _check(alen, "alen", torch.int32, (n_win + 1,), dev)
    for name, t in (("begin", begin), ("end", end), ("win", win)):
        _check(t, name, torch.int32, (B,), dev)
    _check(ovf, "ovf", torch.bool, (n_win,), dev)
    order, starts, counts = _members(members, n_win, B, dev)
    sched_args = [None] * 5 + [0, 0.0, 0, 0]
    if sched is not None:
        orig_ids, (o_codes, o_cov, o_total, o_ovf), scale_final, last = sched
        R = o_codes.shape[0] - 1
        if R < 0:
            raise KernelError("[racon_tpu_torch::kernels] merge_windows_sched "
                              "needs output accumulators with a trash row")
        _check(orig_ids, "orig_ids", torch.int32, (n_win,), dev)
        _check(o_codes, "out codes", torch.uint8, (R + 1, LA), dev)
        _check(o_cov, "out cov", torch.int32, (R + 1, LA), dev)
        _check(o_total, "out total", torch.int32, (R + 1,), dev)
        _check(o_ovf, "out ovf", torch.bool, (R + 1,), dev)
        sched_args = [orig_ids.data_ptr(), o_codes.data_ptr(),
                      o_cov.data_ptr(), o_total.data_ptr(), o_ovf.data_ptr(),
                      R, scale_final, int(last), 1]
    plan = merge_windows_plan(LA, variant)
    wide = plan["variant"] == "wide"
    if not wide and votes.numel() >= 2 ** 31:
        raise KernelError(f"[racon_tpu_torch::kernels] the narrow "
                          f"merge_windows kernel takes sums of fewer than "
                          f"2^31 elements, got {votes.numel()}")
    scratch = torch.empty((n_win, merge_windows_scratch(LA)),
                          dtype=torch.uint8, device=dev) if wide else None
    new_bb = torch.empty_like(bb)
    new_bbw = torch.empty_like(bbw)
    new_alen = torch.empty_like(alen)
    nb = torch.empty_like(begin)
    ne = torch.empty_like(end)
    cov = torch.empty((n_win, LA), dtype=torch.int32, device=dev)
    ovf_out = torch.empty_like(ovf)
    conv = torch.empty_like(ovf)
    rc = _lib().racon_merge_windows(
        votes.data_ptr(), wesc.data_ptr(), bb.data_ptr(), bbw.data_ptr(),
        alen.data_ptr(), begin.data_ptr(), end.data_ptr(), win.data_ptr(),
        order.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        ovf.data_ptr(), new_bb.data_ptr(), new_bbw.data_ptr(),
        new_alen.data_ptr(), nb.data_ptr(), ne.data_ptr(), cov.data_ptr(),
        ovf_out.data_ptr(), conv.data_ptr(),
        scratch.data_ptr() if wide else None, B, n_win, LA, float(ins_scale),
        EPS, int(bool(detect)), int(wide), plan["threads"], *sched_args,
        _stream(dev))
    if rc != 0:
        raise KernelError(f"[racon_tpu_torch::kernels] merge_windows launch "
                          f"failed (cudaError {rc}, plan {plan}, sched "
                          f"{sched is not None})")
    return new_bb, new_bbw, new_alen, nb, ne, cov, ovf_out, conv


def chain_of_loads(steps: int, stride: int, device, lanes: int = 1,
                   lane_stride: int = 0) -> torch.Tensor:
    """The index array of :func:`chase`: from its last entry (less
    ``lane_stride`` entries a lane), ``steps`` loads each ``stride``
    entries below the last, for ``lanes`` lanes."""
    n = steps * stride + (lanes - 1) * lane_stride + 1
    if n >= 2 ** 31:
        raise KernelError(f"[racon_tpu_torch::kernels] a chain of {steps} "
                          f"loads {stride} entries apart outgrows int32")
    return (torch.arange(n, dtype=torch.int32, device=device) -
            stride).clamp_(min=0)


# Most entries (int32) the probe's shared mode holds: 48 KB.
CHASE_SHARED_ENTRIES = 12288


def chase(nxt: torch.Tensor, steps: int, lanes: int = 1,
          lane_stride: int = 0, shared: bool = False) -> torch.Tensor:
    """Lane b follows ``steps`` dependent loads ``i = nxt[i]`` from entry
    ``nxt.numel() - 1 - lane_stride * b``; returns the index each lane
    reaches (int32[lanes]). The latency probe of csrc/probe.cu on a CUDA
    tensor (``shared``: through a copy of ``nxt`` in shared memory, at
    most CHASE_SHARED_ENTRIES entries and 1024 lanes), a Python loop on a
    CPU tensor."""
    start = nxt.numel() - 1
    if start - lane_stride * (lanes - 1) < 0:
        raise KernelError(f"[racon_tpu_torch::kernels] {lanes} lanes "
                          f"{lane_stride} entries apart start outside the "
                          f"{nxt.numel()}-entry chain")
    if shared and (nxt.numel() > CHASE_SHARED_ENTRIES or lanes > 1024):
        raise KernelError(f"[racon_tpu_torch::kernels] the shared-memory "
                          f"chase takes at most {CHASE_SHARED_ENTRIES} "
                          f"entries and 1024 lanes, got {nxt.numel()} and "
                          f"{lanes}")
    if nxt.device.type == "cpu":
        ends = []
        for b in range(lanes):
            i = start - lane_stride * b
            for _ in range(steps):
                i = int(nxt[i])
            ends.append(i)
        return torch.tensor(ends, dtype=torch.int32)
    if nxt.device.type != "cuda":
        raise KernelError("[racon_tpu_torch::kernels] chase needs a CPU or "
                          "CUDA tensor")
    dev = nxt.device
    _check(nxt, "nxt", torch.int32, (nxt.numel(),), dev)
    end = torch.empty((lanes,), dtype=torch.int32, device=dev)
    rc = _lib().racon_chase(nxt.data_ptr(), start, int(lane_stride),
                            int(lanes), int(steps), int(shared),
                            end.data_ptr(), _stream(dev))
    if rc != 0:
        raise KernelError(f"[racon_tpu_torch::kernels] chase launch failed "
                          f"(cudaError {rc})")
    return end
