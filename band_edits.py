"""Per-edit times of the band kernels' shared row body on one NVIDIA GPU.

    python3 band_edits.py [--reps N]

csrc/band_fwd.cu's row body (K1 ``racon_band_fwd`` and K3
``racon_band_tile_fwd``) was edited to fill the card and shorten each
row. The edits tried, kept or not:

- ``reduce`` (kept): the warp totals of the scan read lane-parallel and
  folded with one ``__reduce_max_sync``, instead of a serial loop of up
  to 31 dependent shared-memory loads;
- ``i32`` (kept): the diagonal sum P + sub, its max with the up score
  and its compare with h formed in int32, as the plain version forms
  them (every score is at least NEG, so P + sub >= -2^31), instead of
  in 64 bits;
- ``active`` (kept): one in-band test a thread (SPT divides W, so a
  thread's slots are all in the band or all out) instead of one a slot;
- ``prmt`` (not kept): the byte and halfword stores packed with
  ``__byte_perm`` instead of masks, shifts and ors;
- ``bounds2`` and ``bounds3`` (not kept): ``__launch_bounds__(384, 2)``
  or ``(384, 3)`` on the tiled kernel, a floor of two or three resident
  384-thread blocks an SM (the W=1536 tier's block);
- ``left`` (not kept): slot x0-1 recomputed by each thread from the
  scan's exclusive prefix, instead of exchanged through shared memory
  behind a block barrier;
- ``spt2`` (kept; variant ``spt4`` is the kept body without it): K1 at
  1024 <= W <= 2048 with two band slots a thread instead of four (W/2
  threads a block, a two-slot vector store), twice the warps to hide
  each row's latency at half the blocks an SM. The tiled kernel keeps
  four.

The base variant ``before`` is the source with the kept edits reverted
by text replacement (the body before the edits); every other variant
applies some edits to that base, and applying the kept ones must give
the source back (variant ``kept``). All variants compile at once (one
nvcc each) under the build directory and load with ctypes. Each runs
the same inputs: K3 on tile 1 of an overlap group of G x 64 lanes (G
from the group planner at W=1536, T=2048, k=2) from tile 0's frontier,
K3 on the first 64 of those lanes, K1 at the consensus shape (B=4096,
Lq=640, W=256, k=4), on an untiled overlap chunk as phase 3 of
chip_smoke.py runs it (B=128, Lq=6144, W=1024, k=4), and on the main
path's untiled overlap bucket (3 chunks of 128 lanes at Lq=8192, W=1536,
k=2) in one launch of 384 lanes, which runs in as many waves as the
variant's occupancy gives (as its groups would), and on its first chunk
(B=128). ``--variants a,b`` builds and times only those. Every
variant's outputs must equal the current library's bitwise
(chip_smoke.py holds that library against the plain versions). Times
are warm medians of CUDA-event timings taken in turns (variants in
order, then in reverse, ``reps`` times: chip_smoke.time_turns). Prints one JSON line a case, with each
variant's ms, ms a lane, registers, spills and blocks an SM, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import sys

from chip_smoke import (band_inputs, card, fail, max_abs_err, overlap_chunk,
                        time_turns)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "racon_tpu_torch", "csrc", "band_fwd.cu")

_NO_BOUNDS = "__global__ void band_tile_kernel(RACON_BAND_PARAMS) {"
_BOUNDS = "__global__ void __launch_bounds__(384, {}) band_tile_kernel("
# (text without the edit, text with it) pairs of each edit.
EDITS = {
    "reduce": [(
        """    for (int w = 0; w < warp; ++w) excl = wmax[w] > excl ? wmax[w] : excl;
""",
        """    {
      const int m = __reduce_max_sync(kFull, lane < warp ? wmax[lane] : kNeg);
      excl = m > excl ? m : excl;
    }
""")],
    "i32": [
        ("    long long dg[SPT];\n", "    int dg[SPT];\n"),
        ("        dg[s] = (long long)P[x] + sub;\n",
         "        dg[s] = P[x] + sub;  // >= 2*NEG = -2^31, no wrap\n"),
        ("        long long t = dg[s] > upv[s] ? dg[s] : (long long)upv[s];\n"
         "        if (jc[s] == 0) t = (long long)i * gap;\n",
         "        int t = dg[s] > upv[s] ? dg[s] : upv[s];\n"
         "        if (jc[s] == 0) t = i * gap;\n"),
        ("        const int fv = (int)t - jc[s] * gap;\n",
         "        const int fv = t - jc[s] * gap;\n"),
        ("      d[s] = ((long long)hv == dg[s]) ? kDiag : (hv == upv[s] ? kUp"
         " : kLeft);\n",
         "      d[s] = hv == dg[s] ? kDiag : (hv == upv[s] ? kUp : kLeft);\n")],
    "active": [
        ("  for (int r = 1; r <= Lq; ++r) {\n",
         "  // SPT divides W, so a thread's slots are all in the band or all"
         " out.\n  const bool active = x0 < W;\n"
         "  for (int r = 1; r <= Lq; ++r) {\n"),
        ("      jc[s] = i + kl + x;\n      if (x < W) {\n",
         "      jc[s] = i + kl + x;\n      if (active) {\n"),
        ("    const size_t row = ((size_t)(i - 1) * B + b) * W + x0;\n"
         "    const bool active = x0 < W;\n",
         "    const size_t row = ((size_t)(i - 1) * B + b) * W + x0;\n"),
        ("      if (x < W) {\n        P[x] = h[s];\n",
         "      if (active) {\n        P[x] = h[s];\n")],
    "prmt": [
        ("    uint32_t w = (uint32_t)(v[0] & 0xff) | ((uint32_t)(v[1] & 0xff)"
         " << 8) |\n                 ((uint32_t)(v[2] & 0xff) << 16) | "
         "((uint32_t)(v[3] & 0xff) << 24);\n"
         "    *reinterpret_cast<uint32_t*>(p) = w;\n",
         "    const uint32_t lo = __byte_perm(v[0], v[1], 0x0040);  "
         "// v0.b0 v1.b0 . .\n"
         "    const uint32_t hi = __byte_perm(v[2], v[3], 0x0040);\n"
         "    *reinterpret_cast<uint32_t*>(p) = __byte_perm(lo, hi, 0x5410);"
         "\n"),
        ("    uint2 w;\n    w.x = (uint32_t)(v[0] & 0xffff) | "
         "((uint32_t)(v[1] & 0xffff) << 16);\n    w.y = (uint32_t)(v[2] & "
         "0xffff) | ((uint32_t)(v[3] & 0xffff) << 16);\n"
         "    *reinterpret_cast<uint2*>(p) = w;\n",
         "    *reinterpret_cast<uint2*>(p) = make_uint2(__byte_perm(v[0], "
         "v[1], 0x5410),\n"
         "                                              __byte_perm(v[2], "
         "v[3], 0x5410));\n")],
    "bounds2": [(_NO_BOUNDS, _BOUNDS.format(2) + "RACON_BAND_PARAMS) {")],
    "bounds3": [(_NO_BOUNDS, _BOUNDS.format(3) + "RACON_BAND_PARAMS) {")],
    "left": [(
        """    // Block-wide exclusive prefix max of the per-thread totals.
""",
        """    // Slot x0 - 1's diag score, read before the scan's barrier (the
    // row's writes to P follow it).
    const bool has_left = K >= 2 && tid > 0 && x0 <= W;
    const int pl = has_left ? P[x0 - 1] : 0;
    // Block-wide exclusive prefix max of the per-thread totals.
"""), (
        """      edge[tid] = un[SPT - 1];
      __syncthreads();
      int left = tid > 0 ? edge[tid - 1] : kLeft;
""",
        """      // Slot x0 - 1 recomputed: its inclusive prefix is this thread's
      // exclusive one, its up neighbour P[x0], its predecessor UC[x0].
      int left = kLeft;
      if (has_left) {
        const int jl = jc[0] - 1;
        int sub = (tb[r - 2 + x0] == qb) ? match : mismatch;
        if (jl < 1) sub = kNeg;
        const long long dgl = (long long)pl + sub;
        const int hv = jl >= 0 ? excl + jl * gap : kNeg;
        const int dl = ((long long)hv == dgl)
                           ? kDiag
                           : (hv == P[x0] + gap ? kUp : kLeft);
        const int uu = ((ucp[0] >> 2) & 0xF) + 1;
        left = dl == kUp ? ((uu < kUSat ? uu : kUSat) << 2) + (ucp[0] & 3)
                         : dl;
      }
""")],
    "spt2": [(
        """template <>
struct Vec<4> {
""",
        """template <>
struct Vec<2> {
  static __device__ void put8(uint8_t* p, const int* v) {
    *reinterpret_cast<uint16_t*>(p) =
        (uint16_t)((v[0] & 0xff) | ((v[1] & 0xff) << 8));
  }
  static __device__ void put16(uint16_t* p, const int* v) {
    *reinterpret_cast<uint32_t*>(p) =
        (uint32_t)(v[0] & 0xffff) | ((uint32_t)(v[1] & 0xffff) << 16);
  }
};
template <>
struct Vec<4> {
"""), (
        """  (void)tiled;
  return (W % 4) == 0 ? 4 : 1;
""",
        """  if (!tiled && W >= 1024 && W <= 2048 && W % 2 == 0) return 2;
  return (W % 4) == 0 ? 4 : 1;
"""), (
        """  return band_spt(tiled, W) == 4 ? band_kernel_spt<4>(tiled, k)
                                 : band_kernel_spt<1>(tiled, k);
""",
        """  switch (band_spt(tiled, W)) {
    case 4: return band_kernel_spt<4>(tiled, k);
    case 2: return band_kernel_spt<2>(tiled, k);
    default: return band_kernel_spt<1>(tiled, k);
  }
""")],
}
KEPT = ("reduce", "i32", "active", "spt2")
VARIANTS = {"before": (), "reduce": ("reduce",), "i32": ("i32",),
            "active": ("active",), "prmt": ("prmt",),
            "bounds2": ("bounds2",), "bounds3": ("bounds3",),
            "left": ("left",), "reduce+i32": ("reduce", "i32"),
            "kept": KEPT, "kept+prmt": KEPT + ("prmt",),
            "kept+bounds2": KEPT + ("bounds2",),
            "kept+left": KEPT + ("left",), "spt4": KEPT[:-1]}


def _swap(src: str, name: str, pairs) -> str:
    for a, b in pairs:
        if src.count(a) != 1:
            fail(f"edit {name!r}: its text is not in band_fwd.cu once")
        src = src.replace(a, b)
    return src


def variant_source(src: str, applied) -> str:
    """The source with the kept edits reverted, then ``applied`` made."""
    for name in KEPT:
        src = _swap(src, name, [(b, a) for a, b in EDITS[name]])
    for name in applied:
        src = _swap(src, name, EDITS[name])
    return src


def build_variants(names) -> dict:
    """One shared library for each variant in ``names``, compiled at once;
    returns name -> ctypes library."""
    from racon_tpu_torch.native.build import build_dir, content_tag, run_build
    from racon_tpu_torch.ops import kernels
    with open(_SRC) as f:
        src = f.read()
    if variant_source(src, KEPT) != src:
        fail("reverting and re-making the kept edits does not give "
             "band_fwd.cu back")
    out = os.path.join(build_dir(), "band_edits")
    os.makedirs(out, exist_ok=True)
    paths, cmds = {}, []
    for name in names:
        cu = os.path.join(out, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, VARIANTS[name]))
        tag = content_tag([cu], kernels.NVCC_FLAGS)
        paths[name] = os.path.join(out, f"lib{name}.{tag}.so")
        if not os.path.isfile(paths[name]):
            cmds.append([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", cu,
                         "-o", paths[name]])
    run_build(cmds)
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        lib.racon_band_fwd.restype = ci
        lib.racon_band_fwd.argtypes = [vp] * 8 + [ci] * 7 + [vp]
        lib.racon_band_tile_fwd.restype = ci
        lib.racon_band_tile_fwd.argtypes = [vp] * 13 + [ci] * 8 + [vp]
        lib.racon_band_occupancy.restype = ci
        lib.racon_band_occupancy.argtypes = [ci] * 4 + [vp]
        libs[name] = lib
    return libs


def occupancy(lib, tiled, W, rows, k) -> dict:
    out = (ctypes.c_int * 4)()
    rc = lib.racon_band_occupancy(int(tiled), W, rows, k, out)
    if rc:
        fail(f"occupancy query failed (cudaError {rc})")
    return {"regs": out[1], "spills": out[2], "blocks_per_sm": out[0]}


def tile_case(device, B, W=1536, T=2048, k=2):
    """Tile 1 of a B-lane overlap group from tile 0's frontier: returns
    (run(lib) -> outputs, the current library's outputs)."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.band import band_targets, row0_scores, uc_boundary
    c = overlap_chunk(device, B, 9900, W, T)
    Lq = c["Lq"]
    base = torch.arange(B, dtype=torch.int64, device=device) * Lq
    qT = c["q"].t().contiguous()
    sc = dict(match=0, mismatch=-1, gap=-1, W=W, nxt_k=k)

    def planes():
        return (torch.zeros((2 * T, B, W), dtype=torch.uint8, device=device),
                torch.zeros((2 * T, B, W), dtype=torch.uint8, device=device),
                None)
    prev = row0_scores(c["klo"], W, -1)
    uc = torch.full((B, W), uc_boundary(k), dtype=torch.int32, device=device)
    tb0 = band_targets(c["t"].reshape(-1), base, c["klo"], c["lt"], W + T)
    *_, hl, prev, uc = kernels.fw_dirs_band_tile(
        tb0, qT[:T], c["klo"], c["lq"], 0, prev, uc, prev.clone(),
        out=planes(), **sc)
    tb1 = band_targets(c["t"].reshape(-1), base, c["klo"], c["lt"], W + T,
                       origin=T)
    q1 = qT[T:2 * T].contiguous()
    pl = planes()
    hl_o, p_o, uc_o = (torch.empty((B, W), dtype=torch.int32, device=device)
                       for _ in range(3))

    def run(lib):
        rc = lib.racon_band_tile_fwd(
            tb1.data_ptr(), q1.data_ptr(), c["klo"].data_ptr(),
            c["lq"].data_ptr(), prev.data_ptr(), uc.data_ptr(),
            hl.data_ptr(), pl[0].data_ptr(), pl[1].data_ptr(), None,
            hl_o.data_ptr(), p_o.data_ptr(), uc_o.data_ptr(), B, T, T, W, 0,
            -1, -1, k, torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f"band_tile_fwd launch failed (cudaError {rc})")
        return (pl[0][T:], pl[1][T:], hl_o, p_o, uc_o)
    ref = kernels.fw_dirs_band_tile(tb1, q1, c["klo"], c["lq"], T, prev, uc,
                                    hl, out=planes(), **sc)
    return run, (ref[0], ref[1]) + tuple(ref[3:])


def untiled_case(device, args, Lq, W, k, sc):
    """K1 on ``args`` = (tband, qT, klo, lq): (run(lib) -> outputs, the
    current library's outputs)."""
    import torch
    from racon_tpu_torch.ops import kernels
    B = args[0].shape[0]
    cells = torch.empty((Lq, B, W), dtype=torch.uint8, device=device)
    nxt = torch.empty_like(cells)
    nxt2 = (torch.empty((Lq, B, W), dtype=torch.uint16, device=device)
            if k >= 4 else None)
    hl = torch.empty((B, W), dtype=torch.int32, device=device)

    def run(lib):
        rc = lib.racon_band_fwd(*(a.data_ptr() for a in args),
                                cells.data_ptr(), nxt.data_ptr(),
                                None if nxt2 is None else nxt2.data_ptr(),
                                hl.data_ptr(), B, Lq, W,
                                sc["match"], sc["mismatch"], sc["gap"], k,
                                torch.cuda.current_stream().cuda_stream)
        if rc:
            fail(f"band_fwd launch failed (cudaError {rc})")
        return cells, nxt, nxt2, hl
    return run, kernels.fw_dirs_band(*args, W=W, nxt_k=k, **sc)


def consensus_case(device, B=4096, Lq=640, W=256, k=4):
    *args, _ = band_inputs(device, B, Lq, W)
    return untiled_case(device, args, Lq, W, k,
                        dict(match=5, mismatch=-4, gap=-8))


def overlap_case(device, B=128, L=5400, W=1024, k=4, seed=6):
    """Untiled overlap lanes of L-base reads: by default a chunk as phase
    3 of chip_smoke.py runs it."""
    import torch
    from racon_tpu_torch.ops.band import band_targets
    c = overlap_chunk(device, B, L, W, T=2048, tiled=False, seed=seed)
    Lq = c["Lq"]
    base = torch.arange(B, dtype=torch.int64, device=device) * Lq
    args = (band_targets(c["t"].reshape(-1), base, c["klo"], c["lt"],
                         W + Lq), c["q"].t().contiguous(), c["klo"], c["lq"])
    return untiled_case(device, args, Lq, W, k,
                        dict(match=0, mismatch=-1, gap=-1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants to build and time")
    opts = ap.parse_args()
    names = opts.variants.split(",")
    if any(n not in VARIANTS for n in names):
        fail(f"--variants: choose from {', '.join(VARIANTS)}")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    from racon_tpu_torch.ops import ovl_align
    name_limit = card()
    libs = build_variants(names)
    dev = "cuda"
    G = ovl_align.group_size(64, 1536, 2048, 2, dev)
    # The main path's untiled bucket: 3 chunks of reads up to ~8 kb,
    # Lq=8192, W=1536.
    main_untiled = dict(L=7500, W=1536, k=2, seed=12)
    cases = [("band_tile_fwd group", G * 64, (True, 1536, 2048, 2),
              lambda: tile_case(dev, G * 64)),
             ("band_tile_fwd 64 lanes", 64, (True, 1536, 2048, 2),
              lambda: tile_case(dev, 64)),
             ("band_fwd consensus k=4", 4096, (False, 256, 640, 4),
              lambda: consensus_case(dev)),
             ("band_fwd overlap untiled k=4", 128, (False, 1024, 6144, 4),
              lambda: overlap_case(dev)),
             ("band_fwd overlap untiled bucket of 3 chunks k=2",
              3 * ovl_align.TB, (False, 1536, 8192, 2),
              lambda: overlap_case(dev, 3 * ovl_align.TB, **main_untiled)),
             ("band_fwd overlap untiled chunk k=2", ovl_align.TB,
              (False, 1536, 8192, 2),
              lambda: overlap_case(dev, ovl_align.TB, **main_untiled))]
    for case, B, geo, make in cases:
        run, ref = make()
        rec = {}
        for name, lib in libs.items():
            err = max_abs_err(ref, run(lib))
            if err:
                fail(f"{case}: variant {name!r} disagrees with the current "
                     f"library (max_abs_err={err})")
            rec[name] = occupancy(lib, *geo)
        times = time_turns([functools.partial(run, lib)
                            for lib in libs.values()], opts.reps)
        for name, ms in zip(libs, times):
            rec[name].update(ms=ms, ms_per_lane=ms / B, max_abs_err=0)
        print(json.dumps({"case": case, "B": B, "card": name_limit,
                          "variants": rec}), flush=True)
        del run, ref
        torch.cuda.empty_cache()
    print(name_limit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
