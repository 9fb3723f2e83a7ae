"""The port's CUDA kernels against their plain PyTorch versions, bitwise:
the banded forward (untiled and tiled, each also over a group of
chunks' lanes at the overlap routes' widths), the full-width forward, the
column walk (band and flat layouts) and the walk's latency probe, the
batched NW forward (K4) and its traceback (T1), the monotone count (K5),
the batched aligner end to end, and the round merge (M1, M2 and M2's
sched mode: each against its plain version, and a chunk's rounds, under
the fixed engine and the convergence scheduler, against the CPU run), and
the streaming pipeline's new call paths (a chunk's decoupled walk on
another thread against the fused chunk; stream_consensus against the
serial engine), and the fault plane on the card (a guarded dispatch on
a caller's stream, an abandoned hang, every chunk degraded to the host
path, which device errors are retried).

Needs an NVIDIA GPU with nvcc (the kernels build on first use); on a host
without one every test here skips. Run on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda -q``. No JAX import:
the GPU host runs the port alone.
"""

import numpy as np
import pytest
import torch

from racon_tpu_torch.ops import align, kernels, ovl_align
from racon_tpu_torch.ops.band import (band_geometry, band_targets,
                                      fw_dirs_band_plain,
                                      fw_dirs_band_tile_plain, row0_scores,
                                      uc_boundary)
from racon_tpu_torch.ops.colwalk import col_walk
from racon_tpu_torch.ops.device_merge import monotone_count_plain
from racon_tpu_torch.ops.encode import encode_bases
from racon_tpu_torch.ops.flat import fw_dirs_flat_plain
from racon_tpu_torch.utils.synth import _BASES, mutate

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("torch.cuda.is_available() is False: no GPU on this host")
    return torch.device("cuda")


def _band_case(seed, B, Lq, W, spread):
    rng = np.random.default_rng(seed)
    lq = rng.integers(max(1, Lq // 4), Lq + 1, B).astype(np.int32)
    lt = (lq + rng.integers(-spread, spread + 1, B)).clip(1).astype(np.int32)
    klo, _ = band_geometry(torch.from_numpy(lq), torch.from_numpy(lt), W)
    tband = rng.integers(0, 5, (B, W + Lq)).astype(np.uint8)
    tband[rng.random((B, W + Lq)) < 0.05] = 7
    qT = rng.integers(0, 4, (Lq, B)).astype(np.uint8)
    return (torch.from_numpy(tband), torch.from_numpy(qT), klo,
            torch.from_numpy(lq))


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    if a.dtype == torch.uint16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("W,k", [(128, 1), (128, 2), (256, 4), (192, 4),
                                 (100, 2)])
@pytest.mark.parametrize("scoring", [(5, -4, -8), (1, -1, -1), (0, -1, -1)])
def test_band_kernel_matches_plain(cuda, W, k, scoring):
    m, x, g = scoring
    args = _band_case(3, 96, 64, W, W // 2)
    ref = fw_dirs_band_plain(*args, match=m, mismatch=x, gap=g, W=W,
                             nxt_k=k)
    n0 = kernels.LAUNCHES["band_fwd"]
    out = kernels.fw_dirs_band(*(a.to(cuda) for a in args), match=m,
                               mismatch=x, gap=g, W=W, nxt_k=k)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["band_fwd"] == n0 + 1
    for r, o in zip(ref, out):
        assert _same(r, o)


@pytest.mark.parametrize("Lt", [128, 640, 130])
@pytest.mark.parametrize("scoring", [(5, -4, -8), (0, -1, -1)])
def test_flat_kernel_matches_plain(cuda, Lt, scoring):
    m, x, g = scoring
    rng = np.random.default_rng(5)
    B, Lq = 64, 96
    tbuf = torch.from_numpy(rng.integers(0, 5, (B, Lt)).astype(np.uint8))
    qT = torch.from_numpy(rng.integers(0, 4, (Lq, B)).astype(np.uint8))
    ref = fw_dirs_flat_plain(tbuf, qT, match=m, mismatch=x, gap=g)
    n0 = kernels.LAUNCHES["flat_fwd"]
    out = kernels.fw_dirs_flat(tbuf.to(cuda), qT.to(cuda), match=m,
                               mismatch=x, gap=g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flat_fwd"] == n0 + 1
    assert torch.equal(ref, out.cpu())


def _tile_chain(fwd, args, B, Lq, W, T, k, scoring, dev):
    """Chain ``fwd`` over Lq // T tiles into stitched planes; the band
    origin moves by a few slots between tiles (the frontier is not
    shifted: the kernel and its plain version see the same inputs)."""
    tband, qT, klo, lq = (a.to(dev) for a in args)
    m, x, g = scoring
    planes = (torch.zeros((Lq, B, W), dtype=torch.uint8, device=dev),
              torch.zeros((Lq, B, W), dtype=torch.uint8, device=dev),
              torch.zeros((Lq, B, W), dtype=torch.uint16, device=dev)
              if k == 4 else None)
    prev = row0_scores(klo, W, g)
    uc = torch.full((B, W), uc_boundary(k), dtype=torch.int32, device=dev)
    hl = prev.clone()
    for ti in range(Lq // T):
        kl = (klo - 2 * ti).contiguous()
        *_, hl, prev, uc = fwd(
            tband[:, ti * T:ti * T + W + T].contiguous(),
            qT[ti * T:(ti + 1) * T].contiguous(), kl, lq, ti * T, prev, uc,
            hl, match=m, mismatch=x, gap=g, W=W, nxt_k=k, out=planes)
    return planes + (hl, prev, uc)


@pytest.mark.parametrize("W,k", [(128, 2), (256, 4), (100, 2), (192, 4)])
@pytest.mark.parametrize("scoring", [(5, -4, -8), (0, -1, -1)])
def test_band_tile_kernel_matches_plain(cuda, W, k, scoring):
    B, Lq, T = 48, 96, 32
    args = _band_case(7, B, Lq, W, W // 2)
    ref = _tile_chain(fw_dirs_band_tile_plain, args, B, Lq, W, T, k,
                      scoring, torch.device("cpu"))
    n0 = kernels.LAUNCHES["band_tile_fwd"]
    out = _tile_chain(kernels.fw_dirs_band_tile, args, B, Lq, W, T, k,
                      scoring, cuda)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["band_tile_fwd"] == n0 + Lq // T
    for r, o in zip(ref, out):
        assert _same(r, o)


@pytest.mark.parametrize("W,k", [(1536, 2), (2048, 4)])
def test_band_tile_kernel_group_matches_plain(cuda, W, k):
    """K3 at the overlap tiers' band widths (384- and 512-thread blocks)
    over 144 lanes, more than one 64-lane chunk: a group's launch."""
    B, Lq, T = 144, 64, 32
    args = _band_case(19, B, Lq, W, 200)
    ref = _tile_chain(fw_dirs_band_tile_plain, args, B, Lq, W, T, k,
                      (0, -1, -1), torch.device("cpu"))
    out = _tile_chain(kernels.fw_dirs_band_tile, args, B, Lq, W, T, k,
                      (0, -1, -1), cuda)
    torch.cuda.synchronize()
    for r, o in zip(ref, out):
        assert _same(r, o)


@pytest.mark.parametrize("W,k,B,Lq", [(1536, 2, 768, 2048),
                                      (1024, 4, 384, 256),
                                      (2048, 4, 256, 256)])
def test_band_kernel_untiled_group_matches_plain(cuda, W, k, B, Lq):
    """K1 on a launch group of untiled overlap chunks (128 lanes each) at
    the untiled route's band widths, where it runs two slots a thread
    (512 to 1024 threads a block): the one launch over the group's lanes
    is bitwise the plain version's (run on the card) and, chunk by chunk,
    what each chunk launched alone gives. The 768-lane group's planes
    hold 2.4e9 elements, past 2^31, as the main path's untiled groups'
    do: every plane offset in the kernel is 64-bit."""
    TB = ovl_align.TB
    tband, qT, klo, lq = (a.to(cuda) for a in
                          _band_case(23, B, Lq, W, 300))
    sc = dict(match=0, mismatch=-1, gap=-1, W=W, nxt_k=k)
    n0 = kernels.LAUNCHES["band_fwd"]
    out = kernels.fw_dirs_band(tband, qT, klo, lq, **sc)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["band_fwd"] == n0 + 1
    ref = fw_dirs_band_plain(tband, qT, klo, lq, **sc)
    for r, o in zip(ref, out):
        assert _same(r, o)
    del ref
    for s in range(0, B, TB):
        part = slice(s, s + TB)
        alone = kernels.fw_dirs_band(tband[part], qT[:, part].contiguous(),
                                     klo[part], lq[part], **sc)
        for p, a in zip(out[:3], alone[:3]):
            assert _same(None if p is None else p[:, part], a)
        assert _same(out[3][part], alone[3])


def test_band_untiled_occupancy(cuda):
    """The main path's untiled K1 instantiation (W=1536, Lq=8192, k=2;
    two slots a thread) holds two or more blocks an SM without spilling;
    the group planner then carries blocks x SMs // 128 untiled chunks a
    launch."""
    occ = kernels.band_occupancy(1536, 8192, 2, tiled=False)
    assert occ["threads"] == 768
    assert occ["blocks_per_sm"] >= 2 and occ["spills"] == 0
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    G = ovl_align.group_size(ovl_align.TB, 1536, 8192, 2, cuda, tiled=False)
    assert G == occ["blocks_per_sm"] * sms // ovl_align.TB >= 2


def test_band_tile_occupancy(cuda):
    """The main path's K3 instantiation (W=1536, T=2048, k=2) holds two
    blocks an SM without spilling; the group planner then carries
    blocks x SMs // 64 chunks a launch."""
    occ = kernels.band_occupancy(1536, 2048, 2, tiled=True)
    assert occ["threads"] == 384
    assert occ["blocks_per_sm"] >= 2 and occ["spills"] == 0
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ovl_align.group_size(64, 1536, 2048, 2, cuda) == \
        occ["blocks_per_sm"] * sms // 64
    assert kernels.band_occupancy(256, 640, 4, tiled=False)[
        "blocks_per_sm"] >= 1


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("tiled", [False, True])
def test_col_walk_kernel_matches_plain(cuda, k, tiled):
    """Planes of a real forward; the tiled case maps rows through
    per-tile origins and emits int32."""
    B, Lq, W, T = 40, 96, 128, 32
    tband, qT, klo, lq = _band_case(11, B, Lq, W, 20)
    rng = np.random.default_rng(12)
    lt = (lq + torch.from_numpy(rng.integers(-20, 21, B)).to(torch.int32)
          ).clamp(min=1)
    LA = int(lt.max()) + 24
    t_off = torch.from_numpy(rng.integers(0, 24, B).astype(np.int32))
    cells, nxt, nxt2, _ = fw_dirs_band_plain(tband, qT, klo, lq, match=5,
                                             mismatch=-4, gap=-8, W=W,
                                             nxt_k=k)
    kw = dict(LA=LA, layout="band", nxt=nxt, nxt2=nxt2)
    if tiled:
        kw.update(tile_klo=(klo[None, :] + torch.from_numpy(
            rng.integers(-2, 3, (Lq // T, B)).astype(np.int32))).contiguous(),
            tile_len=T, emit=torch.int32)
    ref = col_walk(cells, lq, lt, klo, t_off, **kw)
    n0 = kernels.LAUNCHES["col_walk"]
    kw_d = {n: (v.to(cuda) if isinstance(v, torch.Tensor) else v)
            for n, v in kw.items()}
    out = kernels.col_walk_kernel(cells.to(cuda), lq.to(cuda), lt.to(cuda),
                                  klo.to(cuda), t_off.to(cuda), **kw_d)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["col_walk"] == n0 + 1
    for name in ("ins_len", "qstart", "op_c", "qi_c", "sat"):
        assert out[name].dtype == ref[name].dtype
        assert torch.equal(ref[name], out[name].cpu()), name


def _reads(seed, B, Lq, err=0.08):
    """B targets of 3/4 to all of Lq - 8 bases and err-error reads of
    them cut to Lq, as base codes zero-padded to Lq: (q, t, lq, lt)."""
    rng = np.random.default_rng(seed)
    q = np.zeros((B, Lq), np.uint8)
    t = np.zeros((B, Lq), np.uint8)
    lq = np.zeros(B, np.int32)
    lt = np.zeros(B, np.int32)
    for b in range(B):
        tt = _BASES[rng.integers(0, 4, int(rng.integers(Lq * 3 // 4,
                                                         Lq - 7)))]
        qq = mutate(rng, tt, err)[0][:Lq]
        q[b, :len(qq)] = encode_bases(qq.tobytes())
        t[b, :len(tt)] = encode_bases(tt.tobytes())
        lq[b], lt[b] = len(qq), len(tt)
    return (torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(lq),
            torch.from_numpy(lt))


def _reads_case(seed, B, Lq, W):
    """Band inputs of 8%-error reads of their targets: paths stay near
    the diagonal. Returns (tband, qT, klo, lq, lt)."""
    q, t, lq, lt = _reads(seed, B, Lq)
    klo, _ = band_geometry(lq, lt, W)
    base = torch.arange(B, dtype=torch.int64) * Lq
    tband = band_targets(t.reshape(-1), base, klo, lt, W + Lq)
    return tband, q.t().contiguous(), klo, lq, lt


def _edge_case(seed, B, Lq, W):
    """Random planes whose lanes reach the plane's edges: targets up to W
    longer or shorter than their queries (paths along slot 0 and slot
    W - 1), queries far shorter than their targets (the walk reaches row
    0 long before column 0), and one-base queries and targets."""
    tband, qT, klo, lq = _band_case(seed, B, Lq, W, W)
    rng = np.random.default_rng(seed + 1)
    lt = (lq + torch.from_numpy(rng.integers(-W, W + 1, B)).to(torch.int32)
          ).clamp(min=1)
    lq = lq.clone()
    lq[:4] = torch.tensor([1, 1, 2, Lq], dtype=torch.int32)
    lt[:4] = torch.tensor([1, Lq, 1, 1], dtype=torch.int32)
    klo, _ = band_geometry(lq, lt, W)
    return tband, qT, klo, lq, lt


# Walk plans beside the planner's default (None): tiny windows that miss
# often, four threads a lane with lanes sharing a warp, one lane a warp
# with windows wider than some planes, and one-row windows (one read a
# window, nothing prefetched) with eight lanes a warp.
_WALK_PLANS = [None, {"G": 4, "R": 8, "S": 16, "lanes_per_block": 3},
               {"G": 8, "R": 24, "S": 32, "lanes_per_block": 5},
               {"G": 32, "R": 64, "S": 64, "lanes_per_block": 2},
               {"G": 4, "R": 1, "S": 32, "lanes_per_block": 9}]


def _walk_both(cuda, cells, lq, lt, klo, t_off, plans=_WALK_PLANS, **kw):
    """The plain walk on the CPU and W1 under each plan on the card, with
    a refill counter: every field equal, bitwise."""
    ref = col_walk(cells, lq, lt, klo, t_off, **kw)
    kw_d = {n: (v.to(cuda) if isinstance(v, torch.Tensor) else v)
            for n, v in kw.items()}
    args = [None if a is None else a.to(cuda)
            for a in (cells, lq, lt, klo, t_off)]
    counts = []
    for plan in plans:
        refills = torch.zeros((lq.shape[0], 2), dtype=torch.int32,
                              device=cuda)
        out = kernels.col_walk_kernel(*args, plan=plan, refills=refills,
                                      **kw_d)
        torch.cuda.synchronize()
        for name in ("ins_len", "qstart", "op_c", "qi_c", "sat"):
            assert out[name].dtype == ref[name].dtype
            assert torch.equal(ref[name], out[name].cpu()), (name, plan)
        counts.append(refills.cpu())
    return counts


@pytest.mark.parametrize("emit", [torch.int16, torch.int32])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("case", ["reads", "random", "edges"])
def test_col_walk_kernel_cases(cuda, case, k, emit):
    """W1 bitwise against the plain walk on a forward of 8%-error reads
    (near-diagonal paths: windows hit), on random planes (paths wander:
    windows miss) and on lanes that reach row 0, slot 0 and slot W - 1;
    B = 37 is no multiple of any plan's lanes a block, and LA + 2 = 4m + 3
    leaves the last group of four positions partial."""
    B, Lq, W = 37, 160, 128
    if case == "reads":
        tband, qT, klo, lq, lt = _reads_case(31, B, Lq, W)
    elif case == "random":
        tband, qT, klo, lq = _band_case(32, B, Lq, W, 20)
        lt = (lq + torch.from_numpy(np.random.default_rng(33).integers(
            -20, 21, B)).to(torch.int32)).clamp(min=1)
    else:
        tband, qT, klo, lq, lt = _edge_case(34, B, Lq, W)
    cells, nxt, nxt2, _ = fw_dirs_band_plain(tband, qT, klo, lq, match=5,
                                             mismatch=-4, gap=-8, W=W,
                                             nxt_k=k)
    LA = int(lt.max()) + 24
    LA += (3 - (LA + 2)) % 4
    t_off = torch.from_numpy(np.random.default_rng(35).integers(
        0, 24, B).astype(np.int32))
    counts = _walk_both(cuda, cells, lq, lt, klo, t_off, LA=LA,
                        layout="band", nxt=nxt, nxt2=nxt2, emit=emit)
    for c in counts:
        assert (c[:, 1] >= 1).all() and (c[:, 0] >= c[:, 1]).all()
    if case == "reads":
        # Near-diagonal paths walk from window to window, and most
        # prefetched windows hold the next cell (24 x 32 windows).
        per_lane = counts[2].to(torch.float64).mean(dim=0)
        assert per_lane[1] < per_lane[0] / 2


@pytest.mark.parametrize("shift", ["within", "beyond"])
@pytest.mark.parametrize("k", [2, 4])
def test_col_walk_kernel_tile_shifts(cuda, k, shift):
    """The tiled route (int32): tile origins shifted between tiles by less
    than the windows' 16 slots and by more than their 64, on the planes of
    a forward of 8%-error reads."""
    B, Lq, W, T = 29, 192, 128, 32
    tband, qT, klo, lq, lt = _reads_case(41, B, Lq, W)
    cells, nxt, nxt2, _ = fw_dirs_band_plain(tband, qT, klo, lq, match=0,
                                             mismatch=-1, gap=-1, W=W,
                                             nxt_k=k)
    rng = np.random.default_rng(42)
    step = rng.integers(-3, 4, (Lq // T, B)) if shift == "within" else \
        rng.choice([-70, 70], (Lq // T, B))
    step[0] = 0
    tile_klo = (klo[None, :] + torch.from_numpy(
        np.cumsum(step, axis=0).astype(np.int32))).contiguous()
    _walk_both(cuda, cells, lq, lt, None, torch.zeros_like(lq), LA=Lq,
               layout="band", nxt=nxt, nxt2=nxt2, tile_klo=tile_klo,
               tile_len=T, emit=torch.int32)


@pytest.mark.parametrize("emit", [torch.int16, torch.int32])
def test_flat_col_walk_kernel_plans(cuda, emit):
    """The flat layout (k=1) under every plan, on full-width planes of
    8%-error reads and of random codes; LA + 2 not a multiple of four."""
    B, Lq, Lt = 37, 96, 112
    rng = np.random.default_rng(51)
    q, t, lq, lt = _reads(52, B, Lq)
    tbuf = torch.zeros((B, Lt), dtype=torch.uint8)
    tbuf[:, :Lq] = t
    for planes in ("reads", "random"):
        if planes == "random":
            q = torch.from_numpy(rng.integers(0, 4, (B, Lq)).astype(np.uint8))
            tbuf = torch.from_numpy(rng.integers(0, 4, (B, Lt)).astype(
                np.uint8))
        cells = fw_dirs_flat_plain(tbuf, q.t().contiguous(), match=5,
                                   mismatch=-4, gap=-8)
        t_off = torch.from_numpy(rng.integers(0, 12, B).astype(np.int32))
        _walk_both(cuda, cells, lq, lt, None, t_off, LA=Lt + 13,
                   layout="flat", emit=emit)


def test_col_walk_kernel_rejects_bad_plans(cuda):
    """A plan the kernel cannot launch (threads a lane not a power of two,
    a block past 1024 threads, windows past the shared memory a block may
    hold) raises, as do planes whose rows are no whole 16-byte pieces (W
    not a multiple of 16, a plane off 16-byte alignment); nothing falls
    back."""
    B, Lq, W = 8, 16, 128
    cells = torch.zeros((Lq, B, W), dtype=torch.uint8, device=cuda)
    lq = torch.full((B,), Lq, dtype=torch.int32, device=cuda)
    for plan in ({"G": 6, "R": 8, "S": 16, "lanes_per_block": 1},
                 {"G": 32, "R": 8, "S": 16, "lanes_per_block": 64},
                 {"G": 32, "R": 2048, "S": 128, "lanes_per_block": 1}):
        with pytest.raises(kernels.KernelError):
            kernels.col_walk_kernel(cells, lq, lq, lq * 0, lq * 0, LA=Lq,
                                    layout="band", plan=plan)
    odd = torch.zeros((Lq, B, 100), dtype=torch.uint8, device=cuda)
    off = torch.zeros(Lq * B * W + 8, dtype=torch.uint8, device=cuda)[8:]
    for planes in (odd, off.view(Lq, B, W)):
        with pytest.raises(kernels.KernelError):
            kernels.col_walk_kernel(planes, lq, lq, lq * 0, lq * 0, LA=Lq,
                                    layout="band")


def test_walk_plans_fit_the_card(cuda):
    """The planner's plans for the main path's four walks launch on this
    card: at least one block an SM, no spills, and every lane of a
    one-wave launch resident at once."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for B, k, layout, n_tiles, emit in ((384, 2, "band", 5, torch.int32),
                                        (128, 4, "band", 0, torch.int16),
                                        (4096, 4, "band", 0, torch.int16),
                                        (1024, 1, "flat", 0, torch.int16)):
        plan = kernels.walk_plan(B, k, layout=layout, n_tiles=n_tiles,
                                 sms=sms)
        occ = kernels.walk_occupancy(k, layout=layout, emit=emit, plan=plan)
        assert occ["spills"] == 0
        blocks = -(-B // plan["lanes_per_block"])
        assert occ["blocks_per_sm"] * sms >= blocks, (B, plan, occ)


@pytest.mark.parametrize("emit", [torch.int16, torch.int32])
@pytest.mark.parametrize("scoring", [(5, -4, -8), (0, -1, -1)])
def test_flat_col_walk_kernel_matches_plain(cuda, emit, scoring):
    """The walk on the full-width forward's planes (layout "flat", k=1),
    as the band-off consensus path and the full-width redo run it."""
    m, x, g = scoring
    rng = np.random.default_rng(13)
    B, Lq, Lt = 48, 96, 128
    lq = torch.from_numpy(rng.integers(1, Lq + 1, B).astype(np.int32))
    lt = torch.from_numpy(rng.integers(1, Lt - 20, B).astype(np.int32))
    tbuf = torch.from_numpy(rng.integers(0, 4, (B, Lt)).astype(np.uint8))
    qT = torch.from_numpy(rng.integers(0, 4, (Lq, B)).astype(np.uint8))
    cells = fw_dirs_flat_plain(tbuf, qT, match=m, mismatch=x, gap=g)
    t_off = torch.from_numpy(rng.integers(0, 20, B).astype(np.int32))
    LA = Lt + 20
    ref = col_walk(cells, lq, lt, None, t_off, LA=LA, layout="flat",
                   emit=emit)
    n0 = kernels.LAUNCHES["col_walk"]
    out = kernels.col_walk_kernel(cells.to(cuda), lq.to(cuda), lt.to(cuda),
                                  None, t_off.to(cuda), LA=LA, layout="flat",
                                  emit=emit)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["col_walk"] == n0 + 1
    for name in ("ins_len", "qstart", "op_c", "qi_c", "sat"):
        assert out[name].dtype == ref[name].dtype
        assert torch.equal(ref[name], out[name].cpu()), name


def _nw_case(seed, B, Lq, Lt):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(0, 5, (B, Lq)).astype(np.uint8))
    t = torch.from_numpy(rng.integers(0, 5, (B, Lt)).astype(np.uint8))
    lq = torch.from_numpy(rng.integers(1, Lq + 1, B).astype(np.int32))
    lt = torch.from_numpy(rng.integers(1, Lt + 1, B).astype(np.int32))
    lq[0], lt[0] = Lq, Lt
    return q, t, lq, lt


@pytest.mark.parametrize("variant", [None, "wide"])
@pytest.mark.parametrize("B", [3, 128, 1030])
@pytest.mark.parametrize("Lt", [50, 56, 128, 200, 384, 512, 640, 768, 896,
                                1024, 1056, 4224])
def test_nw_kernels_match_plain(cuda, B, Lt, variant):
    """K4 (direction codes) in the variant the planner picks (the warp
    kernel at every column count a thread, C = 4, 8, ..., 32, with 16-byte,
    word and byte stores; the wide kernel past Lt = 1024, where Lt=4224
    gives a thread two 4-column groups) and in the wide kernel forced, on
    B not a multiple of the warp kernel's lanes a block; T1 (op strings
    and counts) on its planes."""
    Lq = 64
    q, t, lq, lt = _nw_case(B + Lt, B, Lq, Lt)
    sc = dict(match=5, mismatch=-4, gap=-8)
    ref = align.nw_dirs_plain(q, t, **sc)
    plan = kernels.nw_plan(Lq, Lt, variant)
    key = "nw_fwd" if plan["variant"] == "warp" else "nw_fwd_wide"
    n0 = dict(kernels.LAUNCHES)
    dirs = kernels.nw_dirs(q.to(cuda), t.to(cuda), variant=variant, **sc)
    torch.cuda.synchronize()
    assert torch.equal(ref, dirs.cpu())
    r_ops, r_n = kernels.nw_traceback(ref, lq, lt, Lq + Lt)
    ops, n = kernels.nw_traceback(dirs, lq.to(cuda), lt.to(cuda), Lq + Lt)
    torch.cuda.synchronize()
    assert torch.equal(r_ops, ops.cpu()) and torch.equal(r_n, n.cpu())
    assert kernels.LAUNCHES[key] == n0[key] + 1
    assert kernels.LAUNCHES["nw_traceback"] == n0["nw_traceback"] + 1
    other = "nw_fwd_wide" if key == "nw_fwd" else "nw_fwd"
    assert kernels.LAUNCHES[other] == n0[other]


@pytest.mark.parametrize("Lt", [56, 512, 1024, 4224])
def test_nw_occupancy(cuda, Lt):
    """The warp kernel at the op-string route's width (C = 16) and below
    runs with no spills and at least 7 blocks of 4 lanes an SM (72
    registers at C = 16: a cap at 64 spilled and ran slower); every
    variant fits at least one block."""
    for variant in ([None, "wide"] if Lt <= kernels.NW_WARP_MAX_LT
                    else [None]):
        occ = kernels.nw_occupancy(640, Lt, variant)
        assert occ["blocks_per_sm"] >= 1
        if occ["variant"] == "warp" and occ["C"] <= 16:
            assert occ["spills"] == 0 and occ["blocks_per_sm"] >= 7


def _tb_pairs(seed, B, Lq, Lt, kind):
    """T1 inputs (CPU tensors): ``reads``, 8%-error copies of window-slice
    targets as the op-string route packs them; ``random``, random pairs
    (LEFT and UP runs that leave the band and the window) with lanes of
    lq = 0 and lt = 0; ``clamped``, random pairs with starts past the
    plane (lq > Lq, lt > Lt)."""
    rng = np.random.default_rng(seed)
    if kind == "reads":
        q, t, lq, lt = _reads_pairs(rng, B, Lq, Lt)
    else:
        q, t, lq, lt = _nw_case(seed, B, Lq, Lt)
        lq[1 % B], lt[2 % B] = 0, 0
        if kind == "clamped":
            lq[3 % B], lt[4 % B] = Lq + 5, Lt + 1000
    return q, t, lq, lt


def _reads_pairs(rng, B, Lq, Lt):
    q = np.zeros((B, Lq), np.uint8)
    t = np.zeros((B, Lt), np.uint8)
    lq = np.zeros(B, np.int32)
    lt = np.zeros(B, np.int32)
    for b in range(B):
        tt = _BASES[rng.integers(0, 4, int(rng.integers(Lt * 3 // 4,
                                                         max(Lt - 3, 2))))]
        qq = mutate(rng, tt, 0.08)[0][:Lq]
        t[b, :len(tt)] = encode_bases(tt.tobytes())
        q[b, :len(qq)] = encode_bases(qq.tobytes())
        lq[b], lt[b] = len(qq), len(tt)
    return tuple(torch.from_numpy(a) for a in (q, t, lq, lt))


# Lanes a block for T1's card tests: the planner's (None), one, an odd
# count, and TB_LANES (a block of 32 warps): the planner picks from 1 to
# TB_LANES.
TB_LANES_CASES = (None, 1, 7, kernels.TB_LANES)


def _tb_all_plans(cuda, dirs, lq, lt, L):
    """T1 at every lanes a block of TB_LANES_CASES against the plain
    traceback (run on the card), bitwise; one launch counted a call."""
    rev = align.traceback_plain(dirs, lq, lt, L)
    r_ops = torch.flip(rev, dims=[1])
    r_n = (rev != align.PAD_OP).sum(dim=1, dtype=torch.int32)
    for lanes in TB_LANES_CASES:
        n0 = kernels.LAUNCHES["nw_traceback"]
        ops, n = kernels.nw_traceback(dirs, lq, lt, L, lanes_per_block=lanes)
        torch.cuda.synchronize()
        assert torch.equal(r_ops, ops) and torch.equal(r_n, n), lanes
        assert kernels.LAUNCHES["nw_traceback"] == n0 + 1


@pytest.mark.parametrize("kind", ["reads", "random"])
@pytest.mark.parametrize("B", [3, 128, 1030])
@pytest.mark.parametrize("Lt", [50, 56, 200, 512, 1024, 4224])
def test_nw_traceback_kernel_plans(cuda, Lt, B, kind):
    """T1 on K4's planes at lanes a block from 1 to TB_LANES, at widths
    whose lane rows start unaligned (50, 56, 200) and past the warp
    kernel's (4224), on B not a multiple of the lanes a block: 8%-error
    pairs, and random pairs with lq or lt of 0."""
    Lq = 96
    q, t, lq, lt = (a.to(cuda) for a in _tb_pairs(Lt + B, B, Lq, Lt, kind))
    dirs = kernels.nw_dirs(q, t, match=5, mismatch=-4, gap=-8)
    _tb_all_plans(cuda, dirs, lq, lt, Lq + Lt)


@pytest.mark.parametrize("case", ["clamped", "short L", "codes"])
def test_nw_traceback_kernel_edges(cuda, case):
    """Starts past the plane (clamped onto it), L shorter than the
    paths (the walk stops at L steps; L = 0 too), and planes of codes
    that do not move the walk (PAD_OP and 7 beside DIAG, UP and LEFT:
    runs past the op ring's 256 bytes)."""
    B, Lq, Lt = 130, 100, 72
    q, t, lq, lt = (a.to(cuda) for a in _tb_pairs(7, B, Lq, Lt, "clamped"))
    dirs = kernels.nw_dirs(q, t, match=5, mismatch=-4, gap=-8)
    if case == "clamped":
        _tb_all_plans(cuda, dirs, lq, lt, Lq + Lt)
    elif case == "short L":
        for L in (0, 1, 33, 120):
            _tb_all_plans(cuda, dirs, lq, lt, L)
    else:
        rng = np.random.default_rng(3)
        codes = rng.choice(np.array([0, 0, 0, 1, 2, 3, 7], np.uint8),
                           (Lq, B, Lt))
        _tb_all_plans(cuda, torch.from_numpy(codes).to(cuda), lq, lt, 900)


def test_nw_traceback_refills_match_model(cuda):
    """The kernel's windows and misses a lane are the windowed walk's
    model's (tests/traceback_model.py) at the plane's own address, at
    every lanes a block, on 8%-error pairs and on random ones (whose
    paths leave their windows through a band edge)."""
    from traceback_model import windowed_traceback
    for kind in ("reads", "random"):
        q, t, lq, lt = _tb_pairs(31, 40, 160, 150, kind)
        dirs = kernels.nw_dirs(q.to(cuda), t.to(cuda), match=5, mismatch=-4,
                               gap=-8)
        _, _, want = windowed_traceback(dirs.cpu(), lq, lt, 310,
                                        dirs.data_ptr() % 32)
        assert kind == "reads" or want[:, 1].sum() > 0
        for lanes in TB_LANES_CASES:
            refills = torch.zeros((40, 2), dtype=torch.int32, device=cuda)
            kernels.nw_traceback(dirs, lq.to(cuda), lt.to(cuda), 310,
                                 lanes_per_block=lanes, refills=refills)
            assert np.array_equal(refills.cpu().numpy(), want), lanes


@pytest.mark.parametrize("B,Lq,Lt", [(4096, 512, 512), (3072, 640, 512)])
def test_traceback_occupancy(cuda, B, Lq, Lt):
    """At the op-string route's batch shapes the planner's T1 launch
    spills nothing and holds an SM's share of the lanes at once: one
    wave of the card."""
    occ = kernels.traceback_occupancy(B, Lq, Lt)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert occ["spills"] == 0
    assert occ["blocks_per_sm"] * occ["lanes_per_block"] >= -(-B // sms)
    # The kernel sizes a block's shared memory as TB_LANE_BYTES mirrors.
    assert occ["smem"] == occ["lanes_per_block"] * kernels.TB_LANE_BYTES


def test_nw_traceback_rejects_bad_plans(cuda):
    """Lanes a block past 1 to TB_LANES, and a refill counter of the
    wrong shape, raise before any launch."""
    q, t, lq, lt = (a.to(cuda) for a in _tb_pairs(2, 8, 40, 40, "random"))
    dirs = kernels.nw_dirs(q, t, match=5, mismatch=-4, gap=-8)
    n0 = kernels.LAUNCHES["nw_traceback"]
    for bad in (0, kernels.TB_LANES + 1):
        with pytest.raises(kernels.KernelError):
            kernels.nw_traceback(dirs, lq, lt, 80, lanes_per_block=bad)
    with pytest.raises(kernels.KernelError):
        kernels.nw_traceback(dirs, lq, lt, 80,
                             refills=torch.zeros((8, 3), dtype=torch.int32,
                                                 device=cuda))
    assert kernels.LAUNCHES["nw_traceback"] == n0


def _count_case(kind, B, S, P, seed=17):
    """K5 inputs: non-decreasing rows with a negative pad prefix (the
    op-string route's block keys), unsorted rows with values on both
    sides of [0, P), or rows made mostly of one repeated key."""
    rng = np.random.default_rng(seed)
    if kind == "monotone":
        X = np.cumsum(rng.integers(0, 2, (B, S)), axis=1) - \
            rng.integers(1, 60, (B, 1))
    elif kind == "unsorted":
        X = rng.integers(-50, P + 50, (B, S))
    else:
        X = np.where(rng.random((B, S)) < 0.9,
                     rng.integers(-2, P + 1, (B, 1)),
                     rng.integers(-5, P + 5, (B, S)))
    return torch.from_numpy(X.astype(np.int32))


@pytest.mark.parametrize("kind,B,S,P", [
    ("monotone", 130, 700, 300),
    ("unsorted", 130, 700, 300),
    # Rows of 531 values: 2124 bytes, so rows start off a 16-byte
    # boundary and the head and tail are read singly.
    ("monotone", 37, 531, 300),
    ("unsorted", 37, 531, 33),
    ("repeated", 130, 700, 300),
    ("repeated", 9, 531, 2),
    ("unsorted", 9, 64, 1),
    ("unsorted", 9, 3, 2),
    ("monotone", 9, 0, 33),
    # The op-string route's merge shape.
    ("monotone", 14965, 532, 510),
])
def test_monotone_count_kernel_matches_plain(cuda, kind, B, S, P):
    """K5 against its plain version on aligned and unaligned rows and
    output rows, P down to 1, rows of one repeated key and B not a
    multiple of the lanes a block."""
    X = _count_case(kind, B, S, P).to(cuda)
    ref = monotone_count_plain(X, P)    # on the card: [B, S, P] compares
    n0 = kernels.LAUNCHES["monotone_count"]
    out = kernels.monotone_count(X, P)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["monotone_count"] == n0 + 1
    assert torch.equal(ref, out)


def test_count_occupancy(cuda):
    """K5 at the route's P: 8 lanes a block, 8 blocks (64 warps) an SM;
    a P whose histogram fills the block's shared memory: one lane."""
    occ = kernels.count_occupancy(510)
    assert occ["lanes_per_block"] == 8 and occ["spills"] == 0
    assert occ["blocks_per_sm"] == 8
    assert kernels.count_occupancy(58000)["lanes_per_block"] == 1


@pytest.mark.parametrize("scoring", [(5, -4, -8), (0, -1, -1)])
def test_nw_align_batch_cuda_matches_cpu(cuda, scoring):
    m, x, g = scoring
    q, t, lq, lt = _nw_case(23, 200, 128, 256)
    ref = align.nw_align_batch(q, t, lq, lt, match=m, mismatch=x, gap=g)
    out = align.nw_align_batch(q.to(cuda), t.to(cuda), lq.to(cuda),
                               lt.to(cuda), match=m, mismatch=x, gap=g)
    for r, o in zip(ref, out):
        assert torch.equal(r, o.cpu())


def test_chase_kernel_matches_plain(cuda):
    """The latency probe (csrc/probe.cu) reaches the indices its plain
    version reaches, one lane and 40 lanes, chains cut at several
    depths, through device memory and through shared memory."""
    for lanes, lane_stride, stride in ((1, 0, 1000), (40, 7, 1000),
                                       (1, 0, 30), (40, 7, 30)):
        loads = kernels.chain_of_loads(300, stride, "cpu", lanes=lanes,
                                       lane_stride=lane_stride)
        on_card = loads.to(cuda)
        for steps in (0, 1, 123, 300):
            want = kernels.chase(loads, steps, lanes, lane_stride)
            got = kernels.chase(on_card, steps, lanes, lane_stride)
            assert torch.equal(got.cpu(), want)
            if loads.numel() <= kernels.CHASE_SHARED_ENTRIES:
                got = kernels.chase(on_card, steps, lanes, lane_stride,
                                    shared=True)
                assert torch.equal(got.cpu(), want)
    with pytest.raises(kernels.KernelError):
        kernels.chase(on_card, 1, lanes=10 ** 6, lane_stride=1000)


class _Ovl:
    """Overlap stub: what device_breaking_points reads and writes."""

    strand = False

    def __init__(self, q, t, t_begin):
        self._q, self._t = q, t
        self.q_begin, self.q_end, self.q_length = 0, len(q), len(q)
        self.t_begin = t_begin
        self.breaking_points = None

    def alignment_operands(self, sequences):
        return self._q, self._t


def _breaking_point_runs(specs, cuda, **kw):
    """device_breaking_points on the CPU and on the card: per device the
    overlaps, the fallback indices, the launches made and the tiled
    groups (the untiled groups in ``untiled``)."""
    runs = {}
    for dev in ("cpu", cuda):
        ovls = [_Ovl(*sp) for sp in specs]
        n0 = dict(kernels.LAUNCHES)
        ovl_align.reset_stats()
        fb = ovl_align.device_breaking_points(ovls, None, 500, match=0,
                                              mismatch=-1, gap=-1,
                                              device=dev, **kw)
        torch.cuda.synchronize()
        runs[str(dev)] = (ovls, [ovls.index(o) for o in fb],
                          {k: kernels.LAUNCHES[k] - n0[k] for k in n0},
                          list(ovl_align.TILED_GROUPS))
        runs["untiled", str(dev)] = list(ovl_align.UNTILED_GROUPS)
    return runs


def test_device_breaking_points_grouped_cuda_matches_cpu(cuda):
    """Five 8.5-8.7 kb tiled jobs (queries past the untiled route's 8192
    rows) through a small tier of 2 lanes: three chunks, run on the card
    as one group (G from the K3 occupancy) and
    on the CPU one by one, give the same rows and fallbacks."""
    rng = np.random.default_rng(43)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    specs = []
    for i in range(5):
        t = acgt[rng.integers(0, 4, 8500 + 50 * i)]
        r = rng.random(len(t))
        q = np.where((r >= 0.015) & (r < 0.03),
                     acgt[rng.integers(0, 4, len(t))], t)[r >= 0.015]
        specs.append((q.tobytes(), t.tobytes(), 61 * i))
    runs = _breaking_point_runs(specs, cuda, tiers=((2, 512, 2048, 4),))
    (c_ovl, c_fb, c_n, c_groups), (g_ovl, g_fb, g_n, g_groups) = (
        runs["cpu"], runs["cuda"])
    assert g_fb == c_fb
    assert [(g["chunks"], g["G"], g["groups"]) for g in c_groups] == \
        [(3, 1, 3)]
    assert [(g["chunks"], g["groups"]) for g in g_groups] == [(3, 1)]
    assert g_groups[0]["G"] >= 3
    assert g_n["band_tile_fwd"] == 5 and g_n["col_walk"] == 1
    for c, g in zip(c_ovl, g_ovl):
        assert (c.breaking_points is None) == (g.breaking_points is None)
        if c.breaking_points is not None:
            assert np.array_equal(c.breaking_points, g.breaking_points)
    assert sum(o.breaking_points is not None for o in g_ovl) >= 4


def test_device_breaking_points_untiled_grouped_cuda_matches_cpu(
        cuda, monkeypatch):
    """Twenty 1.0-1.6 kb untiled jobs and one uncertified pair in chunks
    of 8 lanes (TB cut from 128 so that the bucket spans three chunks):
    on the card one group (G from the K1 occupancy; one K1 launch, one
    walk), on the CPU the chunks one by one; same rows and fallbacks."""
    monkeypatch.setattr(ovl_align, "TB", 8)
    rng = np.random.default_rng(47)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    specs = []
    for i in range(20):
        t = acgt[rng.integers(0, 4, 1000 + 30 * i)]
        r = rng.random(len(t))
        q = np.where((r >= 0.03) & (r < 0.06),
                     acgt[rng.integers(0, 4, len(t))], t)[r >= 0.03]
        specs.append((q.tobytes(), t.tobytes(), 37 * i))
    specs.append((acgt[rng.integers(0, 4, 1200)].tobytes(),
                  acgt[rng.integers(0, 4, 1200)].tobytes(), 3))
    runs = _breaking_point_runs(specs, cuda)
    (c_ovl, c_fb, _, _), (g_ovl, g_fb, g_n, _) = runs["cpu"], runs["cuda"]
    assert g_fb == c_fb == [20]
    assert [(g["chunks"], g["G"], g["groups"])
            for g in runs["untiled", "cpu"]] == [(3, 1, 3)]
    g_groups = runs["untiled", "cuda"]
    assert [(g["chunks"], g["groups"]) for g in g_groups] == [(3, 1)]
    assert g_groups[0]["G"] >= 3
    assert g_n["band_fwd"] == 1 and g_n["col_walk"] == 1
    for c, g in zip(c_ovl[:20], g_ovl[:20]):
        assert np.array_equal(c.breaking_points, g.breaking_points)


def test_device_breaking_points_cuda_matches_cpu(cuda):
    """The overlap route on the card (K1, K3, W1 and the re-centering
    between tiles) gives the rows and fallbacks of the plain route:
    untiled 1.2-1.9 kb jobs, one tiled 9.6 kb job, one uncertified job
    and one job no route admits."""
    rng = np.random.default_rng(41)
    acgt = np.frombuffer(b"ACGT", np.uint8)

    def noisy(t, err):
        r = rng.random(len(t))
        keep = r >= err / 2
        sub = (r >= err / 2) & (r < err)
        t = np.where(sub, acgt[rng.integers(0, 4, len(t))], t)
        return t[keep].tobytes()

    specs = []
    for n in (1200, 1500, 1700, 1900):
        t = acgt[rng.integers(0, 4, n)]
        specs.append((noisy(t, 0.08), t.tobytes(), int(rng.integers(0, 900))))
    t = acgt[rng.integers(0, 4, 9600)]
    specs.append((noisy(t, 0.03), t.tobytes(), 731))
    specs.append((acgt[rng.integers(0, 4, 1200)].tobytes(),
                  acgt[rng.integers(0, 4, 1200)].tobytes(), 5))
    specs.append((acgt[rng.integers(0, 4, 10_000)].tobytes(),
                  acgt[rng.integers(0, 4, 12_500)].tobytes(), 0))
    runs = _breaking_point_runs(specs, cuda)
    (c_ovl, c_fb, _, _), (g_ovl, g_fb, g_n, g_groups) = (runs["cpu"],
                                                         runs["cuda"])
    assert g_fb == c_fb == [6, 5]     # over budget first, then uncertified
    # One tiled bucket of one chunk: one group, one K3 launch a tile.
    assert [(g["chunks"], g["groups"]) for g in g_groups] == [(1, 1)]
    assert g_n["band_tile_fwd"] == sum(
        g["groups"] * (g["Lq"] // g["T"]) for g in g_groups) == 5
    assert g_n["col_walk"] == 2 and g_n["band_fwd"] == 1
    for c, g in zip(c_ovl[:5], g_ovl[:5]):
        assert np.array_equal(c.breaking_points, g.breaking_points)


def test_wrappers_reject_bad_inputs(cuda):
    args = _band_case(1, 8, 16, 128, 8)
    tb, qT, klo, lq = (a.to(cuda) for a in args)
    with pytest.raises(kernels.KernelError):
        kernels.fw_dirs_band(tb, qT, klo.to(torch.int64), lq, match=5,
                             mismatch=-4, gap=-8, W=128)
    with pytest.raises(kernels.KernelError):
        kernels.fw_dirs_flat(tb[:, :128].t(), qT, match=5, mismatch=-4,
                             gap=-8)
    cells = torch.zeros((16, 8, 128), dtype=torch.uint8, device=cuda)
    with pytest.raises(kernels.KernelError):
        kernels.col_walk_kernel(cells, lq, lq, None, lq, LA=32,
                                layout="flat", nxt=cells)
    with pytest.raises(kernels.KernelError):
        kernels.nw_dirs(tb[:, :100000].contiguous(),
                        torch.zeros((8, 50000), dtype=torch.uint8,
                                    device=cuda), match=5, mismatch=-4,
                        gap=-8)
    with pytest.raises(kernels.KernelError):
        kernels.monotone_count(lq[None, :].to(torch.int64), 10)
    front = (torch.zeros((8, 128), dtype=torch.int32, device=cuda),) * 3
    for k, i0 in ((1, 0), (2, 12)):    # depth 1; rows past the plane
        with pytest.raises(kernels.KernelError):
            kernels.fw_dirs_band_tile(tb[:, :128 + 8].contiguous(), qT[:8],
                                      klo, lq, i0, *front, match=5,
                                      mismatch=-4, gap=-8, W=128, nxt_k=k,
                                      out=(cells, cells, None))



# ------------------------------------------------------------ merge (M1, M2)

def _merge_chunk(cuda, wins, W, **caps):
    """A chunk's round-0 state on the card and its walk (K1/K2 and W1 on
    the card): the merge kernels' inputs as the main path gives them."""
    from racon_tpu_torch.ops import device_poa as P
    plan = P.ChunkPlan(wins, **caps)
    job, winb = P.load_packed(*plan.packed_bufs(),
                              (plan.B, plan.Lq, plan.n_win, plan.LA), cuda)
    q, qw8, begin, end, lq, win, w_read, bb, bbw, alen = P._unpack_bufs(
        job, winb, plan.Lq, plan.LA)
    fwd = P._lane_fwd(bb, alen, begin, end, q, lq, win, match=5, mismatch=-4,
                      gap=-8, Lq=plan.Lq, LA=plan.LA, band_w=W,
                      nxt_k=4 if W else 1)
    cols, esc_w = P._lane_walk(*fwd, lq, LA=plan.LA, band_w=W)
    return dict(n_win=plan.n_win, LA=plan.LA, B=plan.B, q=q, qw8=qw8,
                begin=begin, end=end, win=win, w_read=w_read, bb=bb, bbw=bbw,
                alen=alen, lt=fwd[3], t_off=fwd[4], cols=cols, esc_w=esc_w)


def _random_chunk(cuda, seed, B, Lq, LA, n_win):
    from merge_model import random_round
    r = random_round(seed, B, Lq, LA, n_win)
    walk = torch.from_numpy(r.pop("walk")).to(cuda)
    c = {k: torch.from_numpy(v).to(cuda) for k, v in r.items()}
    c["cols"] = {n: walk[..., i] for i, n in enumerate(kernels.WALK_FIELDS)}
    return dict(c, n_win=n_win, LA=LA, B=B)


_MERGE_CASES = {}


def _merge_case(cuda, key):
    """The merge inputs of one case (cached: the walks of 4096 lanes are
    shared by the M1 and M2 tests)."""
    if key not in _MERGE_CASES:
        from merge_model import edge_windows, noisy_windows
        if key == "edge band":
            c = _merge_chunk(cuda, edge_windows(1), 256)
        elif key == "edge flat":
            c = _merge_chunk(cuda, edge_windows(1), 0)
        elif key == "edge LA=450":
            c = _merge_chunk(cuda, edge_windows(2), 256, la_cap=450)
        elif key == "4096 lanes":
            c = _merge_chunk(cuda, noisy_windows(130, 30, 500, seed=3), 256)
        else:
            c = _random_chunk(cuda, 5, 300, 96, 200, 12)
        _MERGE_CASES[key] = c
    return _MERGE_CASES[key]


def _votes_args(c):
    return (c["cols"], c["q"], c["qw8"], c["w_read"], c["lt"], c["t_off"],
            c["esc_w"], c["win"])


def _members(c):
    from racon_tpu_torch.ops.device_merge import window_members
    return window_members(c["win"], c["n_win"])


def _bits(t):
    return t.cpu().contiguous().view(torch.uint8) if t.dtype != torch.bool \
        else t.cpu()


_MERGE_KEYS = ["edge band", "edge flat", "edge LA=450", "4096 lanes",
               "random"]


@pytest.mark.parametrize("key", _MERGE_KEYS)
def test_merge_votes_kernel_matches_plain(cuda, key):
    """M1 bitwise against extract_votes_cols -> aggregate_votes on the
    card, at 128 and 4096 lanes, an LA that is no multiple of the gap
    tile, and inputs over every branch."""
    from racon_tpu_torch.ops.device_merge import merge_votes_plain
    c = _merge_case(cuda, key)
    if key == "4096 lanes":
        assert c["B"] == 4096 and c["n_win"] == 160
    kw = dict(n_win=c["n_win"], LA=c["LA"])
    ref = merge_votes_plain(*_votes_args(c), **kw)
    n0 = kernels.LAUNCHES["merge_votes"]
    got = kernels.merge_votes(*_votes_args(c), _members(c), **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["merge_votes"] == n0 + 1
    for r, g in zip(ref, got):
        assert torch.equal(_bits(r), _bits(g))


@pytest.mark.parametrize("detect", [False, True])
@pytest.mark.parametrize("key", _MERGE_KEYS + ["padded lanes"])
def test_merge_windows_kernel_matches_plain(cuda, key, detect):
    """M2 bitwise against add_backbone -> ... -> remap_state on the card,
    every output (padded lanes' spans too), with and without detect."""
    from racon_tpu_torch.ops.device_merge import (merge_votes_plain,
                                                  merge_windows_plain)
    c = dict(_merge_case(cuda, "edge band" if key == "padded lanes"
                         else key))
    n_win, LA = c["n_win"], c["LA"]
    if key == "padded lanes":
        # Padded lanes of odd spans, and a last window with jobs and a
        # dummy row as long as the anchor.
        pad = (c["win"] == n_win).nonzero()[:, 0]
        c["win"] = c["win"].clone()
        c["win"][:3] = n_win - 1
        for name, vals in (("begin", [0, 5, 200, -3]),
                           ("end", [1, 7, 300, LA + 9])):
            c[name] = c[name].clone()
            c[name][pad[:4]] = torch.tensor(vals, dtype=torch.int32,
                                            device=cuda)
        c["alen"] = c["alen"].clone()
        c["alen"][-1] = LA
    votes, wesc = merge_votes_plain(*_votes_args(c), n_win=n_win, LA=LA)
    ovf = c.get("ovf")
    if ovf is None:
        ovf = torch.zeros(n_win, dtype=torch.bool, device=cuda)
        ovf[1] = True
    args = (votes, wesc, c["bb"], c["bbw"], c["alen"], c["begin"], c["end"],
            c["win"], ovf)
    kw = dict(ins_scale=0.2, n_win=n_win, LA=LA, detect=detect)
    ref = merge_windows_plain(*args, **kw)
    n0 = kernels.LAUNCHES["merge_windows"]
    got = kernels.merge_windows(*args, _members(c), **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["merge_windows"] == n0 + 1
    for i, (r, g) in enumerate(zip(ref, got)):
        assert r.dtype == g.dtype and r.shape == g.shape, i
        assert torch.equal(_bits(r), _bits(g)), i
    if key in ("edge band", "edge flat"):
        assert ref[6].any()                   # escape flags, outgrown
    if detect and key != "random":
        assert ref[7].any()


@pytest.mark.parametrize("key", ["edge band", "4096 lanes"])
def test_merge_round_kernels_match_plain(cuda, key):
    """One chunk's back half through device_poa._merge_round (M1 and M2,
    the membership built once a chunk) against the plain versions on the
    card and against _merge_round on the CPU: every output equal."""
    from racon_tpu_torch.ops import device_merge as dm
    from racon_tpu_torch.ops import device_poa as P
    from racon_tpu_torch.ops.device_merge import (merge_votes_plain,
                                                  merge_windows_plain)
    c = _merge_case(cuda, key)
    n_win, LA = c["n_win"], c["LA"]
    ovf = torch.zeros(n_win, dtype=torch.bool, device=cuda)
    state = (c["bb"], c["bbw"], c["alen"], c["begin"], c["end"], c["win"],
             ovf)
    kw = dict(ins_scale=0.3, n_win=n_win, LA=LA, detect=True)
    n0 = dict(kernels.LAUNCHES)
    got = P._merge_round(c["cols"], c["esc_w"], c["lt"], c["t_off"], c["q"],
                         c["qw8"], c["w_read"], *state, _members(c), **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["merge_votes"] == n0["merge_votes"] + 1
    assert kernels.LAUNCHES["merge_windows"] == n0["merge_windows"] + 1
    votes, wesc = merge_votes_plain(*_votes_args(c), n_win=n_win, LA=LA)
    ref = merge_windows_plain(votes, wesc, *state, **kw)
    cpu = P._merge_round(
        {n: c["cols"][n].cpu() for n in kernels.WALK_FIELDS},
        c["esc_w"].cpu(), c["lt"].cpu(), c["t_off"].cpu(), c["q"].cpu(),
        c["qw8"].cpu(), c["w_read"].cpu(), *(s.cpu() for s in state),
        dm.window_members(c["win"].cpu(), n_win), **kw)
    for i, (g, r, h) in enumerate(zip(got, ref, cpu)):
        assert torch.equal(_bits(g), _bits(r)), i
        assert torch.equal(_bits(g), _bits(h)), i


def test_device_chunk_merges_once_a_round(cuda):
    """A chunk's rounds on the card launch M1 and M2 once a round each
    and give the CPU run's bytes."""
    from merge_model import edge_windows
    from racon_tpu_torch.ops import device_poa as P
    wins = edge_windows(3)
    kw = dict(match=5, mismatch=-4, gap=-8, ins_scale=(0.2, 0.2, 0.2, 0.6),
              rounds=4)
    plan = P.ChunkPlan(wins)
    n0 = dict(kernels.LAUNCHES)
    stats = {}
    got = P.run_chunk(plan, device=cuda, stats=stats, **kw)
    rounds = stats["rounds_exec"]
    assert kernels.LAUNCHES["merge_votes"] - n0["merge_votes"] == rounds
    assert kernels.LAUNCHES["merge_windows"] - n0["merge_windows"] == rounds
    ref = P.run_chunk(P.ChunkPlan(wins), device="cpu", **kw)
    for (gc, gv), (rc, rv) in zip(zip(*got), zip(*ref)):
        assert gc == rc
        assert (gv is None and rv is None) or np.array_equal(gv, rv)


def test_merge_occupancy(cuda):
    """M1 keeps no sums in shared memory (only its staged jobs and its
    ring of walk entries, 24 KB; a tile's sums would take 66 KB), uses
    no local memory and runs phase 7's grid (LA = 640, 160 windows) in
    one wave; the narrow M2 holds a gap a thread in registers, with no
    local memory and no scratch, two blocks of 672 threads an SM (all
    160 windows resident at once); the wide M2 keeps its per-gap state
    in a device-memory scratch of about 70 bytes a gap."""
    votes = kernels.merge_occupancy("votes", 640, n_win=160)
    assert votes["threads"] == 128 and votes["spills"] == 0
    assert votes["smem"] <= 24 * 1024
    assert votes["blocks_per_sm"] >= kernels.MERGE_VOTES_BLOCKS
    assert votes["blocks"] == 960 and votes["waves"] == 1
    for LA in (127, 640, 1023):
        windows = kernels.merge_occupancy("windows", LA)
        assert windows["variant"] == "narrow"
        assert windows["spills"] == 0 and windows["threads"] >= LA + 1
        assert windows["smem"] < 8 * LA + 1024
    narrow = kernels.merge_occupancy("windows", 640, n_win=160)
    assert narrow["blocks_per_sm"] >= 2 and narrow["waves"] == 1
    for LA in (384, 1024, 3200):
        wide = kernels.merge_occupancy("windows", LA, "wide")
        assert wide["threads"] == 256 and wide["blocks_per_sm"] >= 1
        assert wide["smem"] < 1024
        assert 60 * LA < kernels.merge_windows_scratch(LA) < 80 * LA
        assert kernels.merge_windows_scratch(LA) % 16 == 0


@pytest.mark.parametrize("LA", [127, 450, 640, 1023, 1024, 1100])
@pytest.mark.parametrize("B,n_win", [(128, 12), (4096, 160), (4096, 8)])
def test_merge_kernels_at_widths(cuda, B, n_win, LA):
    """M1 and M2 bitwise against their plain versions on
    merge_model.random_round inputs (padded lanes, empty windows, every
    walk and query edge) at anchor widths around both kernels' tiles and
    the narrow M2's limit (LA + 1 = 1024), at 128 and 4096 lanes, with
    about 30 and about 500 jobs a window (past M1's 256-job stage), with
    and without detect; the wide M2 too where the narrow one runs."""
    from racon_tpu_torch.ops.device_merge import (merge_votes_plain,
                                                  merge_windows_plain)
    c = _random_chunk(cuda, LA + B + n_win, B, 96, LA, n_win)
    assert (c["win"] == n_win).any()
    mem = _members(c)
    ref = merge_votes_plain(*_votes_args(c), n_win=n_win, LA=LA)
    got = kernels.merge_votes(*_votes_args(c), mem, n_win=n_win, LA=LA)
    for r, g in zip(ref, got):
        assert torch.equal(_bits(r), _bits(g))
    args = (ref[0], ref[1], c["bb"], c["bbw"], c["alen"], c["begin"],
            c["end"], c["win"], c["ovf"])
    variants = [None] + (["wide"] if LA + 1 <= 1024 else [])
    for detect in (False, True):
        kw = dict(ins_scale=0.3, n_win=n_win, LA=LA, detect=detect)
        ref_w = merge_windows_plain(*args, **kw)
        for variant in variants:
            n0 = kernels.LAUNCHES["merge_windows"]
            got_w = kernels.merge_windows(*args, mem, variant=variant, **kw)
            assert kernels.LAUNCHES["merge_windows"] == n0 + 1
            for i, (r, g) in enumerate(zip(ref_w, got_w)):
                assert torch.equal(_bits(r), _bits(g)), (variant, detect, i)


def test_device_redo_on_the_card(cuda):
    """ops/redo.py device_redo on the card: the windows that the first
    pass flags (merge_model.edge_windows: a consensus past the anchor
    width, a saturated walk) run again at the redo's wider anchor
    (la_grow), with M1 and M2 once a round, and the consensus it resolves
    and the windows it leaves for the host equal the CPU run's."""
    from merge_model import edge_windows
    from racon_tpu_torch.ops import device_poa as P
    from racon_tpu_torch.ops.redo import device_redo
    kw = dict(match=5, mismatch=-4, gap=-8, ins_scale=(0.2, 0.2, 0.2, 0.6),
              rounds=4)
    wins = edge_windows(1)
    plan = P.ChunkPlan(wins)
    codes, _ = P.run_chunk(plan, device=cuda, **kw)
    flagged = [w for w, c in zip(wins, codes) if c is None]
    assert len(flagged) == 2
    assert P.ChunkPlan(flagged, la_grow=4 * P.LA_GROW).LA > plan.LA
    n0 = dict(kernels.LAUNCHES)
    stats = {}
    got, rem = device_redo(flagged, device=cuda, stats=stats, **kw)
    rounds = stats["rounds_exec"]
    assert rounds >= 1
    assert kernels.LAUNCHES["merge_votes"] - n0["merge_votes"] == rounds
    assert kernels.LAUNCHES["merge_windows"] - n0["merge_windows"] == rounds
    ref, ref_rem = device_redo(flagged, device="cpu", **kw)
    assert len(got) == len(ref) == 1 and len(rem) == len(ref_rem) == 1
    assert rem[0] is ref_rem[0]
    for (gw, gc, gv), (rw, rc, rv) in zip(got, ref):
        assert gw is rw and gc == rc and np.array_equal(gv, rv)


def test_merge_wrappers_reject_bad_inputs(cuda):
    c = _merge_case(cuda, "random")
    n_win, LA = c["n_win"], c["LA"]
    args = list(_votes_args(c))
    mem = _members(c)
    bad = dict(args[0], ins_len=args[0]["ins_len"].to(torch.int32))
    with pytest.raises(kernels.KernelError):
        kernels.merge_votes(bad, *args[1:], mem, n_win=n_win, LA=LA)
    # Separate column tensors are not the walk's interleaved layout.
    apart = {n: t.contiguous() for n, t in args[0].items()}
    with pytest.raises(kernels.KernelError):
        kernels.merge_votes(apart, *args[1:], mem, n_win=n_win, LA=LA)
    with pytest.raises(kernels.KernelError):
        kernels.merge_votes(*args[:3], args[3].double(), *args[4:], mem,
                            n_win=n_win, LA=LA)
    votes, wesc = kernels.merge_votes(*args, mem, n_win=n_win, LA=LA)
    state = [c["bb"], c["bbw"], c["alen"], c["begin"], c["end"], c["win"],
             c["ovf"]]
    with pytest.raises(kernels.KernelError):
        kernels.merge_windows(votes, wesc, *state, mem, ins_scale=0.2,
                              n_win=n_win - 1, LA=LA)
    with pytest.raises(kernels.KernelError):
        kernels.merge_windows(votes, wesc, *state, mem[:2] + (mem[2][1:],),
                              ins_scale=0.2, n_win=n_win, LA=LA)


def _sched_round_case(cuda, LA, seed):
    """Round 1's merge inputs of a chunk at anchor width LA, built on the
    CPU by the plain versions (any LA) and moved to the card: windows
    that converge at round 1, noisy ones, one whose consensus outgrows
    the anchor, the padding of the 32-window grid, and the sticky flag
    carried on two more windows; a scheduler output accumulator of
    random bytes."""
    from merge_model import (growing_window, sched_noisy_windows,
                             sched_stable_windows)
    from racon_tpu_torch.ops import device_merge as dm
    from racon_tpu_torch.ops import device_poa as P
    from racon_tpu_torch.sched.rounds import sched_unpack
    wlen = min(LA - 64, 600) * 9 // 10
    wins = (sched_stable_windows(seed, 6, wlen) +
            sched_noisy_windows(seed + 1, 4, wlen, 8) +
            [growing_window(seed + 2, wlen // 2)])
    plan = P.ChunkPlan(wins, la_cap=LA)
    st = P.chunk_statics(plan, ins_scale=0.2, rounds=4)
    (bb, bbw, alen, begin, end, q, qw8, lq, w_read, win, ovf, _,
     mem) = sched_unpack(*P.load_packed(
        *plan.packed_bufs(), (plan.B, plan.Lq, plan.n_win, plan.LA), "cpu"),
        Lq=plan.Lq, LA=LA, n_win=plan.n_win)
    kw = dict(match=5, mismatch=-4, gap=-8, Lq=plan.Lq, LA=LA,
              nxt_k=st["nxt_k"])
    bb, bbw, alen, begin, end, _, ovf, _ = P._round_core(
        bb, bbw, alen, begin, end, q, qw8, lq, w_read, win, ovf, mem,
        ins_scale=0.2, n_win=plan.n_win, band_w=st["band_w"], **kw)
    ovf = ovf.clone()
    ovf[[0, 6]] = True
    bw1 = P.round_band_width(st["band_w"], 1)
    fwd = P._lane_fwd(bb, alen, begin, end, q, lq, win, band_w=bw1,
                      **{k: kw[k] for k in ("match", "mismatch", "gap", "Lq",
                                             "LA", "nxt_k")})
    cols, esc_w = P._lane_walk(*fwd, lq, LA=LA, band_w=bw1)
    votes, wesc = dm.merge_votes_plain(cols, q, qw8, w_read, fwd[3], fwd[4],
                                       esc_w, win, n_win=plan.n_win, LA=LA)
    g = torch.Generator().manual_seed(seed)
    R = plan.n_win + 5
    out = (torch.randint(0, 256, (R + 1, LA), generator=g,
                         dtype=torch.uint8),
           torch.randint(-9, 9, (R + 1, LA), generator=g, dtype=torch.int32),
           torch.randint(1, LA, (R + 1,), generator=g, dtype=torch.int32),
           torch.rand(R + 1, generator=g) < 0.5)
    # Rows as after a repack: shuffled, the last few windows on the trash
    # row.
    orig = torch.randperm(R, generator=g)[:plan.n_win].to(torch.int32)
    orig[-3:] = R
    args = tuple(t.to(cuda) for t in (votes, wesc, bb, bbw, alen, begin,
                                       end, win, ovf))
    return dict(args=args, mem=dm.window_members(args[7], plan.n_win),
                out=tuple(t.to(cuda) for t in out), orig=orig.to(cuda),
                n_win=plan.n_win, n_real=plan.n_real_win)


@pytest.mark.parametrize("LA", [127, 450, 640, 1023, 1024, 1100])
def test_merge_windows_sched_kernel_matches_plain(cuda, LA):
    """M2's sched mode, both variants, bitwise against its plain version
    at anchor widths around the narrow kernel's limit: the base outputs,
    and the output accumulators (trash row and rows of windows that do
    not freeze untouched) with ``last`` off and on, on a chunk where some
    windows converge, some carry the sticky flag, some are padding and
    some have no output row."""
    from racon_tpu_torch.ops.device_merge import merge_windows_sched_plain
    c = _sched_round_case(cuda, LA, 70 + LA % 97)
    n_win = c["n_win"]
    variants = [None] + (["wide"] if LA + 1 <= 1024 else [])
    seen = set()
    for last in (False, True):
        kw = dict(ins_scale=0.2, scale_final=0.6, last=last, n_win=n_win,
                  LA=LA, detect=True)
        ref_out = tuple(t.clone() for t in c["out"])
        ref = merge_windows_sched_plain(*c["args"], c["orig"], ref_out, **kw)
        conv, ovf = ref[7], ref[6]
        seen.add((bool(conv[:c["n_real"]].any()), bool(ovf.any()),
                  bool((~(conv | ovf))[:c["n_real"]].any())))
        for variant in variants:
            got_out = tuple(t.clone() for t in c["out"])
            n0 = dict(kernels.LAUNCHES)
            got = kernels.merge_windows_sched(*c["args"], c["mem"], c["orig"],
                                              got_out, variant=variant, **kw)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["merge_windows_sched"] == \
                n0["merge_windows_sched"] + 1
            assert kernels.LAUNCHES["merge_windows"] == n0["merge_windows"]
            for i, (r, g) in enumerate(zip(ref, got)):
                assert torch.equal(_bits(r), _bits(g)), (variant, last, i)
            for i, (r, g) in enumerate(zip(ref_out, got_out)):
                assert torch.equal(_bits(r), _bits(g)), (variant, last, i)
        # Rows of windows that do not freeze and the trash row keep their
        # bytes.
        froze = conv | ovf | last
        keep = torch.ones(c["out"][0].shape[0], dtype=torch.bool,
                          device=cuda)
        keep[c["orig"][froze & (c["orig"] < keep.numel() - 1)].long()] = False
        for a, b in zip(c["out"], ref_out):
            assert torch.equal(_bits(a[keep]), _bits(b[keep]))
    assert (True, True, True) in seen


def test_merge_sched_occupancy(cuda):
    """M2's sched mode keeps the base mode's shape: the narrow kernel
    with no local memory and two blocks of 672 threads an SM at LA = 640;
    the wide kernel at least one block an SM."""
    for LA in (127, 640, 1023):
        occ = kernels.merge_occupancy("windows_sched", LA)
        assert occ["variant"] == "narrow" and occ["spills"] == 0
    occ = kernels.merge_occupancy("windows_sched", 640, n_win=160)
    assert occ["blocks_per_sm"] >= 2 and occ["waves"] == 1
    wide = kernels.merge_occupancy("windows_sched", 1100)
    assert wide["variant"] == "wide" and wide["blocks_per_sm"] >= 1


@pytest.mark.parametrize("name", ["fused_tail", "repack", "early_exit"])
def test_sched_control_paths_cuda_matches_cpu(cuda, name, monkeypatch):
    """The scheduler's three control-flow paths on the card: the engine's
    consensus equals the CPU run's and the fixed engine's on the card,
    M2's sched mode launched once a dispatch's last round."""
    from merge_model import SCHED_BATCHES
    from racon_tpu_torch.models.window import Window, WindowType
    from racon_tpu_torch.ops import device_poa as P
    from racon_tpu_torch.ops.poa import PoaEngine
    out = {}
    for dev, sched in (("cpu", "1"), ("cuda", "1"), ("cuda", "0")):
        monkeypatch.setenv("RACON_TPU_SCHED", sched)
        monkeypatch.setattr(P, "_CAP_HISTORY", set())
        monkeypatch.setattr(P, "_BAND_HISTORY", set())
        ws = SCHED_BATCHES[name](Window, WindowType)
        eng = PoaEngine(device=dev)
        n0 = dict(kernels.LAUNCHES)
        eng.consensus_windows(ws)
        n = {k: v - n0[k] for k, v in kernels.LAUNCHES.items()}
        out[(dev, sched)] = ([w.consensus for w in ws], eng, n)
    cpu, gpu, fixed = out[("cpu", "1")], out[("cuda", "1")], out[
        ("cuda", "0")]
    assert gpu[0] == cpu[0] == fixed[0]
    t, tc = gpu[1].sched_telemetry, cpu[1].sched_telemetry
    assert t.hist == tc.hist and t.dispatches_saved == tc.dispatches_saved
    n = gpu[2]
    assert n["merge_windows_sched"] >= 1
    assert n["merge_votes"] == n["merge_windows"] + \
        n["merge_windows_sched"] == n["band_fwd"] + n["flat_fwd"]
    assert fixed[2]["merge_windows_sched"] == 0


@pytest.mark.parametrize("wlen", [3100, 4000])
def test_device_chunk_long_windows(cuda, wlen):
    """Windows past the anchor width that a block's shared memory could
    hold M2's per-gap state for (LA about 3000): a chunk's rounds on the
    card launch M1 and M2 once a round, M1 and M2 equal their plain
    versions at the chunk's width, and the chunk's bytes equal the CPU
    run's."""
    from merge_model import noisy_windows
    from racon_tpu_torch.ops import device_poa as P
    from racon_tpu_torch.ops.device_merge import (merge_votes_plain,
                                                  merge_windows_plain)
    wins = noisy_windows(3, 6, wlen, seed=11)
    c = _merge_chunk(cuda, wins, 256)
    assert c["LA"] >= 3200
    n_win, LA = c["n_win"], c["LA"]
    mem = _members(c)
    kw = dict(n_win=n_win, LA=LA)
    ref = merge_votes_plain(*_votes_args(c), **kw)
    got = kernels.merge_votes(*_votes_args(c), mem, **kw)
    for r, g in zip(ref, got):
        assert torch.equal(_bits(r), _bits(g))
    ovf = torch.zeros(n_win, dtype=torch.bool, device=cuda)
    args = (ref[0], ref[1], c["bb"], c["bbw"], c["alen"], c["begin"],
            c["end"], c["win"], ovf)
    wkw = dict(ins_scale=0.2, n_win=n_win, LA=LA, detect=True)
    ref_w = merge_windows_plain(*args, **wkw)
    got_w = kernels.merge_windows(*args, mem, **wkw)
    for i, (r, g) in enumerate(zip(ref_w, got_w)):
        assert torch.equal(_bits(r), _bits(g)), i
    ckw = dict(match=5, mismatch=-4, gap=-8, ins_scale=(0.2, 0.2, 0.2, 0.6),
               rounds=4)
    n0 = dict(kernels.LAUNCHES)
    stats = {}
    out = P.run_chunk(P.ChunkPlan(wins), device=cuda, stats=stats, **ckw)
    rounds = stats["rounds_exec"]
    assert kernels.LAUNCHES["merge_votes"] - n0["merge_votes"] == rounds
    assert kernels.LAUNCHES["merge_windows"] - n0["merge_windows"] == rounds
    cpu = P.run_chunk(P.ChunkPlan(wins), device="cpu", **ckw)
    for (gc, gv), (rc, rv) in zip(zip(*out), zip(*cpu)):
        assert gc == rc
        assert (gv is None and rv is None) or np.array_equal(gv, rv)
    # The convergence scheduler on the same chunk (the wide M2's sched
    # mode at this width): the fixed engine's bytes.
    from racon_tpu_torch.sched import ConvergenceScheduler
    sched = ConvergenceScheduler(match=5, mismatch=-4, gap=-8,
                                 scales=ckw["ins_scale"], device=cuda)
    n0 = dict(kernels.LAUNCHES)
    got = sched.run_chunk(P.ChunkPlan(wins))
    assert kernels.LAUNCHES["merge_windows_sched"] > \
        n0["merge_windows_sched"]
    for (gc, gv), (rc, rv) in zip(zip(*got), zip(*cpu)):
        assert gc == rc
        assert (gv is None and rv is None) or np.array_equal(gv, rv)


@pytest.mark.parametrize("layout", ["band", "flat"])
@pytest.mark.parametrize("adaptive", ["1", "0"])
def test_decoupled_walk_matches_fused_on_the_card(cuda, monkeypatch, layout,
                                                  adaptive):
    """dispatch_chunk_fwd on this thread, dispatch_walk on another (as the
    pipeline's compute and walk stages run them, on one stream): the
    packed bytes of the fused dispatch_chunk on the card and of the CPU
    run; the launches split between the threads add up exactly."""
    import threading
    from window_sets import port_windows
    from racon_tpu_torch.ops import device_poa as P
    from racon_tpu_torch.ops.poa import PoaEngine
    monkeypatch.setenv("RACON_TPU_ADAPTIVE", adaptive)
    if layout == "flat":
        monkeypatch.setenv("RACON_TPU_NO_BAND", "1")
    eng = PoaEngine(device=cuda)
    ws = [w for w in port_windows(8, 5, wlen=300) if w.n_layers >= 2]
    dev, _host, lq_max, la_max = eng._partition_device(ws)
    sp = eng._plan_device_slice(dev, lq_max, la_max)
    plan = eng._make_chunk_plan(sp, sp.groups[0])
    rounds = eng.refine_rounds + 1
    kw = dict(match=5, mismatch=-4, gap=-8,
              ins_scale=eng._round_scales(rounds), rounds=rounds)
    assert bool(P.chunk_statics(plan, ins_scale=kw["ins_scale"],
                                rounds=rounds)["band_w"]) == \
        (layout == "band")
    cpu = P.dispatch_chunk(plan, device="cpu", **kw).numpy().tobytes()
    fused = P.dispatch_chunk(plan, device=cuda, **kw).cpu().numpy().tobytes()
    stream = torch.cuda.Stream(cuda)
    n0 = dict(kernels.LAUNCHES)
    with torch.cuda.stream(stream):
        fwd_out, meta = P.dispatch_chunk_fwd(plan, device=cuda, **kw)
    got, walk_n = [], {}

    def walk():
        with torch.cuda.stream(stream):
            before = kernels.thread_launches()
            got.append(P.dispatch_walk(plan, fwd_out, meta).cpu())
            after = kernels.thread_launches()
            walk_n.update({k: v - before.get(k, 0) for k, v in after.items()
                           if v != before.get(k, 0)})

    t = threading.Thread(target=walk)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and got
    assert got[0].numpy().tobytes() == fused == cpu
    n = {k: v - n0[k] for k, v in kernels.LAUNCHES.items() if v != n0[k]}
    fwd_k = "band_fwd" if layout == "band" else "flat_fwd"
    assert walk_n == {"col_walk": 1, "merge_votes": 1, "merge_windows": 1}
    assert n["col_walk"] == n["merge_votes"] == n["merge_windows"] == \
        n[fwd_k]


@pytest.mark.parametrize("sched", ["1", "0"])
def test_stream_consensus_on_the_card_matches_serial(cuda, monkeypatch,
                                                     sched):
    """stream_consensus on the card (its stage threads on the engine's
    stream, the decoupled walk under RACON_TPU_SCHED=0) against the serial
    engine on the card and the CPU run; launch counts exact with two
    launching threads."""
    from window_sets import port_windows
    from racon_tpu_torch.ops import device_poa as P
    from racon_tpu_torch.ops.poa import PoaEngine
    from racon_tpu_torch.pipeline import metrics
    from racon_tpu_torch.pipeline.streaming import stream_consensus
    monkeypatch.setenv("RACON_TPU_SCHED", sched)
    out = {}
    for dev, streamed in (("cpu", False), ("cuda", False), ("cuda", True)):
        monkeypatch.setattr(P, "_CAP_HISTORY", set())
        monkeypatch.setattr(P, "_BAND_HISTORY", set())
        ws = port_windows(24, 42, wlen=300)
        eng = PoaEngine(device=dev)
        metrics.reset()
        clock = P.set_stage_clock(True)
        n0 = dict(kernels.LAUNCHES)
        try:
            if streamed:
                ranges = list(stream_consensus(eng, ws, chunk=8, depth=2))
                assert [i for s, e in ranges for i in range(s, e)] == \
                    list(range(24))
            else:
                eng.consensus_windows(ws)
        finally:
            P.set_stage_clock(False)
        n = {k: v - n0[k] for k, v in kernels.LAUNCHES.items()}
        out[(dev, streamed)] = ([w.consensus for w in ws], n,
                                clock.launches(),
                                metrics.registry().snapshot())
    cpu, serial, piped = out[("cpu", False)], out[("cuda", False)], out[
        ("cuda", True)]
    assert piped[0] == serial[0] == cpu[0]
    n, stages, snap = piped[1], piped[2], piped[3]
    # One forward (banded, or full width in a redo), walk and merge a
    # round, whichever thread launched it.
    k1 = stages["forward"].get("band_fwd", 0) + \
        stages["forward"].get("flat_fwd", 0)
    assert k1 > 0
    assert n["merge_votes"] == n["merge_windows"] + \
        n["merge_windows_sched"] == k1 == n["band_fwd"] + n["flat_fwd"]
    assert stages["walk"]["col_walk"] == n["col_walk"] == k1
    assert stages["merge"]["merge_votes"] == k1
    if sched == "0":
        assert snap["walk_dispatches"] == 2
        assert snap["walk_fused_chunks"] == 1
        assert n["merge_windows_sched"] == 0
    else:
        assert snap["walk_dispatches"] == 0
        assert n["merge_windows_sched"] > 0


# ------------------------------------------------------- fault plane


@pytest.fixture
def fault_plane(monkeypatch):
    """No fault plan, policy, watchdog state or counters from elsewhere;
    the engines' cap histories start empty."""
    from racon_tpu_torch.ops import device_poa as P
    from racon_tpu_torch.pipeline import metrics
    from racon_tpu_torch.resilience import faults, retry, watchdog
    for name in ("RACON_TPU_FAULTS", "RACON_TPU_RETRY", "RACON_TPU_SCHED",
                 "RACON_TPU_DEADLINE_DISPATCH", "RACON_TPU_TIMING",
                 "RACON_TPU_DEADLINE_CELLS_PER_S"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(P, "_CAP_HISTORY", set())
    monkeypatch.setattr(P, "_BAND_HISTORY", set())
    for mod in (faults, retry):
        mod.configure(None)
    watchdog.reset()
    metrics.reset()
    yield
    for mod in (faults, retry):
        mod.configure(None)
    watchdog.reset()
    metrics.reset()


def _engine_run(dev, monkeypatch, batch=4096, n=24, seed=42):
    """Consensus of the pipeline tests' window set on ``dev``; returns
    (consensus, launches made, res_* counters)."""
    import io
    from window_sets import port_windows
    from racon_tpu_torch.ops import device_poa as P
    from racon_tpu_torch.ops.poa import PoaEngine
    from racon_tpu_torch.pipeline import metrics
    monkeypatch.setattr(P, "_CAP_HISTORY", set())
    monkeypatch.setattr(P, "_BAND_HISTORY", set())
    metrics.reset()
    ws = port_windows(n, seed, wlen=300)
    n0 = dict(kernels.LAUNCHES)
    PoaEngine(device=dev, device_batch=batch,
              log=io.StringIO()).consensus_windows(ws)
    torch.cuda.synchronize()
    n1 = {k: v - n0[k] for k, v in kernels.LAUNCHES.items() if v != n0[k]}
    return [w.consensus for w in ws], n1, metrics.resilience_extras()


def test_guarded_dispatch_on_a_stream_matches_unguarded(cuda, monkeypatch,
                                                        fault_plane):
    """dispatch_chunk under the watchdog (its body on a guard thread)
    inside stream_consensus's stage-thread context (its own stream): the
    body launches on that stream and device, the packed bytes and the
    stage clock's launches equal the unguarded dispatch's, and the
    launches are charged to the caller's thread."""
    import threading
    from window_sets import port_windows
    from racon_tpu_torch.ops import device_poa as P
    from racon_tpu_torch.ops.poa import PoaEngine
    monkeypatch.setenv("RACON_TPU_SCHED", "0")
    eng = PoaEngine(device=cuda)
    ws = [w for w in port_windows(8, 5, wlen=300) if w.n_layers >= 2]
    dev, _host, lq_max, la_max = eng._partition_device(ws)
    sp = eng._plan_device_slice(dev, lq_max, la_max)
    plan = eng._make_chunk_plan(sp, sp.groups[0])
    rounds = eng.refine_rounds + 1
    kw = dict(match=5, mismatch=-4, gap=-8,
              ins_scale=eng._round_scales(rounds), rounds=rounds)
    real = P.device_chunk_packed
    seen = []

    def spy(*a, **k):
        seen.append((threading.current_thread().name,
                     torch.cuda.current_stream().cuda_stream,
                     torch.cuda.current_device()))
        return real(*a, **k)

    monkeypatch.setattr(P, "device_chunk_packed", spy)
    from racon_tpu_torch.pipeline.streaming import _thread_context
    ctx = _thread_context(torch.device("cuda", torch.cuda.current_device()))
    out = {}
    for guarded in (False, True):
        monkeypatch.setenv("RACON_TPU_DEADLINE_DISPATCH",
                           "" if guarded else "0")
        clock = P.set_stage_clock(True)
        before = kernels.thread_launches()
        try:
            with ctx():
                here = (torch.cuda.current_stream().cuda_stream,
                        torch.cuda.current_device())
                packed = P.dispatch_chunk(plan, device=cuda, **kw)
                got = packed.cpu().numpy().tobytes()
        finally:
            P.set_stage_clock(False)
        after = kernels.thread_launches()
        mine = {k: v - before.get(k, 0) for k, v in after.items()
                if v != before.get(k, 0)}
        out[guarded] = (got, clock.launches(), mine, clock.ms())
    assert out[True][0] == out[False][0]
    assert out[True][1] == out[False][1] and out[True][1]["forward"]
    assert out[True][2] == out[False][2]
    assert all(ms > 0 for ms in out[True][3].values())
    assert seen[0][0] != "racon-watchdog" and seen[1][0] == "racon-watchdog"
    assert seen[0][1:] == seen[1][1:] == here
    assert here[0] != torch.cuda.default_stream().cuda_stream


def test_hang_at_dispatch_launches_nothing_twice(cuda, monkeypatch,
                                                 fault_plane):
    """A hang at the second dispatch past a 0.5 s deadline: one breach,
    the retry's attempt runs, and the abandoned attempt, when it wakes,
    launches nothing — LAUNCHES equals a clean run's."""
    import time
    from racon_tpu_torch.resilience import faults
    monkeypatch.setenv("RACON_TPU_SCHED", "0")
    clean, n_clean, res_clean = _engine_run("cuda", monkeypatch, batch=60)
    assert res_clean == {}
    monkeypatch.setenv("RACON_TPU_DEADLINE_DISPATCH", "0.5")
    monkeypatch.setenv("RACON_TPU_DEADLINE_CELLS_PER_S", "1e18")
    faults.configure("dispatch/chunk:1!hang=2")
    n0 = dict(kernels.LAUNCHES)
    out, n_hang, res = _engine_run("cuda", monkeypatch, batch=60)
    time.sleep(2.5)
    n_after = {k: v - n0[k] for k, v in kernels.LAUNCHES.items()
               if v != n0[k]}
    assert out == clean
    assert n_hang == n_after == n_clean
    assert res["res_watchdog_breach_total"] == 1
    assert res["res_retry_total"] == 1


def test_degrade_everything_gives_the_host_bytes(cuda, monkeypatch,
                                                 fault_plane):
    """Every upload fails (h2d/chunk:p=1.0, 2 attempts): every window
    polishes on the host path, with the device path's bytes, and no
    consensus kernel launches."""
    from racon_tpu_torch.resilience import faults
    cpu, _n, _res = _engine_run("cpu", monkeypatch)
    monkeypatch.setenv("RACON_TPU_RETRY", "attempts=2,base=0")
    faults.configure("h2d/chunk:p=1.0")
    out, n, res = _engine_run("cuda", monkeypatch)
    assert out == cpu
    assert n == {}
    from window_sets import port_windows
    assert res["res_degraded_windows"] == sum(
        w.n_layers >= 2 for w in port_windows(24, 42, wlen=300))
    assert res["res_retry_exhausted"] == res["res_degraded_chunks"]


def test_timing_path_gives_the_same_bytes_and_launches(cuda, monkeypatch,
                                                        fault_plane):
    """RACON_TPU_TIMING=1 on the card: the fixed engine's rounds inside
    the dispatch/chunk envelope with a sync and a stderr line after the
    h2d and after each round; the same consensus, and the launches of a
    run with no adaptive exit (every round runs)."""
    import contextlib
    import io
    monkeypatch.setenv("RACON_TPU_SCHED", "0")
    monkeypatch.setenv("RACON_TPU_ADAPTIVE", "0")
    clean, n_clean, _ = _engine_run("cuda", monkeypatch, batch=60)
    monkeypatch.delenv("RACON_TPU_ADAPTIVE")
    monkeypatch.setenv("RACON_TPU_TIMING", "1")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out, n, res = _engine_run("cuda", monkeypatch, batch=60)
    assert out == clean and n == n_clean and res == {}
    lines = err.getvalue().splitlines()
    h2d = [ln for ln in lines if "] h2d:" in ln]
    rounds = [ln for ln in lines if "compute/round" in ln]
    assert len(h2d) >= 2 and len(rounds) == 4 * len(h2d)


def test_real_breach_at_d2h_ends_the_run(cuda, monkeypatch, fault_plane,
                                         tmp_path):
    """A real deadline breach at ``d2h/chunk``: each pull of the fixed
    engine first queues about 0.1 s of device work on its stream, which
    the pull waits on, so every attempt breaches a 1 us deadline (at this
    size the chunk's own kernels can end before the caller wakes). The
    exhausted site is not degraded: the CLI exits 1 with no FASTA and no
    window on the host path, after 2 breaches and 1 retry."""
    from test_torch_pipeline import _run_cli, _write_two_contig_inputs
    from racon_tpu_torch.ops import device_poa as P
    from racon_tpu_torch.pipeline import metrics
    real_call = P.retry_call

    def slow_pull(site, fn, *a, **k):
        if site == "d2h/chunk":
            pull = fn

            def fn(*args, **kwargs):
                torch.cuda._sleep(200_000_000)  # device cycles, ~0.1 s
                return pull(*args, **kwargs)
        return real_call(site, fn, *a, **k)

    paths = _write_two_contig_inputs(tmp_path)
    monkeypatch.setenv("RACON_TPU_SCHED", "0")
    monkeypatch.setenv("RACON_TPU_RETRY", "attempts=2,base=0")
    monkeypatch.setenv("RACON_TPU_DEADLINE_D2H", "1e-6")
    monkeypatch.setenv("RACON_TPU_DEADLINE_MBPS", "1e9")
    monkeypatch.setattr(P, "retry_call", slow_pull)
    rc, out, err = _run_cli([*paths, "-w", "200"])
    torch.cuda.synchronize()
    assert rc == 1 and out == b"", err[-2000:]
    assert "d2h/chunk failed after 2 attempt(s)" in err
    res = metrics.resilience_extras()
    assert res.get("res_degraded_windows", 0) == 0
    assert res["res_retry_exhausted"] == 1
    assert res["res_watchdog_breach_total"] == 2
    assert res["res_watchdog_site_d2h_chunk"] == 2
    assert res["res_retry_total"] == 1
    assert res.get("res_fault_injected_total", 0) == 0


def test_out_of_memory_is_retried_and_kernel_error_is_not(cuda, monkeypatch,
                                                          fault_plane):
    from racon_tpu_torch.ops import device_poa as P
    monkeypatch.setenv("RACON_TPU_SCHED", "0")
    clean, n_clean, _ = _engine_run("cuda", monkeypatch)
    real = P.device_chunk_packed
    calls = []

    def oom_once(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return real(*a, **k)

    monkeypatch.setattr(P, "device_chunk_packed", oom_once)
    out, n, res = _engine_run("cuda", monkeypatch)
    assert out == clean and n == n_clean
    assert res["res_retry_total"] == 1 and "res_degraded_windows" not in res

    def broken(*a, **k):
        calls.append(1)
        raise kernels.KernelError("band_fwd launch failed (injected)")

    monkeypatch.setattr(P, "device_chunk_packed", broken)
    calls.clear()
    with pytest.raises(kernels.KernelError):
        _engine_run("cuda", monkeypatch)
    assert len(calls) == 1


# ------------------------------------------------------------ service core

def _serve_inputs(tmp_path, seed, n_contigs):
    from racon_tpu_torch.utils.synth import write_dataset
    p = write_dataset(str(tmp_path / f"in{seed}"), seed=seed,
                      n_contigs=n_contigs, contig_len=6000, read_len=2500,
                      coverage=30)["paths"]
    return [p["reads"], p["overlaps"], p["draft"]]


def _layers(polisher):
    from racon_tpu_torch.cache.memo import window_digest
    return [window_digest(b"", w) for w in polisher.windows]


def test_two_jobs_align_at_once_on_the_card(cuda, tmp_path, fault_plane):
    """Two jobs' Polisher.initialize on two threads at once, their
    overlaps aligned on the card (K1, K3 routes, W1): each job's windows
    are its solo run's, and the card aligned both."""
    from racon_tpu_torch.server.engine import JobSpec, build_polisher
    specs = [JobSpec(*_serve_inputs(tmp_path, seed, n), backend="cuda")
             for seed, n in ((21, 2), (5, 1))]
    solo = []
    for spec in specs:
        p = build_polisher(spec)
        p.initialize()
        solo.append(_layers(p))
    ovl_align.reset_stats()
    got, errors = [None, None], []
    barrier = __import__("threading").Barrier(2)

    def run(i):
        try:
            p = build_polisher(specs[i])
            barrier.wait()
            p.initialize()
            got[i] = _layers(p)
        except Exception as exc:  # collected for the assertion
            errors.append(exc)

    import threading
    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == [] and got == solo
    assert ovl_align.STATS["device_jobs"] > 0
    assert len(ovl_align.UNTILED_GROUPS) + len(ovl_align.TILED_GROUPS) >= 2


def test_nested_guards_credit_launches_to_the_dispatcher(cuda, monkeypatch,
                                                         fault_plane):
    """A batcher dispatch runs the engine under guard("serve/dispatch")
    on a watchdog thread, and the engine's own chunk guards nest inside
    it: every chunk body runs on a watchdog thread in the dispatcher's
    stream and device, and the dispatch record's launches (the
    dispatcher thread's counts) are exactly LAUNCHES' delta, with the
    consensus the unbatched engine's."""
    import threading
    from window_sets import port_windows
    from racon_tpu_torch.ops import device_poa as P
    from racon_tpu_torch.ops.poa import PoaEngine
    from racon_tpu_torch.server.batch import (BatchedEngineProxy,
                                              CrossRequestBatcher)
    monkeypatch.setenv("RACON_TPU_SCHED", "0")
    clean, _, _ = _engine_run("cuda", monkeypatch)
    real = P.device_chunk_packed
    seen = []

    def spy(*a, **k):
        seen.append((threading.current_thread().name,
                     torch.cuda.current_stream().cuda_stream,
                     torch.cuda.current_device()))
        return real(*a, **k)

    monkeypatch.setattr(P, "device_chunk_packed", spy)
    monkeypatch.setattr(P, "_CAP_HISTORY", set())
    monkeypatch.setattr(P, "_BAND_HISTORY", set())
    import io
    eng = PoaEngine(device=cuda, log=io.StringIO())
    b = CrossRequestBatcher(eng, capacity=4096, wait_s=0.0,
                            queue_cap=4).start()
    ws = port_windows(24, 42, wlen=300)
    n0 = dict(kernels.LAUNCHES)
    try:
        BatchedEngineProxy(b, "j1", "acme").consensus_windows(ws)
    finally:
        b.close()
    torch.cuda.synchronize()
    delta = {k: v - n0[k] for k, v in kernels.LAUNCHES.items() if v != n0[k]}
    assert [w.consensus for w in ws] == clean
    assert len(b.dispatches) == 1 and b.dispatches[0]["error"] is None
    assert b.dispatches[0]["launches"] == delta and delta["band_fwd"] > 0
    assert seen and all(name == "racon-watchdog" for name, *_ in seen)
    assert all(s[1:] == (torch.cuda.default_stream().cuda_stream,
                         torch.cuda.current_device()) for s in seen)


def test_kernel_error_in_a_dispatch_stops_the_daemon(cuda, tmp_path,
                                                     monkeypatch,
                                                     fault_plane):
    """A KernelError in a consensus dispatch on the card: the job fails,
    the daemon marks the device lost (``stopped`` set, ``main`` exits 1)
    and refuses new jobs; nothing is served on the CPU."""
    from racon_tpu_torch.ops import device_poa as P
    from racon_tpu_torch.server.daemon import PolishServer
    from racon_tpu_torch.server.engine import JobSpec
    monkeypatch.setenv("RACON_TPU_SCHED", "0")
    monkeypatch.setenv("RACON_TPU_CACHE", "0")

    def broken(*a, **k):
        raise kernels.KernelError("band_fwd launch failed (injected)")

    monkeypatch.setattr(P, "device_chunk_packed", broken)
    server = PolishServer(str(tmp_path / "state"))
    job = server.submit("acme", JobSpec(*_serve_inputs(tmp_path, 21, 2)))
    assert job.finished.wait(300)
    assert server.stopped.wait(5)
    st = job.status()
    assert st["state"] == "failed" and st["error_type"] == "ServeError"
    assert "band_fwd launch failed" in st["error"]
    assert isinstance(server.fatal, kernels.KernelError)
    with pytest.raises(RuntimeError):
        server.submit("acme", JobSpec(*_serve_inputs(tmp_path, 5, 1)))
    assert server.describe()["device_lost"]
    server.drain(10.0)


# --------------------------------------------------------- ledger fleet

def _ledger_cli(argv):
    from test_torch_pipeline import _run_cli
    return _run_cli(argv)


def test_ledger_worker_on_the_card_matches_serial(cuda, tmp_path,
                                                  monkeypatch,
                                                  fault_plane):
    """One ledger worker on the card (two shards, each its own polisher)
    gives the serial cuda run's bytes, launching the consensus kernels
    (K1, W1, M1, M2) on the card and publishing them in its metric shard;
    then an eviction at the second contig of a one-shard ledger and a
    thief with a skewed lease clock: the same bytes, and the thief
    polishes fewer windows than the whole run (it resumes the victim's
    commit) on the card's kernels."""
    from racon_tpu_torch.obs import fleet, metrics
    from racon_tpu_torch.resilience import faults
    paths = _serve_inputs(tmp_path, 21, 3)
    kernels.reset_launches()
    rc, base, err = _ledger_cli([*paths, "--device", "cuda"])
    assert rc == 0, err[-2000:]
    serial = dict(kernels.LAUNCHES)
    serial_windows = metrics.registry().get("poa_windows_total")
    assert serial["merge_votes"] > 0 and base.count(b">") == 3
    monkeypatch.setattr(fleet, "_WRITER", None)
    kernels.reset_launches()
    ovl_align.reset_stats()
    ld = str(tmp_path / "ledger")
    rc, out, err = _ledger_cli([*paths, "--device", "cuda", "--ledger-dir",
                                ld, "--worker-id", "w0"])
    assert rc == 0, err[-2000:]
    assert out == base
    n = dict(kernels.LAUNCHES)
    for name in ("band_fwd", "col_walk", "merge_votes"):
        assert n[name] > 0, name
    assert n["merge_windows"] + n["merge_windows_sched"] == \
        n["merge_votes"]
    last = fleet.load_worker_shards(fleet.obs_dir_for(ld))[0]["records"][-1]
    m = last["metrics"]
    assert last["final"]
    assert m["kernel_launches_merge_votes"] == n["merge_votes"]
    assert 0 < m["kernel_launches_band_fwd_consensus"] <= n["band_fwd"]
    # Eviction and steal, one shard.
    monkeypatch.setenv("RACON_TPU_DIST_SHARDS", "1")
    monkeypatch.setattr(fleet, "_WRITER", None)
    ld2 = str(tmp_path / "ledger2")
    faults.configure("dist/contig:1")
    with pytest.raises(faults.InjectedFault):
        _ledger_cli([*paths, "--device", "cuda", "--ledger-dir", ld2,
                     "--worker-id", "victim"])
    faults.configure("skew=1e9")
    monkeypatch.setattr(fleet, "_WRITER", None)
    kernels.reset_launches()
    metrics.reset()
    rc, out, err = _ledger_cli([*paths, "--device", "cuda", "--ledger-dir",
                                ld2, "--worker-id", "thief"])
    assert rc == 0, err[-2000:]
    assert out == base
    assert kernels.LAUNCHES["merge_votes"] > 0
    assert 0 < metrics.registry().get("poa_windows_total") < serial_windows
    assert "resumes 1/3 committed contig(s)" in err


def test_sigterm_teardown_on_the_card(cuda, tmp_path, fault_plane):
    """The signal path on the card: SIGTERM at the second checkpoint
    commit ends the CLI with 143, the first contig on stdout and in the
    store, as on the CPU; a --resume on the card gives the whole serial
    bytes."""
    import os
    import subprocess
    import sys
    paths = _serve_inputs(tmp_path, 21, 3)
    rc, base, err = _ledger_cli([*paths, "--device", "cuda"])
    assert rc == 0, err[-2000:]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, RACON_TPU_FAULTS="ckpt/commit:1!term",
               PYTHONPATH=root)
    runs = {}
    for dev in ("cuda", "cpu"):
        runs[dev] = subprocess.run(
            [sys.executable, "-m", "racon_tpu_torch.cli", "--device", dev,
             *paths, "--checkpoint-dir", str(tmp_path / dev)],
            capture_output=True, env=env, cwd=root, timeout=600)
        assert runs[dev].returncode == 143, runs[dev].stderr[-2000:]
    assert runs["cuda"].stdout == runs["cpu"].stdout
    assert base.startswith(runs["cuda"].stdout) and runs["cuda"].stdout
    assert b"interrupted (signal 15); 1 contig(s) committed" in \
        runs["cuda"].stderr
    for f in ("manifest.jsonl", "contigs.fasta"):
        assert (tmp_path / "cuda" / f).read_bytes() == \
            (tmp_path / "cpu" / f).read_bytes()
    rc, out, err = _ledger_cli([*paths, "--device", "cuda",
                                "--checkpoint-dir", str(tmp_path / "cuda"),
                                "--resume"])
    assert rc == 0, err[-2000:]
    assert out == base
