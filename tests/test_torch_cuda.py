"""The port's CUDA kernels against their plain PyTorch versions, bitwise:
the banded forward (untiled and tiled, each also over a group of
chunks' lanes at the overlap routes' widths), the full-width forward, the
column walk (band and flat layouts) and the walk's latency probe, the
batched NW forward (K4) and its traceback (T1), the monotone count (K5)
and the batched aligner end to end.

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

