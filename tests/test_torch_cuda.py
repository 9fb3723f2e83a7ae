"""The port's CUDA kernels against their plain PyTorch versions, bitwise:
the banded forward (untiled and tiled), the full-width forward, the
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
from racon_tpu_torch.ops.band import (band_geometry, fw_dirs_band_plain,
                                      fw_dirs_band_tile_plain, row0_scores,
                                      uc_boundary)
from racon_tpu_torch.ops.colwalk import col_walk
from racon_tpu_torch.ops.device_merge import monotone_count_plain
from racon_tpu_torch.ops.flat import fw_dirs_flat_plain

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


@pytest.mark.parametrize("B", [3, 128, 1030])
@pytest.mark.parametrize("Lt", [56, 640, 4224])
def test_nw_kernels_match_plain(cuda, B, Lt):
    """K4 (direction codes; Lt=4224 gives a thread two 4-column groups)
    and T1 (op strings and counts) on its planes."""
    Lq = 64
    q, t, lq, lt = _nw_case(B + Lt, B, Lq, Lt)
    sc = dict(match=5, mismatch=-4, gap=-8)
    ref = align.nw_dirs_plain(q, t, **sc)
    n0 = dict(kernels.LAUNCHES)
    dirs = kernels.nw_dirs(q.to(cuda), t.to(cuda), **sc)
    torch.cuda.synchronize()
    assert torch.equal(ref, dirs.cpu())
    r_ops, r_n = kernels.nw_traceback(ref, lq, lt, Lq + Lt)
    ops, n = kernels.nw_traceback(dirs, lq.to(cuda), lt.to(cuda), Lq + Lt)
    torch.cuda.synchronize()
    assert torch.equal(r_ops, ops.cpu()) and torch.equal(r_n, n.cpu())
    assert kernels.LAUNCHES["nw_fwd"] == n0["nw_fwd"] + 1
    assert kernels.LAUNCHES["nw_traceback"] == n0["nw_traceback"] + 1


@pytest.mark.parametrize("kind", ["monotone", "unsorted"])
def test_monotone_count_kernel_matches_plain(cuda, kind):
    """K5 on non-decreasing rows (the op-string route's keys, with their
    negative pad prefix) and on unsorted rows with values on both sides
    of [0, P)."""
    rng = np.random.default_rng(17)
    B, S, P = 130, 700, 300
    if kind == "monotone":
        X = np.cumsum(rng.integers(0, 2, (B, S)), axis=1) - \
            rng.integers(1, 60, (B, 1))
    else:
        X = rng.integers(-50, P + 50, (B, S))
    X = torch.from_numpy(X.astype(np.int32))
    ref = monotone_count_plain(X, P)
    n0 = kernels.LAUNCHES["monotone_count"]
    out = kernels.monotone_count(X.to(cuda), P)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["monotone_count"] == n0 + 1
    assert torch.equal(ref, out.cpu())


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
    depths."""
    for lanes, lane_stride in ((1, 0), (40, 7)):
        loads = kernels.chain_of_loads(300, 1000, "cpu", lanes=lanes,
                                       lane_stride=lane_stride)
        on_card = loads.to(cuda)
        for steps in (0, 1, 123, 300):
            want = kernels.chase(loads, steps, lanes, lane_stride)
            got = kernels.chase(on_card, steps, lanes, lane_stride)
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
    runs = {}
    for dev in ("cpu", cuda):
        ovls = [_Ovl(*sp) for sp in specs]
        n0 = dict(kernels.LAUNCHES)
        fb = ovl_align.device_breaking_points(ovls, None, 500, match=0,
                                              mismatch=-1, gap=-1,
                                              device=dev)
        runs[str(dev)] = (ovls, [ovls.index(o) for o in fb],
                          {k: kernels.LAUNCHES[k] - n0[k] for k in n0})
    (c_ovl, c_fb, _), (g_ovl, g_fb, g_n) = runs["cpu"], runs["cuda"]
    assert g_fb == c_fb == [6, 5]     # over budget first, then uncertified
    assert g_n["band_tile_fwd"] == 5 and g_n["col_walk"] == 2
    assert g_n["band_fwd"] == 1
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
