"""The port's CUDA kernels against their plain PyTorch versions, bitwise.

Needs an NVIDIA GPU with nvcc (the kernels build on first use); on a host
without one every test here skips. Run on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda -q``. No JAX import:
the GPU host runs the port alone.
"""

import numpy as np
import pytest
import torch

from racon_tpu_torch.ops import kernels
from racon_tpu_torch.ops.band import band_geometry, fw_dirs_band_plain
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


def test_wrappers_reject_bad_inputs(cuda):
    args = _band_case(1, 8, 16, 128, 8)
    tb, qT, klo, lq = (a.to(cuda) for a in args)
    with pytest.raises(kernels.KernelError):
        kernels.fw_dirs_band(tb, qT, klo.to(torch.int64), lq, match=5,
                             mismatch=-4, gap=-8, W=128)
    with pytest.raises(kernels.KernelError):
        kernels.fw_dirs_flat(tb[:, :128].t(), qT, match=5, mismatch=-4,
                             gap=-8)
