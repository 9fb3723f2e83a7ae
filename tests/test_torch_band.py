"""The port's plain banded forward against the JAX package, bitwise.

Same numpy inputs (made from a seed) through ``fw_dirs_band_xla`` and the
port's ``fw_dirs_band_plain`` on every plane — cells, nxt (k >= 2), nxt2
(k = 4) — and hlast, at k = 1/2/4, three scorings and W in {128, 256},
with lanes at the band edges (|lt - lq| near W/2) and lq < Lq. One small
case also holds the port against the Pallas kernel in interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from racon_tpu.ops.pallas.band_kernel import (band_geometry, fw_dirs_band,
                                              fw_dirs_band_xla, uc_boundary)
from racon_tpu_torch.ops import band as tband_mod
from racon_tpu_torch.ops import kernels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCORINGS = [(5, -4, -8), (1, -1, -1), (0, -1, -1)]


def _inputs(seed, B, Lq, W):
    rng = np.random.default_rng(seed)
    lq = rng.integers(Lq // 3, Lq + 1, B).astype(np.int32)
    lq[: B // 4] = Lq                       # some full-height lanes
    half = W // 2
    lt = (lq + rng.integers(-half + 2, half - 1, B)).clip(1).astype(np.int32)
    lt[1] = lq[1] + half - 2                # both band edges
    lt[2] = max(1, lq[2] - half + 2)
    klo_t, _ = tband_mod.band_geometry(torch.from_numpy(lq),
                                       torch.from_numpy(lt), W)
    tb = rng.integers(0, 5, (B, W + Lq)).astype(np.uint8)
    rel = klo_t.numpy()[:, None] + np.arange(W + Lq)[None, :]
    tb[(rel < 0) | (rel >= lt[:, None])] = 7
    qT = rng.integers(0, 4, (Lq, B)).astype(np.uint8)
    return tb, qT, lq, lt, klo_t


def _check(ref, out, k):
    assert np.array_equal(np.asarray(ref[0]), out[0].numpy())
    if k >= 2:
        assert np.array_equal(np.asarray(ref[1]), out[1].numpy())
    else:
        assert out[1] is None
    if k >= 4:
        assert out[2].dtype == torch.uint16
        assert np.array_equal(np.asarray(ref[2]),
                              out[2].view(torch.int16).numpy().view(np.uint16))
    else:
        assert out[2] is None
    assert np.array_equal(np.asarray(ref[-1]), out[3].numpy())


# Every (k, scoring) at W=128; at W=256 every scoring at k=4 and the
# default scoring at k=1/2.
CASES = ([(128, k, s) for k in (1, 2, 4) for s in SCORINGS] +
         [(256, 4, s) for s in SCORINGS] +
         [(256, k, SCORINGS[0]) for k in (1, 2)])


@pytest.mark.parametrize("W,k,scoring", CASES)
def test_band_plain_matches_xla_twin(W, k, scoring):
    m, x, g = scoring
    tb, qT, lq, lt, klo_t = _inputs(17 + k + W, 48, 40, W)
    klo, _ = band_geometry(jnp.asarray(lq), jnp.asarray(lt), W)
    assert np.array_equal(np.asarray(klo), klo_t.numpy())
    ref = fw_dirs_band_xla(jnp.asarray(tb), jnp.asarray(qT), klo,
                           jnp.asarray(lq), match=m, mismatch=x, gap=g, W=W,
                           nxt_k=max(k, 2))
    out = kernels.fw_dirs_band(torch.from_numpy(tb), torch.from_numpy(qT),
                               klo_t, torch.from_numpy(lq), match=m,
                               mismatch=x, gap=g, W=W, nxt_k=k)
    _check(ref, out, k)


@pytest.mark.parametrize("k", [2, 4])
def test_band_plain_matches_pallas_interpret(k):
    """The Pallas kernel body itself (interpret mode, [Lq, W, B] layout,
    128-lane tiles) against the port."""
    tb, qT, lq, lt, klo_t = _inputs(5, 128, 32, 128)
    klo, _ = band_geometry(jnp.asarray(lq), jnp.asarray(lt), 128)
    ref = fw_dirs_band(jnp.asarray(tb), jnp.asarray(qT), klo,
                       jnp.asarray(lq), match=5, mismatch=-4, gap=-8,
                       W=128, interpret=True, nxt_k=k)
    ref = tuple(np.transpose(np.asarray(r), (0, 2, 1)) for r in ref[:-1]) \
        + (ref[-1],)
    out = tband_mod.fw_dirs_band_plain(
        torch.from_numpy(tb), torch.from_numpy(qT), klo_t,
        torch.from_numpy(lq), match=5, mismatch=-4, gap=-8, W=128, nxt_k=k)
    _check(ref, out, k)


def test_uc_boundary_matches_reference():
    for k in (1, 2, 4):
        assert tband_mod.uc_boundary(k) == uc_boundary(k)
