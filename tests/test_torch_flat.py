"""The port's plain full-width forward against the JAX package, bitwise:
``flat.fw_dirs_xla`` on several shapes and scorings, and one case against
the Pallas kernel in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from racon_tpu.ops.flat import fw_dirs_xla
from racon_tpu.ops.pallas.flat_kernel import fw_dirs_pallas
from racon_tpu_torch.ops import kernels
from racon_tpu_torch.ops.flat import fw_dirs_flat_plain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, Lq, Lt):
    rng = np.random.default_rng(seed)
    tbuf = rng.integers(0, 5, (B, Lt)).astype(np.uint8)
    tbuf[:, Lt // 2 + 7:] = 7                 # padding past a short lt
    qT = rng.integers(0, 4, (Lq, B)).astype(np.uint8)
    return tbuf, qT


@pytest.mark.parametrize("shape", [(16, 24, 40), (32, 48, 128)])
@pytest.mark.parametrize("scoring", [(5, -4, -8), (1, -1, -1), (0, -1, -1)])
def test_flat_plain_matches_xla_twin(shape, scoring):
    m, x, g = scoring
    tbuf, qT = _inputs(3, *shape)
    ref = fw_dirs_xla(jnp.asarray(tbuf), jnp.asarray(qT), match=m,
                      mismatch=x, gap=g)
    out = kernels.fw_dirs_flat(torch.from_numpy(tbuf), torch.from_numpy(qT),
                               match=m, mismatch=x, gap=g)
    assert out.dtype == torch.uint8
    assert np.array_equal(np.asarray(ref), out.numpy())


def test_flat_plain_matches_pallas_interpret():
    tbuf, qT = _inputs(9, 128, 32, 128)
    ref = fw_dirs_pallas(jnp.asarray(tbuf), jnp.asarray(qT), match=5,
                         mismatch=-4, gap=-8, interpret=True)
    out = fw_dirs_flat_plain(torch.from_numpy(tbuf), torch.from_numpy(qT),
                             match=5, mismatch=-4, gap=-8)
    assert np.array_equal(np.asarray(ref), out.numpy())
