"""The launch planners of K4 and K5 (ops/kernels.py::nw_plan and
count_plan) and the CPU side of their wrappers: what runs here without a
card. The kernels themselves are held against their plain versions on the
card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from racon_tpu_torch.ops import kernels
from racon_tpu_torch.ops.align import nw_dirs_plain
from racon_tpu_torch.ops.device_merge import monotone_count_plain


@pytest.mark.parametrize("Lt,C", [
    (1, 4), (56, 4), (128, 4), (129, 8), (200, 8), (256, 8), (384, 12),
    (500, 16), (512, 16), (513, 20), (640, 20), (768, 24), (896, 28),
    (1024, 32),
])
def test_nw_plan_warp(Lt, C):
    """Up to Lt = 1024 the warp kernel: ceil(Lt/32) columns a thread
    rounded up to a multiple of 4 (every instantiation, 4 to 32), 4 lanes
    a block, no shared memory; the query length does not enter."""
    for Lq in (1, 512, 640, 100000):
        plan = kernels.nw_plan(Lq, Lt)
        assert plan == {"variant": "warp", "C": C, "lanes_per_block": 4,
                        "threads": 128, "smem": 0}


def test_nw_plan_route_shapes():
    """Every batch shape the op-string route launches ([4096, 512, 512]
    and [3072, 640, 512], B x Lq x Lt) takes the warp kernel at C = 16."""
    for Lq in (512, 640):
        plan = kernels.nw_plan(Lq, 512)
        assert (plan["variant"], plan["C"]) == ("warp", 16)


def test_nw_plan_warp_invariants():
    """For every Lt the warp kernel takes: 32 threads of C columns cover
    the row, C is a multiple of 4 and the least such."""
    for Lt in range(1, kernels.NW_WARP_MAX_LT + 1):
        C = kernels.nw_plan(64, Lt)["C"]
        assert C % 4 == 0 and 4 <= C <= 32
        assert 32 * C >= Lt and (C == 4 or 32 * (C - 4) < Lt)


@pytest.mark.parametrize("Lq,Lt,threads", [
    (64, 1025, 288), (64, 1056, 288), (640, 4224, 1024), (64, 50, 32),
    (640, 512, 128), (64, 4099, 1024),
])
def test_nw_plan_wide(Lq, Lt, threads):
    """Past Lt = 1024 (or when asked for by name) the wide kernel: one
    block a lane of ceil(Lt/4) threads rounded up to a warp, at most
    1024, and the shared memory of nw_smem."""
    variant = None if Lt > kernels.NW_WARP_MAX_LT else "wide"
    plan = kernels.nw_plan(Lq, Lt, variant)
    assert plan == {"variant": "wide", "C": 0, "lanes_per_block": 1,
                    "threads": threads, "smem": kernels.nw_smem(Lq, Lt)}


@pytest.mark.parametrize("Lq,Lt,variant", [
    (0, 512, None), (64, 0, None), (-1, 512, "wide"), (64, -8, "warp"),
    (64, 1025, "warp"), (64, 4224, "warp"),
    (144, 50000, None), (144, 50000, "wide"),
    (64, 512, "flat"), (64, 512, "Warp"),
])
def test_nw_plan_raises(Lq, Lt, variant):
    """Empty shapes, the warp kernel past its width, a wide row past the
    block's shared memory and an unknown variant raise."""
    with pytest.raises(kernels.KernelError):
        kernels.nw_plan(Lq, Lt, variant)


@pytest.mark.parametrize("P,lanes", [
    (1, 8), (2, 8), (33, 8), (510, 8), (514, 8), (7264, 8), (7265, 7),
    (14528, 4), (14529, 3), (58112, 1),
])
def test_count_plan(P, lanes):
    """8 lanes a block unless their histograms (P bins rounded up to a
    multiple of 4, int32) pass SMEM_MAX; then as many as fit."""
    plan = kernels.count_plan(P)
    stride = 4 * (-(-P // 4) * 4)
    assert plan == {"lanes_per_block": lanes, "smem": lanes * stride}
    assert plan["smem"] <= kernels.SMEM_MAX
    assert lanes == kernels.COUNT_LANES or \
        (lanes + 1) * stride > kernels.SMEM_MAX


@pytest.mark.parametrize("P", [0, -3, 58113, 10 ** 6])
def test_count_plan_raises(P):
    with pytest.raises(kernels.KernelError):
        kernels.count_plan(P)


def test_launch_keys():
    """Each K4 variant counts its own launches; a reset zeroes them."""
    assert {"nw_fwd", "nw_fwd_wide", "monotone_count"} <= set(
        kernels.LAUNCHES)
    saved = dict(kernels.LAUNCHES)
    try:
        kernels.LAUNCHES["nw_fwd_wide"] = 3
        kernels.reset_launches()
        assert all(v == 0 for v in kernels.LAUNCHES.values())
    finally:
        kernels.LAUNCHES.update(saved)


@pytest.mark.parametrize("Lt", [50, 512, 1056])
def test_nw_dirs_cpu_is_plain(Lt):
    """On CPU tensors the wrapper is the plain version, launches nothing
    and takes no variant."""
    rng = np.random.default_rng(Lt)
    q = torch.from_numpy(rng.integers(0, 5, (3, 40)).astype(np.uint8))
    t = torch.from_numpy(rng.integers(0, 5, (3, Lt)).astype(np.uint8))
    sc = dict(match=5, mismatch=-4, gap=-8)
    n0 = dict(kernels.LAUNCHES)
    assert torch.equal(kernels.nw_dirs(q, t, **sc), nw_dirs_plain(q, t, **sc))
    assert kernels.LAUNCHES == n0
    with pytest.raises(kernels.KernelError):
        kernels.nw_dirs(q, t, variant="wide", **sc)


@pytest.mark.parametrize("S,P", [(531, 33), (64, 1), (0, 5)])
def test_monotone_count_cpu_is_plain(S, P):
    rng = np.random.default_rng(S + P)
    X = torch.from_numpy(rng.integers(-4, P + 4, (5, S)).astype(np.int32))
    n0 = kernels.LAUNCHES["monotone_count"]
    out = kernels.monotone_count(X, P)
    assert torch.equal(out, monotone_count_plain(X, P))
    assert out.dtype == torch.int32 and out.shape == (5, P)
    assert kernels.LAUNCHES["monotone_count"] == n0
