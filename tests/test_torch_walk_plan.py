"""The column walk's launch planner (ops/kernels.py::walk_plan) and the
CPU side of its wrapper and of the latency probe: what runs here without
a card. The kernel itself is held against the plain walk on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from racon_tpu_torch.ops import kernels
from racon_tpu_torch.ops.colwalk import col_walk


@pytest.mark.parametrize("B,k,layout,n_tiles,want", [
    # The main path's four walks on an H100's 132 SMs: the tiled overlap
    # group, the untiled overlap chunk, the consensus chunk and the flat
    # (band-off) consensus chunk.
    (384, 2, "band", 5, dict(G=32, R=128, S=64, lanes_per_block=3)),
    (128, 4, "band", 0, dict(G=32, R=128, S=64, lanes_per_block=1)),
    (4096, 4, "band", 0, dict(G=4, R=1, S=16, lanes_per_block=32)),
    (1024, 1, "flat", 0, dict(G=32, R=32, S=64, lanes_per_block=4)),
    # Between the two: 8 lanes an SM at k = 4 take the largest window
    # that fits (two 128 x 64 or 64 x 64 windows of 4 bytes a slot for 8
    # lanes pass WALK_SMEM_SM); 9 lanes an SM take one row.
    (1056, 4, "band", 0, dict(G=32, R=32, S=32, lanes_per_block=4)),
    (1057, 4, "band", 0, dict(G=4, R=1, S=16, lanes_per_block=9)),
])
def test_walk_plan_main_shapes(B, k, layout, n_tiles, want):
    plan = kernels.walk_plan(B, k, layout=layout, n_tiles=n_tiles, sms=132)
    assert {n: plan[n] for n in want} == want
    assert plan["lane_bytes"] == kernels.walk_lane_bytes(k, plan["R"],
                                                         plan["S"], n_tiles)
    assert plan["smem"] == plan["lanes_per_block"] * plan["lane_bytes"]


def test_walk_lane_bytes():
    """Two windows of R x S slots (1, 2 or 4 bytes a slot at k = 1, 2, 4)
    and the tile origins rounded up to 16 bytes."""
    assert kernels.walk_lane_bytes(1, 32, 64) == 4096
    assert kernels.walk_lane_bytes(2, 64, 64) == 16384
    assert kernels.walk_lane_bytes(4, 1, 16) == 128
    assert kernels.walk_lane_bytes(2, 64, 64, 5) == 16384 + 32
    assert kernels.walk_lane_bytes(2, 64, 64, 4) == 16384 + 16


@pytest.mark.parametrize("layout,k", [("band", 1), ("band", 2),
                                      ("band", 4), ("flat", 1)])
def test_walk_plan_invariants(layout, k):
    """Over lane counts from 1 to 10^6 and SM counts of several cards:
    a warp a lane and tall windows up to WALK_FEW_LANES lanes an SM, then
    4 threads a lane and one-row windows; at most 128 threads a block and
    no more lanes a block than an SM holds; windows of whole 16-byte
    pieces; a block within the card's shared memory; the windows of an
    SM's lanes within WALK_SMEM_SM unless the smallest window is taken;
    flat windows wider than tall by 32 slots."""
    for sms in (16, 108, 132):
        for B in (1, 7, 64, 131, 384, 1024, 4096, 20000, 10 ** 6):
            plan = kernels.walk_plan(B, k, layout=layout, n_tiles=3,
                                     sms=sms)
            G, R, S = plan["G"], plan["R"], plan["S"]
            lanes_sm = -(-B // sms)
            few = lanes_sm <= kernels.WALK_FEW_LANES
            assert (G, R > 1) == ((32, True) if few else (4, False))
            assert plan["lanes_per_block"] * G <= 128
            assert plan["lanes_per_block"] <= lanes_sm
            assert S % 16 == 0 and R >= 1
            assert plan["smem"] <= kernels.SMEM_MAX
            if few:
                assert (lanes_sm * plan["lane_bytes"] <= kernels.WALK_SMEM_SM
                        or (R, S) == kernels.WALK_WINDOWS[layout][-1])
                if layout == "flat":
                    assert S >= R + 32


def test_walk_plan_rejects_bad_layout():
    with pytest.raises(kernels.KernelError):
        kernels.walk_plan(64, 2, layout="diagonal")


def _walk_inputs(seed=3, B=12, Lq=40, W=32):
    rng = np.random.default_rng(seed)
    cells = torch.from_numpy(rng.integers(0, 256, (Lq, B, W)).astype(
        np.uint8))
    lq = torch.from_numpy(rng.integers(1, Lq + 1, B).astype(np.int32))
    lt = torch.from_numpy(rng.integers(1, Lq + 1, B).astype(np.int32))
    klo = torch.from_numpy(rng.integers(-8, 1, B).astype(np.int32))
    t_off = torch.from_numpy(rng.integers(0, 6, B).astype(np.int32))
    return cells, lq, lt, klo, t_off, int(Lq + 8)


def test_col_walk_wrapper_cpu_is_plain_walk():
    """On CPU tensors the wrapper is the plain walk, whatever plan it is
    given (a plan changes the kernel's time, never its outputs)."""
    cells, lq, lt, klo, t_off, LA = _walk_inputs()
    ref = col_walk(cells, lq, lt, klo, t_off, LA=LA, layout="band")
    n0 = kernels.LAUNCHES["col_walk"]
    for plan in (None, {"G": 4, "R": 8, "S": 16, "lanes_per_block": 3}):
        out = kernels.col_walk_kernel(cells, lq, lt, klo, t_off, LA=LA,
                                      layout="band", plan=plan)
        for name in ("ins_len", "qstart", "op_c", "qi_c", "sat"):
            assert torch.equal(ref[name], out[name])
    assert kernels.LAUNCHES["col_walk"] == n0


def test_col_walk_wrapper_cpu_rejects_refills():
    """The refill counter is the kernel's: on the CPU it raises."""
    cells, lq, lt, klo, t_off, LA = _walk_inputs()
    with pytest.raises(kernels.KernelError):
        kernels.col_walk_kernel(cells, lq, lt, klo, t_off, LA=LA,
                                layout="band",
                                refills=torch.zeros((12, 2),
                                                    dtype=torch.int32))


def test_chase_shared_mode_cpu():
    """The probe's shared mode follows the same chains as its device
    mode (the plain loop on the CPU), and refuses arrays past its shared
    memory or more than 1024 lanes."""
    loads = kernels.chain_of_loads(200, 7, "cpu", lanes=5, lane_stride=3)
    for steps in (0, 1, 50, 300):
        assert torch.equal(
            kernels.chase(loads, steps, 5, 3, shared=True),
            kernels.chase(loads, steps, 5, 3))
    big = kernels.chain_of_loads(kernels.CHASE_SHARED_ENTRIES, 1, "cpu")
    with pytest.raises(kernels.KernelError):
        kernels.chase(big, 1, shared=True)
    with pytest.raises(kernels.KernelError):
        kernels.chase(loads, 1, lanes=1025, lane_stride=0, shared=True)
