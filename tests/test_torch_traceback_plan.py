"""T1's launch planner (ops/kernels.py::traceback_plan, traceback_band)
and a Python model of its windowed walk (tests/traceback_model.py): what
runs here without a card. The model reads the plane only through the
kernel's windows; it must give the plain traceback's op strings and
counts (ops/align.py::traceback_plain) and the reference's
``_traceback_flat`` (JAX on the CPU) on 8%-error pairs as the op-string
route makes them and on adversarial planes. The kernel itself is held
against the plain traceback and this model's refill counts on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from racon_tpu.ops import align as ralign
from racon_tpu_torch.ops import align as palign
from racon_tpu_torch.ops import kernels
from racon_tpu_torch.ops.encode import encode_bases
from racon_tpu_torch.utils.synth import _BASES, mutate
from traceback_model import windowed_traceback

SC = dict(match=5, mismatch=-4, gap=-8)


@pytest.mark.parametrize("B,Lq,Lt,lanes", [
    # The op-string route's batch shapes on an H100's 132 SMs: 32 and 24
    # lanes an SM, each SM's share in one block; the earlier rows' shape; a
    # 512-lane batch (4 lanes an SM), the card tests' B = 3 and 1030, and
    # 5000 lanes (38 an SM: two blocks of 19).
    (4096, 512, 512, 32), (3072, 640, 512, 24), (4096, 640, 512, 32),
    (512, 512, 512, 4), (3, 64, 50, 1), (1030, 64, 4224, 8),
    (5000, 512, 512, 19),
])
def test_traceback_plan_route_shapes(B, Lq, Lt, lanes):
    plan = kernels.traceback_plan(B, Lq, Lt, sms=132)
    assert plan == {"R": 32, "C": 64, "M": 16, "lanes_per_block": lanes,
                    "smem": lanes * kernels.TB_LANE_BYTES}


def test_traceback_lane_bytes():
    """Two windows of R x C bytes (the one walked and the one
    prefetched), each with R + 2 int32 first columns, and the op ring:
    whole 16-byte pieces, so every lane's windows stay 16-byte aligned,
    and a whole SM's share of 32 lanes fits a block."""
    R, C, _ = kernels.TB_WINDOW
    assert kernels.TB_LANE_BYTES == 2 * (R * C + 4 * (R + 2)) + \
        kernels.TB_RING == 4624
    assert kernels.TB_LANE_BYTES % 16 == 0
    assert kernels.TB_LANES * kernels.TB_LANE_BYTES <= kernels.SMEM_MAX


@pytest.mark.parametrize("sms", [16, 108, 132])
def test_traceback_plan_invariants(sms):
    """Over lane counts from 1 to 10^6: an SM's share of the lanes,
    ceil(B / sms), split into as few blocks of at most TB_LANES lanes as
    it takes, the blocks within one lane of each other; a block within
    the card's shared memory; band widths of whole sectors with the
    margin on either side of the diagonal at least half a sector."""
    for B in (1, 3, 7, 64, 131, 512, 1030, 3072, 4096, 20000, 10 ** 6):
        plan = kernels.traceback_plan(B, 512, 512, sms=sms)
        lanes_sm = -(-B // sms)
        lpb = plan["lanes_per_block"]
        blocks = -(-lanes_sm // kernels.TB_LANES)
        assert 1 <= lpb <= min(kernels.TB_LANES, lanes_sm)
        assert -(-lanes_sm // lpb) == blocks
        assert blocks * lpb - lanes_sm < blocks
        assert plan["smem"] == lpb * kernels.TB_LANE_BYTES <= \
            kernels.SMEM_MAX
        C, M = plan["C"], plan["M"]
        assert C % 32 == 0 and M >= 16 and C - M - 32 >= 16


def test_traceback_plan_rejects_bad_shapes():
    for shape in ((0, 64, 64), (8, 0, 64), (8, 64, 0)):
        with pytest.raises(kernels.KernelError):
            kernels.traceback_plan(*shape)


@pytest.mark.parametrize("j0", [1, 2, 31, 32, 33, 500])
def test_traceback_band_sectors_and_diagonal(j0):
    """Each row's band starts on a 32-byte sector boundary of the plane's
    addresses and holds the diagonal column j0 - 1 - r with at least M
    bytes on its left and C - M - 32 on its right, whatever the rows'
    addresses modulo 32."""
    R, C, M = kernels.TB_WINDOW
    rng = np.random.default_rng(j0)
    for _ in range(8):
        starts = [int(a) for a in rng.integers(0, 1 << 40, R)]
        for r, (a, lo) in enumerate(zip(starts, kernels.traceback_band(
                j0, starts))):
            x = j0 - 1 - r
            assert (a + lo) % 32 == 0
            assert lo <= x - M and x + (C - M - 32) < lo + C


def _pairs(seed, B, Lq, Lt, err=0.08):
    """8%-error pairs as the op-string route packs them (targets of
    window-slice lengths, queries noisy copies), or random pairs with
    random lengths in [0, Lq] x [0, Lt] (err=None: long LEFT and UP runs
    that leave the band, and lanes with lq or lt of 0)."""
    rng = np.random.default_rng(seed)
    q = np.zeros((B, Lq), np.uint8)
    t = np.zeros((B, Lt), np.uint8)
    lq = np.zeros(B, np.int32)
    lt = np.zeros(B, np.int32)
    for b in range(B):
        if err is None:
            lq[b], lt[b] = rng.integers(0, Lq + 1), rng.integers(0, Lt + 1)
            if b in (2, 3):  # a tall and a wide lane: UP and LEFT runs
                lq[b], lt[b] = (Lq, min(8, Lt)) if b == 2 else (3, Lt)
            q[b, :lq[b]] = rng.integers(0, 4, lq[b])
            t[b, :lt[b]] = rng.integers(0, 4, lt[b])
            continue
        tt = _BASES[rng.integers(0, 4, int(rng.integers(Lt * 3 // 4,
                                                         Lt - 3)))]
        qq = mutate(rng, tt, err)[0][:Lq]
        t[b, :len(tt)] = encode_bases(tt.tobytes())
        q[b, :len(qq)] = encode_bases(qq.tobytes())
        lq[b], lt[b] = len(qq), len(tt)
    if err is None:
        lq[0], lt[1 % B] = 0, 0
    return tuple(torch.from_numpy(a) for a in (q, t, lq, lt))


def _check(dirs, lq, lt, L, base_mods=(0, 13, 31), reference=True):
    """The model at each plane address modulo 32 equals the plain
    traceback (and the reference's, where every start lies on the
    plane); returns the refill counts at the first."""
    ref_ops, ref_n = kernels.nw_traceback(dirs, lq, lt, L)
    if reference:
        Lq, B, Lt = dirs.shape
        rev = ralign._traceback_flat(
            jnp.asarray(dirs.numpy().reshape(-1)), B * Lt,
            jnp.asarray(np.arange(B, dtype=np.int32) * Lt), L,
            jnp.asarray(lq.numpy()), jnp.asarray(lt.numpy()))
        assert np.array_equal(np.asarray(rev)[:, ::-1], ref_ops.numpy())
    counts = None
    for bm in base_mods:
        ops, n, refills = windowed_traceback(dirs, lq, lt, L, bm)
        assert np.array_equal(ops, ref_ops.numpy()), bm
        assert np.array_equal(n, ref_n.numpy()), bm
        assert (refills[:, 1] <= refills[:, 0]).all()
        if counts is None:
            counts = refills
    return counts


def test_model_route_pairs():
    """8%-error pairs at a route-like width: the model gives the plain
    op strings, and the windows hold the paths (about one window a 32
    rows, no misses)."""
    q, t, lq, lt = _pairs(10, 12, 256, 256)
    dirs = palign.nw_dirs_plain(q, t, **SC)
    counts = _check(dirs, lq, lt, 512)
    R = kernels.TB_WINDOW[0]
    assert (counts[:, 0] >= np.ceil(lq.numpy() / R)).all()
    assert counts[:, 1].sum() == 0


@pytest.mark.parametrize("Lt", [50, 56, 200])
def test_model_random_pairs(Lt):
    """Random pairs (LEFT and UP runs past the band and the window,
    lanes with lq or lt of 0) at unaligned widths: paths that leave
    their windows through a band edge."""
    q, t, lq, lt = _pairs(Lt, 9, 70, Lt, err=None)
    dirs = palign.nw_dirs_plain(q, t, **SC)
    counts = _check(dirs, lq, lt, 70 + Lt)
    assert counts[:, 1].sum() > 0


def test_model_short_L_and_clamped_starts():
    """L shorter than the paths (the walk stops at L steps), and starts
    past the plane (lq > Lq, lt > Lt, clamped onto it; the reference
    does not clamp, so only the plain traceback is held)."""
    q, t, lq, lt = _pairs(4, 8, 90, 80)
    dirs = palign.nw_dirs_plain(q, t, **SC)
    for L in (1, 17, 100):
        _check(dirs, lq, lt, L)
    lq2, lt2 = lq.clone(), lt.clone()
    lq2[:3] = torch.tensor([90, 200, 91], dtype=torch.int32)
    lt2[2:5] = torch.tensor([80, 81, 1000], dtype=torch.int32)
    _check(dirs, lq2, lt2, 170, reference=False)


def test_model_codes_that_do_not_move():
    """Bytes other than DIAG, UP and LEFT (PAD_OP among them) are
    emitted and stay put, as in the plain version, until L steps: the
    ring's capacity ends a run, and the walk goes on in its window."""
    rng = np.random.default_rng(9)
    Lq, B, Lt = 40, 6, 48
    dirs = torch.from_numpy(rng.choice(np.array([0, 0, 0, 1, 2, 3, 7],
                                                np.uint8), (Lq, B, Lt)))
    lq = torch.from_numpy(rng.integers(0, Lq + 1, B).astype(np.int32))
    lt = torch.from_numpy(rng.integers(0, Lt + 1, B).astype(np.int32))
    _check(dirs, lq, lt, 700)


def test_traceback_wrapper_cpu_is_plain():
    """On CPU tensors the wrapper is the plain traceback and launches
    nothing; lanes a block and refill counters are the card's and
    raise."""
    q, t, lq, lt = _pairs(6, 5, 40, 44, err=None)
    dirs = palign.nw_dirs_plain(q, t, **SC)
    rev = palign.traceback_plain(dirs, lq, lt, 84)
    n0 = kernels.LAUNCHES["nw_traceback"]
    ops, n = kernels.nw_traceback(dirs, lq, lt, 84)
    assert torch.equal(ops, torch.flip(rev, dims=[1]))
    assert torch.equal(n, (rev != palign.PAD_OP).sum(dim=1,
                                                     dtype=torch.int32))
    assert kernels.LAUNCHES["nw_traceback"] == n0
    with pytest.raises(kernels.KernelError):
        kernels.nw_traceback(dirs, lq, lt, 84, lanes_per_block=1)
    with pytest.raises(kernels.KernelError):
        kernels.nw_traceback(dirs, lq, lt, 84,
                             refills=torch.zeros((5, 2), dtype=torch.int32))


@pytest.mark.parametrize("lanes", [0, -1, 33])
def test_traceback_plan_check_rejects(lanes):
    """Lanes a block past 1 to TB_LANES (a block of 32 warps) raise
    before any launch; None takes the plan's, and any in range is
    taken as given."""
    plan = kernels.traceback_plan(4096, 512, 512)
    with pytest.raises(kernels.KernelError):
        kernels._traceback_lanes(plan, lanes)
    assert kernels._traceback_lanes(plan, None) == plan["lanes_per_block"]
    assert [kernels._traceback_lanes(plan, k) for k in (1, 16, 32)] == \
        [1, 16, 32]
