"""The port's fixed-round device chunk against the JAX package's, on
``bench.build_windows`` chunks with the reference run under
RACON_TPU_SCHED=0 (its fixed-round engine).

ChunkPlan's packed byte buffers must be equal, and collect_chunk's codes,
coverages, flagged (ovf) windows and executed rounds must match — with
the port's own plan, with the reference's buffers fed through
``load_packed``, and on the full-width path (RACON_TPU_NO_BAND=1).
"""

import numpy as np
import pytest
import torch

import bench
from racon_tpu.ops import device_poa as R
from racon_tpu_torch.ops import device_poa as P


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(match=5, mismatch=-4, gap=-8, ins_scale=(0.2, 0.2, 0.2, 0.6),
          rounds=4)


@pytest.fixture(autouse=True)
def _fresh_histories(monkeypatch):
    """Both engines pick caps and band widths from per-process histories;
    start both empty so earlier tests in this worker cannot make them
    disagree (the reference's history is restored afterwards)."""
    monkeypatch.setenv("RACON_TPU_SCHED", "0")
    for mod in (R, P):
        monkeypatch.setattr(mod, "_CAP_HISTORY", set())
        monkeypatch.setattr(mod, "_BAND_HISTORY", set())


def _plans(n_win, seed):
    wins = bench.build_windows(n_win, 30, 500, seed)
    return R.ChunkPlan(wins), P.ChunkPlan(wins)


def _same(ref, port):
    (rc, rv), (pc, pv) = ref, port
    assert len(rc) == len(pc)
    for a, b, va, vb in zip(rc, pc, rv, pv):
        assert a == b
        if a is not None:
            assert np.array_equal(va, vb)


def test_packed_buffers_equal():
    pr, pp = _plans(16, 1)
    for a, b in zip(pr.packed_bufs(), pp.packed_bufs()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (pr.B, pr.Lq, pr.LA, pr.n_win, pr.band_w) == \
        (pp.B, pp.Lq, pp.LA, pp.n_win, pp.band_w)


@pytest.mark.parametrize("n_win,seed", [(8, 1), (5, 2)])
def test_collect_chunk_matches_reference(n_win, seed):
    pr, pp = _plans(n_win, seed)
    rs, ps = {}, {}
    ref = R.run_chunk(pr, stats=rs, **KW)
    port = P.run_chunk(pp, device="cpu", stats=ps, **KW)
    _same(ref, port)
    assert rs["rounds_exec"] == ps["rounds_exec"]


def test_reference_buffers_through_load_packed():
    pr, pp = _plans(8, 3)
    ref = R.run_chunk(pr, **KW)
    st = P.chunk_statics(pp, ins_scale=KW["ins_scale"], rounds=4)
    job, winb = P.load_packed(*pr.packed_bufs(),
                              (pr.B, pr.Lq, pr.n_win, pr.LA), "cpu")
    packed = P.device_chunk_packed(
        job, winb, match=5, mismatch=-4, gap=-8,
        ins_scale=KW["ins_scale"], Lq=pr.Lq, n_win=pr.n_win, LA=pr.LA,
        band_w=st["band_w"], rounds=4, adaptive=st["adaptive"],
        nxt_k=st["nxt_k"])
    _same(ref, P.collect_chunk(pp, packed))


def test_full_width_path_matches_reference(monkeypatch):
    monkeypatch.setenv("RACON_TPU_NO_BAND", "1")
    pr, pp = _plans(6, 4)
    assert P.chunk_statics(pp, ins_scale=0.2, rounds=4)["band_w"] == 0
    _same(R.run_chunk(pr, **KW), P.run_chunk(pp, device="cpu", **KW))


def test_stage_clock_counts_launches_inside_each_stage(monkeypatch):
    from racon_tpu_torch.ops import kernels
    monkeypatch.setitem(kernels.LAUNCHES, "col_walk", 5)
    clock = P.set_stage_clock(True)
    try:
        cpu = torch.device("cpu")
        for _ in range(2):
            with P._stage("walk", cpu):
                kernels._launched("col_walk")  # as the wrapper counts
            with P._stage("merge", cpu):
                pass
    finally:
        P.set_stage_clock(False)
    assert clock.launches() == {"walk": {"col_walk": 2}, "merge": {}}
    assert set(clock.ms()) == {"walk", "merge"}


def test_load_packed_rejects_wrong_dims():
    _, pp = _plans(2, 5)
    job, winb = pp.packed_bufs()
    with pytest.raises(ValueError):
        P.load_packed(job, winb, (pp.B, pp.Lq + 1, pp.n_win, pp.LA), "cpu")
