"""The port's decoupled final-round walk against the JAX package's (run
under JAX_PLATFORMS=cpu).

- device_poa.dispatch_chunk_fwd + device_poa.dispatch_walk give exactly the
  packed bytes of the fused dispatch_chunk (band and full-width layouts,
  adaptive exit on and off), and the reference's split gives the same;
- the streaming executor's walk gate: the walk meter's counts equal the
  reference's (decoupled dispatches, fused chunks, on/off); a single
  chunk stays fused; RACON_TPU_WALK_QUEUE=0 turns the decoupled walk off;
- the walk queue's budget: plane bytes against the reference's, the
  RACON_TPU_WALK_QUEUE parsing, and the card rule at phase 4's chunk as a
  pure function (an 80 GB card admits the chunk at depth 2, the
  reference's constant admits none).
"""

import numpy as np
import pytest
import torch

from racon_tpu_torch.ops import budget as PB
from racon_tpu_torch.ops import device_poa as P
from racon_tpu_torch.pipeline import metrics
from racon_tpu_torch.pipeline.streaming import stream_consensus
from racon_tpu_torch.utils import env

from window_sets import port_windows, reference_windows

_GATES = (env.WALK_ASYNC, env.WALK_QUEUE, env.SCHED, env.ADAPTIVE,
          env.PIPELINE, env.STALL_S, env.WALK_K, env.NO_BAND)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    from racon_tpu.obs import metrics as r_metrics
    from racon_tpu.ops import device_poa as R
    for name in _GATES:
        monkeypatch.delenv(name, raising=False)
    # A pipeline that hangs fails the test through the stall detector.
    monkeypatch.setenv(env.STALL_S, "120")
    for mod in (R, P):
        monkeypatch.setattr(mod, "_CAP_HISTORY", set())
        monkeypatch.setattr(mod, "_BAND_HISTORY", set())
    metrics.reset()
    r_metrics.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    r_metrics.reset()


def _plan(eng, ws):
    dev, _host, lq_max, la_max = eng._partition_device(ws)
    sp = eng._plan_device_slice(dev, lq_max, la_max)
    assert sp.groups
    return eng._make_chunk_plan(sp, sp.groups[0])


# Windows of about 300 bases: an anchor width of 384, room for a band.
WLEN = 300


def _chunk_fixture(seed):
    """One port ChunkPlan of 8 windows and the engine's parameters."""
    from racon_tpu_torch.ops.poa import PoaEngine
    eng = PoaEngine(device="cpu")
    plan = _plan(eng, [w for w in port_windows(8, seed, WLEN)
                       if w.n_layers >= 2])
    rounds = eng.refine_rounds + 1
    return eng, plan, eng._round_scales(rounds), rounds


def _reference_split(seed):
    """The reference's dispatch_chunk_fwd + dispatch_walk on the same
    windows: the packed output bytes."""
    from racon_tpu.ops.colwalk import dispatch_walk
    from racon_tpu.ops.device_poa import dispatch_chunk_fwd
    from racon_tpu.ops.poa import PoaEngine
    eng = PoaEngine(backend="jax")
    plan = _plan(eng, [w for w in reference_windows(8, seed, WLEN)
                       if w.n_layers >= 2])
    rounds = eng.refine_rounds + 1
    fwd_out, meta = dispatch_chunk_fwd(
        plan, match=eng.match, mismatch=eng.mismatch, gap=eng.gap,
        ins_scale=eng._round_scales(rounds), rounds=rounds)
    return bytes(np.asarray(dispatch_walk(plan, fwd_out, meta)))


@pytest.mark.parametrize("adaptive", ["1", "0"])
@pytest.mark.parametrize("layout", ["band", "flat"])
def test_walk_unit_parity_fused_vs_decoupled(monkeypatch, adaptive, layout):
    monkeypatch.setenv(env.ADAPTIVE, adaptive)
    if layout == "flat":
        monkeypatch.setenv(env.NO_BAND, "1")
    seed = 5 if adaptive == "1" else 1
    eng, plan, scales, rounds = _chunk_fixture(seed)
    st = P.chunk_statics(plan, ins_scale=scales, rounds=rounds)
    assert bool(st["band_w"]) == (layout == "band")
    assert st["adaptive"] == (adaptive == "1")
    kw = dict(match=eng.match, mismatch=eng.mismatch, gap=eng.gap,
              ins_scale=scales, rounds=rounds, device="cpu")
    fused = P.dispatch_chunk(plan, **kw).numpy().tobytes()
    fwd_out, meta = P.dispatch_chunk_fwd(plan, **kw)
    assert len(fwd_out) == 14 and meta["rounds"] == rounds
    split = P.dispatch_walk(plan, fwd_out, meta).numpy().tobytes()
    assert split == fused
    if layout == "band":
        assert split == _reference_split(seed)


def test_walk_plane_bytes_for_matches_reference(monkeypatch):
    from racon_tpu.ops import device_poa as R
    from racon_tpu.ops.poa import PoaEngine
    for no_band in ("", "1"):
        monkeypatch.setenv(env.NO_BAND, no_band)
        eng, plan, scales, rounds = _chunk_fixture(1)
        reng = PoaEngine(backend="jax")
        rplan = _plan(reng, [w for w in reference_windows(8, 1, WLEN)
                             if w.n_layers >= 2])
        got = P.walk_plane_bytes_for(plan, ins_scale=scales, rounds=rounds)
        assert got > 0
        assert got == R.walk_plane_bytes_for(rplan, ins_scale=scales,
                                             rounds=rounds)


# ------------------------------------------------- the executor's gate


def _port_stream(n, seed, chunk=8):
    from racon_tpu_torch.ops.poa import PoaEngine
    ws = port_windows(n, seed)
    ranges = list(stream_consensus(PoaEngine(device="cpu"), ws, chunk=chunk,
                                   depth=2))
    assert [i for s, e in ranges for i in range(s, e)] == list(range(n))
    return [w.consensus for w in ws], metrics.registry().snapshot()


def _ref_stream(n, seed, chunk=8):
    from racon_tpu.obs import metrics as r_metrics
    from racon_tpu.ops.poa import PoaEngine
    from racon_tpu.pipeline.streaming import stream_consensus as rsc
    ws = reference_windows(n, seed)
    r_metrics.reset()
    list(rsc(PoaEngine(backend="jax"), ws, chunk=chunk, depth=2))
    return [w.consensus for w in ws], r_metrics.registry().snapshot()


_WALK_KEYS = ("walk_async_enabled", "walk_dispatches", "walk_fused_chunks")


def _walk_counts(snap):
    return {k: snap.get(k, 0) for k in _WALK_KEYS}


def test_stream_walk_async_counts_match_reference(monkeypatch):
    """Fixed rounds, three chunks: the first two walk decoupled, the last
    stays fused, as in the reference; with RACON_TPU_WALK_ASYNC=0 none
    does. The consensus is the serial engine's either way."""
    from racon_tpu_torch.ops.poa import PoaEngine
    monkeypatch.setenv(env.SCHED, "0")
    serial = port_windows(24, 3)
    PoaEngine(device="cpu").consensus_windows(serial)
    want = [w.consensus for w in serial]
    for walk in ("1", "0"):
        monkeypatch.setenv(env.WALK_ASYNC, walk)
        monkeypatch.setattr(P, "_CAP_HISTORY", set())
        monkeypatch.setattr(P, "_BAND_HISTORY", set())
        metrics.reset()
        out, snap = _port_stream(24, 3)
        ref, rsnap = _ref_stream(24, 3)
        assert out == want == ref, walk
        assert _walk_counts(snap) == _walk_counts(rsnap), walk
        if walk == "1":
            assert snap["walk_dispatches"] == 2
            assert snap["walk_fused_chunks"] == 1
            assert snap["walk_seconds"] > 0
            assert snap["walk_queue_peak"] >= 1
        else:
            assert snap["walk_dispatches"] == 0
            assert snap["walk_async_enabled"] == 0


def test_single_chunk_stream_falls_back_fused(monkeypatch):
    monkeypatch.setenv(env.SCHED, "0")
    out, snap = _port_stream(8, 13, chunk=32)
    ref, rsnap = _ref_stream(8, 13, chunk=32)
    assert out == ref
    assert _walk_counts(snap) == _walk_counts(rsnap) == {
        "walk_async_enabled": 1, "walk_dispatches": 0,
        "walk_fused_chunks": 1}


def test_walk_queue_zero_disables_decoupling(monkeypatch):
    monkeypatch.setenv(env.SCHED, "0")
    monkeypatch.setenv(env.WALK_QUEUE, "0")
    _out, snap = _port_stream(24, 3)
    assert snap["walk_dispatches"] == 0
    assert snap["walk_async_enabled"] == 0
    assert snap["walk_fused_chunks"] == 3


def test_scheduler_keeps_fused_dispatches(monkeypatch):
    monkeypatch.setenv(env.SCHED, "1")
    monkeypatch.setenv(env.WALK_ASYNC, "1")
    _out, snap = _port_stream(16, 9)
    assert snap["walk_dispatches"] == 0
    assert snap["walk_async_enabled"] == 0


# -------------------------------------------------------- the budget


def test_walk_queue_budget_on_the_card_and_on_the_cpu():
    """Phase 4's chunk at its final round (B = 4096, Lq = 640, band
    round_band_width(256, 3) = 192, k = 4): 2.01 GB of planes. The
    reference's one-buffer budget admits none; an 80 GB card's admits the
    three that a depth-2 queue needs (two parked, one being walked)."""
    from racon_tpu.ops import budget as RB
    W = P.round_band_width(256, 3)
    assert W == 192
    pb = PB.walk_plane_bytes(4096, 640, W, 4)
    assert pb == RB.walk_plane_bytes(4096, 640, W, 4) == 2013265920
    want = 2 + 1
    assert PB.WALK_QUEUE_BYTES == RB.WALK_QUEUE_BYTES
    assert PB.walk_queue_bytes("cpu") == RB.WALK_QUEUE_BYTES
    assert PB.walk_queue_depth(pb, want) == RB.walk_queue_depth(pb, want) == 0
    for total in (80 * 10 ** 9, 80 * 2 ** 30):
        cap = PB.walk_queue_bytes("cuda", total)
        assert cap == int(PB.GROUP_MEM_FRACTION * total)
        assert PB.walk_queue_depth(pb, want, cap) == want
    # A 16 GB card holds two plane sets at most: depth 2 is refused.
    assert PB.walk_queue_depth(pb, want, PB.walk_queue_bytes(
        "cuda", 16 * 10 ** 9)) == 1
    # k and padding as in the reference's count.
    for k in (1, 2, 4):
        assert PB.walk_plane_bytes(128, 256, 384, k) == \
            RB.walk_plane_bytes(128, 256, 384, k)
    assert PB.walk_queue_depth(0, 3) == 3 and PB.walk_queue_depth(5, 0) == 0


@pytest.mark.parametrize("raw,want", [("", 2), ("0", 0), ("5", 5),
                                      ("x", None), ("-1", None)])
def test_walk_queue_env_matches_reference(monkeypatch, raw, want):
    from racon_tpu.ops import budget as RB
    monkeypatch.setenv(env.WALK_QUEUE, raw)
    if want is None:
        with pytest.raises(ValueError, match="RACON_TPU_WALK_QUEUE"):
            PB.walk_queue_env(2)
        with pytest.raises(ValueError):
            RB.walk_queue_env(2)
    else:
        assert PB.walk_queue_env(2) == RB.walk_queue_env(2) == want
