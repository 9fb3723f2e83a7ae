"""The port's convergence scheduler (racon_tpu_torch/sched/) against the
JAX package's (racon_tpu/sched/, run under JAX_PLATFORMS=cpu), at small
sizes with one torch thread.

- RepackPlan and SchedTelemetry: the reference's own cases
  (tests/test_sched.py), on both classes side by side;
- the env gates (RACON_TPU_SCHED, RACON_TPU_ADAPTIVE, RACON_TPU_REDO) and
  which chunk loop and redo each selects;
- the scale-schedule check;
- the plain sched_rounds (M2's sched mode through its plain version)
  against the reference's sched_rounds on the same unpacked chunk:
  detect on and off, ``last`` False and True, the adaptive tail — the
  accumulators, flags and state bitwise;
- the three control-flow paths of the chunk loop (fused tail, repack,
  full early exit) on the port's engine: byte-identical to the port's
  fixed-round engine and to the reference's scheduler, with the
  reference's telemetry;
- the SCHED x ADAPTIVE matrix through ``python -m racon_tpu_torch.cli
  --device cpu`` against the reference CLI at its defaults.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from racon_tpu.models.window import Window as RWindow
from racon_tpu.models.window import WindowType as RWindowType
from racon_tpu.ops import device_poa as R
from racon_tpu_torch.models.window import Window as PWindow
from racon_tpu_torch.models.window import WindowType as PWindowType
from racon_tpu_torch.ops import device_poa as P
from racon_tpu_torch.utils import env

from merge_model import (SCHED_BATCHES, growing_window, sched_noisy_windows,
                         sched_stable_windows)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALES = (0.2, 0.2, 0.2, 0.6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_histories(monkeypatch):
    """Both engines pick caps and band widths from per-process histories;
    start both empty so that they pack the same chunks."""
    for mod in (R, P):
        monkeypatch.setattr(mod, "_CAP_HISTORY", set())
        monkeypatch.setattr(mod, "_BAND_HISTORY", set())
    for name in (env.SCHED, env.ADAPTIVE, env.REDO, env.NO_BAND):
        monkeypatch.delenv(name, raising=False)


# --------------------------------------------------------------- RepackPlan


def _toy_plans(n_shards=1):
    """The reference test's toy: 8 current rows (6 real + 2 padded), dummy
    row id 8, trash row 100; survivors rows 0, 2, 3, 6."""
    from racon_tpu.sched import RepackPlan as RPlan
    from racon_tpu_torch.sched import RepackPlan as PPlan
    surv = np.array([1, 0, 1, 1, 0, 0, 1, 0], bool)
    win = np.array([0, 0, 1, 2, 2, 3, 4, 5, 6, 8, 8, 8], np.int32)
    orig_ids = np.array([10, 11, 12, 13, 14, 15, 16, 17], np.int32)
    return surv, win, orig_ids, [
        cls(surv, win, orig_ids, trash=100, n_shards=n_shards)
        for cls in (RPlan, PPlan)]


_PLAN_FIELDS = ("n_surv", "n_win", "B", "n_lanes", "win_map", "win_real",
                "orig_ids", "lane_idx", "new_win")


@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_repack_plan_matches_reference(n_shards):
    _, _, _, (ref, port) = _toy_plans(n_shards)
    for f in _PLAN_FIELDS:
        a, b = getattr(ref, f), getattr(port, f)
        assert np.array_equal(a, b) and np.asarray(a).dtype == \
            np.asarray(b).dtype, f
    assert port.n_surv == 4 and port.n_win == 32
    assert port.B % (128 * n_shards) == 0 and port.B >= port.n_lanes


def test_repack_plan_padding_and_lane_round_trip():
    surv, win, orig_ids, (_, plan) = _toy_plans()
    assert plan.win_map[:plan.n_surv].tolist() == [0, 2, 3, 6]
    assert plan.orig_ids[:plan.n_surv].tolist() == [10, 12, 13, 16]
    assert (plan.win_map[plan.n_surv:] == surv.shape[0]).all()
    assert not plan.win_real[plan.n_surv:].any()
    assert (plan.orig_ids[plan.n_surv:] == 100).all()
    assert (plan.lane_idx[plan.n_lanes:] == 0).all()
    assert (plan.new_win[plan.n_lanes:] == plan.n_win).all()
    assert plan.lane_idx[:plan.n_lanes].tolist() == [0, 1, 3, 4, 5, 8]
    for i in range(plan.n_lanes):
        assert orig_ids[win[plan.lane_idx[i]]] == \
            plan.orig_ids[plan.new_win[i]]


# ------------------------------------------------------------ telemetry


def _feed(t):
    t.record_chunk(10)
    for r in range(2):
        t.record_round(r, 10)
    t.record_freeze(2, 6)
    t.record_round(2, 4)
    t.record_round(3, 4)
    t.record_freeze(4, 4)
    t.record_repack(0.25)
    t.record_skip(0)
    return t


def test_telemetry_matches_reference():
    from racon_tpu.sched import SchedTelemetry as RTel
    from racon_tpu_torch.sched import SchedTelemetry as PTel
    ref, port = _feed(RTel(4)), _feed(PTel(4))
    assert port.hist == ref.hist == {2: 6, 4: 4}
    assert port.survivor_frac() == ref.survivor_frac() == [1.0, 1.0, 0.4,
                                                           0.4]
    assert port.rounds_saved_frac() == pytest.approx(1 - 28 / 40)
    assert port.as_extras() == ref.as_extras()
    assert port.summary() == ref.summary()
    assert "windows=10" in port.summary()
    empty = PTel(4)
    assert empty.survivor_frac() == [0.0] * 4
    assert empty.rounds_saved_frac() == 0.0


# ------------------------------------------------------------ env gates


@pytest.mark.parametrize("name,fn", [
    (env.SCHED, env.sched_enabled), (env.ADAPTIVE, env.adaptive_enabled),
    (env.REDO, env.redo_enabled)])
def test_env_gates(monkeypatch, name, fn):
    monkeypatch.delenv(name, raising=False)
    assert fn()
    for off in ("0", "false"):
        monkeypatch.setenv(name, off)
        assert not fn()
    for on in ("1", ""):
        monkeypatch.setenv(name, on)
        assert fn()


def test_adaptive_gate_in_chunk_statics(monkeypatch):
    plan = P.ChunkPlan(sched_stable_windows(5, 2, 120))
    assert P.chunk_statics(plan, ins_scale=SCALES, rounds=4)["adaptive"]
    assert not P.chunk_statics(plan, ins_scale=(0.1, 0.2, 0.2, 0.6),
                               rounds=4)["adaptive"]
    assert not P.chunk_statics(plan, ins_scale=0.2, rounds=2)["adaptive"]
    monkeypatch.setenv(env.ADAPTIVE, "0")
    assert not P.chunk_statics(plan, ins_scale=SCALES, rounds=4)["adaptive"]


def test_scheduler_rejects_varying_scales():
    from racon_tpu_torch.sched import ConvergenceScheduler
    with pytest.raises(ValueError, match="uniform"):
        ConvergenceScheduler(match=5, mismatch=-4, gap=-8,
                             scales=(0.1, 0.2, 0.6), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        ConvergenceScheduler(match=5, mismatch=-4, gap=-8, scales=(),
                             device="cpu")
    s = ConvergenceScheduler(match=5, mismatch=-4, gap=-8,
                             scales=(0.2, 0.2, 0.2, 0.6), device="cpu")
    assert s.rounds == 4 and s.scale == 0.2 and s.scale_final == 0.6


def _telemetry_holds(name, t):
    assert sum(t.hist.values()) == t.windows
    if name == "fused_tail":
        assert t.windows == 10 and t.hist == {4: 10}
        assert t.dispatches_saved == 0
    elif name == "repack":
        assert t.windows == 36 and t.hist.get(2, 0) >= 28
        assert t.rounds_saved_frac() > 0.3
    else:
        assert t.hist == {2: 8} and t.dispatches_saved == 2
        assert t.rounds_saved_frac() == pytest.approx(0.5)


def _port_polish(name, monkeypatch, sched):
    from racon_tpu_torch.ops.poa import PoaEngine
    monkeypatch.setenv(env.SCHED, "1" if sched else "0")
    monkeypatch.setattr(P, "_CAP_HISTORY", set())
    monkeypatch.setattr(P, "_BAND_HISTORY", set())
    ws = SCHED_BATCHES[name](PWindow, PWindowType)
    eng = PoaEngine(device="cpu")
    eng.consensus_windows(ws)
    return [w.consensus for w in ws], eng


@pytest.mark.parametrize("name", sorted(SCHED_BATCHES))
def test_control_paths_match_fixed_and_reference(monkeypatch, name):
    from racon_tpu.ops.poa import PoaEngine as RPoaEngine
    monkeypatch.setenv(env.SCHED, "1")
    ws = SCHED_BATCHES[name](RWindow, RWindowType)
    reng = RPoaEngine(backend="jax")
    reng.consensus_windows(ws)
    ref = [w.consensus for w in ws]
    _telemetry_holds(name, reng.sched_telemetry)

    fixed, feng = _port_polish(name, monkeypatch, False)
    assert feng.sched_telemetry is None
    out, eng = _port_polish(name, monkeypatch, True)
    assert out == fixed == ref
    t = eng.sched_telemetry
    _telemetry_holds(name, t)
    assert t.hist == reng.sched_telemetry.hist
    assert t.survivor_frac() == reng.sched_telemetry.survivor_frac()
    assert t.dispatches_saved == reng.sched_telemetry.dispatches_saved


# ------------------------------------------------------------ sched_rounds


def _unpacked_pair():
    """A chunk of converging, noisy and flagged windows, unpacked by both
    packages' sched_unpack from the same buffers."""
    import jax.numpy as jnp
    from racon_tpu.sched.rounds import sched_unpack as r_unpack
    from racon_tpu_torch.sched.rounds import sched_unpack as p_unpack
    rw = dict(W=RWindow, WT=RWindowType)
    ws = (sched_stable_windows(51, 5, 150, **rw) +
          sched_noisy_windows(52, 4, 150, 8, **rw) +
          [growing_window(53, **rw)])
    plan = R.ChunkPlan(ws)
    job, winb = plan.packed_bufs()
    dims = dict(Lq=plan.Lq, LA=plan.LA, n_win=plan.n_win)
    ref = r_unpack(jnp.asarray(job), jnp.asarray(winb), **dims)
    port = p_unpack(*P.load_packed(job, winb, (plan.B, plan.Lq, plan.n_win,
                                               plan.LA), "cpu"), **dims)
    return plan, list(ref), list(port)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bitwise(ref, port, what):
    a, b = _np(ref), _np(port)
    assert a.shape == b.shape, what
    if a.dtype.kind == "f":
        a = a.view(np.uint32)
        b = b.astype(np.float32).view(np.uint32)
    assert np.array_equal(a, b.astype(a.dtype)), what


def test_plain_sched_rounds_match_reference():
    """The port's sched_rounds (plain versions on the CPU) against the
    reference's, one step after another on one chunk: rounds 0-1 with
    detection, one detecting round, one round with detection off, the
    adaptive fused tail with ``last``, and a last detecting round."""
    import jax.numpy as jnp
    from racon_tpu.sched.rounds import sched_rounds as r_rounds
    from racon_tpu_torch.sched.rounds import sched_rounds as p_rounds
    plan, ref, port = _unpacked_pair()
    band_w = plan.band_w
    b0, b1 = R.round_band_width(band_w, 0), R.round_band_width(band_w, 1)
    orig = np.arange(plan.n_win, dtype=np.int32)
    rstate, rout = ref[:11], ref[11:]
    pstate, pout, mem = port[:11], port[11], port[12]
    statics = dict(match=5, mismatch=-4, gap=-8, scale=0.2, scale_final=0.6,
                   Lq=plan.Lq, n_win=plan.n_win, LA=plan.LA, nxt_k=2)
    steps = [((b0, b1), True, False, False), ((b1,), True, False, False),
             ((b1,), False, False, False), ((b1, b1, b1), False, True, True),
             ((b1,), True, True, False)]
    saw_conv = saw_ovf = False
    for band_ws, detect, last, adaptive in steps:
        got = r_rounds(*rstate, *rout, jnp.asarray(orig), jnp.asarray(last),
                       pallas=False, band_ws=band_ws, detect=detect,
                       adaptive=adaptive, **statics)
        (bb, bbw, alen, begin, end, ovf, conv, oc, ocv, ot, oo, ran) = got
        res = p_rounds(*pstate, pout, torch.from_numpy(orig), last, mem,
                       band_ws=band_ws, detect=detect, adaptive=adaptive,
                       **statics)
        (pbb, pbbw, palen, pbegin, pend, povf, pconv, pout, pran) = res
        what = f"step {band_ws} detect={detect} last={last}"
        for n, a, b in (("bb", bb, pbb), ("bbw", bbw, pbbw),
                        ("alen", alen, palen), ("begin", begin, pbegin),
                        ("end", end, pend), ("ovf", ovf, povf),
                        ("conv", conv, pconv)):
            _bitwise(a, b, f"{what}: {n}")
        # The reference's trash row takes the last of several writes; the
        # port writes none there.
        for n, a, b in zip(("codes", "cov", "total", "ovf"),
                           (oc, ocv, ot, oo), pout):
            _bitwise(_np(a)[:-1], b[:-1], f"{what}: out {n}")
        assert int(ran) == pran, what
        saw_conv |= bool(_np(conv).any())
        saw_ovf |= bool(_np(ovf).any())
        rstate = [bb, bbw, alen, begin, end] + rstate[5:10] + [ovf]
        rout = [oc, ocv, ot, oo]
        pstate = [pbb, pbbw, palen, pbegin, pend] + pstate[5:10] + [povf]
    assert saw_conv and saw_ovf
    # Every real window froze by the end and holds an output row.
    assert (pout[2][:plan.n_real_win] >= 1).all()


def test_merge_windows_sched_plain_skips_trash_and_unfrozen():
    """M2's sched mode (plain) writes only freezing windows' rows, never
    the trash row, and leaves the base-mode outputs as merge_windows'."""
    from racon_tpu_torch.ops import device_merge as dm
    plan, _, port = _unpacked_pair()
    (bb, bbw, alen, begin, end, q, qw8, lq, w_read, win, ovf, out,
     mem) = port
    fwd = P._lane_fwd(bb, alen, begin, end, q, lq, win, match=5,
                      mismatch=-4, gap=-8, Lq=plan.Lq, LA=plan.LA,
                      band_w=plan.band_w, nxt_k=2)
    cols, esc_w = P._lane_walk(*fwd, lq, LA=plan.LA, band_w=plan.band_w)
    votes, wesc = dm.merge_votes_plain(cols, q, qw8, w_read, fwd[3], fwd[4],
                                       esc_w, win, n_win=plan.n_win,
                                       LA=plan.LA)
    args = (votes, wesc, bb, bbw, alen, begin, end, win, ovf)
    kw = dict(ins_scale=0.2, n_win=plan.n_win, LA=plan.LA, detect=True)
    base = dm.merge_windows_plain(*args, **kw)
    # Every other window points at the trash row.
    orig = torch.arange(plan.n_win, dtype=torch.int32)
    orig[1::2] = plan.n_win
    acc = tuple(t.clone() for t in out)
    got = dm.merge_windows_sched_plain(*args, orig, acc, scale_final=0.6,
                                       last=True, **kw)
    for a, b in zip(base, got):
        assert torch.equal(a, b)
    for fresh, now in zip(out, acc):
        assert torch.equal(fresh[1::2], now[1::2])       # trash rows, odd
    assert (acc[2][0:plan.n_win:2] >= 1).all()
    assert not torch.equal(acc[0][0], out[0][0])
    # Not last: only converged or flagged windows write (round 0 detects
    # nothing here, so only the flagged ones).
    acc2 = tuple(t.clone() for t in out)
    res = dm.merge_windows_sched_plain(*args, torch.arange(
        plan.n_win, dtype=torch.int32), acc2, scale_final=0.6, last=False,
        **kw)
    froze = res[6] | res[7]
    for fresh, now in zip(out, acc2):
        keep = ~torch.cat([froze, torch.zeros(1, dtype=torch.bool)])
        assert torch.equal(fresh[keep], now[keep])


# ------------------------------------------------------------ redo gate


def test_redo_gate_sends_flagged_windows_to_host(monkeypatch):
    from racon_tpu_torch.ops import redo
    from racon_tpu_torch.ops.poa import PoaEngine
    calls = []
    real = redo.device_redo

    def spy(*a, **k):
        calls.append(len(a[0]))
        return real(*a, **k)

    monkeypatch.setattr(redo, "device_redo", spy)
    out = {}
    for gate in ("1", "0"):
        monkeypatch.setenv(env.REDO, gate)
        monkeypatch.setattr(P, "_CAP_HISTORY", set())
        monkeypatch.setattr(P, "_BAND_HISTORY", set())
        w = growing_window(53)
        eng = PoaEngine(device="cpu")
        eng.stats = {}
        eng.consensus_windows([w] + sched_stable_windows(54, 2, 150))
        out[gate] = (w.consensus, dict(eng.stats))
    assert calls == [1]
    assert out["1"][1].get("redo_device_windows", 0) + \
        out["1"][1].get("redo_host_windows", 0) == 1
    assert "redo_device_windows" not in out["0"][1]
    assert out["0"][1]["redo_host_windows"] == 1


# ------------------------------------------------------------ chunk loops


def test_default_chunk_loop_is_the_scheduler(monkeypatch):
    """No env: _consensus_device runs ConvergenceScheduler.run_chunk (with
    the next chunk's h2d started first); RACON_TPU_SCHED=0: the fixed
    engine, dispatching up to three chunks before collecting the first."""
    from racon_tpu_torch.ops import poa
    from racon_tpu_torch.sched import scheduler
    events = []
    real_run = scheduler.ConvergenceScheduler.run_chunk
    real_put = scheduler.ConvergenceScheduler.put_chunk
    real_disp, real_coll = P.dispatch_chunk, P.collect_chunk

    def run(self, plan, **k):
        events.append(("run", plan.n_real_win))
        return real_run(self, plan, **k)

    def put(self, plan):
        events.append(("put", plan.n_real_win))
        return real_put(self, plan)

    def disp(plan, **k):
        events.append(("dispatch", plan.n_real_win))
        return real_disp(plan, **k)

    def coll(plan, packed, **k):
        events.append(("collect", plan.n_real_win))
        return real_coll(plan, packed, **k)

    monkeypatch.setattr(scheduler.ConvergenceScheduler, "run_chunk", run)
    monkeypatch.setattr(scheduler.ConvergenceScheduler, "put_chunk", put)
    monkeypatch.setattr(P, "dispatch_chunk", disp)
    monkeypatch.setattr(P, "collect_chunk", coll)
    groups = [sched_stable_windows(60 + i, 2, 120) for i in range(4)]

    def drive(sched):
        events.clear()
        monkeypatch.setenv(env.SCHED, sched)
        eng = poa.PoaEngine(device="cpu")
        monkeypatch.setattr(eng, "_plan_device_slice", lambda a, b, c: _Slice(
            groups))
        eng._consensus_device([w for g in groups for w in g], 120, 120)
        return [e[0] for e in events if e[0] != "collect" or sched == "0"]

    got = drive("")
    assert got[:3] == ["put", "put", "run"]
    assert got.count("run") == 4 and "dispatch" not in got
    got = drive("0")
    assert got == ["dispatch"] * 3 + ["collect", "dispatch"] + \
        ["collect"] * 3


class _Slice:
    """A _DeviceSlicePlan of given chunk groups (no host windows)."""

    def __init__(self, groups):
        self.groups, self.host = groups, []
        self.lq_cap = self.la_cap = self.band_cap = None
        self.overflow_msg = None


# ------------------------------------------------------------ CLI matrix


def _cli_env(sched=None, adaptive=None):
    e = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
             MKL_NUM_THREADS="1")
    for name, v in ((env.SCHED, sched), (env.ADAPTIVE, adaptive)):
        e.pop(name, None)
        if v is not None:
            e[name] = v
    e["PYTHONPATH"] = ROOT + os.pathsep + e.get("PYTHONPATH", "")
    return e


def test_cli_sched_adaptive_matrix_matches_reference(tmp_path):
    """The port's CLI under each of SCHED x ADAPTIVE against the reference
    CLI at its defaults (scheduler and adaptive exit on), on partial
    reads with PAF overlaps; all five run at once, one thread each."""
    from racon_tpu_torch.utils.synth import write_dataset
    ds = write_dataset(str(tmp_path), seed=21, contig_len=3000,
                       read_len=1500, coverage=20)
    p = ds["paths"]
    args = [p["reads"], p["overlaps"], p["draft"]]
    procs = {"ref": subprocess.Popen(
        [sys.executable, "-m", "racon_tpu.cli", "--backend", "jax", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=_cli_env(),
        cwd=str(tmp_path))}
    for sched in ("1", "0"):
        for adaptive in ("1", "0"):
            procs[(sched, adaptive)] = subprocess.Popen(
                [sys.executable, "-m", "racon_tpu_torch.cli", "--device",
                 "cpu", *args], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, env=_cli_env(sched, adaptive),
                cwd=str(tmp_path))
    outs = {}
    for k, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (k, err.decode()[-2000:])
        outs[k] = (out, err.decode())
    ref = outs.pop("ref")[0]
    assert ref.startswith(b">ctg0 ") and len(ref) > 2000
    for k, (out, err) in outs.items():
        assert out == ref, k
        # The scheduler's summary line on stderr, under the scheduler
        # only.
        assert ("scheduler windows=" in err) == (k[0] == "1"), k
