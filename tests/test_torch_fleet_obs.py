"""The port's fleet observability plane and the CLI's signal teardown
against the JAX package's: worker metric shards (history, cadence, torn
flush), the fleet aggregate (merge kinds, timeline, lineage, stragglers,
the supervisor's fold), the OpenMetrics fleet render and the pull
endpoint, the trace-context handoff and the per-job timeline — each held
byte for byte against the reference on the same files — and SIGTERM in
the middle of a run: the port's CLI exits 143 with the reference's
stdout and store, each package's store resumes under the other's CLI,
and a ledger worker's teardown leaves a final metric snapshot.

Inputs: tests/serve_inputs.py (tiny drafts and reads from a seed)."""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import pytest

from racon_tpu.obs import export as RX
from racon_tpu.obs import fleet as RFLEET
from racon_tpu.obs import metrics as RM
from racon_tpu.obs import trace as RT
from racon_tpu.resilience import faults as RF
from racon_tpu_torch.obs import export as obs_export
from racon_tpu_torch.obs import fleet as obs_fleet
from racon_tpu_torch.obs import metrics as obs_metrics
from racon_tpu_torch.obs import trace as PT
from racon_tpu_torch.resilience import faults

from serve_inputs import (ROOT, _capture, port_cli, subprocess_env,
                          write_inputs)


@pytest.fixture(autouse=True)
def fleet_clean(monkeypatch):
    for env in (faults.ENV_FAULTS, obs_fleet.ENV_OBS_DIR,
                obs_fleet.ENV_FLUSH_S, obs_fleet.ENV_STRAGGLER_FRAC,
                obs_export.ENV_METRICS_PORT, PT.ENV_TRACE_CTX,
                "RACON_TPU_TRACE", "RACON_TPU_DIST_SHARDS",
                "RACON_TPU_PIPELINE"):
        monkeypatch.delenv(env, raising=False)
    for mod in (faults, RF):
        mod.configure(None)
    for mod in (obs_metrics, RM):
        mod.reset()
    obs_fleet._WRITER = RFLEET._WRITER = None
    yield
    for mod in (faults, RF):
        mod.configure(None)
    obs_metrics.reset()
    obs_fleet._WRITER = RFLEET._WRITER = None


class _Died(BaseException):
    """Stand-in for os._exit in in-process crash drills."""


@pytest.fixture
def soft_crash(monkeypatch):
    monkeypatch.setattr(obs_fleet, "hard_exit",
                        lambda code: (_ for _ in ()).throw(_Died(code)))
    return _Died


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Three contigs and the port's serial stdout on them."""
    paths = write_inputs(str(tmp_path_factory.mktemp("in")), n_contigs=3)
    rc, out, err = port_cli(paths)
    assert rc == 0, err
    return paths, out


def _writer(d, wid="w0", fp="fp1", interval=0.0):
    reg = obs_metrics.Registry()
    w = obs_fleet.WorkerMetricsWriter(str(d), wid, fp, reg=reg,
                                      interval_s=interval)
    return w, reg


# --------------------------------------------------------- writer shards

def test_writer_publishes_snapshot_history(tmp_path):
    w, reg = _writer(tmp_path)
    reg.inc("dist_claims")
    w.flush()
    reg.inc("dist_claims")
    w.flush(final=True)
    recs = [json.loads(ln) for ln in
            open(w.path, "rb").read().splitlines()]
    assert [r["seq"] for r in recs] == [0, 1]
    assert [r["final"] for r in recs] == [False, True]
    assert recs[0]["metrics"]["dist_claims"] == 1
    assert recs[1]["metrics"]["dist_claims"] == 2
    assert all(r["worker_id"] == "w0" and r["run_fp"] == "fp1"
               for r in recs)
    w.flush()
    assert len(open(w.path, "rb").read().splitlines()) == 2


def test_writer_records_match_reference(tmp_path, monkeypatch):
    """The same registry snapshots through both packages' writers, on a
    patched clock: the same shard file, byte for byte."""
    import time
    clock = {}

    def fake(name):
        def tick():
            clock[name] += 0.25
            return clock[name]
        return tick

    monkeypatch.setattr(time, "time", fake("wall"))
    monkeypatch.setattr(time, "perf_counter", fake("perf"))
    for sub, fleet_mod, reg in (
            ("port", obs_fleet, obs_metrics.Registry()),
            ("ref", RFLEET, RM.MetricsRegistry())):
        clock.update(wall=1.7e9, perf=100.0)
        w = fleet_mod.WorkerMetricsWriter(str(tmp_path / sub), "w/1",
                                          "fp1", reg=reg, interval_s=0.0)
        reg.inc("dist_claims", 2)
        reg.set("dist_workers", 2)
        reg.inc("phase_seconds_total", 1.5)
        assert w.maybe_flush()
        reg.max("pipe_q_depth_peak", 7)
        w.flush(final=True)
    assert (tmp_path / "port" / "worker_w_1.metrics.jsonl").read_bytes() \
        == (tmp_path / "ref" / "worker_w_1.metrics.jsonl").read_bytes()


def test_maybe_flush_honors_interval(tmp_path):
    w, _ = _writer(tmp_path, interval=3600.0)
    assert w.maybe_flush()
    assert not w.maybe_flush()
    w.interval_s = 0.0
    assert w.maybe_flush()


def test_shard_path_sanitizes_worker_id(tmp_path):
    p = obs_fleet.shard_path(str(tmp_path), "w/0:evil id")
    assert os.path.dirname(p) == str(tmp_path)
    assert os.path.basename(p) == "worker_w_0_evil_id.metrics.jsonl"
    for wid in ("a" * 100, "", "ok-1.2_x"):
        assert obs_fleet.shard_path("d", wid) == RFLEET.shard_path("d", wid)


def test_install_writer_flushes_eagerly(tmp_path):
    obs_fleet.install_writer(str(tmp_path), "w0", "fp1",
                             reg=obs_metrics.Registry(), interval_s=0.0)
    assert len(obs_fleet.load_worker_shards(str(tmp_path))) == 1
    obs_fleet.flush_final()
    shards = obs_fleet.load_worker_shards(str(tmp_path))
    assert shards[0]["records"][-1]["final"]
    # flush_final also dumps the flight recorder beside the shards.
    assert any(n.startswith("flight_") for n in os.listdir(tmp_path))


def test_torn_snapshot_recovers_prefix(tmp_path, soft_crash):
    faults.configure("obs/snapshot:2!torn")
    w, reg = _writer(tmp_path)
    reg.inc("dist_claims")
    w.flush()
    reg.inc("dist_claims")
    w.flush()
    reg.inc("dist_claims")
    with pytest.raises(soft_crash):
        w.flush()
    faults.configure(None)
    shards = obs_fleet.load_worker_shards(str(tmp_path))
    assert len(shards) == 1 and not shards[0]["clean"]
    recs = shards[0]["records"]
    assert [r["seq"] for r in recs] == [0, 1]
    assert recs[-1]["metrics"]["dist_claims"] == 2
    model = obs_fleet.aggregate(str(tmp_path))
    assert model["fleet"]["dist_claims"] == 2
    assert not model["workers"]["w0"]["clean"]
    assert RFLEET.load_worker_shards(str(tmp_path)) == shards


# ----------------------------------------------------------- aggregation

def _two_worker_dir(tmp_path):
    wa, ra = _writer(tmp_path, "A", "fp1")
    ra.inc("dist_claims", 2)
    ra.inc("poa_windows_total", 30)
    ra.max("pipe_q_depth_peak", 3)
    ra.set("sched_windows", 10)
    ra.inc("phase_seconds_polish", 1.5)
    ra.inc("phase_seconds_total", 1.5)
    wa.flush(final=True)
    wb, rb = _writer(tmp_path, "B", "fp1")
    rb.inc("dist_claims", 3)
    rb.inc("poa_windows_total", 50)
    rb.max("pipe_q_depth_peak", 7)
    rb.set("sched_windows", 25)
    rb.inc("phase_seconds_polish", 2.5)
    rb.inc("phase_seconds_total", 2.5)
    wb.flush(final=True)
    return tmp_path


def test_aggregate_merges_by_kind(tmp_path):
    model = obs_fleet.aggregate(str(_two_worker_dir(tmp_path)))
    assert model["run_fp"] == "fp1" and model["n_workers"] == 2
    fleet = model["fleet"]
    assert fleet["dist_claims"] == 5
    assert fleet["poa_windows_total"] == 80
    assert fleet["pipe_q_depth_peak"] == 7
    assert fleet["sched_windows"] == 25
    assert fleet["phase_seconds_total"] == 4.0
    for wid, windows in (("A", 30), ("B", 50)):
        wrk = model["workers"][wid]
        assert wrk["final"] and wrk["clean"]
        assert wrk["phase_seconds"] == {"polish": pytest.approx(
            1.5 if wid == "A" else 2.5)}
        if wrk["wall_s"] > 0:
            assert wrk["windows_per_sec"] == pytest.approx(
                windows / wrk["wall_s"], abs=1e-3)
    assert model == RFLEET.aggregate(str(tmp_path))


def test_aggregate_prefers_obs_subdir(tmp_path):
    sub = tmp_path / obs_fleet.OBS_SUBDIR
    sub.mkdir()
    w, reg = _writer(sub, "A", "fp1")
    reg.inc("dist_claims")
    w.flush(final=True)
    assert obs_fleet.aggregate(str(tmp_path))["n_workers"] == 1
    assert obs_fleet.aggregate(str(sub))["n_workers"] == 1


def test_aggregate_refuses_mixed_run_fp(tmp_path):
    wa, _ = _writer(tmp_path, "A", "fp1")
    wa.flush()
    wb, _ = _writer(tmp_path, "B", "fp2")
    wb.flush()
    with pytest.raises(obs_fleet.FleetObsError, match="different runs"):
        obs_fleet.aggregate(str(tmp_path))


def test_aggregate_empty_dir_raises(tmp_path):
    with pytest.raises(obs_fleet.FleetObsError, match="no worker"):
        obs_fleet.aggregate(str(tmp_path))


def test_timeline_compresses_renew_runs(tmp_path):
    w, _ = _writer(tmp_path, "A", "fp1")
    w.flush(final=True)
    events = [
        {"ev": "claim", "name": "shard_000", "worker": "A", "t": 1.0},
        {"ev": "renew", "name": "shard_000", "worker": "A", "t": 2.0},
        {"ev": "renew", "name": "shard_000", "worker": "A", "t": 3.0},
        {"ev": "renew", "name": "shard_000", "worker": "A", "t": 4.0},
        {"ev": "steal", "name": "shard_000", "worker": "B",
         "victim": "A", "t": 9.0, "expired_for_s": 4.0},
        {"ev": "renew", "name": "shard_000", "worker": "B", "t": 10.0},
        {"ev": "complete", "name": "shard_000", "worker": "B",
         "t": 11.0},
    ]
    with open(tmp_path / "events.jsonl", "w") as fh:
        for e in events:
            fh.write(json.dumps(e) + "\n")
    model = obs_fleet.aggregate(str(tmp_path))
    lane = model["timeline"]["shard_000"]
    assert [e["ev"] for e in lane] == ["claim", "renew", "steal",
                                       "renew", "complete"]
    assert lane[1]["n"] == 3 and lane[1]["t_last"] == 4.0
    assert lane[3]["n"] == 1
    assert lane[2]["victim"] == "A"
    assert model["steals"] == 1
    assert model == RFLEET.aggregate(str(tmp_path))


@pytest.mark.parametrize("frac", ["", "0.9", "1"])
def test_straggler_flags_match_reference(tmp_path, monkeypatch, frac):
    import time
    monkeypatch.setenv(obs_fleet.ENV_STRAGGLER_FRAC, frac)
    for wid, windows, wall in (("A", 100, 10.0), ("B", 90, 10.0),
                               ("C", 20, 10.0), ("D", 0, 10.0)):
        w, reg = _writer(tmp_path, wid, "fp1")
        reg.inc("poa_windows_total", windows)
        w._t0 = time.perf_counter() - wall
        w.flush(final=True)
    model = obs_fleet.aggregate(str(tmp_path))
    ref = RFLEET.aggregate(str(tmp_path))
    assert model["stragglers"] == ref["stragglers"]
    assert "C" in model["stragglers"] and "D" not in model["stragglers"]
    monkeypatch.setenv(obs_fleet.ENV_STRAGGLER_FRAC, "1.5")
    with pytest.raises(obs_fleet.FleetObsError, match="invalid"):
        obs_fleet.aggregate(str(tmp_path))


# ---------------------------------------------------------- OpenMetrics

def test_render_registry_valid_and_byte_stable():
    snap = {"dist_claims": 3, "pipe_q_depth_peak": 2.0,
            "sched_windows": 7, "poa_windows_total": 12,
            "ovl_device_fraction": 0.75,
            "sched_rounds_hist": {"2": 5},
            "h2d_bytes": 1024}
    text = obs_export.render_registry(snap)
    assert obs_export.validate_openmetrics(text) == []
    assert text == obs_export.render_registry(dict(snap))
    assert text == RX.render_registry(snap)
    assert "racon_tpu_dist_claims_total 3" in text
    assert "racon_tpu_poa_windows_total 12" in text
    assert "racon_tpu_poa_windows_total_total" not in text
    assert "# TYPE racon_tpu_poa_windows counter" in text
    assert "# TYPE racon_tpu_pipe_q_depth_peak gauge" in text
    assert "racon_tpu_pipe_q_depth_peak 2\n" in text
    assert "sched_rounds_hist" not in text
    assert text.endswith("# EOF\n")


def test_render_fleet_series(tmp_path):
    model = obs_fleet.aggregate(str(_two_worker_dir(tmp_path)))
    text = obs_export.render_fleet(model)
    assert obs_export.validate_openmetrics(text) == []
    assert "racon_tpu_fleet_workers 2" in text
    assert 'racon_tpu_worker_windows_per_sec{worker="A"}' in text
    assert 'racon_tpu_worker_final{worker="B"} 1' in text
    assert "racon_tpu_dist_claims_total 5" in text
    assert text == obs_export.render_fleet(
        obs_fleet.aggregate(str(tmp_path)))


def test_validator_catches_structural_breakage():
    assert obs_export.validate_openmetrics("racon_tpu_x 1\n")
    bad = ("# HELP racon_tpu_c help\n# TYPE racon_tpu_c counter\n"
           "racon_tpu_c 1\n# EOF\n")
    assert any("_total" in e for e in obs_export.validate_openmetrics(bad))
    bad = ("# HELP racon_tpu_g help\n# TYPE racon_tpu_g gauge\n"
           "racon_tpu_g nope\n# EOF\n")
    assert any("non-numeric" in e for e in
               obs_export.validate_openmetrics(bad))
    ok = ("# HELP racon_tpu_g help\n# TYPE racon_tpu_g gauge\n"
          "racon_tpu_g 1\n# EOF\n")
    assert obs_export.validate_openmetrics(ok) == []


def test_pull_endpoint_serves_render():
    reg = obs_metrics.Registry()
    reg.inc("dist_claims", 4)
    server = obs_export.serve_metrics(
        0, lambda: obs_export.render_registry(reg.snapshot()))
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            body = resp.read().decode()
            ctype = resp.headers["Content-Type"]
        assert ctype == obs_export.CONTENT_TYPE == RX.CONTENT_TYPE
        assert "racon_tpu_dist_claims_total 4" in body
        assert obs_export.validate_openmetrics(body) == []
    finally:
        server.shutdown()
        server.server_close()


# ----------------------------------------------- registry merge hazards

def test_record_dist_single_lock_under_contention():
    """record_dist's increment runs under the registry's lock: threads
    hammering one counter (the watchdog's and the batcher's threads
    record beside the main one) lose nothing."""
    reg = obs_metrics.Registry()
    n_threads, n_iters = 8, 300

    def hammer():
        for _ in range(n_iters):
            obs_metrics.record_dist("claims", 0, "w", reg=reg)
            obs_metrics.record_dist("steal_latency_s", 0, "w", value=0.5,
                                    reg=reg)

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = reg.snapshot()
    assert snap["dist_claims"] == n_threads * n_iters
    assert snap["dist_steal_latency_s"] == 0.5 * n_threads * n_iters


def test_merge_kind_table():
    mk = obs_metrics.merge_kind
    assert mk("dist_claims") == obs_metrics.MERGE_SUM
    assert mk("poa_windows_total") == obs_metrics.MERGE_SUM
    assert mk("sched_flag_pulls") == obs_metrics.MERGE_SUM
    assert mk("pipe_q_depth_peak") == obs_metrics.MERGE_MAX
    assert mk("sched_windows") == obs_metrics.MERGE_LAST
    assert mk("dist_workers") == obs_metrics.MERGE_LAST
    assert mk("ovl_device_fraction") == obs_metrics.MERGE_LAST
    mv = obs_metrics.merge_values
    assert mv("dist_claims", [2, None, 3]) == 5
    assert mv("pipe_q_depth_peak", [2, 7, 3]) == 7
    assert mv("sched_windows", [10, 25]) == 25
    assert mv("sched_rounds_hist", [{"2": 1}, {"2": 5}]) == {"2": 5}
    assert mv("dist_claims", [None, None]) is None
    hist = {"buckets": [1] * 12, "sum": 0.5, "count": 12}
    for key, vals in (("dist_claims", [1.5, 2]), ("ava_buckets", [3, 1]),
                      ("walk_queue_peak", [1, 9, 4]),
                      ("dispatch_round_s", [hist, hist, None]),
                      ("dist_workers", [True, 2])):
        assert mk(key) == RM.merge_kind(key)
        assert mv(key, vals) == RM.merge_values(key, vals)


def test_autoscale_merge_kinds():
    mk = obs_metrics.merge_kind
    assert mk("dist_scale_up_total") == obs_metrics.MERGE_SUM
    assert mk("dist_scale_down_total") == obs_metrics.MERGE_SUM
    assert mk("dist_splits_total") == obs_metrics.MERGE_SUM
    assert mk("fleet_target_workers") == obs_metrics.MERGE_LAST
    assert obs_metrics.merge_values("fleet_target_workers", [4, 2]) == 2


def test_record_kernel_launches(monkeypatch):
    """A worker's snapshot carries its kernel launches: K1's consensus
    share is its launches less the overlap aligner's untiled groups."""
    from racon_tpu_torch.distributed.worker import record_kernel_launches
    from racon_tpu_torch.ops import kernels, ovl_align
    reg = obs_metrics.Registry()
    record_kernel_launches(reg)
    assert reg.snapshot() == {}       # nothing launched on the CPU
    monkeypatch.setitem(kernels.LAUNCHES, "band_fwd", 70)
    monkeypatch.setitem(kernels.LAUNCHES, "merge_votes", 64)
    monkeypatch.setattr(ovl_align, "UNTILED_GROUPS",
                        [{"groups": 2}, {"groups": 4}])
    record_kernel_launches(reg)
    assert reg.snapshot() == {"kernel_launches_band_fwd": 70,
                              "kernel_launches_merge_votes": 64,
                              "kernel_launches_band_fwd_consensus": 64}


def test_record_kernel_launches_splits_the_walk_by_case(monkeypatch):
    """W1's launches by case: one a tiled or untiled overlap group, one
    a flat-layout forward (K2), the consensus engine's band walks the
    rest; the cases add up to W1's whole count."""
    from racon_tpu_torch.distributed.worker import record_kernel_launches
    from racon_tpu_torch.ops import kernels, ovl_align
    reg = obs_metrics.Registry()
    for name, n in (("band_fwd", 30), ("flat_fwd", 5), ("col_walk", 47)):
        monkeypatch.setitem(kernels.LAUNCHES, name, n)
    monkeypatch.setattr(ovl_align, "TILED_GROUPS",
                        [{"groups": 3}, {"groups": 9}])
    monkeypatch.setattr(ovl_align, "UNTILED_GROUPS", [{"groups": 2}])
    record_kernel_launches(reg)
    snap = reg.snapshot()
    walks = {k: v for k, v in snap.items()
             if k.startswith("kernel_launches_col_walk_")}
    assert walks == {"kernel_launches_col_walk_tiled": 12,
                     "kernel_launches_col_walk_untiled": 2,
                     "kernel_launches_col_walk_flat": 5,
                     "kernel_launches_col_walk_consensus": 28}
    assert sum(walks.values()) == snap["kernel_launches_col_walk"] == 47
    assert snap["kernel_launches_band_fwd_consensus"] == 28


# ------------------------------------------- span context and trace ctx

def test_tracer_set_context_tags_spans(tmp_path):
    path = str(tmp_path / "t.jsonl")
    tr = PT.Tracer(path)
    tr.set_context(worker_id="A", run_fp="fp1")
    with tr.span("phase", "one"):
        pass
    tr.set_context(shard=2)
    with tr.span("phase", "two", shard=5):
        pass
    tr.set_context(shard=None)
    with tr.span("phase", "three"):
        pass
    tr.finish()
    spans = {r["name"]: r for r in
             (json.loads(ln) for ln in open(path))
             if r.get("ev") == "span"}
    assert spans["one"]["worker_id"] == "A"
    assert spans["one"]["run_fp"] == "fp1"
    assert "shard" not in spans["one"]
    assert spans["two"]["shard"] == 5
    assert "shard" not in spans["three"]
    assert spans["three"]["worker_id"] == "A"


@pytest.mark.parametrize("ctx", ["", "abc:7", "abc:x", ":3", " d00d:12 "])
def test_trace_ctx_handoff_matches_reference(tmp_path, monkeypatch, ctx):
    monkeypatch.setenv(PT.ENV_TRACE_CTX, ctx)
    assert PT.ENV_TRACE_CTX == RT.ENV_TRACE_CTX
    assert PT.env_trace_ctx() == RT.env_trace_ctx()
    tr = PT.Tracer(str(tmp_path / "t.jsonl"))
    got = PT.adopt_trace_context(tracer=tr)
    want = RT.adopt_trace_context(tracer=RT.Tracer(str(tmp_path / "r")))
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.trace_id, got.parent_id) == \
            (want.trace_id, want.parent_id)
        with tr.span("phase", "x"):
            pass
    tr.finish()
    spans = [json.loads(ln) for ln in open(tmp_path / "t.jsonl")]
    tagged = [s for s in spans if s.get("trace_id")]
    assert len(tagged) == (1 if got is not None else 0)


def test_job_timeline_matches_reference(tmp_path):
    obs = tmp_path / "obs"
    obs.mkdir()
    for name, begin, tid, fp in (("a.jsonl", 100.0, "T1", "fp1"),
                                 ("b.jsonl.part", 105.0, "T1,T2", "fp1"),
                                 ("c.jsonl", 90.0, "T2", "fp9")):
        with open(obs / name, "w") as fh:
            fh.write(json.dumps({"ev": "begin", "schema": 1,
                                 "unix_time": begin}) + "\n")
            for i in range(3):
                fh.write(json.dumps({
                    "ev": "span", "id": i + 1, "parent": None,
                    "kind": "phase", "name": f"s{i}", "t0": i * 0.5,
                    "dur_s": 0.1, "trace_id": tid, "run_fp": fp}) + "\n")
    w, _ = _writer(obs, "A", "fp1")
    w.flush()
    got = obs_fleet.assemble_job_timeline(str(tmp_path), "T1")
    assert got == RFLEET.assemble_job_timeline(str(tmp_path), "T1")
    assert got["n_processes"] == 2 and got["n_spans"] == 6
    with pytest.raises(obs_fleet.FleetObsError, match="mixed runs"):
        obs_fleet.assemble_job_timeline(str(tmp_path), "T2")
    with pytest.raises(obs_fleet.FleetObsError, match="no span"):
        obs_fleet.assemble_job_timeline(str(tmp_path), "T3")


# ------------------------------------------------------- elastic fleet

def _lineage_dir(tmp_path):
    obs = tmp_path / obs_fleet.OBS_SUBDIR
    obs.mkdir()
    w, reg = _writer(obs, "A", "fp1")
    reg.inc("poa_windows_total", 12)
    w.flush(final=True)
    events = [
        {"ev": "spawn", "worker": "as0", "reason": "scale-up"},
        {"ev": "claim", "name": "shard_0", "worker": "A", "t": 1.0},
        {"ev": "split", "name": "shard_0", "child": "shard_0s1_1",
         "worker": "A", "epoch": 1, "start": 2, "end": 6, "t": 2.0},
        {"ev": "claim", "name": "shard_0s1_1", "worker": "B",
         "t": 2.5},
        {"ev": "split", "name": "shard_0s1_1",
         "child": "shard_0s1_1s1_1", "worker": "B", "epoch": 1,
         "start": 4, "end": 6, "t": 3.0},
        {"ev": "steal", "name": "shard_0s1_1", "worker": "C",
         "victim": "B", "t": 9.0, "expired_for_s": 1.0, "epoch": 2},
        {"ev": "retire", "worker": "as0", "reason": "scale-down"},
    ]
    with open(tmp_path / "events.jsonl", "w") as fh:
        for e in events:
            fh.write(json.dumps(e) + "\n")
    hb = {"schema": 1, "unix_time": 12.0, "interval_s": 0.5,
          "target_workers": 2, "live_workers": 2, "done": False,
          "metrics": {"dist_scale_up_total": 3,
                      "dist_scale_down_total": 1,
                      "fleet_target_workers": 2,
                      "bogus_non_numeric": "nope"}}
    (obs / obs_fleet.SUPERVISOR_NAME).write_text(json.dumps(hb))
    return tmp_path


def test_aggregate_split_lineage_and_supervisor_fold(tmp_path):
    model = obs_fleet.aggregate(str(_lineage_dir(tmp_path)))
    assert model["splits"] == 2
    assert model["spawns"] == 1 and model["retires"] == 1
    assert model["lineage"] == {
        "shard_0s1_1": "shard_0",
        "shard_0s1_1s1_1": "shard_0s1_1"}
    lane = model["timeline"]["shard_0"]
    assert [e["ev"] for e in lane] == ["claim", "split"]
    assert lane[1]["child"] == "shard_0s1_1"
    assert model["supervisor"]["target_workers"] == 2
    assert model["fleet"]["dist_scale_up_total"] == 3
    assert model["fleet"]["dist_scale_down_total"] == 1
    assert model["fleet"]["fleet_target_workers"] == 2
    assert "bogus_non_numeric" not in model["fleet"]
    text = obs_export.render_fleet(model)
    assert obs_export.validate_openmetrics(text) == []
    assert "racon_tpu_dist_scale_up_total 3" in text
    assert "racon_tpu_fleet_target_workers 2" in text
    assert text == obs_export.render_fleet(
        obs_fleet.aggregate(str(tmp_path)))


@pytest.mark.parametrize("layout", ["two_workers", "lineage"])
def test_fleet_render_matches_reference(tmp_path, layout):
    """The same shard files, events and heartbeat through both packages'
    aggregate and render_fleet: the same model and the same text."""
    root = str(_two_worker_dir(tmp_path) if layout == "two_workers"
               else _lineage_dir(tmp_path))
    model = obs_fleet.aggregate(root)
    assert model == RFLEET.aggregate(root)
    text = obs_export.render_fleet(model)
    assert text == RX.render_fleet(RFLEET.aggregate(root))
    assert obs_export.validate_openmetrics(text) == []


# ------------------------------------------------ the signal teardown

def _store_files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in ("meta.json", "manifest.jsonl", "contigs.fasta")}


def test_sigterm_teardown_matches_reference(tmp_path, inputs):
    """SIGTERM mid-run (the ``term`` action at the second checkpoint
    commit), each CLI in its own process: both exit 143 with the same
    stdout and the same committed contigs, and each package's store
    resumes under the other's CLI to the uninterrupted bytes."""
    paths, base = inputs
    env = subprocess_env(RACON_TPU_FAULTS="ckpt/commit:1!term")
    runs = {}
    for pkg, flag in (("racon_tpu_torch", ["--device", "cpu"]),
                      ("racon_tpu", ["--backend", "native"])):
        d = str(tmp_path / pkg)
        runs[pkg] = subprocess.run(
            [sys.executable, "-m", f"{pkg}.cli", *flag, *paths,
             "--checkpoint-dir", d], capture_output=True, env=env,
            cwd=ROOT, timeout=300)
    port, ref = runs["racon_tpu_torch"], runs["racon_tpu"]
    assert ref.returncode == 143, ref.stderr.decode()[-2000:]
    assert port.returncode == 143, port.stderr.decode()[-2000:]
    assert port.stdout == ref.stdout
    assert b"interrupted (signal 15); 1 contig(s) committed" in \
        port.stderr
    port_store = _store_files(str(tmp_path / "racon_tpu_torch"))
    assert port_store == _store_files(str(tmp_path / "racon_tpu"))
    assert port_store["manifest.jsonl"].count(b'"ev": "contig"') == 1
    # Each package resumes the other's store.
    from racon_tpu import cli as rcli
    rc, out, err = port_cli([*paths, "--checkpoint-dir",
                             str(tmp_path / "racon_tpu"), "--resume"])
    assert rc == 0, err
    assert out == base
    rc, out, err = _capture(rcli.main, [
        "--backend", "native", *paths, "--checkpoint-dir",
        str(tmp_path / "racon_tpu_torch"), "--resume"])
    assert rc == 0, err
    assert out == base


def test_sigterm_leaves_final_snapshot(tmp_path, inputs, monkeypatch):
    """A ledger worker SIGTERM'd mid-shard exits 143 through the CLI's
    teardown, which releases its lease and publishes a final metric
    snapshot first."""
    from racon_tpu_torch.distributed import WorkLedger
    paths, _ = inputs
    ledger = str(tmp_path / "ledger")
    monkeypatch.setenv("RACON_TPU_DIST_SHARDS", "2")
    monkeypatch.setenv(obs_fleet.ENV_FLUSH_S, "0")
    faults.configure("dist/contig:0!term")
    rc, out, err = port_cli(["--ledger-dir", ledger, "--workers", "1",
                             "--worker-id", "W", *paths])
    assert rc == 143, err
    assert "interrupted (signal 15)" in err and out == b""
    shards = obs_fleet.load_worker_shards(
        os.path.join(ledger, obs_fleet.OBS_SUBDIR))
    assert len(shards) == 1
    last = shards[0]["records"][-1]
    assert last["worker_id"] == "W" and last["final"]
    assert last["metrics"]["dist_retires"] == 1
    led = WorkLedger.attach(ledger)
    assert [e["ev"] for e in led.events()] == ["claim", "release"]
    # The released shard is claimable at once.
    assert led.claim_shard("other").name == "shard_0"


def test_serial_obs_dir_opt_in(tmp_path, inputs, monkeypatch):
    """RACON_TPU_OBS_DIR gives a serial run the metric shard a fleet
    worker writes, final at exit, under its --worker-id... and the
    flight recorder's dump beside it."""
    paths, base = inputs
    obs = tmp_path / "obs"
    monkeypatch.setenv(obs_fleet.ENV_OBS_DIR, str(obs))
    rc, out, err = port_cli([*paths, "--worker-id", "solo"])
    assert rc == 0 and out == base, err
    model = obs_fleet.aggregate(str(obs))
    assert list(model["workers"]) == ["solo"]
    wrk = model["workers"]["solo"]
    assert wrk["final"] and wrk["metrics"]["poa_windows_total"] > 0
    assert wrk["phase_seconds"]
    from racon_tpu_torch.server.engine import JobSpec
    assert model["run_fp"] == JobSpec(*paths).fingerprint()
