"""The port's elastic fleet supervisor against the JAX package's: the
autoscale policy and its environment, the target decision, the worker
argv (the port's CLI, never the reference's), the fault plan, the
heartbeat and the ``/healthz`` fleet view — each equal to the
reference's on the same inputs — and one autoscaled fleet of worker
processes on ``--device cpu``, whose first spawn is killed mid-shard:
the supervisor replaces it and prints the serial CLI's bytes, without
building a polisher or resolving a device itself.

Inputs: tests/serve_inputs.py (tiny drafts and reads from a seed)."""

import io
import json
import os
import sys
import time

import numpy as np
import pytest

from racon_tpu.distributed import autoscaler as RASC
from racon_tpu.obs import export as RX
from racon_tpu.obs import fleet as RFLEET
from racon_tpu_torch.distributed import autoscaler as asc
from racon_tpu_torch.distributed.ledger import LedgerError
from racon_tpu_torch.obs import export as obs_export
from racon_tpu_torch.obs import fleet as obs_fleet

from serve_inputs import port_cli, write_inputs


@pytest.fixture(autouse=True)
def autoscale_clean(monkeypatch):
    for env in (asc.ENV_MIN, asc.ENV_MAX, asc.ENV_INTERVAL,
                asc.ENV_MAX_SPAWNS, asc.ENV_DEADLINE, asc.ENV_FAULT_PLAN,
                "RACON_TPU_FAULTS", "RACON_TPU_DIST_SHARDS",
                "RACON_TPU_METRICS_PORT", "RACON_TPU_TRACE_CTX",
                "RACON_TPU_OBS_DIR", "RACON_TPU_PIPELINE"):
        monkeypatch.delenv(env, raising=False)
    obs_fleet._WRITER = None
    yield
    obs_fleet._WRITER = None


# --------------------------------------------------------------- policy

def _policy_fields(pol):
    return (pol.min_workers, pol.max_workers, pol.interval_s,
            pol.max_spawns, pol.deadline_s)


def test_policy_defaults_and_env(monkeypatch):
    pol = asc.AutoscalePolicy.from_env(default_max=4)
    assert (pol.min_workers, pol.max_workers) == (1, 4)
    assert pol.interval_s == 0.5
    assert pol.max_spawns == 16
    assert pol.deadline_s == 0.0
    monkeypatch.setenv(asc.ENV_MIN, "2")
    monkeypatch.setenv(asc.ENV_MAX, "6")
    monkeypatch.setenv(asc.ENV_INTERVAL, "0.01")
    monkeypatch.setenv(asc.ENV_MAX_SPAWNS, "40")
    monkeypatch.setenv(asc.ENV_DEADLINE, "120")
    pol = asc.AutoscalePolicy.from_env(default_max=4)
    assert (pol.min_workers, pol.max_workers) == (2, 6)
    assert pol.interval_s == 0.05
    assert (pol.max_spawns, pol.deadline_s) == (40, 120.0)
    monkeypatch.setenv(asc.ENV_MAX, "oops")
    with pytest.raises(LedgerError, match="not a number"):
        asc.AutoscalePolicy.from_env(default_max=4)
    monkeypatch.setenv(asc.ENV_MAX, "1")
    monkeypatch.setenv(asc.ENV_MIN, "5")
    with pytest.raises(LedgerError, match="MIN 5 > MAX 1"):
        asc.AutoscalePolicy.from_env(default_max=4)


def test_policy_from_env_matches_reference(monkeypatch):
    rng = np.random.default_rng(4)
    envs = (asc.ENV_MIN, asc.ENV_MAX, asc.ENV_INTERVAL,
            asc.ENV_MAX_SPAWNS, asc.ENV_DEADLINE)
    assert envs == (RASC.ENV_MIN, RASC.ENV_MAX, RASC.ENV_INTERVAL,
                    RASC.ENV_MAX_SPAWNS, RASC.ENV_DEADLINE)
    for _ in range(40):
        for name in envs:
            pick = int(rng.integers(0, 4))
            if pick == 0:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, ["", "3", "0.2", "9"][pick])
        default_max = int(rng.integers(1, 9))
        try:
            want = _policy_fields(RASC.AutoscalePolicy.from_env(
                default_max))
        except RASC.LedgerError as exc:
            with pytest.raises(LedgerError) as got:
                asc.AutoscalePolicy.from_env(default_max)
            assert str(got.value).split("] ", 1)[1] == \
                str(exc).split("] ", 1)[1]
            continue
        assert _policy_fields(asc.AutoscalePolicy.from_env(
            default_max)) == want


def test_decide_clamps_to_open_work():
    pol = asc.AutoscalePolicy(1, 4, 0.5, 16, 0.0)
    assert asc.decide(None, pol) == 4
    assert asc.decide(0, pol) == 1
    assert asc.decide(2, pol) == 2
    assert asc.decide(9, pol) == 4
    rng = np.random.default_rng(6)
    for _ in range(100):
        lo = int(rng.integers(0, 5))
        hi = lo + int(rng.integers(0, 5)) or 1
        args = (lo, hi, 0.5, 8, 0.0)
        work = None if rng.random() < 0.1 else int(rng.integers(0, 12))
        assert asc.decide(work, asc.AutoscalePolicy(*args)) == \
            RASC.decide(work, RASC.AutoscalePolicy(*args))


def test_worker_argv_strips_supervisor_flags():
    raw = ["--device", "cpu", "--autoscale", "--worker-id", "sup",
           "--ledger-dir", "L", "--worker-id=sup2", "reads.fa"]
    assert asc.worker_argv(raw) == ["--device", "cpu", "--ledger-dir", "L",
                                    "reads.fa"]
    rng = np.random.default_rng(8)
    words = ["--autoscale", "--worker-id", "w1", "--worker-id=w2",
             "--device", "cpu", "--ledger-dir", "L", "-t", "4", "x.fa"]
    for _ in range(100):
        argv = [words[i] for i in rng.integers(0, len(words),
                                               int(rng.integers(0, 9)))]
        assert asc.worker_argv(argv) == RASC.worker_argv(argv)


def test_spawn_argv_runs_the_ports_cli(tmp_path):
    """A worker's command line is the reference's but for the module,
    which is the port's CLI; --device passes through as given and is
    never added."""
    assert asc.WORKER_MODULE == "racon_tpu_torch.cli"
    for raw in (["--device", "cpu", "--autoscale", "a", "b", "c"],
                ["--autoscale", "--ledger-dir", "L", "a", "b", "c"]):
        sc = asc.Autoscaler(str(tmp_path), raw, policy=asc.AutoscalePolicy(
            1, 2, 0.1, 8, 0.0), out=io.BytesIO(), log=io.StringIO())
        argv = sc.spawn_argv("as3")
        assert argv == [sys.executable, "-m", "racon_tpu_torch.cli",
                        *RASC.worker_argv(raw), "--worker-id", "as3"]
        assert "racon_tpu.cli" not in argv
        assert argv.count("--device") == raw.count("--device")


def test_fault_plan_loads_and_validates(tmp_path, monkeypatch):
    log = io.StringIO()
    assert asc._load_fault_plan(log) == []
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(["dist/shard:0!kill", "", "skew=1"]))
    monkeypatch.setenv(asc.ENV_FAULT_PLAN, str(path))
    assert asc._load_fault_plan(log) == ["dist/shard:0!kill", "",
                                         "skew=1"]
    assert "2 faulted spawn(s) of 3" in log.getvalue()
    path.write_text(json.dumps({"not": "a list"}))
    with pytest.raises(LedgerError, match="JSON list"):
        asc._load_fault_plan(log)
    monkeypatch.setenv(asc.ENV_FAULT_PLAN, str(tmp_path / "missing"))
    with pytest.raises(LedgerError, match="unreadable fault plan"):
        asc._load_fault_plan(log)


# ------------------------------------------------------------ heartbeat

def _scaler(tmp_path, mod=asc):
    return mod.Autoscaler(str(tmp_path / "ledger"), ["--device", "cpu"],
                          policy=mod.AutoscalePolicy(1, 2, 0.1, 8, 0.0),
                          out=io.BytesIO(), log=io.StringIO())


def test_heartbeat_record_round_trips(tmp_path, monkeypatch):
    sc = _scaler(tmp_path)
    sc.counters["scale_up_total"] = 3
    sc.counters["evicted_total"] = 1
    sc.counters["self_evicted_total"] = 1
    sc._heartbeat(target=2, open_work=5, done=False)
    hb = obs_fleet.load_supervisor(sc.ledger_dir)
    assert hb is not None and hb["schema"] == 1
    assert hb["target_workers"] == 2 and hb["open_shards"] == 5
    assert hb["done"] is False and hb["seq"] == 0
    assert hb["workers_evicted"] == 2
    assert hb["metrics"] == {"dist_scale_up_total": 3,
                             "dist_scale_down_total": 0,
                             "fleet_target_workers": 2}
    sc._heartbeat(target=0, open_work=0, done=True)
    hb = obs_fleet.load_supervisor(sc.ledger_dir)
    assert hb["seq"] == 1 and hb["done"] is True
    # The reference's supervisor writes the same record.
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    files = []
    for sub, mod in (("port", asc), ("ref", RASC)):
        s = _scaler(tmp_path / sub, mod)
        s.counters["retired_total"] = 2
        s._heartbeat(target=1, open_work=None, done=False)
        files.append(open(os.path.join(s.obs_dir, "autoscaler.json"),
                          "rb").read())
    assert files[0] == files[1]


# --------------------------------------------------------- fleet health

def _write_heartbeat(ledger_dir, age_s=0.0, interval_s=0.5, done=False):
    d = obs_fleet.obs_dir_for(ledger_dir)
    os.makedirs(d, exist_ok=True)
    rec = {"schema": 1, "unix_time": time.time() - age_s,
           "interval_s": interval_s, "target_workers": 2,
           "live_workers": 2, "done": done, "workers_live": 2,
           "workers_evicted": 1, "workers_retired": 0,
           "workers_done": 0}
    with open(os.path.join(d, obs_fleet.SUPERVISOR_NAME), "w") as fh:
        fh.write(json.dumps(rec))


def _same_health(ld):
    got = obs_export.fleet_health(ld)
    want = RX.fleet_health(ld)
    for snap in (got, want):
        snap["fleet"].get("autoscaler", {}).pop("age_s", None)
    assert got == want
    return obs_export.fleet_health(ld)


def test_fleet_health_view_and_supervisor_staleness(tmp_path):
    ld = str(tmp_path / "ledger")
    os.makedirs(ld)
    snap = _same_health(ld)
    assert snap["status"] == "ok"
    assert snap["fleet"]["open_shards"] is None
    assert "autoscaler" not in snap["fleet"]
    _write_heartbeat(ld, age_s=0.0)
    snap = _same_health(ld)
    assert snap["status"] == "ok"
    assert snap["fleet"]["autoscaler"]["target_workers"] == 2
    assert snap["fleet"]["workers_evicted"] == 1
    _write_heartbeat(ld, age_s=60.0, interval_s=0.5)
    snap = _same_health(ld)
    assert snap["status"] == "supervisor-dead"
    assert snap["fleet"]["autoscaler"]["age_s"] >= 59.0
    _write_heartbeat(ld, age_s=60.0, done=True)
    assert _same_health(ld)["status"] == "ok"
    # A published ledger shows its open shards.
    from racon_tpu_torch.distributed import WorkLedger
    WorkLedger.open(ld, "fp", n_targets=3, workers=1)
    snap = _same_health(ld)
    assert snap["fleet"]["open_shards"] == 2
    assert snap["fleet"]["merge_done"] is False


def test_fleet_health_served_as_503(tmp_path):
    import urllib.error
    import urllib.request
    ld = str(tmp_path / "ledger")
    os.makedirs(ld)
    _write_heartbeat(ld, age_s=60.0, interval_s=0.5)
    srv = obs_export.serve_metrics(
        0, lambda: "# EOF\n", health=lambda: obs_export.fleet_health(ld))
    try:
        url = "http://127.0.0.1:%d/healthz" % srv.server_address[1]
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(url)
        assert exc.value.code == 503
        assert json.loads(exc.value.read())["status"] == \
            "supervisor-dead"
        _write_heartbeat(ld, age_s=0.0)
        with urllib.request.urlopen(url) as resp:
            assert resp.status == 200
    finally:
        srv.shutdown()
        srv.server_close()


# ---------------------------------------------------- an autoscaled fleet

def test_autoscaled_fleet_replaces_a_killed_worker(tmp_path, monkeypatch):
    """``--autoscale --workers 2`` in this process, its workers real
    processes of the port's CLI on ``--device cpu``: spawn #0 is killed
    at its first contig (``dist/contig:0!kill``); the supervisor counts
    the eviction, spawns a replacement, and prints the serial bytes. The
    supervisor itself resolves no device and builds no polisher."""
    from racon_tpu_torch.server import engine
    from racon_tpu_torch.utils import device
    paths = write_inputs(str(tmp_path / "in"), n_contigs=3)
    rc, base, err = port_cli(paths)
    assert rc == 0, err

    def forbidden(*a, **k):
        raise AssertionError("the supervisor touched the device path")

    monkeypatch.setattr(device, "resolve_device", forbidden)
    monkeypatch.setattr(engine, "build_polisher", forbidden)
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps(["dist/contig:0!kill"]))
    monkeypatch.setenv(asc.ENV_FAULT_PLAN, str(plan))
    monkeypatch.setenv(asc.ENV_INTERVAL, "0.1")
    monkeypatch.setenv("RACON_TPU_DIST_SHARDS", "2")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         os.environ.get("PYTHONPATH", "")]))
    ld = str(tmp_path / "ledger")
    rc, out, err = port_cli([*paths, "--autoscale", "--workers", "2",
                             "--lease-s", "2", "--ledger-dir", ld])
    assert rc == 0, err
    assert out == base
    hb = obs_fleet.load_supervisor(ld)
    assert hb["done"] and hb["spawned_total"] >= 3
    assert hb["evicted_total"] >= 1 and hb["workers_live"] == 0
    events = [json.loads(ln) for ln in open(os.path.join(
        ld, "events.jsonl"))]
    assert sum(e["ev"] == "steal" for e in events) >= 1
    logs = sorted(os.listdir(os.path.join(ld, "logs")))
    assert logs[:3] == ["as0.log", "as1.log", "as2.log"]
    model = obs_fleet.aggregate(ld)
    assert model == RFLEET.aggregate(ld)
    assert {"as0", "as1", "as2"} <= set(model["workers"])
    assert not model["workers"]["as0"]["final"]    # killed: no final
    text = obs_export.render_fleet(model)
    assert obs_export.validate_openmetrics(text) == []
    assert text == RX.render_fleet(RFLEET.aggregate(ld))


class _FakeProc:
    def __init__(self, argv, rc=None, **kw):
        self.argv, self.env, self.rc = argv, kw.get("env"), rc
        self.pid = 4242

    def poll(self):
        return self.rc


def test_self_evicted_worker_is_replaced_avoiding_its_shard(
        tmp_path, monkeypatch):
    """Exit 75 (a terminal watchdog breach) is replaced at once, outside
    the target policy, with RACON_TPU_DIST_AVOID naming the shard the
    sick worker released — the reference's decision; the spawn's env is
    the reference's but for RACON_TPU_METRICS_PORT, which stays with the
    supervisor, and its argv runs the port's CLI."""
    from racon_tpu.distributed import ledger as RL
    from racon_tpu_torch.resilience.watchdog import EXIT_SELF_EVICT
    monkeypatch.setenv("RACON_TPU_METRICS_PORT", "9999")
    spawned = {}
    for sub, mod, led_mod in (("port", asc, asc.dledger),
                              ("ref", RASC, RL)):
        popen = []
        monkeypatch.setattr(mod.subprocess, "Popen",
                            lambda argv, **kw: popen.append(
                                _FakeProc(argv, **kw)) or popen[-1])
        sc = _scaler(tmp_path / sub, mod)
        led_mod.WorkLedger.open(sc.ledger_dir, "fp", n_targets=4,
                                workers=2)
        led_mod.append_event(sc.ledger_dir, {"ev": "release",
                                             "name": "shard_1",
                                             "worker": "as0"})
        sc.procs = [{"proc": _FakeProc([], rc=EXIT_SELF_EVICT), "wid": "as0",
                     "log_fh": io.BytesIO(), "retiring": False}]
        sc._reap()
        assert sc.counters["self_evicted_total"] == 1
        assert sc.counters["replaced_total"] == 1
        assert [w["wid"] for w in sc.procs] == ["as0"]
        spawned[sub] = popen[0]
    port, ref = spawned["port"], spawned["ref"]
    assert port.env["RACON_TPU_DIST_AVOID"] == \
        ref.env["RACON_TPU_DIST_AVOID"] == "shard_1"
    assert "RACON_TPU_METRICS_PORT" not in port.env
    assert ref.env["RACON_TPU_METRICS_PORT"] == "9999"
    assert {k: v for k, v in ref.env.items()
            if k != "RACON_TPU_METRICS_PORT"} == port.env
    assert port.argv[2] == "racon_tpu_torch.cli" and \
        ref.argv[2] == "racon_tpu.cli"
    assert port.argv[3:] == ref.argv[3:] == ["--device", "cpu",
                                             "--worker-id", "as0"]
