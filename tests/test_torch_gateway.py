"""The port's gateway fleet route against the JAX package's: the routing
policy (``decide_route``, case for case the reference's matrix, with
fragment-correction jobs sized by bytes), the size signals, the fleet
layout and the worker argv, the service sizing policy, the autoscaler's
gateway hooks, ``run_fleet_job`` (a full commit, a replay of a partial
prefix, and no output or a failed supervisor raising
``FleetDispatchError``), a real supervisor spawning a CPU worker under
an armed daemon, and an armed daemon routing one job to the fleet and one
local. Every stream is held to the reference CLI's bytes.

Stated differences: ``FleetPaths`` has no counterpart of the reference's
``pool_dir`` (its XLA compile cache; every CUDA worker loads the
checkout's one kernel library), and no worker gets
``RACON_TPU_JAX_CACHE``; the
worker argv passes the job's device as ``--device`` where the reference
passes ``--backend``.

Inputs: tests/serve_inputs.py (tiny drafts and reads from a seed)."""

import io
import json
import os

import pytest

from racon_tpu.distributed import autoscaler as RASC
from racon_tpu.gateway import dispatch as rd
from racon_tpu.gateway import policy as rpol
from racon_tpu.obs import metrics as rmetrics
from racon_tpu.resilience import faults as RF
from racon_tpu.server.engine import JobSpec as RSpec
from racon_tpu_torch.distributed import autoscaler as asc
from racon_tpu_torch.gateway import dispatch as pd
from racon_tpu_torch.gateway import policy as ppol
from racon_tpu_torch.obs import fleet as obs_fleet
from racon_tpu_torch.obs import metrics
from racon_tpu_torch.resilience import faults as PF
from racon_tpu_torch.server.engine import JobSpec

from serve_inputs import ROOT, port_cli, ref_cli, write_inputs

GATE_ENVS = ("RACON_TPU_GATE_FLEET", "RACON_TPU_GATE_FLEET_MIN_TARGETS",
             "RACON_TPU_GATE_FLEET_MIN_BYTES",
             "RACON_TPU_GATE_QUEUE_PRESSURE", "RACON_TPU_GATE_WORKERS")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in GATE_ENVS + (
            asc.ENV_MIN, asc.ENV_MAX, asc.ENV_INTERVAL, asc.ENV_MAX_SPAWNS,
            asc.ENV_DEADLINE, asc.ENV_FAULT_PLAN, "RACON_TPU_FAULTS",
            "RACON_TPU_TRACE", "RACON_TPU_TRACE_CTX", "RACON_TPU_CACHE",
            "RACON_TPU_CACHE_DIR", "RACON_TPU_JAX_CACHE",
            "RACON_TPU_METRICS_PORT", "RACON_TPU_DIST_SHARDS",
            "RACON_TPU_OBS_DIR", "RACON_TPU_PIPELINE",
            "RACON_TPU_SERVE_BATCH_WAIT_S"):
        monkeypatch.delenv(name, raising=False)
    for mod in (PF, RF):
        mod.configure(None)
    for mod in (metrics, rmetrics):
        mod.reset()
    obs_fleet._WRITER = None
    yield
    for mod in (PF, RF):
        mod.configure(None)
    obs_fleet._WRITER = None


def _spec(paths, **kw):
    kw.setdefault("backend", "cpu")
    return JobSpec(*paths, **kw)


def _wait(job, timeout_s=180.0):
    assert job.finished.wait(timeout_s), \
        f"job {job.id} still {job.state} after {timeout_s}s"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Two 3-contig input sets, the reference CLI's bytes on each, and a
    gateway state dir whose fleet ledger for the first set was run to
    its merge by one in-process port worker with the argv the gateway
    hands its fleet (the short-circuit a resubmitted fingerprint hits)."""
    root = tmp_path_factory.mktemp("gw")
    sets = []
    for seed in (11, 22):
        paths = write_inputs(str(root / f"in{seed}"), n_contigs=3,
                             seed=seed)
        rc, ref, err = ref_cli(paths)
        assert rc == 0, err
        assert ref.count(b">") == 3
        sets.append((paths, ref))
    state = str(root / "state")
    spec = _spec(sets[0][0])
    fp = pd.fleet_paths(state, spec.fingerprint())
    os.makedirs(fp.ledger_dir)
    rc, out, err = port_cli(pd.worker_cli_argv(spec, fp.ledger_dir, 1) +
                            ["--worker-id", "seed"])
    assert rc == 0, err
    assert out == sets[0][1], "the port's ledger worker differs from " \
        "the reference CLI"
    obs_fleet._WRITER = None
    return {"sets": sets, "state": state}


# ------------------------------------------------------- routing policy

_ARMED = {"RACON_TPU_GATE_FLEET": "1",
          "RACON_TPU_GATE_FLEET_MIN_TARGETS": "4",
          "RACON_TPU_GATE_QUEUE_PRESSURE": "2"}
_AVA = dict(_ARMED, RACON_TPU_GATE_FLEET_MIN_BYTES="1000")


@pytest.mark.parametrize("gates, ava, n, depth, nbytes", [
    ({}, None, 10_000, 99, 0),            # unarmed: always local
    (_ARMED, None, 4, 0, 0),              # at the size threshold
    (_ARMED, None, 400, 0, 0),            # far past it
    (_ARMED, None, 3, 0, 0),              # small, idle daemon
    (_ARMED, None, 3, 1, 0),              # small, shallow queue
    (_ARMED, None, 1, 2, 0),              # queue-pressure override
    ({"RACON_TPU_GATE_FLEET": "1"}, None, 32, 0, 0),   # default 32
    ({"RACON_TPU_GATE_FLEET": "1"}, None, 31, 7, 0),   # default 8
    ({"RACON_TPU_GATE_FLEET": "1"}, None, 31, 8, 0),
    ({"RACON_TPU_GATE_FLEET": "off"}, None, 400, 9, 0),
    (_AVA, True, 3, 0, 5000),             # few records, many bytes
    (_AVA, True, 400, 0, 800),            # many records, few bytes
    (_AVA, True, 1, 2, 10),               # pressure in the ava regime
    ({}, True, 3, 9, 10**9),              # unarmed ava
    ({"RACON_TPU_GATE_FLEET": "1"}, True, 1, 0, 8388608),  # default
    (dict(_AVA, RACON_TPU_GATE_FLEET_MIN_BYTES="1"), None, 3, 0, 10**9),
    (dict(_AVA, RACON_TPU_GATE_FLEET_MIN_BYTES="1"), False, 4, 0, 0),
])
def test_decide_route_matches_reference(monkeypatch, gates, ava, n, depth,
                                        nbytes):
    for k, v in gates.items():
        monkeypatch.setenv(k, v)
    specs = (None, None) if ava is None else (
        _spec(["r.fa", "o.paf", "r.fa"], fragment_correction=ava),
        RSpec("r.fa", "o.paf", "r.fa", fragment_correction=ava))
    got = pd.decide_route(specs[0], n, depth, target_bytes=nbytes)
    want = rd.decide_route(specs[1], n, depth, target_bytes=nbytes)
    assert tuple(got) == tuple(want)
    assert got.route in ("fleet", "local")


def test_route_fault_site_fires_before_decision(monkeypatch):
    monkeypatch.setenv("RACON_TPU_GATE_FLEET", "1")
    PF.configure("gate/route:0")
    with pytest.raises(PF.InjectedFault):
        pd.decide_route(None, 10_000)
    PF.configure(None)
    assert pd.decide_route(None, 10_000).route == "fleet"


@pytest.mark.parametrize("name, blob", [
    ("one.fasta", b">c0\nACGT\n"),
    ("three.fasta", b">c0\nACGT\n>c1\nAC\n>c2 x\nGG\nTT\n"),
    ("reads.fastq", b"@r0\nACGT\n+\nIIII\n@r1\nAC\n+\nII\n"),
])
def test_target_stats_match_reference(tmp_path, name, blob):
    p = tmp_path / name
    p.write_bytes(blob)
    assert pd.count_targets(str(p)) == rd.count_targets(str(p))
    assert pd.target_stats(str(p)) == rd.target_stats(str(p)) == \
        (blob.count(blob[:1]), len(blob))


def test_fleet_paths_match_reference(tmp_path):
    """Run dirs keyed by fingerprint, the CAS shared under the gateway
    root, as the reference lays them out; the reference's ``pool_dir``
    has no counterpart."""
    state = str(tmp_path / "state")
    for fp in ("a" * 64, "b" * 64):
        got, want = pd.fleet_paths(state, fp), rd.fleet_paths(state, fp)
        assert (got.root, got.run_dir, got.ledger_dir, got.cas_dir) == \
            (want.root, want.run_dir, want.ledger_dir, want.cas_dir)
        assert set(want._fields) - set(got._fields) == {"pool_dir"}
        assert set(got._fields) < set(want._fields)
    assert pd.fleet_paths(state, "a" * 64) == pd.fleet_paths(state, "a" * 64)


@pytest.mark.parametrize("opts", [
    {}, {"window_length": 250, "match": 3, "include_unpolished": True},
    {"fragment_correction": True, "error_threshold": 0.25, "gap": -6,
     "quality_threshold": 7.5, "threads": 4, "backend": "cuda"}])
def test_worker_cli_argv_matches_reference(tmp_path, opts):
    """The reference's argv but for ``--device`` in place of
    ``--backend``; the port's CLI parses it into a JobSpec with the
    job's fingerprint, so the ledger refuses nothing."""
    from racon_tpu_torch.cli import build_parser
    paths = ["r.fa", "o.paf", "d.fa"]
    backend = opts.get("backend", "cpu")
    spec = _spec(paths, **opts)
    ref = RSpec(*paths, **dict(opts, backend=backend))
    ld = str(tmp_path / "ledger")
    got = pd.worker_cli_argv(spec, ld, 3)
    want = rd.worker_cli_argv(ref, ld, 3)
    i = want.index("--backend")
    assert got == want[:i] + ["--device"] + want[i + 1:]
    assert got[got.index("--device") + 1] == backend
    args = build_parser().parse_args(got)
    parsed = JobSpec(
        *args.paths, include_unpolished=args.include_unpolished,
        fragment_correction=args.fragment_correction,
        window_length=args.window_length,
        quality_threshold=args.quality_threshold,
        error_threshold=args.error_threshold, match=args.match,
        mismatch=args.mismatch, gap=args.gap, backend=args.device,
        threads=args.threads)
    assert parsed.identity() == spec.identity() == ref.identity()
    assert (args.ledger_dir, args.workers) == (ld, 3)


def test_fleet_replay_records_match_reference_split(tmp_path, inputs):
    """The records ``run_fleet_job`` replays off a merged FASTA are the
    reference's ``_split_fasta`` records, byte for byte."""
    from racon_tpu_torch.ava.emit import iter_fasta_records
    blob = inputs["sets"][0][1]
    merged = tmp_path / "out.fasta"
    merged.write_bytes(blob)
    got = [bytes(r) for r in iter_fasta_records(str(merged))]
    assert got == rd._split_fasta(blob)
    assert b"".join(got) == blob


# ---------------------------------------------------- service sizing

def _both_targets(open_work, pol_args, ledger_dir=None):
    got = ppol.service_target(open_work, asc.AutoscalePolicy(*pol_args),
                              ledger_dir=ledger_dir)
    want = rpol.service_target(open_work, RASC.AutoscalePolicy(*pol_args),
                               ledger_dir=ledger_dir)
    assert got == want
    assert metrics.registry().get("gate_fleet_target") == got == \
        rmetrics.registry().get("gate_fleet_target")
    return got


def test_service_target_boosts_on_queue_signals(monkeypatch):
    """The boost from queue depth and from the queue-wait p95 over the
    stock clamp, capped by the policy's max, as the reference's."""
    monkeypatch.setenv("RACON_TPU_GATE_QUEUE_PRESSURE", "4")
    pol = (1, 8, 0.5, 16, 0.0)
    assert _both_targets(2, pol) == asc.decide(
        2, asc.AutoscalePolicy(*pol)) == 2
    for reg in (metrics.registry(), rmetrics.registry()):
        reg.set("serve_queue_depth_peak", 4)
    assert _both_targets(2, pol) == 3
    for _ in range(20):
        metrics.record_hist("serve_queue_wait_s", 1.0)
        rmetrics.record_hist("serve_queue_wait_s", 1.0)
    assert _both_targets(2, pol) == 4
    assert _both_targets(8, pol) == 8
    assert _both_targets(None, pol) == 8
    assert ppol.SLOW_WAIT_S == rpol.SLOW_WAIT_S == 0.25


def test_service_target_damped_by_fleet_drain_rate(tmp_path, monkeypatch):
    """A fleet already draining faster than work arrives gets no boost."""
    monkeypatch.setenv("RACON_TPU_GATE_QUEUE_PRESSURE", "1")
    for reg in (metrics.registry(), rmetrics.registry()):
        reg.set("serve_queue_depth_peak", 9)
    ld = str(tmp_path / "ledger")
    obs = os.path.join(ld, obs_fleet.OBS_SUBDIR)
    os.makedirs(obs)
    pol = (1, 8, 0.5, 16, 0.0)
    assert ppol.fleet_windows_per_sec(ld) == 0.0
    assert _both_targets(2, pol, ledger_dir=ld) == 3
    with open(os.path.join(obs, "worker_w1.metrics.jsonl"), "w") as fh:
        fh.write(json.dumps({
            "schema": obs_fleet.SNAPSHOT_SCHEMA, "worker_id": "w1",
            "run_fp": "f" * 16, "wall_s": 2.0,
            "metrics": {"poa_windows_total": 400}}) + "\n")
    assert ppol.fleet_windows_per_sec(ld) == \
        rpol.fleet_windows_per_sec(ld) == 200.0
    assert _both_targets(2, pol, ledger_dir=ld) == 2


# ------------------------------------------- the autoscaler's hooks

class _FakeProc:
    def __init__(self, argv, **kw):
        self.argv, self.env = argv, kw.get("env")
        self.pid = 4242

    def poll(self):
        return None


def test_autoscaler_gateway_hooks_match_reference(tmp_path, monkeypatch):
    """``extra_env`` applies last to every spawn and ``trace_dir`` gives
    each spawn its own trace file, as in the reference, except that
    ``RACON_TPU_METRICS_PORT`` never reaches a worker, not even through
    ``extra_env``; ``target_fn`` replaces decide() a tick."""
    extra = {"RACON_TPU_CACHE_DIR": str(tmp_path / "cas"),
             "RACON_TPU_TRACE_CTX": "cafe" * 4 + ":7",
             "RACON_TPU_METRICS_PORT": "9999"}
    spawned = {}
    for sub, mod in (("port", asc), ("ref", RASC)):
        popen = []
        monkeypatch.setattr(mod.subprocess, "Popen",
                            lambda argv, **kw: popen.append(
                                _FakeProc(argv, **kw)) or popen[-1])
        trace_dir = str(tmp_path / sub / "obs")
        sc = mod.Autoscaler(
            str(tmp_path / sub), ["--device", "cpu", "a", "b", "c"],
            policy=mod.AutoscalePolicy(1, 2, 0.05, 8, 0.0),
            out=io.BytesIO(), log=io.StringIO(), extra_env=extra,
            trace_dir=trace_dir)
        assert sc._spawn("test")
        spawned[sub] = popen[0]
        assert popen[0].env["RACON_TPU_TRACE"] == os.path.join(
            trace_dir, "worker_as0.jsonl")

        class _Stop(Exception):
            pass

        seen = []

        def target_fn(open_work, pol):
            seen.append((open_work, pol.max_workers))
            raise _Stop()

        sc = mod.Autoscaler(
            str(tmp_path / sub / "t"), ["a", "b", "c"],
            policy=mod.AutoscalePolicy(1, 2, 0.05, 8, 0.0),
            out=io.BytesIO(), log=io.StringIO(), target_fn=target_fn)
        with pytest.raises(_Stop):
            sc.run()
        assert seen == [(None, 2)]
    port, ref = spawned["port"], spawned["ref"]
    for k in ("RACON_TPU_CACHE_DIR", "RACON_TPU_TRACE_CTX"):
        assert port.env[k] == ref.env[k] == extra[k]
    assert ref.env["RACON_TPU_METRICS_PORT"] == "9999"
    assert "RACON_TPU_METRICS_PORT" not in port.env
    assert {k: v for k, v in ref.env.items()
            if k not in ("RACON_TPU_METRICS_PORT", "RACON_TPU_TRACE")} == \
        {k: v for k, v in port.env.items() if k != "RACON_TPU_TRACE"}


# ------------------------------------------------ the job→ledger adapter

def _job(tmp_path, job_id, spec, tenant="acme"):
    from racon_tpu_torch.server.jobs import Job
    return Job(job_id, tenant, spec, str(tmp_path / "jobs" / job_id))


def test_run_fleet_job_commits_and_replays(tmp_path, inputs):
    """A finished ledger's out.fasta is committed contig by contig into
    the job's own store (the reference CLI's bytes, one fleet_run), and a
    second pass over the same store re-emits the committed prefix."""
    from racon_tpu_torch.server.jobs import open_store
    paths, ref = inputs["sets"][0]
    spec = _spec(paths)
    job = _job(tmp_path, "j0001", spec)
    store = open_store(job)
    assert pd.run_fleet_job(job, inputs["state"], store) == 3
    store.close()
    assert job.result_bytes() == ref
    snap = metrics.registry().snapshot()
    assert snap["gate_fleet_runs"] == 1 and snap["gate_fleet_wall_s"] >= 0
    job2 = _job(tmp_path, "j0001", spec)
    store2 = open_store(job2)
    assert len(store2.committed) == 3
    assert pd.run_fleet_job(job2, inputs["state"], store2) == 3
    store2.close()
    assert job2.result_bytes() == ref


def test_run_fleet_job_resumes_partial_prefix(tmp_path, inputs):
    """tid 0 already in the job's store, 1-2 still owed: the prefix is
    re-emitted from the store and only the rest committed."""
    from racon_tpu_torch.server.jobs import open_store
    paths, ref = inputs["sets"][0]
    recs = rd._split_fasta(ref)
    job = _job(tmp_path, "j0002", _spec(paths))
    store = open_store(job)
    nl = recs[0].index(b"\n")
    store.commit(0, bytes(recs[0][1:nl]), bytes(recs[0][nl + 1:-1]))
    assert pd.run_fleet_job(job, inputs["state"], store) == 3
    assert len(store.committed) == 3
    store.close()
    assert job.result_bytes() == ref


def test_run_fleet_job_env_and_failures(tmp_path, monkeypatch, inputs):
    """Every worker gets the fleet CAS and the trace context (and no
    ``RACON_TPU_JAX_CACHE``); a supervisor that publishes no output, or
    exits 71, raises FleetDispatchError — as the reference's."""
    from racon_tpu_torch.server.jobs import open_store
    paths, _ = inputs["sets"][1]
    state = str(tmp_path / "state")
    seen = {}

    def fake(run_rc):
        class _Scaler:
            def __init__(self, ledger_dir, argv, **kw):
                seen.update(kw, ledger_dir=ledger_dir, argv=argv)

            def run(self):
                return run_rc
        return _Scaler

    for mod, spec in ((pd, _spec(paths)), (rd, RSpec(*paths,
                                                       backend="jax"))):
        from racon_tpu.server.jobs import Job as RJob
        from racon_tpu.server.jobs import open_store as ropen
        for rc, match in ((0, "without a merged"), (71, "exited 71")):
            seen.clear()
            target = ("racon_tpu_torch" if mod is pd else "racon_tpu") + \
                ".distributed.autoscaler.Autoscaler"
            monkeypatch.setattr(target, fake(rc))
            if mod is pd:
                job = _job(tmp_path, f"p{rc}", spec)
                store = open_store(job)
            else:
                job = RJob(f"r{rc}", "acme", spec,
                           str(tmp_path / "rjobs" / f"r{rc}"))
                store = ropen(job)
            with pytest.raises(mod.FleetDispatchError, match=match):
                mod.run_fleet_job(job, state, store,
                                  trace_ctx="cafe" * 4 + ":7")
            store.close()
            assert job.result_bytes() == b""
            fp = mod.fleet_paths(state, spec.fingerprint())
            assert seen["ledger_dir"] == fp.ledger_dir
            assert seen["trace_dir"] == os.path.join(fp.ledger_dir, "obs")
            assert seen["argv"] == mod.worker_cli_argv(spec, fp.ledger_dir,
                                                       2)
            assert seen["extra_env"]["RACON_TPU_CACHE_DIR"] == fp.cas_dir
            assert seen["extra_env"]["RACON_TPU_TRACE_CTX"] == \
                "cafe" * 4 + ":7"
            assert callable(seen["target_fn"])
            assert os.path.isdir(fp.cas_dir)
            if mod is pd:
                assert set(seen["extra_env"]) == {"RACON_TPU_CACHE_DIR",
                                                  "RACON_TPU_TRACE_CTX"}
            else:
                assert "RACON_TPU_JAX_CACHE" in seen["extra_env"]


def test_daemon_fleet_failure_fails_the_job(tmp_path, monkeypatch, inputs):
    """An armed fleet route whose supervisor fails ends the job
    ``failed`` with FleetDispatchError; it is never served locally."""
    from racon_tpu_torch.server.daemon import PolishServer

    class _Dead:
        def __init__(self, *a, **kw):
            pass

        def run(self):
            return 71

    monkeypatch.setattr(
        "racon_tpu_torch.distributed.autoscaler.Autoscaler", _Dead)
    monkeypatch.setenv("RACON_TPU_GATE_FLEET", "1")
    monkeypatch.setenv("RACON_TPU_GATE_FLEET_MIN_TARGETS", "1")
    server = PolishServer(str(tmp_path / "state"))
    job = server.submit("acme", _spec(inputs["sets"][1][0]))
    _wait(job)
    assert (job.state, job.error_type) == ("failed", "FleetDispatchError")
    assert "exited 71" in job.error and job.result_bytes() == b""
    assert server.batchers() == [] and job.launches == {}
    snap = metrics.registry().snapshot()
    assert snap["gate_routed_fleet"] == 1
    assert "gate_routed_local" not in snap and "gate_fleet_runs" not in snap
    server.drain(5.0)


# ------------------------------------------------- the daemon's route

def test_real_supervisor_serves_a_fleet_job(tmp_path, monkeypatch, inputs):
    """An armed daemon routes a 3-contig job to the fleet: a real
    supervisor in the job's runner thread spawns one worker process of
    the port's CLI on ``--device cpu``, and the job's stream is the
    reference CLI's bytes. The worker's metric shard and trace land
    under the ledger's obs/; the daemon's own thread launches nothing.
    Resubmitted, the fingerprint hits the daemon's cache and spawns
    nothing."""
    from racon_tpu_torch.server.daemon import PolishServer
    paths, ref = inputs["sets"][1]
    for k, v in (("RACON_TPU_GATE_FLEET", "1"),
                 ("RACON_TPU_GATE_FLEET_MIN_TARGETS", "2"),
                 ("RACON_TPU_GATE_WORKERS", "1"),
                 (asc.ENV_INTERVAL, "0.1"), ("OMP_NUM_THREADS", "1"),
                 ("PYTHONPATH", os.pathsep.join(
                     [ROOT, os.environ.get("PYTHONPATH", "")]))):
        monkeypatch.setenv(k, v)
    state = str(tmp_path / "state")
    server = PolishServer(state)
    job = server.submit("acme", _spec(paths))
    _wait(job)
    assert job.state == "done", job.error
    assert job.result_bytes() == ref
    assert job.n_committed == 3 and job.launches == {}
    snap = metrics.registry().snapshot()
    assert (snap["gate_routed_fleet"], snap["gate_fleet_runs"]) == (1, 1)
    assert snap["gate_fleet_target"] == 1
    fp = pd.fleet_paths(state, _spec(paths).fingerprint())
    events = [json.loads(ln) for ln in open(os.path.join(
        fp.ledger_dir, "events.jsonl"))]
    spawns = [e for e in events if e["ev"] == "spawn"]
    assert [e["worker"] for e in spawns] == ["as0"]
    obs = os.path.join(fp.ledger_dir, "obs")
    with open(os.path.join(obs, "worker_as0.jsonl")) as fh:
        spans = [json.loads(ln) for ln in fh]
    assert any(sp.get("trace_id") == job.trace.trace_id for sp in spans)
    shard = obs_fleet.load_worker_shards(obs)
    assert [s["records"][-1]["worker_id"] for s in shard] == ["as0"]
    assert os.listdir(fp.cas_dir)
    again = server.submit("acme", _spec(paths))
    _wait(again)
    assert again.state == "done" and again.result_bytes() == ref
    assert metrics.registry().get("cache_hits_total") == 1
    assert metrics.registry().get("gate_routed_fleet") == 1
    assert sum(json.loads(ln)["ev"] == "spawn" for ln in open(
        os.path.join(fp.ledger_dir, "events.jsonl"))) == 1
    server.drain(5.0)


def test_armed_daemon_routes_fleet_and_local(monkeypatch, inputs):
    """An armed daemon ships a big-enough job to the fleet (a finished
    ledger, the short-circuit a resubmitted fingerprint hits) and keeps
    a small one on the in-process batcher; both streams are the
    reference CLI's bytes, and the gate counters tell the routes
    apart."""
    from racon_tpu_torch.server.daemon import PolishServer
    monkeypatch.setenv("RACON_TPU_CACHE", "0")
    monkeypatch.setenv("RACON_TPU_GATE_FLEET", "1")
    monkeypatch.setenv("RACON_TPU_GATE_FLEET_MIN_TARGETS", "1")
    (p1, ref1), (p2, ref2) = inputs["sets"]
    server = PolishServer(inputs["state"])
    j1 = server.submit("acme", _spec(p1))
    _wait(j1)
    monkeypatch.setenv("RACON_TPU_GATE_FLEET_MIN_TARGETS", "99")
    j2 = server.submit("umbrella", _spec(p2))
    _wait(j2)
    server.drain(5.0)
    assert (j1.state, j2.state) == ("done", "done"), (j1.error, j2.error)
    assert j1.result_bytes() == ref1 and j2.result_bytes() == ref2
    snap = metrics.registry().snapshot()
    assert (snap["gate_routed_fleet"], snap["gate_routed_local"],
            snap["gate_fleet_runs"], snap["serve_jobs_completed"]) == \
        (1, 1, 1, 2)
    assert j1.launches == {} and len(server.batchers()) == 1
