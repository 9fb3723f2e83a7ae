"""The port's service core against the JAX package's: JobSpec identity and
fingerprint, the cross-request batcher (the JAX package's six batcher
tests, run on both packages' batchers with a fake engine), the job
journal, and the daemon on the CPU: two tenants' jobs co-riding
dispatches and streaming both CLIs' bytes, the HTTP surface, a daemon
killed at its second commit then restarted to the same bytes, the submit
fault and cancel, the local route and the gateway lease, and no hidden
fallback (a job that asks for the card on a host without one fails
typed; a KernelError in a dispatch ends the daemon non-zero, and a real
breach of a dispatch's deadline stops the batcher). The fleet route is
held in tests/test_torch_gateway.py.

Inputs: tests/serve_inputs.py (tiny drafts and reads from a seed)."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from racon_tpu_torch.obs import metrics
from racon_tpu_torch.resilience import faults as PF

from serve_inputs import (ROOT, port_cli, ref_cli, subprocess_env,
                          write_inputs)


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    from racon_tpu.obs import metrics as rmetrics
    from racon_tpu.resilience import faults as RF
    for name in ("RACON_TPU_FAULTS", "RACON_TPU_CACHE",
                 "RACON_TPU_GATE_FLEET", "RACON_TPU_SERVE_BATCH_WAIT_S",
                 "RACON_TPU_SERVE_BATCH", "RACON_TPU_SERVE_MAX_JOBS",
                 "RACON_TPU_PIPELINE"):
        monkeypatch.delenv(name, raising=False)
    for mod in (PF, RF):
        mod.configure(None)
    for mod in (metrics, rmetrics):
        mod.reset()
    yield
    for mod in (PF, RF):
        mod.configure(None)


@pytest.fixture(scope="module")
def two_inputs(tmp_path_factory):
    """Two input sets (acme's and umbrella's) and the reference CLI's
    bytes on each, which the port's CLI must match."""
    out = []
    for seed, n in ((11, 2), (22, 3)):
        paths = write_inputs(str(tmp_path_factory.mktemp(f"in{seed}")),
                             n_contigs=n, seed=seed)
        rc, ref, err = ref_cli(paths)
        assert rc == 0, err
        rc, port, err = port_cli(paths)
        assert rc == 0, err
        assert port == ref and ref.count(b">") == n
        out.append((paths, ref))
    return out


def _spec(paths, **kw):
    from racon_tpu_torch.server.engine import JobSpec
    kw.setdefault("backend", "cpu")
    return JobSpec(*paths, **kw)


def _wait(job, timeout_s=120.0):
    assert job.finished.wait(timeout_s), \
        f"job {job.id} still {job.state} after {timeout_s}s"


def _close(server):
    for b in server.batchers():
        b.close()


# ---------------------------------------------------------------- JobSpec

@pytest.mark.parametrize("opts", [
    {}, {"window_length": 250, "match": 3, "threads": 4},
    {"include_unpolished": True, "fragment_correction": True,
     "error_threshold": 0.25}])
def test_jobspec_identity_and_fingerprint_match_reference(tmp_path, opts):
    from racon_tpu.server.engine import JobSpec as RJ
    from racon_tpu_torch.server.engine import JobSpec as PJ
    paths = write_inputs(str(tmp_path))
    ref = RJ(*paths, backend="jax", **opts)
    port = PJ(*paths, **opts)
    assert port.identity() == ref.identity()
    assert json.dumps(port.identity(), sort_keys=True) == \
        json.dumps(ref.identity(), sort_keys=True)
    assert port.fingerprint() == ref.fingerprint()
    assert port.backend == "cuda"            # the card unless asked
    clone = PJ.from_dict(port.as_dict())
    assert clone.identity() == port.identity() and clone.paths == paths
    assert set(port.as_dict()) == set(ref.as_dict())
    # A journal the reference wrote loads as a port spec.
    assert PJ.from_dict(ref.as_dict()).fingerprint() == ref.fingerprint()


# ---------------------------------------------------------------- batcher

class _Window:
    """Stand-in with the Window surface the batcher touches."""

    def __init__(self, n=300, layers=3):
        self._n = n
        self.n_layers = layers
        self.polished = False

    def __len__(self):
        return self._n


class _FakeEngine:
    backend = "fake"

    def __init__(self, fail=False, delay_s=0.0):
        self.batches = []
        self.fail = fail
        self.delay_s = delay_s

    def consensus_windows(self, windows):
        self.batches.append(len(windows))
        if self.fail:
            raise RuntimeError("device wedged")
        if self.delay_s:
            time.sleep(self.delay_s)
        for w in windows:
            w.polished = True
        return len(windows)


@pytest.fixture(params=["reference", "port"])
def pkg(request):
    """(batch module, metrics module, faults module) of one package."""
    if request.param == "reference":
        from racon_tpu.obs import metrics as m
        from racon_tpu.resilience import faults as f
        from racon_tpu.server import batch as b
    else:
        from racon_tpu_torch.obs import metrics as m
        from racon_tpu_torch.resilience import faults as f
        from racon_tpu_torch.server import batch as b
    return b, m, f


def _concurrent_consensus(batch, batcher, jobs):
    results = {}

    def run(jid, tenant, windows):
        proxy = batch.BatchedEngineProxy(batcher, jid, tenant)
        try:
            results[jid] = proxy.consensus_windows(windows)
        except Exception as exc:  # collected for assertions
            results[jid] = exc

    threads = [threading.Thread(target=run, args=spec) for spec in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def test_batcher_packs_across_jobs(pkg):
    batch, m, _ = pkg
    eng = _FakeEngine()
    b = batch.CrossRequestBatcher(eng, capacity=32, wait_s=1.0,
                                  queue_cap=8).start()
    try:
        results = _concurrent_consensus(batch, b, [
            ("j1", "acme", [_Window() for _ in range(5)]),
            ("j2", "acme", [_Window() for _ in range(5)]),
            ("j3", "umbrella", [_Window() for _ in range(5)]),
        ])
    finally:
        b.close()
    assert results == {"j1": 5, "j2": 5, "j3": 5}
    assert sum(eng.batches) == 15
    assert len(eng.batches) < 3, "cross-job packing never happened"
    snap = m.registry().snapshot()
    assert snap["serve_batch_windows"] == 15
    assert snap["serve_batch_occupancy"] > 0
    assert snap["serve_batches"] == len(eng.batches)


def test_batcher_splits_oversized_request(pkg):
    batch, _, _ = pkg
    eng = _FakeEngine()
    b = batch.CrossRequestBatcher(eng, capacity=4, wait_s=0.01,
                                  queue_cap=8).start()
    try:
        results = _concurrent_consensus(
            batch, b, [("j1", "acme", [_Window() for _ in range(10)])])
    finally:
        b.close()
    assert results == {"j1": 10}
    assert max(eng.batches) <= 4


def test_batcher_tenant_fairness(pkg):
    batch, _, _ = pkg
    eng = _FakeEngine()
    b = batch.CrossRequestBatcher(eng, capacity=4, wait_s=60.0,
                                  queue_cap=64)
    for i in range(6):
        b._stage(batch._WorkItem(f"a{i}", "acme", [_Window(), _Window()]))
    b._stage(batch._WorkItem("u0", "umbrella", [_Window(), _Window()]))
    assert {it.tenant for it in b._compose()} == {"acme", "umbrella"}


def test_batcher_flush_deadline_dispatches_partial(pkg):
    batch, _, _ = pkg
    eng = _FakeEngine()
    b = batch.CrossRequestBatcher(eng, capacity=1024, wait_s=0.05,
                                  queue_cap=8).start()
    try:
        t0 = time.perf_counter()
        results = _concurrent_consensus(
            batch, b, [("j1", "acme", [_Window() for _ in range(3)])])
        elapsed = time.perf_counter() - t0
    finally:
        b.close()
    assert results == {"j1": 3}
    assert elapsed < 5.0


def test_batcher_dispatch_failure_fans_out_to_jobs(pkg):
    batch, _, _ = pkg
    eng = _FakeEngine(fail=True)
    b = batch.CrossRequestBatcher(eng, capacity=32, wait_s=0.5,
                                  queue_cap=8).start()
    try:
        results = _concurrent_consensus(batch, b, [
            ("j1", "acme", [_Window() for _ in range(2)]),
            ("j2", "umbrella", [_Window() for _ in range(2)]),
        ])
    finally:
        b.close()
    assert all(isinstance(v, batch.ServeError) for v in results.values())


def test_batcher_injected_dispatch_fault(pkg):
    batch, m, f = pkg
    f.configure("serve/dispatch:0")
    eng = _FakeEngine()
    b = batch.CrossRequestBatcher(eng, capacity=32, wait_s=0.5,
                                  queue_cap=8).start()
    try:
        results = _concurrent_consensus(
            batch, b, [("j1", "acme", [_Window() for _ in range(2)])])
        # The batcher serves on after an injected fault.
        again = _concurrent_consensus(
            batch, b, [("j2", "acme", [_Window() for _ in range(2)])])
    finally:
        b.close()
    assert isinstance(results["j1"], batch.ServeError)
    assert again == {"j2": 2}
    assert m.registry().snapshot()["res_fault_site_serve_dispatch"] == 1


def test_batcher_device_loss_stops_dispatching():
    """A KernelError in a dispatch (a sticky CUDA error) fails its batch,
    calls on_fatal once, and every later item fails without reaching the
    engine; an injected fault or a timeout does not."""
    from racon_tpu_torch.ops.kernels import KernelError
    from racon_tpu_torch.server import batch
    assert not batch.device_lost(TimeoutError("slow"))
    assert not batch.device_lost(PF.InjectedFault("serve/dispatch", 0))
    wrapped = RuntimeError("outer")
    wrapped.__cause__ = KernelError("launch failed")
    assert batch.device_lost(wrapped)

    class Broken(_FakeEngine):
        def consensus_windows(self, windows):
            self.batches.append(len(windows))
            raise KernelError("band_fwd launch failed (injected)")

    eng, lost = Broken(), []
    b = batch.CrossRequestBatcher(eng, capacity=8, wait_s=0.01,
                                  queue_cap=8, on_fatal=lost.append).start()
    try:
        first = _concurrent_consensus(batch, b, [("j1", "a", [_Window()])])
        later = _concurrent_consensus(batch, b, [("j2", "a", [_Window()])])
    finally:
        b.close()
    assert isinstance(first["j1"], batch.ServeError)
    assert isinstance(later["j2"], batch.ServeError)
    assert eng.batches == [1] and len(lost) == 1
    assert isinstance(b.fatal, KernelError)
    assert [d["error"] is not None for d in b.dispatches] == [True, True]


def test_batcher_real_breach_stops_dispatching(monkeypatch):
    """A dispatch that overruns its serve/dispatch deadline with no
    injected fault behind it keeps running on an abandoned watchdog
    thread: the batcher takes the device as lost (on_fatal, later items
    fail unsent), while an injected breach only fails its batch."""
    from racon_tpu_torch.resilience import watchdog
    from racon_tpu_torch.resilience.watchdog import DispatchTimeout
    from racon_tpu_torch.server import batch
    assert batch.device_lost(DispatchTimeout("serve/dispatch", 0.1, 0.2))
    assert not batch.device_lost(
        DispatchTimeout("serve/dispatch", 0.1, 0.2, injected=True))
    monkeypatch.setenv("RACON_TPU_DEADLINE_DISPATCH", "0.05")
    monkeypatch.setenv("RACON_TPU_DEADLINE_CELLS_PER_S", "1e12")
    eng, lost = _FakeEngine(delay_s=0.5), []
    b = batch.CrossRequestBatcher(eng, capacity=8, wait_s=0.01,
                                  queue_cap=8, on_fatal=lost.append).start()
    try:
        first = _concurrent_consensus(batch, b, [("j1", "a", [_Window()])])
        later = _concurrent_consensus(batch, b, [("j2", "a", [_Window()])])
    finally:
        b.close()
        watchdog.reset()
    assert isinstance(first["j1"], batch.ServeError)
    assert isinstance(first["j1"].__cause__, DispatchTimeout)
    assert isinstance(later["j2"], batch.ServeError)
    assert eng.batches == [1] and lost == [b.fatal]
    assert isinstance(b.fatal, DispatchTimeout) and not b.fatal.injected


# ------------------------------------------------------------ job journal

def test_job_journal_roundtrip_and_id_allocation(tmp_path):
    from racon_tpu.server.jobs import Job as RJob
    from racon_tpu.server.jobs import scan as rscan
    from racon_tpu_torch.server.jobs import Job, allocate_id, scan
    root = str(tmp_path)
    assert allocate_id(root) == "j0001"
    d = os.path.join(root, "j0001")
    os.makedirs(d)
    job = Job("j0001", "acme", _spec(["r.fa", "o.paf", "d.fa"],
                                     window_length=123), d)
    job.persist()
    assert allocate_id(root) == "j0002"
    loaded = scan(root)
    assert [(j.id, j.tenant, j.state) for j in loaded] == \
        [("j0001", "acme", "queued")]
    assert loaded[0].spec.identity() == job.spec.identity()
    job.state, job.error, job.error_type = "failed", "boom", "DeviceError"
    job.persist()
    again = scan(root)[0]
    assert (again.state, again.error, again.error_type) == \
        ("failed", "boom", "DeviceError")
    # The reference reads the port's journal, and the reverse.
    assert rscan(root)[0].spec.identity() == job.spec.identity()
    rd = os.path.join(root, "j0002")
    os.makedirs(rd)
    from racon_tpu.server.engine import JobSpec as RJ
    RJob("j0002", "umbrella", RJ("r.fa", "o.paf", "d.fa"), rd).persist()
    assert [j.tenant for j in scan(root)] == ["acme", "umbrella"]


# ------------------------------------------------------------ the daemon

def test_daemon_two_tenants_match_both_clis(tmp_path, two_inputs,
                                            monkeypatch):
    """Two tenants' jobs through the shared batcher: each stream is the
    reference CLI's bytes (= the port CLI's), and their windows co-ride a
    dispatch (a 4 s batch wait)."""
    from racon_tpu_torch.server.daemon import PolishServer
    monkeypatch.setenv("RACON_TPU_SERVE_BATCH_WAIT_S", "4")
    monkeypatch.setenv("RACON_TPU_CACHE", "0")
    server = PolishServer(str(tmp_path / "state"))
    jobs = [server.submit(tenant, _spec(paths))
            for tenant, (paths, _) in zip(("acme", "umbrella"),
                                          two_inputs)]
    for job in jobs:
        _wait(job)
    _close(server)
    for job, (_, ref) in zip(jobs, two_inputs):
        assert job.state == "done", job.error
        assert job.result_bytes() == ref
    dispatches = [d for b in server.batchers() for d in b.dispatches]
    assert any(len(d["tenants"]) == 2 for d in dispatches), dispatches
    snap = metrics.registry().snapshot()
    assert snap["serve_jobs_submitted"] == snap["serve_jobs_completed"] == 2
    assert snap["gate_routed_local"] == 2
    assert snap["res_ckpt_commits"] == 5
    assert server.describe()["active"] == 0


def test_daemon_http_surface(tmp_path, two_inputs):
    """submit/status/stream/cancel over the wire, /healthz, the
    OpenMetrics render, and a Tier-1 hit on the resubmission."""
    from racon_tpu_torch.obs.export import validate_openmetrics
    from racon_tpu_torch.server.daemon import PolishServer, serve_http
    paths, ref = two_inputs[0]
    server = PolishServer(str(tmp_path / "state"))
    httpd = serve_http(server, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, body=None):
        req = urllib.request.Request(
            url + path, data=json.dumps(body or {}).encode(),
            method="POST")
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())

    try:
        body = {"tenant": "acme", "sequences": paths[0],
                "overlaps": paths[1], "targets": paths[2],
                "options": {"backend": "cpu"}}
        ids = []
        for _ in range(2):
            status, sub = post("/v1/jobs", body)
            assert status == 202
            ids.append(sub["id"])
            _wait(server.get(sub["id"]))
        assert ids == ["j0001", "j0002"]
        for jid in ids:
            with urllib.request.urlopen(f"{url}/v1/jobs/{jid}") as r:
                assert json.loads(r.read())["state"] == "done"
            with urllib.request.urlopen(f"{url}/v1/jobs/{jid}/stream") as r:
                assert r.headers["X-Racon-State"] == "done"
                assert r.read() == ref
        assert metrics.registry().get("cache_hits_total") == 1
        with urllib.request.urlopen(f"{url}/healthz") as r:
            health = json.loads(r.read())
        assert health["status"] == "ok"
        assert [j["id"] for j in health["serve"]["jobs"]] == ids
        with urllib.request.urlopen(f"{url}/metrics") as r:
            text = r.read().decode()
        assert validate_openmetrics(text) == []
        assert "racon_tpu_serve_jobs_completed_total 2" in text
        assert post(f"/v1/jobs/{ids[0]}/cancel")[1]["state"] == "done"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{url}/v1/jobs/j9999")
        assert ei.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            post("/v1/jobs", dict(body, options={"bogus": 1}))
        assert ei.value.code == 400
    finally:
        httpd.shutdown()
        _close(server)


def test_openmetrics_render_matches_reference():
    from racon_tpu.obs import export as rexport
    from racon_tpu.obs import metrics as rmetrics
    from racon_tpu_torch.obs import export
    for m in (metrics, rmetrics):
        m.record_serve_batch(40, 256, ["j1", "j2"], ["a", "b"], 0.1,
                             round_s=0.3)
        m.record_serve_job("submitted", "j1", "a")
        m.record_hist("serve_job_latency_s", 1.5)
        m.record_cache("job", "hit")
        m.record_ckpt("commit", 0, 30)
        m.registry().set("serve_active_jobs", 2)
    port = export.render_registry(metrics.registry().snapshot())
    ref = rexport.render_registry(rmetrics.registry().snapshot())
    strip = ("serve_rate_wall_s",)
    assert [ln for ln in port.splitlines() if not any(s in ln for s in strip)] \
        == [ln for ln in ref.splitlines() if not any(s in ln for s in strip)]
    assert export.validate_openmetrics(port) == []
    assert export.validate_openmetrics("x 1\n") != []
    assert metrics.hist_quantile(
        metrics.registry().get("serve_job_latency_s"), 0.5,
        metrics.HIST_BUCKETS["serve_job_latency_s"]) == \
        rmetrics.hist_quantile(
            rmetrics.registry().get("serve_job_latency_s"), 0.5,
            rmetrics.HIST_BUCKETS["serve_job_latency_s"])
    for key in ("serve_batch_occupancy", "serve_queue_depth_peak",
                "dispatch_round_s", "cache_hits_total", "res_ckpt_bytes"):
        assert metrics.merge_kind(key) == rmetrics.merge_kind(key)


def test_daemon_killed_at_commit_restarts_to_the_same_bytes(tmp_path,
                                                            two_inputs):
    """A daemon subprocess killed at its second commit
    (serve/commit:1!kill: rc 137, one contig durable, the journal still
    "running") is re-queued by a fresh daemon, which re-emits the
    committed prefix from the shard and streams the CLI's bytes; a third
    daemon serves the terminal job's stream rebuilt from its store."""
    from racon_tpu_torch.server.daemon import PolishServer
    paths, ref = two_inputs[1]
    state = str(tmp_path / "state")
    proc = subprocess.Popen(
        [sys.executable, "-m", "racon_tpu_torch.server", "--state-dir",
         state, "--port", "0"], cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE,
        env=subprocess_env(RACON_TPU_FAULTS="serve/commit:1!kill"))
    try:
        port_file = os.path.join(state, "port")
        t0 = time.perf_counter()
        while not os.path.exists(port_file):
            assert proc.poll() is None, proc.stderr.read().decode()
            assert time.perf_counter() - t0 < 120
            time.sleep(0.05)
        with open(port_file) as fh:
            url = f"http://127.0.0.1:{int(fh.read())}/v1/jobs"
        body = json.dumps({"tenant": "acme", "sequences": paths[0],
                           "overlaps": paths[1], "targets": paths[2],
                           "options": {"backend": "cpu"}}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                url, data=body, method="POST")) as r:
            job_id = json.loads(r.read())["id"]
        rc = proc.wait(timeout=120)
        err = proc.stderr.read().decode()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 137, err[-2000:]
    with open(os.path.join(state, "jobs", job_id, "job.json")) as fh:
        assert json.load(fh)["state"] == "running"
    server = PolishServer(state)
    assert server.recover() == 1
    job = server.get(job_id)
    _wait(job)
    _close(server)
    assert job.state == "done", job.error
    assert job.result_bytes() == ref
    snap = metrics.registry().snapshot()
    assert snap["serve_jobs_resumed"] == 1 and snap["res_ckpt_skips"] >= 1
    third = PolishServer(state)
    assert third.recover() == 0
    assert third.get(job_id).result_bytes() == ref


def test_daemon_submit_fault_and_cancel(tmp_path, two_inputs):
    """serve/submit faults reach the submitter before any journal write;
    a job cancelled while queued (one job at a time) never runs."""
    from racon_tpu_torch.server.daemon import PolishServer
    from racon_tpu_torch.server.jobs import scan
    paths, ref = two_inputs[0]
    os.environ["RACON_TPU_SERVE_MAX_JOBS"] = "1"
    try:
        server = PolishServer(str(tmp_path / "state"))
    finally:
        os.environ.pop("RACON_TPU_SERVE_MAX_JOBS")
    PF.configure("serve/submit:0")
    with pytest.raises(PF.InjectedFault):
        server.submit("acme", _spec(paths))
    assert scan(server.jobs_root) == []
    PF.configure(None)
    first = server.submit("acme", _spec(paths))
    queued = server.submit("acme", _spec(two_inputs[1][0]))
    server.cancel(queued.id)
    _wait(first)
    _wait(queued)
    _close(server)
    assert first.state == "done" and first.result_bytes() == ref
    assert queued.state == "cancelled" and queued.result_bytes() == b""
    assert [j.state for j in scan(server.jobs_root)] == ["done",
                                                         "cancelled"]


def test_cuda_job_without_a_gpu_fails_typed(tmp_path, two_inputs,
                                            monkeypatch):
    """A job that does not ask for the CPU fails with a DeviceError in
    its status on a host without a GPU; it is never served on the
    CPU."""
    import torch
    from racon_tpu_torch.server.daemon import PolishServer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("RACON_TPU_CACHE", "0")
    server = PolishServer(str(tmp_path / "state"))
    job = server.submit("acme", _spec(two_inputs[0][0], backend="cuda"))
    _wait(job)
    _close(server)
    st = job.status()
    assert (st["state"], st["error_type"]) == ("failed", "DeviceError")
    assert "no CUDA device is available" in st["error"]
    assert job.result_bytes() == b""
    assert server.fatal is None


def test_kernel_error_in_a_dispatch_ends_the_daemon(tmp_path, two_inputs):
    """A KernelError in a consensus dispatch: the job fails, the daemon
    stops admitting and ``main`` exits 1 (a daemon subprocess whose
    engine's kernels fail)."""
    paths, _ = two_inputs[0]
    state = str(tmp_path / "state")
    script = f"""
import json, os, sys, threading, time, urllib.request
from racon_tpu_torch.ops import kernels
from racon_tpu_torch.ops.poa import PoaEngine
def broken(self, windows):
    raise kernels.KernelError("band_fwd launch failed (injected)")
PoaEngine.consensus_windows = broken
state = {state!r}
def client():
    port_file = os.path.join(state, "port")
    while not os.path.exists(port_file):
        time.sleep(0.05)
    url = "http://127.0.0.1:%d/v1/jobs" % int(open(port_file).read())
    body = json.dumps({{"tenant": "acme", "sequences": {paths[0]!r},
                       "overlaps": {paths[1]!r}, "targets": {paths[2]!r},
                       "options": {{"backend": "cpu"}}}}).encode()
    urllib.request.urlopen(urllib.request.Request(url, data=body,
                                                  method="POST")).read()
threading.Thread(target=client, daemon=True).start()
from racon_tpu_torch.server.daemon import main
sys.exit(main(["--state-dir", state, "--port", "0"]))
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, timeout=180,
                         env=subprocess_env(RACON_TPU_CACHE="0"))
    err = out.stderr.decode()
    assert out.returncode == 1, err[-2000:]
    assert "device lost" in err and "exiting: the device was lost" in err
    with open(os.path.join(state, "jobs", "j0001", "job.json")) as fh:
        rec = json.load(fh)
    assert (rec["state"], rec["error_type"]) == ("failed", "ServeError")
    assert "band_fwd launch failed" in rec["error"]


def test_jobs_route_local_and_gateway_lease(tmp_path):
    """With the fleet gate off every job routes local, reason
    fleet-disabled, as the JAX package routes it; gate/route fires
    before the decision. The state-dir lease: one holder, adoption of
    an expired lease bumps the epoch, the loser's renew fails."""
    from racon_tpu.gateway import dispatch as rd
    from racon_tpu_torch.gateway import dispatch as pd
    from racon_tpu_torch.gateway.ha import GatewayLease, GatewayLeaseLost
    ref = rd.decide_route(_spec(["r", "o", "t"]), 0, 3)
    assert tuple(pd.decide_route(_spec(["r", "o", "t"]), 0, 3)) == \
        tuple(ref)
    assert not pd.fleet_enabled() and not rd.fleet_enabled()
    PF.configure("gate/route:0")
    with pytest.raises(PF.InjectedFault):
        pd.decide_route(None, 0)
    PF.configure(None)
    state = str(tmp_path)
    a = GatewayLease(state, "gw-a", lease_s=30.0)
    b = GatewayLease(state, "gw-b", lease_s=30.0)
    assert a.try_acquire() and not a.adopted
    assert not b.try_acquire()               # live lease
    a.renew()
    PF.configure("skew=60")                  # a's lease looks expired
    assert b.try_acquire() and b.adopted and b.epoch == 2
    PF.configure(None)
    with pytest.raises(GatewayLeaseLost):
        a.renew()
    b.release()
    c = GatewayLease(state, "gw-c", lease_s=30.0)
    assert c.try_acquire() and not c.adopted and c.epoch == 3


def test_registry_updates_from_many_threads_lose_nothing():
    """The daemon's job threads, dispatcher and HTTP handlers share the
    one registry: 16 threads (more than this host's cores) under a short
    switch interval record batches, cache events and pipeline counters;
    no update is lost and the derived gauges match their totals."""
    from racon_tpu_torch.pipeline.metrics import record_h2d
    n_threads, n = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for k in range(n):
                metrics.record_serve_batch(1 + (k % 3), 256, ["j"], ["t"],
                                           0.0)
                metrics.record_cache("window", "hit" if k % 2 else "miss")
                record_h2d(10, 0.0)

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = metrics.registry().snapshot()
    total = n_threads * n
    windows = n_threads * sum(1 + (k % 3) for k in range(n))
    assert snap["serve_batches"] == total
    assert snap["serve_batch_windows"] == windows
    assert snap["serve_batch_occupancy"] == round(windows / (total * 256), 4)
    assert snap["cache_hits_total"] + snap["cache_misses_total"] == total
    assert snap["cache_hit_ratio"] == 0.5
    assert snap["h2d_transfers"] == total and snap["h2d_bytes"] == 10 * total
