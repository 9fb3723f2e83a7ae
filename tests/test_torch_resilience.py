"""The port's fault plane (racon_tpu_torch/resilience/, the deadlines of
ops/budget.py) against the JAX package's (racon_tpu/resilience/, run
under JAX_PLATFORMS=cpu):

- the fault grammar: both injectors decide the same call indices for
  every spec of the reference's tests and for ``p=`` specs over indices
  0..999 at three seeds, and refuse the same specs;
- the retry policy's backoff on a grid of attempts and sites, and the
  ``RACON_TPU_RETRY`` parsing and its errors; the transient classes,
  where the port differs from the reference on purpose (CUDA errors);
- the deadlines under every ``RACON_TPU_DEADLINE_*`` override;
- the guard: results and exceptions pass through, a breach raises
  DispatchTimeout, terminal escalation, an abandoned attempt never runs
  its body, and the body's launches are charged to the caller's thread
  (it runs on a watchdog thread);
- the engine on ``--device cpu`` against the reference engine with
  ``backend="jax"`` under fault specs, both chunk drivers: the consensus
  equals the clean run's and the reference's, and the ``res_*`` counters
  are equal between the two packages; a KernelError is never retried or
  degraded, a one-shot out-of-memory error is retried;
- where the port degrades: only an injected failure or an upload's; a
  real deadline breach or out-of-memory where kernels run ends the run
  (exit 1, nothing degraded), and the redo's degraded chunks are
  counted like the engine's;
- ``RACON_TPU_TIMING=1``: the same bytes and one stderr line a round,
  with a one-shot ``h2d/chunk`` fault absorbed.
"""

import contextlib
import io
import threading
import time

import pytest
import torch

from racon_tpu_torch.ops import device_poa as P
from racon_tpu_torch.ops import budget as PB
from racon_tpu_torch.ops import kernels
from racon_tpu_torch.pipeline import metrics
from racon_tpu_torch.resilience import faults as F
from racon_tpu_torch.resilience import retry as RT
from racon_tpu_torch.resilience import watchdog as W
from racon_tpu_torch.utils import env

from window_sets import port_windows, reference_windows

_ENVS = (env.FAULTS, env.RETRY, env.DEADLINE_H2D, env.DEADLINE_D2H,
         env.DEADLINE_DISPATCH, env.DEADLINE_MBPS, env.DEADLINE_CELLS_PER_S,
         env.DEADLINE_SCALE, env.WATCHDOG_TERMINAL, env.FAULT_HANG_S,
         env.FAULT_STALL_S, env.TIMING, env.SCHED, env.ADAPTIVE,
         env.PIPELINE, env.STALL_S, env.TRACE)


def _reset_all():
    from racon_tpu.obs import metrics as r_metrics
    from racon_tpu.resilience import faults as rf, retry as rr
    from racon_tpu.resilience import watchdog as rw
    for mod in (F, rf):
        mod.configure(None)
    for mod in (RT, rr):
        mod.configure(None)
    W.reset()
    rw.reset()
    metrics.reset()
    r_metrics.reset()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No gate from the caller's environment; both packages' injectors,
    policies, watchdog state, counters and cap histories start empty."""
    from racon_tpu.ops import device_poa as R
    for name in _ENVS:
        monkeypatch.delenv(name, raising=False)
    for mod in (R, P):
        monkeypatch.setattr(mod, "_CAP_HISTORY", set())
        monkeypatch.setattr(mod, "_BAND_HISTORY", set())
    _reset_all()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    _reset_all()


# ------------------------------------------------------- fault grammar

# Every spec the reference's tests use (tests/test_resilience.py,
# tests/test_failslow.py, the fault module's docstring), plus this
# slice's chip_smoke specs.
_SPECS = (
    "h2d/chunk:0,1,2", "x/y:0,2", "s:p=0.5;seed=1", "s:p=0.5;seed=2",
    "a:0!hang=0.5;b:1!stall=2", "a:0!hang", "x/y:0!stall=0.3",
    "h2d/chunk:p=1.0", "h2d/chunk:0", "h2d/chunk:0!hang=0.6",
    "pipe/pack:0!hang=3", "d2h/chunk:p=0.05;seed=7", "ckpt/commit:1!kill",
    "dist/contig:1!kill", "ckpt/manifest:0!torn", "skew=9999",
    "h2d/chunk:0,1;sched/flags:3;h2d/repack:0;d2h/chunk:4",
    "dispatch/chunk:2;d2h/chunk:1", "dispatch/chunk:1!hang=2",
    " io/read : 3 ; io/inflate:p=0.25 ; seed=11 ",
)


def _rules(inj):
    return {site: (r.indices, r.prob, r.action, r.duration)
            for site, r in inj._rules.items()}


@pytest.mark.parametrize("spec", _SPECS)
def test_fault_spec_decisions_match_reference(spec):
    from racon_tpu.resilience import faults as rf
    port, ref = F.FaultInjector(spec), rf.FaultInjector(spec)
    assert _rules(port) == _rules(ref)
    assert (port.seed, port.skew, port.sites()) == \
        (ref.seed, ref.skew, ref.sites())
    for site in port.sites() + ("other/site",):
        assert [port._decide(site, i) for i in range(64)] == \
            [ref._decide(site, i) for i in range(64)], site


@pytest.mark.parametrize("seed", [0, 7, 123456789])
@pytest.mark.parametrize("p", [0.05, 0.5, 0.97])
def test_probability_decisions_match_reference(seed, p):
    from racon_tpu.resilience import faults as rf
    spec = f"d2h/chunk:p={p};seed={seed}"
    port, ref = F.FaultInjector(spec), rf.FaultInjector(spec)
    got = [port._decide("d2h/chunk", i) for i in range(1000)]
    assert got == [ref._decide("d2h/chunk", i) for i in range(1000)]
    # A seed passed to the constructor overrides the spec's.
    over = F.FaultInjector(f"d2h/chunk:p={p}", seed=seed)
    assert [over._decide("d2h/chunk", i) for i in range(1000)] == got
    assert abs(sum(g is not None for g in got) / 1000 - p) < 0.06


@pytest.mark.parametrize("bad", [
    "h2d/chunk", "s:p=1.5", "s:x,y", "s:0!explode", "seed=abc", ":0",
    "s:0!stall=x", "s:0!raise=3", "s:0!hang=-1", "s:0!kill=2", "skew=x",
    "s:-1", "s:p=-0.1"])
def test_fault_spec_errors_match_reference(bad):
    from racon_tpu.resilience import faults as rf
    with pytest.raises(rf.FaultSpecError) as ref:
        rf.FaultInjector(bad)
    with pytest.raises(F.FaultSpecError) as port:
        F.FaultInjector(bad)
    assert str(port.value).replace("racon_tpu_torch::", "racon_tpu::") == \
        str(ref.value)


def test_injector_check_counts_and_fires():
    """The reference's explicit-index case on the port: raises at the
    listed indices, counts every call, records what fired and counts it
    in the registry; ``stall`` sleeps and proceeds."""
    inj = F.FaultInjector("x/y:0,2;s/t:1!stall=0.2")
    with pytest.raises(F.InjectedFault) as ei:
        inj.check("x/y")
    assert (ei.value.site, ei.value.index) == ("x/y", 0)
    inj.check("x/y")
    with pytest.raises(F.InjectedFault):
        inj.check("x/y")
    inj.check("other/site")
    inj.check("s/t")
    t0 = time.monotonic()
    assert inj.check("s/t") is False
    assert time.monotonic() - t0 >= 0.15
    assert inj.counts() == {"x/y": 3, "other/site": 1, "s/t": 2}
    assert [f[:2] for f in inj.fired] == [("x/y", 0), ("x/y", 2),
                                         ("s/t", 1)]
    snap = metrics.registry().snapshot()
    assert snap["res_fault_injected_total"] == 3
    assert snap["res_fault_site_x_y"] == 2
    F.configure(None)
    F.maybe_fault("h2d/chunk")          # unarmed: a no-op


def test_sites_table_lists_the_ports_sites():
    assert F.SITES == tuple(sorted(F.SITES))
    assert set(F.SITES) == {"d2h/chunk", "dispatch/chunk", "dispatch/walk",
                            "h2d/chunk", "h2d/repack", "io/inflate",
                            "io/read", "sched/flags", "cache/load",
                            "cache/store", "ckpt/commit", "ckpt/manifest",
                            "gate/adopt", "gate/route", "obs/flight",
                            "serve/commit", "serve/dispatch",
                            "serve/submit", "dist/claim", "dist/contig",
                            "dist/merge", "dist/merge_write",
                            "dist/shard", "dist/split", "obs/snapshot"}
    assert F.SITE_PREFIXES == ("pipe/",)


def test_faults_armed_from_env(monkeypatch):
    monkeypatch.setenv(env.FAULTS, "h2d/chunk:1;skew=2.5")
    F._ARMED = False
    inj = F.get_injector()
    assert inj is not None and inj.sites() == ("h2d/chunk",)
    assert F.clock_skew() == 2.5
    F.maybe_fault("h2d/chunk")
    with pytest.raises(F.InjectedFault):
        F.maybe_fault("h2d/chunk")
    F.configure("a/b:0!torn")
    assert F.maybe_torn("a/b") is True
    with pytest.raises(F.InjectedFault):
        F.configure("a/b:0!torn").check("a/b")   # no write to tear


# --------------------------------------------------------- retry policy

_POLICIES = (dict(), dict(attempts=5, base=0.05, seed=3),
             dict(attempts=10, base=1.0, multiplier=4.0, max_delay=2.5,
                  jitter=0.0),
             dict(attempts=8, base=0.2, jitter=0.5, seed=99))


@pytest.mark.parametrize("kw", _POLICIES)
def test_backoff_matches_reference(kw):
    from racon_tpu.resilience import retry as rr
    port, ref = RT.RetryPolicy(**kw), rr.RetryPolicy(**kw)
    for site in ("", "h2d/chunk", "d2h/chunk", "sched/flags",
                 "dispatch/walk"):
        for attempt in range(1, 12):
            assert port.delay(attempt, site) == ref.delay(attempt, site)
        assert port.schedule(site) == ref.schedule(site)


@pytest.mark.parametrize("spec", [
    "", "attempts=7,base=0.2,seed=9", "attempts=1", " jitter=0 , max_delay=0.5",
    "attempts", "attempts=x", "attempts=0", "foo=1", "base=1,seed=2.5"])
def test_retry_env_matches_reference(monkeypatch, spec):
    from racon_tpu.resilience import retry as rr

    def outcome(mod):
        mod.configure(None)
        try:
            pol = mod.default_policy()
        except Exception as exc:  # noqa: BLE001 — compared below
            return type(exc).__name__, str(exc).replace(
                "racon_tpu_torch::", "racon_tpu::")
        return tuple(getattr(pol, k) for k in RT.RetryPolicy.__slots__)

    monkeypatch.setenv(env.RETRY, spec)
    assert outcome(RT) == outcome(rr)


@pytest.mark.parametrize("exc, transient", [
    (F.InjectedFault("h2d/chunk", 0), True),
    (ConnectionError("x"), True), (TimeoutError("x"), True),
    (W.DispatchTimeout("d2h/chunk", 1.0, 1.5), True), (OSError("x"), True),
    (torch.OutOfMemoryError("CUDA out of memory"), True),
    (kernels.KernelError("band_fwd launch failed"), False),
    (torch.AcceleratorError("illegal memory access"), False),
    (RuntimeError("CUDA error: device-side assert"), False),
    (W.WatchdogTerminal("dispatch/chunk", 1, 1), False),
    (KeyError("x"), False), (ValueError("x"), False)])
def test_transient_classes(exc, transient):
    """The port retries what the reference retries, minus the runtime
    errors: on CUDA a kernel's error is sticky and asynchronous, so it
    must end the run, not be retried or degraded."""
    assert RT.is_transient(exc) is transient


def _exhausted(site, exc):
    return RT.RetryExhausted(site, 2, exc)


@pytest.mark.parametrize("site, exc, degradable", [
    ("dispatch/chunk", F.InjectedFault("dispatch/chunk", 0), True),
    ("d2h/chunk", F.InjectedFault("d2h/chunk", 3), True),
    ("d2h/chunk", W.DispatchTimeout("d2h/chunk", 1.0, 1.5), False),
    ("d2h/chunk", W.DispatchTimeout("d2h/chunk", 1.0, 1.5, True), True),
    ("sched/flags", W.DispatchTimeout("sched/flags", 1.0, 1.5), False),
    ("dispatch/walk", torch.OutOfMemoryError("CUDA out of memory"), False),
    ("dispatch/chunk", torch.OutOfMemoryError("CUDA out of memory"), False),
    ("h2d/chunk", torch.OutOfMemoryError("CUDA out of memory"), True),
    ("h2d/repack", W.DispatchTimeout("h2d/repack", 1.0, 1.5), True),
    ("h2d/chunk", OSError("pin failed"), True)])
def test_exhaustion_degrades_only_injected_or_upload(site, exc, degradable):
    """A chunk may go to the host path only where that hides no kernel:
    the last failure was injected, or the site is an upload."""
    assert _exhausted(site, exc).degradable is degradable


def test_breach_of_an_injected_hang_is_injected():
    """A breach while the body sleeps in an injected hang is injected (it
    degrades); a breach of a body that is just slow is not."""
    pol = RT.RetryPolicy(attempts=1, base=0.0, jitter=0.0)
    F.configure("dispatch/chunk:0!hang=0.4")
    with pytest.raises(RT.RetryExhausted) as ei:
        RT.call("dispatch/chunk", lambda: "late", policy=pol, deadline_s=0.1)
    assert ei.value.last.injected and ei.value.degradable
    F.configure(None)
    with pytest.raises(RT.RetryExhausted) as ei:
        RT.call("dispatch/chunk", time.sleep, 0.4, policy=pol,
                deadline_s=0.1)
    assert isinstance(ei.value.last, W.DispatchTimeout)
    assert not ei.value.last.injected and not ei.value.degradable
    time.sleep(0.5)                 # let both abandoned workers end


def test_call_recovers_counts_and_exhausts():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("hiccup")
        return 42

    pol = RT.RetryPolicy(attempts=4, base=0.0, jitter=0.0)
    assert RT.call("t/site", flaky, policy=pol) == 42
    assert len(calls) == 3
    with pytest.raises(KeyError):
        RT.call("t/site", lambda: {}["x"], policy=pol)
    with pytest.raises(RT.RetryExhausted) as ei:
        RT.call("d2h/chunk", lambda: (_ for _ in ()).throw(
            TimeoutError("down")), policy=RT.RetryPolicy(3, 0.0, jitter=0))
    assert (ei.value.site, ei.value.attempts) == ("d2h/chunk", 3)
    assert isinstance(ei.value.__cause__, TimeoutError)
    F.configure("h2d/chunk:0,1,2")
    assert RT.call("h2d/chunk", lambda: "ok", policy=pol) == "ok"
    snap = metrics.registry().snapshot()
    assert snap["res_retry_total"] == 2 + 2 + 3
    assert snap["res_retry_site_t_site"] == 2
    assert snap["res_retry_exhausted"] == 1
    assert snap["res_fault_injected_total"] == 3


# ------------------------------------------------------------ deadlines

@pytest.mark.parametrize("over", [
    {}, {env.DEADLINE_H2D: "10"}, {env.DEADLINE_MBPS: "1.0"},
    {env.DEADLINE_SCALE: "2.0"},
    {env.DEADLINE_H2D: "10", env.DEADLINE_MBPS: "1.0",
     env.DEADLINE_SCALE: "2.0"},
    {env.DEADLINE_H2D: "0"}, {env.DEADLINE_D2H: "7.5"},
    {env.DEADLINE_DISPATCH: "-1"}, {env.DEADLINE_DISPATCH: "0.5"},
    {env.DEADLINE_CELLS_PER_S: "1e3"}])
def test_deadlines_match_reference(monkeypatch, over):
    from racon_tpu.ops import budget as rb
    from racon_tpu.resilience import watchdog as rw
    for k, v in over.items():
        monkeypatch.setenv(k, v)
    for nbytes in (0, 10 ** 6, 10 ** 7, -5, 3 * 4160 * 640):
        for d in ("h2d", "d2h"):
            assert PB.transfer_deadline_s(nbytes, d) == \
                rb.transfer_deadline_s(nbytes, d)
    for cells in (0, 4 * 10 ** 6, 4096 * 640 * 256 * 4):
        assert PB.dispatch_deadline_s(cells) == rb.dispatch_deadline_s(cells)
    for site in F.SITES + ("pipe/pack", "ckpt/commit"):
        assert W.site_deadline(site) == rw.site_deadline(site), site


@pytest.mark.parametrize("over, call", [
    ({env.DEADLINE_H2D: "abc"}, lambda m: m.transfer_deadline_s(0, "h2d")),
    ({env.DEADLINE_MBPS: "0"}, lambda m: m.transfer_deadline_s(1, "h2d")),
    ({env.DEADLINE_SCALE: "0"}, lambda m: m.dispatch_deadline_s(1)),
    ({env.DEADLINE_CELLS_PER_S: "-2"}, lambda m: m.dispatch_deadline_s(1)),
    ({}, lambda m: m.transfer_deadline_s(0, "sideways"))])
def test_deadline_errors_match_reference(monkeypatch, over, call):
    from racon_tpu.ops import budget as rb
    for k, v in over.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError) as ref:
        call(rb)
    with pytest.raises(ValueError) as port:
        call(PB)
    assert str(port.value).replace("racon_tpu_torch::", "racon_tpu::") == \
        str(ref.value)


# ---------------------------------------------------------------- guard

def test_guard_passes_results_and_exceptions():
    assert W.guard("t/s", 5.0, lambda a, b=0: a + b, 2, b=3) == 5
    with pytest.raises(KeyError):
        W.guard("t/s", 5.0, lambda: {}["x"])
    assert W.guard("t/s", 0.0, threading.get_ident) == threading.get_ident()
    assert W.guard("t/s", 5.0, lambda: threading.current_thread().name) == \
        "racon-watchdog"
    assert W.guard("t/s", 5.0, W.ambient_deadline) == 5.0
    assert W.ambient_deadline() == 0.0
    assert "res_watchdog_breach_total" not in metrics.registry().snapshot()


def test_guard_breach_and_terminal(monkeypatch):
    t0 = time.monotonic()
    with pytest.raises(W.DispatchTimeout) as ei:
        W.guard("d2h/slow", 0.15, time.sleep, 0.6)
    assert time.monotonic() - t0 < 0.6
    assert (ei.value.site, ei.value.deadline_s) == ("d2h/slow", 0.15)
    h = W.health_snapshot()
    assert h["status"] == "ok" and h["watchdog_breaches"] == 1
    monkeypatch.setenv(env.WATCHDOG_TERMINAL, "2")
    with pytest.raises(W.WatchdogTerminal) as ei:
        W.guard("dispatch/chunk", 0.1, time.sleep, 0.5)
    assert W.is_terminal(ei.value)
    wrapped = RuntimeError("stage")
    wrapped.__cause__ = ei.value
    assert W.is_terminal(wrapped) and not W.is_terminal(RuntimeError("x"))
    snap = metrics.registry().snapshot()
    assert snap["res_watchdog_breach_total"] == 2
    assert snap["res_watchdog_site_d2h_slow"] == 1
    assert snap["res_watchdog_terminal_total"] == 1
    assert W.health_snapshot()["status"] == "terminal"
    W.note_stall(5)
    assert W.health_snapshot()["pipeline_stalls"] == 1
    monkeypatch.setenv(env.WATCHDOG_TERMINAL, "x")
    with pytest.raises(ValueError, match="RACON_TPU_WATCHDOG_TERMINAL"):
        W.terminal_limit()


def test_abandoned_attempt_never_runs_its_body():
    """A hang at the site outlives the deadline; the retry's second
    attempt runs the body. When the abandoned worker wakes, it returns
    without running the body: one launch, not two."""
    kernels.reset_launches()
    calls = []

    def body():
        calls.append(threading.current_thread().name)
        kernels._launched("band_fwd")
        return "ok"

    F.configure("dispatch/chunk:0!hang=0.5")
    pol = RT.RetryPolicy(attempts=3, base=0.0, jitter=0.0)
    assert RT.call("dispatch/chunk", body, policy=pol,
                   deadline_s=0.15) == "ok"
    time.sleep(0.6)                     # the abandoned worker has woken
    assert len(calls) == 1
    assert kernels.LAUNCHES["band_fwd"] == 1
    snap = metrics.registry().snapshot()
    assert snap["res_watchdog_breach_total"] == 1
    assert snap["res_retry_total"] == 1
    kernels.reset_launches()


def test_guard_charges_launches_to_the_caller():
    """The body runs on a watchdog thread; its launches (the wrappers'
    per-thread counts) are credited to the caller's thread, so the stage
    clock and the host clock read as if it ran inline."""
    kernels.reset_launches()
    clock = P.set_stage_clock(True)
    host = P.set_host_clock(True)
    cpu = torch.device("cpu")

    def body():
        with P._stage("walk", cpu), P.host_part("walk"):
            kernels._launched("col_walk")
        kernels._launched("merge_votes")
        kernels._launched("merge_votes")

    try:
        before = kernels.thread_launches()
        with P._stage("merge", cpu):
            W.guard("dispatch/walk", 5.0, body)
        after = kernels.thread_launches()
    finally:
        P.set_stage_clock(False)
        P.set_host_clock(False)
    assert {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)} == \
        {"col_walk": 1, "merge_votes": 2}
    assert clock.launches() == {"walk": {"col_walk": 1},
                                "merge": {"col_walk": 1, "merge_votes": 2}}
    assert host.n == {"walk": 1}
    kernels.reset_launches()


# ------------------------------------------------------ engine parity

def _policy(mod, attempts):
    mod.configure(mod.RetryPolicy(attempts=attempts, base=0.0, jitter=0.0))


def _res(snap):
    return {k: v for k, v in snap.items() if k.startswith("res_")}


# Eight windows of five layers in chunks of at most 20 jobs: two chunks,
# so that a second-call fault index lands on the second chunk.
N, SEED, BATCH = 8, 5, 20


def _port_engine(spec, attempts=3, n=N, seed=SEED, batch=BATCH):
    from racon_tpu_torch.ops.poa import PoaEngine
    P._CAP_HISTORY.clear()
    P._BAND_HISTORY.clear()
    metrics.reset()
    F.configure(spec)
    _policy(RT, attempts)
    ws = port_windows(n, seed)
    log = io.StringIO()
    PoaEngine(device="cpu", device_batch=batch,
              log=log).consensus_windows(ws)
    F.configure(None)
    return [w.consensus for w in ws], _res(metrics.registry().snapshot()), \
        log.getvalue()


_REF = {}


_CLEAN = {}


def _port_clean(n=N):
    """The port's clean run under the current gates (computed once)."""
    key = (env.read(env.SCHED), n)
    if key not in _CLEAN:
        _CLEAN[key] = _port_engine(None, n=n)
    return _CLEAN[key]


def _ref_engine(spec, sched, attempts=3, n=N, seed=SEED, batch=BATCH):
    key = (spec, sched, attempts, n, seed, batch, env.read(env.TIMING))
    if key not in _REF:
        from racon_tpu.obs import metrics as r_metrics
        from racon_tpu.ops import device_poa as R
        from racon_tpu.ops.poa import PoaEngine
        from racon_tpu.resilience import faults as rf, retry as rr
        R._CAP_HISTORY.clear()
        R._BAND_HISTORY.clear()
        r_metrics.reset()
        rf.configure(spec)
        _policy(rr, attempts)
        ws = reference_windows(n, seed)
        PoaEngine(backend="jax", device_batch=batch,
                  log=io.StringIO()).consensus_windows(ws)
        rf.configure(None)
        rr.configure(None)
        _REF[key] = ([w.consensus for w in ws],
                     _res(r_metrics.registry().snapshot()))
    return _REF[key]


@pytest.mark.parametrize("sched", ["1", "0"])
@pytest.mark.parametrize("spec, attempts", [
    ("h2d/chunk:p=1.0", 2), ("h2d/chunk:0,1", 3), ("dispatch/chunk:1", 3),
    ("d2h/chunk:0", 3),
    ("h2d/chunk:0,1;sched/flags:3;h2d/repack:0;d2h/chunk:4", 3)])
def test_engine_under_faults_matches_reference(monkeypatch, sched, spec,
                                               attempts):
    monkeypatch.setenv(env.SCHED, sched)
    clean, clean_res, _ = _port_clean()
    assert clean_res == {}
    out, res, log = _port_engine(spec, attempts)
    ref_out, ref_res = _ref_engine(spec, sched, attempts)
    assert out == clean
    assert out == ref_out
    assert res == ref_res
    if attempts == 2:                   # every upload fails: all degraded
        assert res["res_degraded_windows"] == sum(
            w.n_layers >= 2 for w in port_windows(N, SEED))
        assert "host path" in log
    else:
        assert res.get("res_retry_total", 0) == res.get(
            "res_fault_injected_total", 0)
        assert "res_degraded_windows" not in res


def test_kernel_error_is_not_retried_or_degraded(monkeypatch):
    from racon_tpu_torch.ops.poa import PoaEngine
    monkeypatch.setenv(env.SCHED, "0")
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise kernels.KernelError("[racon_tpu_torch::kernels] band_fwd "
                                  "launch failed (cudaError 700)")

    monkeypatch.setattr(P, "device_chunk_packed", broken)
    ws = port_windows(8, 3)
    with pytest.raises(kernels.KernelError):
        PoaEngine(device="cpu", log=io.StringIO()).consensus_windows(ws)
    assert len(calls) == 1
    assert _res(metrics.registry().snapshot()) == {}
    assert all(w.consensus is None for w in ws if w.n_layers >= 2)


def test_cli_exits_1_on_kernel_error(tmp_path, monkeypatch):
    from test_torch_pipeline import _run_cli, _write_two_contig_inputs

    def broken(*a, **k):
        raise kernels.KernelError("[racon_tpu_torch::kernels] band_fwd "
                                  "launch failed (cudaError 719)")

    paths = _write_two_contig_inputs(tmp_path)
    monkeypatch.setenv(env.SCHED, "0")
    monkeypatch.setattr(P, "device_chunk_packed", broken)
    rc, out, err = _run_cli([*paths, "--device", "cpu", "-w", "200"])
    assert rc == 1 and out == b""
    assert "cudaError 719" in err
    snap = metrics.registry().snapshot()
    assert snap.get("res_degraded_windows", 0) == 0
    assert snap.get("res_retry_total", 0) == 0


@pytest.mark.parametrize("sched, depth", [("1", "0"), ("0", "0"),
                                          ("1", "2")])
def test_real_breach_at_d2h_ends_the_run(tmp_path, monkeypatch, sched,
                                         depth):
    """A pull that is really slow (not an injected hang) breaches its
    deadline on every attempt: the RetryExhausted at ``d2h/chunk`` is not
    degraded — on the card that pull waits on the chunk's kernels — so
    the CLI exits 1 with no FASTA and nothing on the host path, serial or
    streamed."""
    from test_torch_pipeline import _run_cli, _write_two_contig_inputs
    real = P.record_d2h

    def slow(*a, **k):
        time.sleep(0.6)
        return real(*a, **k)

    paths = _write_two_contig_inputs(tmp_path)
    monkeypatch.setenv(env.SCHED, sched)
    monkeypatch.setenv(env.RETRY, "attempts=2,base=0")
    monkeypatch.setenv(env.DEADLINE_D2H, "0.2")
    monkeypatch.setattr(P, "record_d2h", slow)
    rc, out, err = _run_cli([*paths, "--device", "cpu", "-w", "200",
                             "--pipeline-depth", depth])
    time.sleep(0.7)                 # let the abandoned pulls end
    assert rc == 1 and out == b"", err[-2000:]
    assert "d2h/chunk failed after 2 attempt(s)" in err
    assert "host path" not in err
    res = metrics.resilience_extras()
    assert res.get("res_degraded_windows", 0) == 0
    assert res["res_watchdog_breach_total"] >= 2
    assert res["res_retry_exhausted"] == 1


def test_out_of_memory_exhausted_at_dispatch_is_not_degraded(monkeypatch):
    monkeypatch.setenv(env.SCHED, "0")

    def oom(*a, **k):
        raise torch.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(P, "device_chunk_packed", oom)
    with pytest.raises(RT.RetryExhausted) as ei:
        _port_engine(None, attempts=2)
    F.configure(None)
    assert ei.value.site == "dispatch/chunk" and not ei.value.degradable
    res = _res(metrics.registry().snapshot())
    assert res["res_retry_exhausted"] == 1
    assert "res_degraded_windows" not in res


def test_redo_exhaustion_is_counted_as_degraded(monkeypatch):
    """A wide-band redo chunk whose dispatch runs out of retries on an
    injected fault degrades like an engine chunk: a stderr line and
    ``res_degraded_windows``; its windows still polish on the host path
    with the clean bytes. A real out-of-memory there ends the run."""
    from racon_tpu_torch.ops.poa import PoaEngine
    clean = [w for w in port_windows(N, SEED) if w.n_layers >= 2]
    eng = PoaEngine(device="cpu", device_batch=BATCH, log=io.StringIO())
    eng._redo_trunc(clean)
    want = [w.consensus for w in clean]
    ws = [w for w in port_windows(N, SEED) if w.n_layers >= 2]
    metrics.reset()
    F.configure("dispatch/chunk:p=1.0")
    _policy(RT, 2)
    log = io.StringIO()
    PoaEngine(device="cpu", device_batch=BATCH, log=log)._redo_trunc(ws)
    F.configure(None)
    assert [w.consensus for w in ws] == want
    res = _res(metrics.registry().snapshot())
    assert res["res_degraded_windows"] == len(ws)
    assert res["res_degraded_chunks"] == res["res_retry_exhausted"] >= 1
    assert "gave up at dispatch/chunk" in log.getvalue()

    def oom(*a, **k):
        raise torch.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(P, "device_chunk_packed", oom)
    metrics.reset()
    with pytest.raises(RT.RetryExhausted):
        PoaEngine(device="cpu", device_batch=BATCH,
                  log=io.StringIO())._redo_trunc(
            [w for w in port_windows(N, SEED) if w.n_layers >= 2])
    assert "res_degraded_windows" not in _res(metrics.registry().snapshot())


class _Pipe:
    def __init__(self, alive):
        self.alive = alive


@pytest.mark.parametrize("armed, running, device, alive, why", [
    (True, ("pack",), "cpu", False, ""),
    (True, ("pack",), "cuda", False, ""),
    (True, ("compute",), "cpu", False, ""),
    (False, ("pack",), "cpu", False, "no fault plan is armed"),
    (True, ("compute",), "cuda", False, "compute stage stalled on the card"),
    (True, ("h2d", "walk"), "cuda", False, "walk stage stalled on the card"),
    (True, ("pack",), "cpu", True, "a stage thread is still running")])
def test_stall_recovery_is_held_to_the_drill(armed, running, device, alive,
                                             why):
    """The stall recovery re-polishes on the host only under an armed
    fault plan, never for a compute or walk stage stalled on the card,
    and only once every stage thread has exited."""
    from racon_tpu_torch.pipeline.stages import PipelineStalled
    from racon_tpu_torch.pipeline.streaming import _stall_unrecoverable
    F.configure("pipe/pack:0!hang=3" if armed else None)
    got = _stall_unrecoverable(PipelineStalled(0.5, "", running),
                               _Pipe(alive), device)
    F.configure(None)
    assert got == why if not why else why in got


def test_out_of_memory_once_is_retried(monkeypatch):
    monkeypatch.setenv(env.SCHED, "0")
    clean, _, _ = _port_clean()
    real = P.device_chunk_packed
    calls = []

    def oom_once(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")
        return real(*a, **k)

    monkeypatch.setattr(P, "device_chunk_packed", oom_once)
    out, res, _ = _port_engine(None)
    assert out == clean
    assert res == {"res_retry_site_dispatch_chunk": 1, "res_retry_total": 1,
                   "res_retry_backoff_s": 0.0}


def test_rounds_leave_their_inputs_untouched():
    """A retried dispatch starts from the same buffers: the rounds read
    the packed buffers through copies and never write them, and the walk
    half gives the same bytes twice from the same planes."""
    from racon_tpu_torch.ops.poa import PoaEngine
    ws = [w for w in port_windows(10, 9) if w.n_layers >= 2]
    plan = P.ChunkPlan(ws)
    eng = PoaEngine(device="cpu")
    rounds = eng.refine_rounds + 1
    scales = eng._round_scales(rounds)
    st = P.chunk_statics(plan, ins_scale=scales, rounds=rounds)
    bufs = P.put_chunk_bufs(plan, "cpu")
    job0, win0 = (t.clone() for t in bufs.tensors())
    kw = dict(match=5, mismatch=-4, gap=-8, ins_scale=scales, Lq=plan.Lq,
              n_win=plan.n_win, LA=plan.LA, band_w=st["band_w"],
              rounds=rounds, adaptive=st["adaptive"], nxt_k=st["nxt_k"])
    a = P.device_chunk_packed(*bufs.tensors(), **kw)
    assert torch.equal(bufs.job, job0) and torch.equal(bufs.win, win0)
    fwd_out, job = P.device_chunk_fwd(*bufs.tensors(), **kw)
    meta = dict(st, job=job, ins_scale=scales, rounds=rounds)
    w1 = P.dispatch_walk(plan, fwd_out, meta)
    w2 = P.dispatch_walk(plan, fwd_out, meta)
    assert torch.equal(a, w1) and torch.equal(w1, w2)


# --------------------------------------------------------------- timing

def test_timing_path_bytes_lines_and_h2d_envelope(monkeypatch):
    monkeypatch.setenv(env.SCHED, "0")
    clean, _, _ = _port_clean()
    monkeypatch.setenv(env.TIMING, "1")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out, res, _ = _port_engine("h2d/chunk:0", attempts=3)
    assert out == clean
    assert res["res_fault_injected_total"] == 1
    assert res["res_retry_total"] == 1
    assert "res_retry_exhausted" not in res
    lines = err.getvalue().splitlines()
    rounds = [ln for ln in lines if "compute/round" in ln]
    h2d = [ln for ln in lines if ln.endswith("s") and ": " in ln
           and "] h2d:" in ln]
    assert len(h2d) >= 1 and len(rounds) == 4 * len(h2d)
    assert all(ln.startswith("[racon_tpu_torch::run_chunk] ")
               for ln in rounds + h2d)
    ref_err = io.StringIO()
    with contextlib.redirect_stderr(ref_err):
        ref_out, ref_res = _ref_engine("h2d/chunk:0", "0")
    assert out == ref_out and res == ref_res
    ref_rounds = [ln for ln in ref_err.getvalue().splitlines()
                  if "compute/round" in ln]
    assert len(ref_rounds) == len(rounds)
