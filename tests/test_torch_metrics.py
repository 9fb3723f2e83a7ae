"""The port's run telemetry (obs/metrics.py) against the JAX package's,
run under JAX_PLATFORMS=cpu.

- CLI snapshot parity: the reference CLI (``--backend jax``) and the
  port's (``--device cpu``) on the same inputs, each once a case (a
  module-scoped fixture): the scheduler on the two-contig input of
  tests/test_torch_pipeline.py, ``RACON_TPU_SCHED=0`` on a converging
  input (the adaptive exit fires), ``--pipeline-depth 2``, and ``-f`` on
  an all-vs-all set. The final metric snapshots have the same keys, less
  the reference's ``jax_cache_*`` (no meaning without JAX) and ``ovl_*``
  (on ``--device cpu`` the port sends overlaps to the native aligner)
  and the port's align-phase step seconds (``OVL_STEP_KEYS``),
  the same counts, and the traces the same (kind, name) multiset over
  run, phase, chunk, transfer, round and ingest; the "scheduler" stderr
  line has the same text;
- a wide-band redo through both engines: the same redo and dispatch
  counts;
- ``ovl_*`` of a set no overlap route admits (the tiled and untiled
  routes' ``ovl_*`` and ``tile`` points are held against the
  reference's in tests/test_torch_ovl_align.py, on that file's run of
  both device_breaking_points, so the slow tiled run is not repeated);
- each ``*_extras`` function against the reference's on the same
  recorded events; METRIC_SPECS and the merge kinds against the
  reference's; the fleet fold and the OpenMetrics render of a CLI
  snapshot; the port's own rows (``OVL_STEP_KEYS`` and
  ``ovl_tail_lanes``) and their merge kind.
"""

import collections
import contextlib
import fnmatch
import io
import json
import time
import types

import numpy as np
import pytest
import torch

from racon_tpu.obs import metrics as RM
from racon_tpu_torch.obs import metrics as PM
from racon_tpu_torch.utils import env

from test_torch_pipeline import _run_cli, _write_two_contig_inputs
from window_sets import BASES

_ENVS = (env.FAULTS, env.RETRY, env.TIMING, env.SCHED, env.ADAPTIVE,
         env.PIPELINE, env.PIPELINE_DEPTH, env.STALL_S, env.TRACE,
         env.INGEST, env.INGEST_WORKERS, env.REDO, env.WATCHDOG_TERMINAL)


def _reset_all():
    from racon_tpu.obs import trace as r_trace
    from racon_tpu.pipeline import configure as r_configure
    from racon_tpu.resilience import faults as rf, retry as rr
    from racon_tpu.resilience import watchdog as rw
    from racon_tpu_torch.obs import trace as p_trace
    from racon_tpu_torch.pipeline import configure
    from racon_tpu_torch.resilience import faults as pf, retry as pr
    from racon_tpu_torch.resilience import watchdog as pw
    for mod in (pf, rf, pr, rr):
        mod.configure(None)
    for mod in (pw, rw, PM, RM):
        mod.reset()
    configure(None)
    r_configure(None)
    p_trace._tracer = None
    r_trace._tracer = None


@contextlib.contextmanager
def _clean_state(gates=None):
    """Both packages from zero: no env gate but ``gates``, empty
    registries, null tracers, fresh shape histories, one torch thread."""
    from racon_tpu.ops import device_poa as R
    from racon_tpu_torch.ops import device_poa as P
    with pytest.MonkeyPatch.context() as mp:
        for name in _ENVS:
            mp.delenv(name, raising=False)
        for k, v in (gates or {}).items():
            mp.setenv(k, v)
        for mod in (R, P):
            mp.setattr(mod, "_CAP_HISTORY", set())
            mp.setattr(mod, "_BAND_HISTORY", set())
        _reset_all()
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            yield
        finally:
            torch.set_num_threads(n)
            _reset_all()


def _ref_cli(argv):
    from racon_tpu import cli

    stdout = io.StringIO()
    stdout.buffer = io.BytesIO()
    err = io.StringIO()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(err):
        rc = cli.main(["--backend", "jax", *argv])
    return rc, stdout.buffer.getvalue(), err.getvalue()


def _read_trace(path):
    lines = [json.loads(ln) for ln in open(path, encoding="utf-8")]
    assert lines[0]["ev"] == "begin" and lines[-1]["ev"] == "metrics"
    return lines[1:-1], {k: v for k, v in lines[-1].items() if k != "ev"}


def _converging_inputs(d, n_reads=8, clen=400):
    """Two contigs whose reads are exact copies of the truth: every
    window reaches its fixed point early, so the adaptive exit fires."""
    rng = np.random.default_rng(23)
    drafts, reads, paf = [], [], []
    for ci in (1, 2):
        truth = BASES[rng.integers(0, 4, clen)]
        draft = truth.copy()
        pos = rng.choice(clen, 12, replace=False)
        draft[pos] = BASES[(rng.integers(1, 4, 12) +
                            np.searchsorted(BASES, truth[pos])) % 4]
        drafts.append(b">c%d\n%s\n" % (ci, draft.tobytes()))
        for i in range(n_reads):
            name = f"c{ci}r{i}"
            reads.append(b">%s\n%s\n" % (name.encode(), truth.tobytes()))
            paf.append(f"{name}\t{clen}\t0\t{clen}\t+\tc{ci}\t{clen}\t0"
                       f"\t{clen}\t{clen}\t{clen}\t60")
    d.mkdir()
    (d / "draft.fasta").write_bytes(b"".join(drafts))
    (d / "reads.fasta").write_bytes(b"".join(reads))
    (d / "ovl.paf").write_text("\n".join(paf) + "\n")
    return [str(d / "reads.fasta"), str(d / "ovl.paf"),
            str(d / "draft.fasta")]


def _fragment_inputs(d):
    from racon_tpu_torch.utils.synth import write_dataset
    p = write_dataset(str(d), seed=12, contig_len=600, coverage=6,
                      fastq=True, ava=True)["paths"]
    return ["-f", p["reads"], p["ava"], p["reads"]]


# name -> (inputs under a tmp dir, extra argv, env gates)
CLI_CASES = {
    "sched": (lambda d: _write_two_contig_inputs(d), [], {}),
    "fixed": (lambda d: _converging_inputs(d / "in"), [],
              {env.SCHED: "0"}),
    "pipeline": (lambda d: _write_two_contig_inputs(d),
                 ["--pipeline-depth", "2"], {}),
    "fragment": (_fragment_inputs, [], {}),
}


@pytest.fixture(scope="module", params=sorted(CLI_CASES))
def cli_pair(request, tmp_path_factory):
    """One case's reference and port CLI runs with ``--trace``: per
    package (rc, stdout, stderr, spans, final snapshot)."""
    make, extra, gates = CLI_CASES[request.param]
    d = tmp_path_factory.mktemp(request.param)
    argv = [*make(d), *extra]
    runs = {}
    with _clean_state(gates):
        for pkg, run, tail in (("ref", _ref_cli, []),
                               ("port", _run_cli, ["--device", "cpu"])):
            path = str(d / f"{pkg}.jsonl")
            rc, out, err = run([*argv, *tail, "--trace", path])
            assert rc == 0, err[-2000:]
            spans, snap = _read_trace(path)
            runs[pkg] = types.SimpleNamespace(out=out, err=err, spans=spans,
                                              snap=snap)
    assert runs["port"].out == runs["ref"].out
    return request.param, runs["ref"], runs["port"]


def _comparable_keys(snap):
    """The reference's keys the port records on --device cpu: all but
    the compile cache's and the overlap aligner's."""
    return {k for k in snap
            if not k.startswith(("jax_cache_", "ovl_"))}


def test_cli_snapshot_keys_match_reference(cli_pair):
    _, ref, port = cli_pair
    steps = set(PM.OVL_STEP_KEYS) & set(port.snap)
    assert set(port.snap) - steps == _comparable_keys(ref.snap)
    # On --device cpu the card route does not run; the host aligner
    # (every overlap without a CIGAR) and the walk do.
    assert steps == {"ovl_host_align_s", "ovl_walk_s"}
    assert all(port.snap[k] > 0 for k in steps)
    assert sum(port.snap[k] for k in steps) <= \
        port.snap["align_phase_seconds"]
    # The keys the port used to lack, where the case runs their code.
    for key in ("device_dispatches", "adaptive_rounds_executed",
                "adaptive_rounds_scheduled", "walk_chain_len",
                "align_phase_seconds", "ingest_enabled",
                "ingest_fraction_of_wall", "h2d_transfer_s"):
        assert key in port.snap, key


#: Keys compared by value: counts and values derived only from counts.
_COUNT_KEYS = (
    "device_dispatches", "adaptive_rounds_executed",
    "adaptive_rounds_scheduled", "adaptive_early_exits", "walk_chain_len",
    "sched_rounds", "sched_windows", "sched_chunks", "sched_rounds_hist",
    "sched_survivor_frac", "sched_rounds_saved_frac",
    "sched_dispatches_saved", "sched_flag_pulls", "redo_passes",
    "redo_device_windows", "redo_host_windows", "ingest_records",
    "ingest_raw_bytes", "ingest_enabled", "h2d_transfers", "h2d_bytes",
    "d2h_transfers", "d2h_bytes", "poa_windows_total", "pipe_runs",
    "walk_dispatches", "walk_fused_chunks", "walk_async_enabled")


def _counts(snap):
    out = {k: snap[k] for k in _COUNT_KEYS if k in snap}
    out.update({k: v for k, v in snap.items()
                if k.startswith("pipe_stage_") and k.endswith("_items")})
    out.update({k: v["count"] for k, v in snap.items()
                if k in PM.HIST_BUCKETS})
    return out


def test_cli_snapshot_counts_match_reference(cli_pair):
    name, ref, port = cli_pair
    assert _counts(port.snap) == _counts(ref.snap)
    if name == "fixed":
        # The converging input exits early on the fixed engine.
        assert port.snap["adaptive_early_exits"] > 0
        assert port.snap["adaptive_rounds_executed"] < \
            port.snap["adaptive_rounds_scheduled"]
    if name in ("sched", "pipeline"):
        assert port.snap["sched_chunks"] >= 1
        assert port.snap["device_dispatches"] >= 3


_SPAN_KINDS = ("run", "phase", "chunk", "transfer", "round", "ingest")


def _kinds(spans):
    return collections.Counter(
        (s["kind"], s["name"].replace("racon_tpu_torch", "racon_tpu"))
        for s in spans if s["kind"] in _SPAN_KINDS)


def test_cli_trace_span_kinds_match_reference(cli_pair):
    _, ref, port = cli_pair
    assert _kinds(port.spans) == _kinds(ref.spans)
    assert sum(1 for s in port.spans if s["kind"] == "ingest") >= 2


def test_cli_scheduler_line_matches_reference(cli_pair):
    name, ref, port = cli_pair

    def lines(err):
        return [ln.split("] ", 1)[1] for ln in err.splitlines()
                if "Polisher::polish] scheduler " in ln]

    assert lines(port.err) == lines(ref.err)
    assert bool(lines(port.err)) == (name != "fixed")
    if lines(port.err):
        assert lines(port.err)[-1] == \
            "scheduler " + PM.sched_summary_line(
                _as_registry(port.snap))


def _as_registry(snap):
    reg = PM.MetricsRegistry()
    for k, v in snap.items():
        reg.set(k, v)
    return reg


def _spec_row(specs, key):
    for row in specs:
        if fnmatch.fnmatchcase(key, row[0]):
            return row
    return None


def test_cli_snapshot_keys_have_specs_and_merge_kinds(cli_pair):
    _, ref, port = cli_pair
    for key in port.snap:
        row = _spec_row(PM.METRIC_SPECS, key)
        assert row is not None, key
        if key in PM.OVL_STEP_KEYS:
            assert row == (key, PM.MERGE_SUM, key)
        else:
            assert row == _spec_row(RM.METRIC_SPECS, key), key
        assert PM.merge_kind(key) == RM.merge_kind(key) == row[1], key


def test_fleet_fold_and_render_carry_the_new_keys(cli_pair):
    """Two workers' copies of a CLI snapshot fold as the reference folds
    them, and the OpenMetrics render carries the new families."""
    from racon_tpu_torch.obs.export import (render_registry,
                                            validate_openmetrics)
    _, _, port = cli_pair
    snap = port.snap
    for key, v in snap.items():
        assert PM.merge_values(key, [v, v]) == RM.merge_values(key, [v, v])
    assert PM.merge_values("device_dispatches", [3, 4]) == 7
    assert PM.merge_values("sched_windows", [3, 4]) == 4
    text = render_registry(snap)
    validate_openmetrics(text)
    for sample in ("device_dispatches_total", "walk_chain_len",
                   "h2d_transfer_s_bucket", "adaptive_rounds_executed_total",
                   "align_phase_seconds_total", "ingest_enabled"):
        assert f"\nracon_tpu_{sample}" in text, sample


# ---------------------------------------------------------------- redo


def test_redo_counts_match_reference():
    """A flagged window beside two stable ones through both engines: the
    same redo pass, dispatches, adaptive rounds and transfers."""
    from merge_model import growing_window, sched_stable_windows
    from racon_tpu.models.window import Window as RW, WindowType as RWT
    from racon_tpu.ops.poa import PoaEngine as RPoaEngine
    from racon_tpu_torch.ops.poa import PoaEngine
    snaps = {}
    for pkg in ("ref", "port"):
        with _clean_state():
            if pkg == "ref":
                kw = dict(W=RW, WT=RWT)
                eng = RPoaEngine(backend="jax")
            else:
                kw = {}
                eng = PoaEngine(device="cpu")
            ws = [growing_window(53, **kw)] + \
                sched_stable_windows(54, 2, 150, **kw)
            with contextlib.redirect_stderr(io.StringIO()):
                eng.consensus_windows(ws)
            snaps[pkg] = (RM if pkg == "ref" else PM).registry().snapshot()
    ref, port = snaps["ref"], snaps["port"]
    assert set(port) == _comparable_keys(ref)
    assert _counts(port) == _counts(ref)
    assert port["redo_passes"] == 1
    assert port["redo_device_windows"] + port["redo_host_windows"] == 1
    for key in port:
        assert _spec_row(PM.METRIC_SPECS, key) == \
            _spec_row(RM.METRIC_SPECS, key) is not None, key


# ------------------------------------------------------- overlap aligner


def test_ovl_counters_of_a_rejected_set_match_reference():
    """A set no route admits: every job counted native, no tile, the
    reference's ``ovl_*``. (The tiled and untiled routes' counters and
    ``tile`` points are held against the reference's in
    tests/test_torch_ovl_align.py, on that file's run of both
    device_breaking_points.)"""
    from racon_tpu.ops import ovl_align as rovl
    from racon_tpu_torch.ops import ovl_align as povl
    from test_torch_ovl_align import _Ovl, _overlap_set
    over_budget = _overlap_set(31)[5]
    with _clean_state():
        povl.reset_stats()
        for ovl, kw in ((rovl, {}), (povl, dict(device="cpu"))):
            assert len(ovl.device_breaking_points(
                [_Ovl(*over_budget)], None, 500, match=0, mismatch=-1,
                gap=-1, **kw)) == 1
        want = {"ovl_device_fraction": 0.0, "ovl_device_jobs": 0,
                "ovl_native_jobs": 1, "ovl_tiles_exec": 0}
        # The port writes its own ovl_tail_lanes on every record_ovl.
        assert RM.ovl_extras() == want
        assert PM.ovl_extras() == dict(want, ovl_tail_lanes=0)


# ------------------------------------------- recorders and their extras


def _record_all(m, reg):
    """The same events through module ``m``'s recorders into ``reg``."""
    from racon_tpu_torch.sched.telemetry import SchedTelemetry
    for s in (0.0004, 0.003, 0.02, 0.7, 4.0):
        m.record_h2d(1 << 20, s, reg=reg, name="h2d/chunk")
    m.record_d2h(3 << 18, 0.01, reg=reg, name="d2h/chunk")
    m.record_flag_pull(64, 0.002, reg=reg)
    reg.inc("device_dispatches", 7)
    m.record_retry("h2d/chunk", 1, 0.05, "InjectedFault", True, reg=reg)
    m.record_retry_exhausted("d2h/chunk", 3, reg=reg)
    m.record_fault("dispatch/chunk", 2, "raise", reg=reg)
    m.record_watchdog_breach("d2h/chunk", 0.5, 0.75, terminal=True,
                             reg=reg)
    m.record_stall(0.5, 5, reg=reg)
    m.record_degraded(11, reg=reg)
    m.record_ckpt("commit", 3, 900, reg=reg)
    m.record_ckpt("resume", 2, 0, reg=reg)
    m.record_dist("claims", 1, "w0", reg=reg)
    m.record_dist("steal_latency_s", 2, "w1", value=0.25, reg=reg)
    m.set_dist("workers", 3, reg=reg)
    m.record_ovl(5, 2, 35, reg=reg)
    m.record_ovl(0, 1, 0, reg=reg)
    m.record_align_phase(1.5, reg=reg)
    m.record_redo(3, 1, reg=reg)
    reg.set("walk_chain_len", 161)
    m.record_ingest_inflate("bgzf", 1000, 4000, 0.01, 4, reg=reg)
    m.record_ingest_parse("prefetch", 0.02, 15, 4000, reg=reg)
    m.record_ingest_wait(0.005, reg=reg)
    m.set_ingest_fraction(2.0, reg=reg)
    reg.set("ingest_enabled", 1)
    m.record_stage("compute", 1.25, 0.5, 0.25, 9, reg=reg)
    m.record_queue("h2d", 2, 0.1, 0.2, reg=reg)
    m.record_pipeline_wall(2.5, reg=reg)
    for overlap in (0.0, 0.004, 0.3):
        m.record_walk(0.5, overlap, 3, 1, 2, True, reg=reg)
    m.record_serve_job("submitted", "j1", "acme", reg=reg)
    m.record_serve_batch(200, 256, ["j1"], ["acme"], 0.03, round_s=0.4,
                         reg=reg)
    m.set_serve_active(2, reg=reg)
    m.set_serve_rate(12.5, reg=reg)
    m.record_hist("serve_job_latency_s", 3.0, reg)
    m.record_hist("serve_queue_wait_s", 0.2, reg)
    m.record_gate("route_fleet", "j1", "acme", reg=reg, wall_s=1.5)
    m.set_gate_fleet_target(2, reg=reg)
    m.set_gate_rate(4.25, compile_skip_s=1.5, reg=reg)
    m.record_ava_plan(types.SimpleNamespace(
        n_targets=40, n_buckets=3, quantum=512, budget=8,
        pad_frac=0.12345), reg=reg)
    m.set_ava_bench(100.5, 2048.25, 31.5, reg=reg)
    m.record_cache("job", "miss", reg=reg)
    m.record_cache("window", "hit", n=3, reg=reg)
    m.record_cache("job", "store", nbytes=4096, reg=reg)
    t = SchedTelemetry(4)
    t.record_chunk(10)
    for r in range(4):
        t.record_round(r, 10 - 2 * r)
    t.record_freeze(2, 4)
    t.record_freeze(4, 6)
    t.record_repack(0.0123)
    t.record_skip(1)
    m.publish_sched(t, reg)
    m.record_phase_seconds("[pkg::Polisher::initialize] loaded sequences",
                           0.5, reg=reg)
    m.record_windows(10, reg=reg)


_EXTRAS = ("transfer_extras", "resilience_extras", "dist_extras",
           "ovl_extras", "redo_extras", "ingest_extras", "pipeline_extras",
           "walk_extras", "serve_extras", "gate_extras", "ava_extras",
           "result_cache_extras", "sched_extras", "sched_summary_line",
           "hist_percentiles", "snapshot")


@pytest.mark.parametrize("name", _EXTRAS)
def test_extras_match_reference(name, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    regs = {}
    with _clean_state():
        for m in (RM, PM):
            regs[m] = m.MetricsRegistry()
            _record_all(m, regs[m])
    ref, port = regs[RM], regs[PM]
    if name == "snapshot":
        got, want = port.snapshot(), ref.snapshot()
        # The fed histograms: five transfers, the walks that walked.
        assert got["h2d_transfer_s"]["count"] == 5
        assert got["walk_hidden_s"]["count"] == 3
    elif name == "hist_percentiles":
        got = {h: PM.hist_percentiles(h, port) for h in PM.HIST_BUCKETS}
        want = {h: RM.hist_percentiles(h, ref) for h in RM.HIST_BUCKETS}
        assert all(got.values())
    else:
        got, want = getattr(PM, name)(port), getattr(RM, name)(ref)
        assert got
    if name in ("ovl_extras", "snapshot"):
        # The port's own key, written by every record_ovl (none of the
        # recorded calls had a tail lane).
        assert got.pop("ovl_tail_lanes") == 0
    assert got == want


def test_empty_extras_match_reference():
    for name in _EXTRAS[:-2]:
        if name in ("sched_extras", "sched_summary_line"):
            continue
        assert getattr(PM, name)(PM.MetricsRegistry()) == \
            getattr(RM, name)(RM.MetricsRegistry()) == {}, name


def test_metric_specs_match_reference():
    """The reference's rows less its three compile-cache rows, in its
    order, plus the port's align-phase step rows and its tail-lane row
    (sums), each row's kind
    the merge kind of its exact keys; no ``jax_cache_*`` key has a row
    or a gauge kind here."""
    want = tuple(r for r in RM.METRIC_SPECS
                 if not r[0].startswith("jax_cache_"))
    port_keys = PM.OVL_STEP_KEYS + ("ovl_tail_lanes",)
    own = tuple(r for r in PM.METRIC_SPECS if r[0] in port_keys)
    assert tuple(r for r in PM.METRIC_SPECS if r not in own) == want
    assert own == tuple((k, PM.MERGE_SUM, k) for k in sorted(port_keys))
    ovl = [r[0] for r in PM.METRIC_SPECS if r[0].startswith("ovl_")]
    assert ovl == sorted(ovl)
    assert len(RM.METRIC_SPECS) - len(PM.METRIC_SPECS) == 3 - len(own)
    for pattern, kind, _doc in PM.METRIC_SPECS:
        if "*" not in pattern:
            assert PM.merge_kind(pattern) == RM.merge_kind(pattern) == kind
    assert PM.HIST_BUCKETS == RM.HIST_BUCKETS
    assert PM.SCHED_KEYS == RM.SCHED_KEYS
    assert PM._MERGE_LAST_KEYS == {k for k in RM._MERGE_LAST_KEYS
                                   if not k.startswith("jax_cache_")}
