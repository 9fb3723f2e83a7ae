"""The port's fault plane at its edges, against the JAX package's (run
under JAX_PLATFORMS=cpu): the CLI, the JSONL tracer and the ingest plane.

- the CLI on the two-contig inputs of tests/test_torch_pipeline.py, the
  port's (``--device cpu``) and the reference's (``--backend jax``) under
  the same ``RACON_TPU_FAULTS`` specs, the reference's stall drill
  included: the same stdout bytes and exit code, the clean run's bytes,
  and the same ``res_*`` counters;
- ``--trace``: both CLIs' JSONL on the same input have the same schema
  and the same multiset of ``(kind, name)`` for the kinds run, phase,
  chunk and transfer, after the two packages' names are mapped onto one
  another (listed below with the reason);
- ``io/read`` and ``io/inflate`` faults: the same offset-bearing
  ParseError offsets as the reference on the serial line readers, the
  mmap record readers and the pooled inflate; the port's single-member
  stream inflate gives its offset deterministically (the reference's
  does not: PERF.md §7); ``prefetch_ok`` is false while an ``io/*`` site
  is armed.
"""

import collections
import contextlib
import gzip
import io
import json

import numpy as np
import pytest
import torch

from racon_tpu_torch.io import ingest as PI
from racon_tpu_torch.io import parsers as PP
from racon_tpu_torch.obs import trace as PT
from racon_tpu_torch.ops import device_poa as P
from racon_tpu_torch.pipeline import metrics
from racon_tpu_torch.resilience import faults as F
from racon_tpu_torch.resilience import retry as RT
from racon_tpu_torch.resilience import watchdog as W
from racon_tpu_torch.utils import env

from test_torch_pipeline import _run_cli, _write_two_contig_inputs

_ENVS = (env.FAULTS, env.RETRY, env.TIMING, env.SCHED, env.ADAPTIVE,
         env.PIPELINE, env.PIPELINE_DEPTH, env.STALL_S, env.TRACE,
         env.INGEST, env.INGEST_WORKERS, env.WATCHDOG_TERMINAL)


def _reset_all():
    from racon_tpu.obs import metrics as r_metrics
    from racon_tpu.obs import trace as r_trace
    from racon_tpu.pipeline import configure as r_configure
    from racon_tpu.resilience import faults as rf, retry as rr
    from racon_tpu.resilience import watchdog as rw
    from racon_tpu_torch.pipeline import configure
    for mod in (F, rf, RT, rr):
        mod.configure(None)
    for mod in (W, rw, metrics, r_metrics):
        mod.reset()
    configure(None)
    r_configure(None)
    # Back to the null tracers: a finished trace must not swallow the
    # next test's spans.
    PT._tracer = None
    r_trace._tracer = None


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
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


def _ref_cli(argv):
    """The reference CLI in this process, its stdout bytes captured."""
    from racon_tpu import cli

    class _Capture(io.StringIO):
        pass

    stdout = _Capture()
    stdout.buffer = io.BytesIO()
    err = io.StringIO()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(err):
        rc = cli.main(["--backend", "jax", *argv])
    return rc, stdout.buffer.getvalue(), err.getvalue()


def _res(snap):
    return {k: v for k, v in snap.items() if k.startswith("res_")}


def _both(argv, spec):
    """Run the reference's CLI and the port's under ``spec``; returns
    ((rc, out, err, res) of the reference, the same of the port)."""
    from racon_tpu.obs import metrics as r_metrics
    from racon_tpu.resilience import faults as rf
    runs = []
    for configure, run, reg in (
            (rf.configure, _ref_cli, r_metrics),
            (F.configure, lambda a: _run_cli([*a, "--device", "cpu"]),
             metrics)):
        reg.reset()
        configure(spec)
        try:
            rc, out, err = run(argv)
        finally:
            configure(None)
        runs.append((rc, out, err, _res(reg.registry().snapshot())))
    return runs


_CLEAN = {}


def _clean_bytes(paths):
    if "out" not in _CLEAN:
        rc, out, err = _run_cli([*paths, "--device", "cpu"])
        assert rc == 0 and out.count(b">") == 2, err
        _CLEAN["out"] = out
    return _CLEAN["out"]


@pytest.mark.parametrize("spec, gates", [
    ("h2d/chunk:0,1;sched/flags:0;d2h/chunk:0", {}),
    ("h2d/chunk:1;dispatch/chunk:0;d2h/chunk:1", {env.SCHED: "0"}),
    ("h2d/chunk:p=1.0", {env.RETRY: "attempts=2,base=0"}),
    ("pipe/pack:0!hang=3", {env.PIPELINE: "1", env.STALL_S: "0.5"}),
])
def test_cli_under_faults_matches_reference(tmp_path, monkeypatch, spec,
                                            gates):
    paths = _write_two_contig_inputs(tmp_path)
    clean = _clean_bytes(paths)
    for k, v in gates.items():
        monkeypatch.setenv(k, v)
    RT.configure(None)
    (rrc, rout, rerr, rres), (prc, pout, perr, pres) = _both(paths, spec)
    assert rrc == 0, rerr[-2000:]
    assert prc == 0, perr[-2000:]
    assert pout == rout == clean
    assert pres == rres
    if spec.startswith("pipe/"):
        assert "stall detected" in perr and "stall detected" in rerr
        assert metrics.registry().get("pipe_stall_events") == 1
        assert pres["res_degraded_windows"] > 0
        assert W.health_snapshot()["pipeline_stalls"] == 1
    elif "p=1.0" in spec:
        assert pres["res_degraded_windows"] > 0
        assert "host path" in perr
    else:
        assert pres["res_retry_total"] == pres["res_fault_injected_total"]
        assert "res_degraded_windows" not in pres


# ---------------------------------------------------------------- trace

# (kind, name) pairs the two packages name differently, and why:
# the port's phase lines and run span carry its own package name.
def _norm(name: str) -> str:
    return name.replace("racon_tpu_torch", "racon_tpu")


def _read_trace(path):
    lines = [json.loads(ln) for ln in open(path, encoding="utf-8")]
    assert lines[0]["ev"] == "begin" and lines[0]["schema"] == 1
    assert lines[-1]["ev"] == "metrics"
    spans = lines[1:-1]
    for s in spans:
        assert s["ev"] == "span"
        assert {"id", "parent", "kind", "name", "t0", "dur_s"} <= set(s)
    ids = {s["id"] for s in spans}
    assert len(ids) == len(spans)
    assert all(s["parent"] is None or s["parent"] in ids for s in spans)
    return spans, lines[-1]


def test_trace_matches_reference(tmp_path):
    """Under the scheduler, the default chunk driver: chunk spans, and
    the h2d/chunk, h2d/repack and d2h/chunk transfers."""
    paths = _write_two_contig_inputs(tmp_path)
    rp, pp = str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")
    rrc, rout, rerr = _ref_cli([*paths, "--trace", rp])
    prc, pout, perr = _run_cli([*paths, "--device", "cpu", "--trace", pp])
    assert rrc == prc == 0 and pout == rout, (rerr[-1000:], perr[-1000:])
    rspans, rmetrics = _read_trace(rp)
    pspans, pmetrics = _read_trace(pp)
    kinds = ("run", "phase", "chunk", "transfer")

    def multiset(spans):
        return collections.Counter((s["kind"], _norm(s["name"]))
                                   for s in spans if s["kind"] in kinds)

    assert multiset(pspans) == multiset(rspans)
    # Every span nests under the run span, as the reference's do.
    run = [s for s in pspans if s["kind"] == "run"]
    assert len(run) == 1 and run[0]["parent"] is None
    for s in pspans:
        if s["kind"] == "transfer":
            assert s["bytes"] > 0 and s["dir"] in ("h2d", "d2h")
    assert {s["name"] for s in pspans if s["kind"] == "transfer"} >= \
        {"h2d/chunk", "d2h/chunk"}
    assert pmetrics["h2d_transfers"] == rmetrics["h2d_transfers"]
    assert pmetrics["d2h_transfers"] == rmetrics["d2h_transfers"]


def test_trace_spans_nest_across_guard_threads(tmp_path, monkeypatch):
    """A span opened inside a guarded body (a watchdog thread) keeps its
    caller's span as its parent; the NVTX gate needs no card (a range
    that cannot be pushed is skipped)."""
    monkeypatch.setenv(env.TRACE_XPROF, "1")
    path = str(tmp_path / "t.jsonl")
    tr = PT.configure(path)
    assert tr._xprof
    assert PT.configure(path) is tr
    with tr.span("chunk", "c0") as outer:
        W.guard("dispatch/chunk", 5.0,
                lambda: tr.span("round", "r0").end())
        tr.point("transfer", "h2d/chunk", dur_s=0.01, bytes=8, dir="h2d")
    tr.finish({"k": 1})
    assert tr.closed and PT.configure(None) is PT.NULL
    spans, m = _read_trace(path)
    by = {s["name"]: s for s in spans}
    assert by["r0"]["parent"] == outer.id == by["h2d/chunk"]["parent"]
    assert m["k"] == 1
    assert PT.parse_trace_ctx("abc:7") == PT.TraceContext("abc", 7)
    assert PT.parse_trace_ctx("abc") is None


# ---------------------------------------------------------------- ingest

def _fasta(n, seed, wrap=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        seq = bytes(np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, int(rng.integers(50, 200)))])
        body = seq if wrap is None else b"\n".join(
            seq[j:j + wrap] for j in range(0, len(seq), wrap))
        out.append(b">r%d some description\n%s\n" % (i, body))
    return b"".join(out)


def _fastq(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(50, 120))
        seq = bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, k)])
        out.append(b"@q%d\n%s\n+\n%s\n" % (i, seq, b"I" * k))
    return b"".join(out)


def _paf(n):
    return "".join(f"r{i}\t100\t0\t100\t+\tc0\t1000\t{i}\t{i + 100}\t90\t100"
                   f"\t60\n" for i in range(n)).encode()


def _offset(parsers_mod, kind, path):
    make = parsers_mod.create_overlap_parser if kind == "paf" \
        else parsers_mod.create_sequence_parser
    p = make(path)
    with pytest.raises(parsers_mod.ParseError) as ei:
        p.parse(-1)
    with pytest.raises(parsers_mod.ParseError, match="previously failed"):
        p.parse(-1)
    return ei.value.offset, str(ei.value)


@pytest.mark.parametrize("kind, ingest, spec", [
    ("fasta", "0", "io/read:5"), ("fasta", "1", "io/read:2"),
    ("fasta.wrapped", "0", "io/read:7"), ("fasta.wrapped", "1", "io/read:3"),
    ("fastq", "0", "io/read:9"), ("fastq", "1", "io/read:3"),
    ("paf", "1", "io/read:4"),
    ("members.fasta.gz", "1", "io/inflate:0"),
    ("members.fasta.gz", "1", "io/inflate:9"),
    ("members.fasta.gz", "1", "io/read:40"),
    ("one.fasta.gz", "1", "io/inflate:0"),
    ("one.fasta.gz", "0", "io/read:11"),
])
def test_io_fault_offsets_match_reference(tmp_path, monkeypatch, kind,
                                          ingest, spec):
    from racon_tpu.io import parsers as rp
    from racon_tpu.resilience import faults as rf
    monkeypatch.setenv(env.INGEST, ingest)
    monkeypatch.setenv(env.INGEST_WORKERS, "2")
    if kind.startswith("members"):
        data = b"".join(gzip.compress(_fasta(6, s)) for s in range(16))
    elif kind.startswith("one"):
        data = gzip.compress(_fasta(40, 3))
    else:
        data = {"fasta": _fasta(30, 1), "fasta.wrapped": _fasta(30, 2, 60),
                "fastq": _fastq(30, 4), "paf": _paf(30)}[kind]
    ext = {"paf": ".paf", "fastq": ".fastq"}.get(kind, "")
    path = str(tmp_path / (kind + ext if ext else kind))
    if not path.endswith((".gz", ".fasta", ".fastq", ".paf")):
        path += ".fasta"
    open(path, "wb").write(data)
    got = []
    for configure, mod in ((rf.configure, rp), (F.configure, PP)):
        configure(spec)
        try:
            got.append(_offset(mod, "paf" if kind == "paf" else "seq", path))
        finally:
            configure(None)
    (ref_off, ref_msg), (port_off, port_msg) = got
    assert port_off == ref_off
    assert "read failure" in port_msg and "injected fault" in port_msg
    assert metrics.registry().get("res_fault_injected_total") == 1


def test_stream_inflate_fault_offset_is_deterministic(tmp_path, monkeypatch):
    """A single-member gzip inflates on a producer thread; a fault at its
    second feed reaches the parser after the first feed's lines, every
    time (the reference's copy drops the queued feed, so its offset
    depends on the threads' timing)."""
    from racon_tpu_torch.io import inflate
    monkeypatch.setenv(env.INGEST, "1")
    data = _fasta(9000, 8)
    assert len(data) > inflate._FEED
    path = str(tmp_path / "big.fasta.gz")
    open(path, "wb").write(gzip.compress(data))
    want = data[:inflate._FEED].rfind(b"\n") + 1
    for _ in range(3):
        F.configure("io/inflate:1")
        try:
            off, _msg = _offset(PP, "seq", path)
        finally:
            F.configure(None)
        assert off == want


def test_prefetch_off_while_an_io_site_is_armed(monkeypatch):
    from racon_tpu.io import ingest as ri
    from racon_tpu.resilience import faults as rf
    cases = [(None, "1", True), ("h2d/chunk:0", "1", True),
             ("io/read:3", "1", False), ("io/inflate:p=0.5", "1", False),
             (None, "0", False)]
    for spec, gate, want in cases:
        monkeypatch.setenv(env.INGEST, gate)
        F.configure(spec)
        rf.configure(spec)
        assert PI.prefetch_ok() is want is ri.prefetch_ok(), (spec, gate)
