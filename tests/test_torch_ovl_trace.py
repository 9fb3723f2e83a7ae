"""The align phase's host steps, the ingest waits and the consensus chunk
loop as the tracer's ``dispatch`` spans, and the align phase's always-on
step counters (obs/metrics.OVL_STEP_KEYS).

A small PAF job runs through ``Polisher`` on the CPU with a ``Tracer``
on a tmp file. The card's route runs there too, on its plain versions:
the job's engine reads as a CUDA one while the overlaps are aligned, the
route's device is the CPU, and the admission sends every overlap of odd
query length to the host aligner, so all six steps run. Then:

- ``seq_transmute``, ``ovl_prep``, the launch spans, ``ovl_collect``,
  ``host_align`` and ``bp_walk`` follow one another inside the "aligned
  overlaps" phase span and cover it;
- no two ``dispatch`` spans of the job overlap;
- the three counters are present, above 0, and sum to at most
  ``align_phase_seconds``; with the null tracer nothing is written and
  they still count;
- ``ingest_wait`` spans come from the prefetching ingest plane;
- under the convergence scheduler, ``poa_plan`` and ``poa_apply`` take
  turns with the ``chunk`` spans and overlap none of them.

Plus the tracer's ``t0_perf`` origin, and one card case (skips without a
GPU): ``ovl_prep`` before every launch, ``ovl_collect`` after the last.
"""

import io
import json
import types

import pytest
import torch

from racon_tpu_torch.obs import metrics, trace
from racon_tpu_torch.ops import ovl_align
from racon_tpu_torch.utils import env
from racon_tpu_torch.utils.logger import Logger
from racon_tpu_torch.utils.synth import write_dataset

ALIGNED = "[racon_tpu_torch::Polisher::initialize] aligned overlaps"
# Span t0 and dur_s are rounded to microseconds.
EPS = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _job(paths, tracer, monkeypatch, card_on_cpu=True):
    """One kC job through Polisher (initialize, then polish) with
    ``tracer`` as the process tracer and the registry from zero; returns
    the registry's snapshot after it."""
    from racon_tpu_torch.models.polisher import PolisherType, create_polisher
    for name in (env.TRACE, env.SCHED, env.INGEST, env.PIPELINE,
                 env.PIPELINE_DEPTH):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(trace, "_tracer", tracer)
    metrics.reset()
    p = create_polisher(*paths, PolisherType.kC, 200, 10.0, 0.3, 5, -4, -8,
                        device="cpu", logger=Logger(stream=io.StringIO()))
    p.window_chunk = 4      # two chunks, each a consensus call's
    engine = p.engine
    if card_on_cpu:
        route = ovl_align.device_breaking_points
        monkeypatch.setenv(env.OVL_TILED, "0")
        # 16-lane chunks: the plain forward's work goes with the lanes.
        monkeypatch.setattr(ovl_align, "TB", 16)
        monkeypatch.setattr(ovl_align, "untiled_admits",
                            lambda lq, lt: lq % 2 == 0)
        monkeypatch.setattr(
            ovl_align, "device_breaking_points",
            lambda *a, **kw: route(*a, **dict(kw, device="cpu")))
        p.engine = types.SimpleNamespace(device=torch.device("cuda"))
    try:
        p.initialize()
    finally:
        p.engine = engine
    assert p.polish()
    snap = metrics.registry().snapshot()
    tracer.finish()
    return snap


def _spans(path):
    lines = [json.loads(ln) for ln in open(path, encoding="utf-8")]
    assert lines[0]["ev"] == "begin"
    return [s for s in lines[1:] if s["ev"] == "span"]


def _end(s):
    return s["t0"] + s["dur_s"]


def _dispatch(spans):
    return sorted((s for s in spans if s["kind"] == "dispatch"),
                  key=lambda s: s["t0"])


@pytest.fixture(scope="module")
def traced_job(tmp_path_factory):
    """The traced job: (spans, registry snapshot)."""
    d = tmp_path_factory.mktemp("ovl_trace")
    paths = write_dataset(str(d / "in"), seed=3, contig_len=1600,
                          read_len=800, coverage=6)["paths"]
    path = str(d / "trace.jsonl")
    with pytest.MonkeyPatch.context() as mp:
        snap = _job([paths["reads"], paths["overlaps"], paths["draft"]],
                    trace.Tracer(path), mp)
    return _spans(path), snap


def test_align_phase_steps_are_dispatch_spans_inside_the_phase(traced_job):
    spans, _ = traced_job
    phase = [s for s in spans if s["kind"] == "phase" and s["name"] == ALIGNED]
    assert len(phase) == 1
    p0, p1 = phase[0]["t0"], _end(phase[0])
    steps = [s for s in _dispatch(spans) if p0 - EPS <= s["t0"] <= p1 + EPS]
    names = [s["name"] for s in steps]
    assert names[0] == "seq_transmute" and names[1] == "ovl_prep"
    assert names[-3:] == ["ovl_collect", "host_align", "bp_walk"]
    assert set(names[2:-3]) == {"ovl_chunk"}
    assert all(_end(s) <= p1 + EPS for s in steps)
    by = {s["name"]: s for s in steps}
    assert by["host_align"]["jobs"] > 0 and by["host_align"]["threads"] == 1
    assert by["bp_walk"]["overlaps"] == by["ovl_prep"]["overlaps"] > \
        by["ovl_prep"]["jobs"] > 0
    # The spans cover the phase but for the few statements between them.
    covered = sum(s["dur_s"] for s in steps)
    assert covered <= phase[0]["dur_s"] + EPS
    assert covered >= 0.95 * phase[0]["dur_s"]


def test_no_two_dispatch_spans_overlap(traced_job):
    spans, _ = traced_job
    disp = _dispatch(spans)
    assert len(disp) > 10
    for a, b in zip(disp, disp[1:]):
        assert _end(a) <= b["t0"] + EPS, (a["name"], b["name"])


def test_step_counters_are_positive_and_within_the_phase(traced_job):
    _, snap = traced_job
    steps = {k: snap.get(k) for k in metrics.OVL_STEP_KEYS}
    assert all(v is not None and v > 0 for v in steps.values()), steps
    assert sum(steps.values()) <= snap["align_phase_seconds"]
    assert snap["ovl_device_jobs"] > 0 and snap["ovl_native_jobs"] > 0
    assert metrics.ovl_extras(metrics.MetricsRegistry()) == {}
    reg = metrics.MetricsRegistry()
    for k, v in snap.items():
        reg.set(k, v)
    assert {k: metrics.ovl_extras(reg)[k] for k in steps} == \
        {k: round(v, 4) for k, v in steps.items()}


def test_null_tracer_writes_nothing_and_still_counts(tmp_path, monkeypatch):
    paths = write_dataset(str(tmp_path / "in"), seed=4, contig_len=800,
                          read_len=600, coverage=6)["paths"]
    before = sorted(p.name for p in tmp_path.rglob("*"))
    snap = _job([paths["reads"], paths["overlaps"], paths["draft"]],
                trace.NULL, monkeypatch)
    assert sorted(p.name for p in tmp_path.rglob("*")) == before
    assert all(snap.get(k, 0) > 0 for k in metrics.OVL_STEP_KEYS), snap


def test_ingest_waits_are_dispatch_spans(traced_job):
    spans, _ = traced_job
    waits = [s for s in spans if s["name"] == "ingest_wait"]
    assert waits and all(s["kind"] == "dispatch" for s in waits)
    assert {s["file"] for s in waits} == {"targets", "reads", "overlaps"}
    loaded = [s for s in spans if s["kind"] == "phase" and
              s["name"].endswith("loaded overlaps")]
    assert all(_end(s) <= _end(loaded[0]) + EPS for s in waits)


def test_poa_plan_and_apply_take_turns_with_chunks(traced_job):
    spans, _ = traced_job
    loop = sorted((s for s in spans if s["name"] in ("poa_plan",
                                                     "poa_apply") or
                   (s["kind"] == "chunk" and
                    s["name"].startswith("chunk"))),
                  key=lambda s: s["t0"])
    names = ["chunk" if s["kind"] == "chunk" else s["name"] for s in loop]
    chunks = names.count("chunk")
    assert chunks >= 2
    assert names.count("poa_plan") == names.count("poa_apply") == chunks
    for i, name in enumerate(names):
        if name == "chunk":
            # Its own plan (or the next chunk's, started first) before
            # it, its apply right after it.
            assert names[i - 1] == "poa_plan" and \
                names[i + 1] == "poa_apply"
    for a, b in zip(loop, loop[1:]):
        assert _end(a) <= b["t0"] + EPS, (a["name"], b["name"])


def test_tracer_begin_line_carries_its_perf_counter_origin(tmp_path):
    path = str(tmp_path / "t.jsonl")
    tracer = trace.Tracer(path)
    tracer.finish()
    begin = json.loads(open(path, encoding="utf-8").readline())
    assert begin["schema"] == trace.SCHEMA_VERSION == 1
    assert begin["t0_perf"] == tracer._t0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("torch.cuda.is_available() is False: no GPU on this host")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_route_spans_bracket_the_launches(cuda, tmp_path, monkeypatch):
    """On the card, with reads long enough for both routes: ``ovl_prep``
    ends before the first launch span, ``ovl_collect`` starts after the
    last, and no two dispatch spans of the job overlap."""
    from racon_tpu_torch.models.polisher import PolisherType, create_polisher
    paths = write_dataset(str(tmp_path / "in"), seed=6, contig_len=20000,
                          read_len=9500, coverage=6)["paths"]
    for name in (env.TRACE, env.OVL_TILED, env.PIPELINE):
        monkeypatch.delenv(name, raising=False)
    path = str(tmp_path / "trace.jsonl")
    tracer = trace.Tracer(path)
    monkeypatch.setattr(trace, "_tracer", tracer)
    metrics.reset()
    p = create_polisher(paths["reads"], paths["overlaps"], paths["draft"],
                        PolisherType.kC, 500, 10.0, 0.3, 5, -4, -8,
                        device="cuda", logger=Logger(stream=io.StringIO()))
    p.initialize()
    tracer.finish()
    disp = _dispatch(_spans(path))
    names = [s["name"] for s in disp]
    launches = [s for s in disp if s["name"] in ("ovl_chunk",
                                                 "ovl_tiled_chunk")]
    assert {s["name"] for s in launches} == {"ovl_chunk", "ovl_tiled_chunk"}
    prep = disp[names.index("ovl_prep")]
    collect = disp[names.index("ovl_collect")]
    assert all(_end(prep) <= s["t0"] + EPS for s in launches)
    assert all(_end(s) <= collect["t0"] + EPS for s in launches)
    for a, b in zip(disp, disp[1:]):
        assert _end(a) <= b["t0"] + EPS, (a["name"], b["name"])
    assert metrics.registry().get("ovl_card_s") > 0
