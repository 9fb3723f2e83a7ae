"""The port's streaming pipeline (racon_tpu_torch/pipeline/) against the
JAX package's (racon_tpu/pipeline/, run under JAX_PLATFORMS=cpu).

- the queues, the stages and the slice tracker: the port-side cases
  of the reference's tests/test_pipeline.py (FIFO, close, backpressure,
  abort, stage order, a None return, a failure without a hang, an
  abandoned consumer, in-order release), with a timeout on every get,
  join and wait;
- the gates' truth table and depth, beside the reference's;
- stream_consensus on tests/test_pipeline.py's window set (trivial
  windows included) over RACON_TPU_SCHED x RACON_TPU_ADAPTIVE: the port's
  streamed consensus equals its serial engine's and the reference's
  stream_consensus;
- the polisher (polish_stream == polish; polish under RACON_TPU_PIPELINE=1)
  and the CLI (--pipeline-depth 2 against the reference CLI's bytes; a
  stage failure exits non-zero, a stall recovers with the clean bytes);
- the counters with two launching threads: the launch counts and the
  stage clock's per-thread attribution stay exact.
"""

import contextlib
import io
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from racon_tpu_torch.ops import device_poa as P
from racon_tpu_torch.ops import kernels
from racon_tpu_torch.pipeline import (BoundedQueue, Pipeline, PipelineAborted,
                                      QueueClosed, StageError, configure,
                                      metrics, pipeline_depth,
                                      pipeline_enabled, walk_async_enabled)
from racon_tpu_torch.pipeline.streaming import SliceTracker, stream_consensus
from racon_tpu_torch.utils import env

from window_sets import BASES, mutate, port_windows, reference_windows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 10.0   # seconds any get, join or wait here may take
_GATES = (env.PIPELINE, env.PIPELINE_DEPTH, env.WALK_ASYNC, env.WALK_QUEUE,
          env.STALL_S, env.SCHED, env.ADAPTIVE, env.INGEST)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """No gate from the caller's environment; the CLI depth and the
    counters start empty, and both engines' cap histories too. The stall
    detector's window is cut to 120 s, so that a pipeline that hangs in
    a test fails it instead (drain's own get has no timeout)."""
    from racon_tpu.ops import device_poa as R
    from racon_tpu.pipeline import configure as r_configure
    for name in _GATES:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv(env.STALL_S, "120")
    for mod in (R, P):
        monkeypatch.setattr(mod, "_CAP_HISTORY", set())
        monkeypatch.setattr(mod, "_BAND_HISTORY", set())
    configure(None)
    r_configure(None)
    metrics.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    configure(None)
    r_configure(None)


# ------------------------------------------------------------- queues


def test_queue_fifo_and_close_drain():
    q = BoundedQueue("q", 4)
    for i in range(3):
        q.put(i)
    q.close()
    assert [q.get(timeout=T) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(QueueClosed):
        q.get(timeout=T)
    with pytest.raises(RuntimeError, match="closed"):
        q.put(99)


def test_queue_backpressure_blocks_producer():
    q = BoundedQueue("q", 2)
    done = threading.Event()

    def produce():
        for i in range(6):
            q.put(i)
        done.set()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    assert not done.wait(0.05), "producer ran past the capacity bound"
    assert q.depth == 2
    got = [q.get(timeout=T) for _ in range(6)]
    t.join(timeout=T)
    assert not t.is_alive() and done.is_set() and got == list(range(6))
    m = q.metrics()
    assert m["peak"] == 2 and m["items"] == 6
    assert m["put_wait_s"] > 0


def test_queue_abort_unblocks_blocked_put_and_drops_items():
    q = BoundedQueue("q", 1)
    q.put(0)
    errs = []

    def blocked_put():
        try:
            q.put(1)
        except PipelineAborted:
            errs.append("put")

    t = threading.Thread(target=blocked_put, daemon=True)
    t.start()
    time.sleep(0.02)
    q.abort()
    t.join(timeout=T)
    assert not t.is_alive() and errs == ["put"]
    with pytest.raises(PipelineAborted):
        q.get(timeout=T)          # abort drops queued items too


# ------------------------------------------------------------- stages


def _stopped(pipe):
    """Every stage thread has exited (joined with a timeout)."""
    for s in pipe._stages:
        s.join(timeout=T)
    return not pipe.alive


def test_pipeline_happy_path_preserves_order():
    pipe = Pipeline("t")
    qa = pipe.queue("a", 2)
    qb = pipe.queue("b", 2)
    pipe.source("src", lambda: iter(range(10)), qa)
    pipe.stage("sq", lambda x: x * x, qa, qb)
    with pipe:
        out = list(pipe.drain(qb))
    assert out == [i * i for i in range(10)]
    assert _stopped(pipe)
    snap = metrics.registry().snapshot()
    assert snap["pipe_stage_sq_items"] == 10
    assert snap["pipe_queue_b_peak"] >= 1


def test_stage_returning_none_consumes_item():
    side = []
    pipe = Pipeline("t")
    qa = pipe.queue("a", 2)
    qb = pipe.queue("b", 2)

    def route(x):
        if x % 2:
            side.append(x)
            return None
        return x

    pipe.source("src", lambda: iter(range(6)), qa)
    pipe.stage("route", route, qa, qb)
    with pipe:
        out = list(pipe.drain(qb))
    assert out == [0, 2, 4] and side == [1, 3, 5]
    assert _stopped(pipe)


def test_stage_exception_propagates_without_hang():
    pipe = Pipeline("t")
    qa = pipe.queue("a", 1)
    qb = pipe.queue("b", 1)

    def boom(x):
        if x == 2:
            raise ValueError("stage blew up")
        return x

    pipe.source("src", lambda: iter(range(100)), qa)
    pipe.stage("boom", boom, qa, qb)
    t0 = time.perf_counter()
    with pipe:
        with pytest.raises(StageError, match="'boom' failed") as ei:
            list(pipe.drain(qb))
    assert isinstance(ei.value.__cause__, ValueError)
    assert _stopped(pipe)
    assert time.perf_counter() - t0 < T, "teardown hung"


def test_abandoned_consumer_tears_down_cleanly():
    pipe = Pipeline("t")
    qa = pipe.queue("a", 1)
    pipe.source("src", lambda: iter(range(100)), qa)
    with pipe:
        for _item in pipe.drain(qa):
            break                # consumer walks away mid-stream
    assert _stopped(pipe)


def test_stage_threads_enter_the_thread_context():
    seen = []

    @contextlib.contextmanager
    def ctx():
        seen.append(threading.current_thread().name)
        yield

    pipe = Pipeline("t", thread_context=ctx)
    qa = pipe.queue("a", 1)
    qb = pipe.queue("b", 1)
    pipe.source("src", lambda: iter(range(3)), qa)
    pipe.stage("id", lambda x: x, qa, qb)
    with pipe:
        assert list(pipe.drain(qb)) == [0, 1, 2]
    assert sorted(seen) == ["racon-pipe-id", "racon-pipe-src"]


def test_stall_detector_fails_the_pipeline(monkeypatch):
    monkeypatch.setenv(env.STALL_S, "0.3")
    release = threading.Event()
    pipe = Pipeline("t")
    qa = pipe.queue("a", 1)
    qb = pipe.queue("b", 1)
    pipe.source("src", lambda: iter(range(3)), qa)
    pipe.stage("wedged", lambda x: release.wait(T) and x, qa, qb)
    t0 = time.perf_counter()
    try:
        with pipe:
            with pytest.raises(StageError, match="stalled"):
                list(pipe.drain(qb))
            release.set()
    finally:
        release.set()
    assert time.perf_counter() - t0 < T
    assert _stopped(pipe)
    assert metrics.registry().get("pipe_stall_events") == 1


# ------------------------------------------------------- slice tracker


def test_slice_tracker_releases_in_order():
    tr = SliceTracker()
    tr.register(0, 0, 8, 2)
    tr.register(1, 8, 16, 1)
    tr.register(2, 16, 20, 1)
    assert tr.retire(1) == []
    assert tr.retire(0) == []
    assert tr.retire(0) == [(0, 0, 8), (1, 8, 16)]
    assert tr.retire(2) == [(2, 16, 20)]
    assert tr.flush() == []


def test_slice_tracker_zero_item_slice_releases():
    tr = SliceTracker()
    tr.register(0, 0, 4, 0)
    tr.register(1, 4, 8, 1)
    assert tr.retire(1) == [(0, 0, 4), (1, 4, 8)]


def test_slice_tracker_lost_item_fails_loudly():
    tr = SliceTracker()
    tr.register(0, 0, 4, 2)
    tr.retire(0)
    with pytest.raises(RuntimeError, match="never completed"):
        tr.flush()
    tr2 = SliceTracker()
    tr2.register(0, 0, 4, 1)
    tr2.retire(0)
    with pytest.raises(RuntimeError, match="more items"):
        tr2.retire(0)


# -------------------------------------------------------------- gating


def test_gating_truth_table_matches_reference(monkeypatch):
    from racon_tpu import pipeline as R
    rows = []
    for env_val, depth in ((None, None), ("1", None), ("1", 0), ("1", 3),
                           ("0", 3), ("false", 3), (None, 2), (None, 0)):
        if env_val is None:
            monkeypatch.delenv(env.PIPELINE, raising=False)
        else:
            monkeypatch.setenv(env.PIPELINE, env_val)
        configure(depth)
        R.configure(depth)
        rows.append(pipeline_enabled())
        assert pipeline_enabled() == R.pipeline_enabled(), (env_val, depth)
    assert rows == [False, True, False, True, False, False, True, False]
    for val in ("0", "false", "1", None):
        if val is None:
            monkeypatch.delenv(env.WALK_ASYNC, raising=False)
        else:
            monkeypatch.setenv(env.WALK_ASYNC, val)
        assert walk_async_enabled() == R.walk_async_enabled() == \
            (val not in ("0", "false"))


def test_gating_depth(monkeypatch):
    assert pipeline_depth() == 2           # DEFAULT_DEPTH
    configure(5)
    assert pipeline_depth() == 5
    configure(None)
    monkeypatch.setenv(env.PIPELINE_DEPTH, "7")
    assert pipeline_depth() == 7
    monkeypatch.setenv(env.PIPELINE_DEPTH, "bogus")
    with pytest.raises(ValueError, match="invalid"):
        pipeline_depth()
    with pytest.raises(ValueError, match="invalid pipeline depth"):
        configure(-1)


# ----------------------------------------------- streaming differential


def _stream(ws, chunk=8, depth=2):
    from racon_tpu_torch.ops.poa import PoaEngine
    ranges = list(stream_consensus(PoaEngine(device="cpu"), ws,
                                   chunk=chunk, depth=depth))
    assert [i for s, e in ranges for i in range(s, e)] == \
        list(range(len(ws)))
    return [w.consensus for w in ws]


_REF = {}


def reference_stream(sched, adaptive, n=24, seed=42):
    """The reference's stream_consensus on the same windows under the
    same gates (computed once per combination)."""
    key = (sched, adaptive, n, seed)
    if key not in _REF:
        from racon_tpu.ops import device_poa as R
        from racon_tpu.ops.poa import PoaEngine
        from racon_tpu.pipeline.streaming import stream_consensus as rsc
        saved = {k: os.environ.get(k) for k in (env.SCHED, env.ADAPTIVE)}
        hist = (R._CAP_HISTORY, R._BAND_HISTORY)
        os.environ[env.SCHED], os.environ[env.ADAPTIVE] = sched, adaptive
        R._CAP_HISTORY, R._BAND_HISTORY = set(), set()
        try:
            ws = reference_windows(n, seed)
            list(rsc(PoaEngine(backend="jax"), ws, chunk=8, depth=2))
        finally:
            R._CAP_HISTORY, R._BAND_HISTORY = hist
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        _REF[key] = [w.consensus for w in ws]
    return _REF[key]


@pytest.mark.parametrize("sched", ["1", "0"])
@pytest.mark.parametrize("adaptive", ["1", "0"])
def test_stream_consensus_matches_serial_and_reference(monkeypatch, sched,
                                                       adaptive):
    from racon_tpu_torch.ops.poa import PoaEngine
    monkeypatch.setenv(env.SCHED, sched)
    monkeypatch.setenv(env.ADAPTIVE, adaptive)
    serial = port_windows(24, 42)
    PoaEngine(device="cpu").consensus_windows(serial)
    monkeypatch.setattr(P, "_CAP_HISTORY", set())
    monkeypatch.setattr(P, "_BAND_HISTORY", set())
    metrics.reset()
    out = _stream(port_windows(24, 42))
    assert out == [w.consensus for w in serial]
    assert out == reference_stream(sched, adaptive)
    snap = metrics.registry().snapshot()
    assert snap["pipe_runs"] == 1
    for key in ("pipe_stage_build_items", "pipe_stage_pack_items",
                "pipe_stage_compute_busy_s", "pipe_stage_walk_stall_in_s",
                "pipe_queue_run_peak", "pipe_wall_s", "walk_fused_chunks"):
        assert key in snap, key


def test_stream_consensus_abandoned_generator_closes_cleanly():
    from racon_tpu_torch.ops.poa import PoaEngine
    gen = stream_consensus(PoaEngine(device="cpu"), port_windows(24, 7),
                           chunk=4, depth=1)
    next(gen)
    t0 = time.perf_counter()
    gen.close()
    assert time.perf_counter() - t0 < T, "generator close hung"


def test_stream_consensus_empty_input():
    from racon_tpu_torch.ops.poa import PoaEngine
    assert list(stream_consensus(PoaEngine(device="cpu"), [])) == []


def test_stream_consensus_stage_failure_raises(monkeypatch):
    """A failing stage reaches the caller; nothing finishes the windows on
    the host instead."""
    from racon_tpu_torch.ops.poa import PoaEngine

    def broken(*_a, **_k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(P, "dispatch_chunk", broken)
    monkeypatch.setenv(env.SCHED, "0")
    monkeypatch.setenv(env.WALK_ASYNC, "0")
    ws = port_windows(8, 3)
    with pytest.raises(StageError, match="'compute' failed") as ei:
        list(stream_consensus(PoaEngine(device="cpu"), ws, chunk=4))
    assert "launch failed" in str(ei.value.__cause__)
    assert all(w.consensus is None for w in ws if w.n_layers >= 2)


# --------------------------------------------------- polisher and CLI


def _write_two_contig_inputs(d, n_reads=8, clen=400):
    """tests/test_pipeline.py's two-contig workload."""
    rng = np.random.default_rng(11)
    drafts, reads, paf = [], [], []
    for ci in (1, 2):
        truth = BASES[rng.integers(0, 4, clen)]
        draft = mutate(rng, truth)
        drafts.append(b">c%d\n%s\n" % (ci, draft))
        for i in range(n_reads):
            r = mutate(rng, truth)
            name = f"c{ci}r{i}"
            reads.append(b">" + name.encode() + b"\n" + r + b"\n")
            paf.append(f"{name}\t{len(r)}\t0\t{len(r)}\t+\tc{ci}"
                       f"\t{len(draft)}\t0\t{len(draft)}"
                       f"\t{min(len(r), len(draft))}"
                       f"\t{max(len(r), len(draft))}\t60")
    (d / "draft.fasta").write_bytes(b"".join(drafts))
    (d / "reads.fasta").write_bytes(b"".join(reads))
    (d / "ovl.paf").write_text("\n".join(paf) + "\n")
    return [str(d / "reads.fasta"), str(d / "ovl.paf"), str(d / "draft.fasta")]


def _polisher(paths):
    from racon_tpu_torch.models.polisher import PolisherType, create_polisher
    p = create_polisher(*paths, PolisherType.kC, 200, 10.0, 0.3, 5, -4, -8,
                        device="cpu")
    p.window_chunk = 3      # several slices, so the stream interleaves them
    p.initialize()
    return p


def test_polish_stream_matches_polish(tmp_path, monkeypatch):
    paths = _write_two_contig_inputs(tmp_path)
    serial = _polisher(paths).polish(True)
    monkeypatch.setenv(env.PIPELINE, "1")
    streamed = list(_polisher(paths).polish_stream(True))
    assert [s.name for s in streamed] == [s.name for s in serial]
    assert [s.data for s in streamed] == [s.data for s in serial]
    assert len(serial) == 2
    # The gate sent polish_records through stream_consensus.
    assert metrics.registry().get("pipe_runs") == 1


def _cli_env(**gates):
    e = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
             MKL_NUM_THREADS="1", **gates)
    e.pop(env.STALL_S, None)      # communicate() below has its timeout
    e["PYTHONPATH"] = ROOT + os.pathsep + e.get("PYTHONPATH", "")
    return e


def test_cli_pipeline_depth_matches_reference_cli(tmp_path):
    """--pipeline-depth 2 on both CLIs, under the scheduler and under
    RACON_TPU_SCHED=0 (where the port walks decoupled), against the
    reference CLI's bytes at the same flags; all at once, one thread
    each."""
    from racon_tpu_torch.utils.synth import write_dataset
    ds = write_dataset(str(tmp_path), seed=23, n_contigs=2, contig_len=2500,
                       read_len=1200, coverage=14)
    p = ds["paths"]
    args = [p["reads"], p["overlaps"], p["draft"], "--pipeline-depth", "2"]
    procs = {"ref": subprocess.Popen(
        [sys.executable, "-m", "racon_tpu.cli", "--backend", "jax", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=_cli_env(),
        cwd=str(tmp_path))}
    for sched in ("1", "0"):
        procs[sched] = subprocess.Popen(
            [sys.executable, "-m", "racon_tpu_torch.cli", "--device", "cpu",
             *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=_cli_env(RACON_TPU_SCHED=sched), cwd=str(tmp_path))
    outs = {}
    for k, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (k, err.decode()[-2000:])
        outs[k] = out
    assert outs["ref"].startswith(b">ctg0 ") and outs["ref"].count(b">") == 2
    assert outs["1"] == outs["ref"]
    assert outs["0"] == outs["ref"]


def _run_cli(argv):
    from racon_tpu_torch import cli
    out_b = io.BytesIO()
    out_t = io.TextIOWrapper(out_b, encoding="utf-8")
    err = io.StringIO()
    with contextlib.redirect_stdout(out_t), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
        out_t.flush()
    return rc, out_b.getvalue(), err.getvalue()


def test_cli_rejects_negative_pipeline_depth(tmp_path):
    paths = _write_two_contig_inputs(tmp_path)
    rc, out, err = _run_cli([*paths, "--device", "cpu", "--pipeline-depth",
                             "-1"])
    assert rc == 1 and out == b"" and "invalid pipeline depth" in err


def test_cli_exits_nonzero_on_stage_failure_and_stall(tmp_path, monkeypatch):
    """A stage's exception ends the CLI with exit code 1 and no FASTA;
    nothing falls back to the host path. A stage that stops making
    progress trips the stall detector: with no fault plan armed the stall
    ends the run the same way. Under the reference's stall drill (an
    injected ``pipe/pack`` hang, tests/test_failslow.py) the stream
    recovers as the reference's does: every window past the last retired
    slice is polished on the host path, exit code 0, and the FASTA is the
    clean run's, byte for byte."""
    from racon_tpu_torch.resilience import faults
    from racon_tpu_torch.ops.poa import PoaEngine
    paths = _write_two_contig_inputs(tmp_path)
    argv = [*paths, "--device", "cpu", "-w", "200", "--pipeline-depth", "2"]
    make = PoaEngine._make_chunk_plan
    rc, clean, err = _run_cli(argv)
    assert rc == 0 and clean.count(b">") == 2, err
    metrics.reset()

    def broken(self, sp, ws):
        raise RuntimeError("pack failed")

    monkeypatch.setattr(PoaEngine, "_make_chunk_plan", broken)
    rc, out, err = _run_cli(argv)
    assert rc == 1 and out == b""
    assert "'pack' failed" in err and "pack failed" in err

    release = threading.Event()

    def wedged(self, sp, ws):
        release.wait(2.0)      # four stall windows
        return make(self, sp, ws)

    monkeypatch.setattr(PoaEngine, "_make_chunk_plan", wedged)
    monkeypatch.setenv(env.STALL_S, "0.5")
    metrics.reset()
    try:
        rc, out, err = _run_cli(argv)
    finally:
        release.set()
    assert rc == 1 and out == b""
    assert "stall detected" in err
    assert "stall not recovered: no fault plan is armed" in err
    assert metrics.registry().get("pipe_stall_events") == 1
    assert metrics.registry().get("res_degraded_windows", 0) == 0

    monkeypatch.setattr(PoaEngine, "_make_chunk_plan", make)
    metrics.reset()
    faults.configure("pipe/pack:0!hang=2")
    try:
        rc, out, err = _run_cli(argv)
    finally:
        faults.configure(None)
    assert rc == 0, err
    assert out == clean
    assert "stall detected" in err and "host path" in err
    assert metrics.registry().get("pipe_stall_events") == 1
    assert metrics.registry().get("res_degraded_windows", 0) > 0


# ------------------------------------------- counters, two threads


def test_launch_counts_exact_with_two_launching_threads():
    """Threads launching plain-version stages at once (as the compute and
    walk stages do), with a short switch interval: LAUNCHES loses no
    update, and the stage clock charges each stage only its own thread's
    launches."""
    kernels.reset_launches()
    clock = P.set_stage_clock(True)
    host = P.set_host_clock(True)
    cpu = torch.device("cpu")
    n_iter, n_threads = 400, 8
    start = threading.Barrier(n_threads)

    def worker(k):
        stage = "walk" if k % 2 else "forward"
        name = "col_walk" if k % 2 else "band_fwd"
        start.wait(T)
        for _ in range(n_iter):
            with P._stage(stage, cpu), P.host_part(stage):
                kernels._launched(name)
                kernels._launched("merge_votes")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
        P.set_stage_clock(False)
        P.set_host_clock(False)
    assert not any(t.is_alive() for t in threads)
    half = n_threads // 2 * n_iter
    assert kernels.LAUNCHES["col_walk"] == half
    assert kernels.LAUNCHES["band_fwd"] == half
    assert kernels.LAUNCHES["merge_votes"] == 2 * half
    assert clock.launches() == {
        "walk": {"col_walk": half, "merge_votes": half},
        "forward": {"band_fwd": half, "merge_votes": half}}
    assert host.n == {"walk": half, "forward": half}
    assert len(clock._ev["walk"]) == len(clock._ev["forward"]) == half
    kernels.reset_launches()


def test_registry_updates_exact_from_threads():
    reg = metrics.Registry()
    n_iter, n_threads = 2000, 8

    def worker(k):
        for i in range(n_iter):
            reg.inc("n")
            reg.max("peak", k * n_iter + i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert reg.get("n") == n_iter * n_threads
    assert reg.get("peak") == n_iter * n_threads - 1
