"""The port's benchmark: whole polishing jobs through
``racon_tpu_torch.cli.main`` on one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (``setup_s``, from process start to the window): torch and the
port imported on a CUDA card, the port's kernel library loaded from its
compile cache (``build/racon_tpu_torch/``), the benchmark's helper built
under ``build/benchmark/``, the cell's distinct jobs synthesised from the
seed under ``$TMPDIR``, and the first job run once untimed.

Window: whole cycles of the distinct jobs back to back, each job
``cli.main([reads, overlaps, targets, <options>, -t N, --device cuda])``
(``-f`` first in fragment correction); no cycle starts after
``--seconds``, so every distinct job runs the same number of times.
The traced run adds ``--trace <file>`` to each job and turns on
``torch.profiler``, the port's host clock and the K1/K3 launch log.

After the window: accuracy against the generator's truth, the plain
reference on the sampled windows, and one JSON line on stdout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from portbench import accuracy, check, spec  # noqa: E402

# Top-level module names that must not be loaded in the process that
# prints the result: JAX and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "racon_tpu")
MARKER = "portbench.window"


class RunError(RuntimeError):
    """The run cannot produce a result; nothing is printed on stdout."""


@dataclass
class TracedRun:
    """What a per-layer metric reader gets (portbench/reading.py)."""
    jobs: list
    trace: object
    launches: Dict[str, List[dict]]
    counts: Dict[str, object]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def card_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def diagnostics(runs, parts, accuracy_s, reference_s) -> dict:
    """What the result line carries besides the metrics, for whoever
    reads a run: set-up by part, each job's seconds, the jobs' mean
    logger phases and overlap counters, and the checks' seconds."""
    phases: Dict[str, float] = {}
    for r in runs:
        for k, v in r.phases().items():
            phases[k] = phases.get(k, 0.0) + v / len(runs)
    ovl = {k: v for k, v in runs[0].registry.items()
           if k.startswith("ovl_")} if runs else {}
    return {"setup_parts_s": parts,
            "job_s": [r.t1 - r.t0 for r in runs],
            "phases_mean_s": phases, "ovl_first_job": ovl,
            "accuracy_s": accuracy_s, "reference_s": reference_s}


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda") -> dict:
    """One run of a cell; returns the result object. ``device`` "cpu"
    serves only the benchmark's own rehearsal and tests."""
    import torch
    cell = spec.load_cell(cell_name)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RunError("no CUDA card: torch.cuda.is_available() is "
                           "false")
        if torch.cuda.device_count() < cell.chips:
            raise RunError(f"the cell needs {cell.chips} card(s), "
                           f"{torch.cuda.device_count()} visible")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    try:
        from racon_tpu_torch import cli  # noqa: F401
        from racon_tpu_torch.ops import device_poa, kernels
    except ImportError as exc:
        raise RunError(f"cannot import the port: {exc}") from exc
    from portbench import jobs as jobs_mod
    from portbench import profile as prof_mod
    from portbench.inputs import prepare_inputs

    parts = {"import": time.perf_counter() - T0}
    if device == "cuda":
        kernels._lib()               # the compile cache, or nvcc once
    ed = accuracy.EditDistance(ROOT)
    parts["libraries"] = time.perf_counter() - T0 - parts["import"]
    config, traffic = cell.config, cell.traffic
    fragment = traffic["mode"] == "ava"
    options = [str(x) for x in config["racon_options"]]
    threads = int(traffic["threads"])
    tmp = tempfile.mkdtemp(prefix=f"portbench-{cell_name}-")
    try:
        t = time.perf_counter()
        inputs, samples = prepare_inputs(config, traffic, seed, tmp)
        parts["synthesis"] = time.perf_counter() - t

        def argv(k: int, trace_path: Optional[str] = None) -> List[str]:
            a = inputs[k].argv(threads, options, device)
            return a + (["--trace", trace_path] if trace_path else [])

        capture = jobs_mod.Capture()
        capture.install()
        warm = jobs_mod.run_job(argv(0), 0, capture, [])
        parts["warm_up_job"] = warm.t1 - warm.t0
        if warm.rc != 0:
            raise RunError(f"the warm-up job failed (rc {warm.rc}):\n"
                           f"{warm.stderr[-4000:]}")
        launch_log = host_clock = prof = None
        if trace:
            launch_log = prof_mod.LaunchLog(spec.kernel_counts())
            launch_log.install()
            host_clock = device_poa.set_host_clock(True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        # The window.
        trace_files = []

        def run_one(i: int, k: int):
            tpath = None
            if trace:
                tpath = os.path.join(tmp, f"trace{i}.jsonl")
            r = jobs_mod.run_job(argv(k, tpath), k, capture, samples[k],
                                 host_clock)
            r.target_bases = inputs[k].target_bases
            r.n_windows = inputs[k].n_windows
            if trace:
                from racon_tpu_torch.obs import trace as port_trace
                trace_files.append((tpath, port_trace.get_tracer()._t0))
            return r

        if prof is not None:
            prof.__enter__()
        marker = torch.profiler.record_function(MARKER)
        marker.__enter__()
        w0 = time.perf_counter()
        setup_s = w0 - T0
        runs = jobs_mod.run_window(run_one, len(inputs), seconds)
        if device == "cuda":
            torch.cuda.synchronize()
        w1 = time.perf_counter()
        marker.__exit__(None, None, None)
        if prof is not None:
            prof.__exit__(None, None, None)
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
        capture.uninstall()
        if trace:
            launch_log.uninstall()
            device_poa.set_host_clock(False)

        done = [r for r in runs if r.rc == 0]
        failed = len(runs) - len(done)
        result = {"correct": False, "attempted": len(runs),
                  "failed": failed, "metrics": {}}
        metrics = result["metrics"]
        if trace:
            dtrace = (prof_mod.device_trace(prof, MARKER, w0, w1)
                      if device == "cuda" else prof_mod.DeviceTrace(w1 - w0))
            spans = []
            for path, t0p in trace_files:
                spans.extend(prof_mod.read_spans(path, t0p, w0))
            traced = TracedRun(done, dtrace, launch_log.host(),
                               launch_log.counts)
            for m in cell.per_layer:
                value = spec.metric_reader(m["name"]).read(traced)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            result["breakdown"] = prof_mod.breakdown(dtrace, spans)
        else:
            errors = total = 0
            cache: Dict[bytes, tuple] = {}
            for r in done:
                if r.fasta not in cache:
                    recs = [(h.split(" ", 1)[0], d)
                            for h, d in jobs_mod.fasta_records(r.fasta)]
                    cache[r.fasta] = accuracy.job_errors(
                        ed, recs, inputs[r.input_index].truth)
                e, n = cache[r.fasta]
                errors += e
                total += n
            want = {
                "polished_kbp_per_s": jobs_mod.kbp_per_s(runs),
                "polished_qv": accuracy.qv(errors, total) if total else 0.0,
                "peak_device_gib": peak / 2 ** 30,
                "setup_s": setup_s,
            }
            for m in cell.end_to_end:
                if m["name"] in want:
                    metrics[m["name"]] = {"value": want[m["name"]],
                                          "unit": m["unit"]}
        t_post = time.perf_counter()
        # Free the port's device memory before the reference runs.
        if device == "cuda":
            torch.cuda.empty_cache()
        from reference.polish import reference_jobs
        refs = dict(enumerate(reference_jobs(
            [(j.reads, j.overlaps, j.targets, j.fragment_correction,
              samples[k]) for k, j in enumerate(inputs)], options,
            device=device)))
        t_ref = time.perf_counter()
        numbers = check.compare(runs, refs, samples, fragment)
        lim = check.limits(cell_name)
        result["correct"] = check.verdict(numbers, lim)
        gpu = (torch.cuda.get_device_name(0) if device == "cuda"
               else "cpu")
        result["device"] = {"platform": "gpu" if device == "cuda" else "cpu",
                            "kind": gpu, "count": cell.chips,
                            "memory_peak_bytes": int(peak)}
        if trace:
            result["device"]["busy_s"] = dtrace.busy_s()
            result["device"]["window_s"] = dtrace.window_s
        result["card"] = card_limit() if device == "cuda" else "cpu"
        result["diag"] = diagnostics(runs, parts, t_post - w1,
                                     t_ref - t_post)
        result["checks"] = {k: {"value": v, "limit": lim[k]}
                            for k, v in numbers.items()}
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace))
    except (RunError, spec.SpecError) as exc:
        print(f"[portbench] error: {exc}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"[portbench] error: the process loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"[portbench] check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
