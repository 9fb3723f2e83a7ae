"""Readings for the limits of ``correct``: the program's, the control's
and the planted faults'.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--controls int16,int8,bf16] [--faults base_altered --seconds 1]

For every seed: the cell's distinct jobs made as a run makes them, each
polished once through ``racon_tpu_torch.cli.main`` on the card, and judged
by ``portbench.check`` against the plain reference on the windows a run
samples (the lower readings). For each control the reference is put in
the program's place, computed in a lower precision, and its windows are
judged by the same ``check.compare`` and ``check.verdict`` (the upper
readings); the control makes only the sampled windows, so its FASTA is
not judged:

- ``int16``, ``int8``: every DP score of both aligners saturated to that
  signed type (the port's cells are int32);
- ``bf16``, ``fp8``: the vote sums accumulated in bfloat16 or
  float8_e4m3fn, one rounded add at a time (the port's are float32).

For each planted fault (``portbench/faults.py``), a whole run of the cell
(``run.run``) with the fault in place, at the cell's own size.

One JSON line per seed and reading on stdout. The benchmark's own runs
never run this.
"""

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

CONTROLS = {
    "int16": {"score_bits": 16},
    "int8": {"score_bits": 8},
    "bf16": {"vote_dtype": "bfloat16"},
    "fp8": {"vote_dtype": "float8_e4m3fn"},
}


def as_run(k: int, job):
    """A reference's job (``reference.polish.JobRef``) in the program's
    place: the job run of input ``k`` that ``check.compare`` reads, with
    the sampled windows and no FASTA."""
    from portbench import jobs as jobs_mod
    windows = {g: (w.backbone,
                   [(x.begin, x.end, x.data, x.quality) for x in w.layers],
                   w.consensus, w.polished)
               for g, w in job.windows.items()}
    summary = jobs_mod.PortSummary(job.target_names, job.target_lengths,
                                   job.n_sequences, windows, {})
    return jobs_mod.JobRun(k, 0, b"", "", 0.0, 0.0, [summary])


def readings(cell_name: str, seeds, controls, device: str = "cuda",
             control_seeds=None):
    """Yield one record per seed (the program) and per control seed and
    control."""
    import torch
    from portbench import check, jobs as jobs_mod, spec
    from portbench.inputs import prepare_inputs
    from reference.polish import reference_jobs
    cell = spec.load_cell(cell_name)
    config, traffic = cell.config, cell.traffic
    options = [str(x) for x in config["racon_options"]]
    fragment = traffic["mode"] == "ava"
    control_seeds = set(control_seeds if control_seeds is not None
                        else seeds)
    capture = jobs_mod.Capture()
    capture.install()
    try:
        for seed in seeds:
            with tempfile.TemporaryDirectory(prefix="portbench-ctl-") as tmp:
                inputs, samples = prepare_inputs(config, traffic, seed, tmp)
                runs = []
                t0 = time.perf_counter()
                for k, job in enumerate(inputs):
                    argv = job.argv(int(traffic["threads"]), options,
                                    device)
                    runs.append(jobs_mod.run_job(argv, k, capture,
                                                 samples[k]))
                port_s = time.perf_counter() - t0
                if device == "cuda":
                    torch.cuda.empty_cache()
                t0 = time.perf_counter()
                specs = [(j.reads, j.overlaps, j.targets,
                          j.fragment_correction, samples[k])
                         for k, j in enumerate(inputs)]
                refs = dict(enumerate(reference_jobs(specs, options,
                                                     device=device)))
                ref_s = time.perf_counter() - t0
                lim = check.limits(cell_name)
                nums = check.compare(runs, refs, samples, fragment)
                yield {"seed": seed, "who": "program",
                       "correct": check.verdict(nums, lim), **nums,
                       "windows": sum(len(s) for s in samples.values()),
                       "port_s": port_s, "reference_s": ref_s}
                runs.clear()
                if seed not in control_seeds:
                    continue
                for name in controls:
                    kw = dict(CONTROLS[name])
                    if "vote_dtype" in kw:
                        kw["vote_dtype"] = getattr(torch, kw["vote_dtype"])
                    other = reference_jobs(specs, options, device=device,
                                           **kw)
                    nums = check.compare(
                        [as_run(k, job) for k, job in enumerate(other)],
                        refs, samples, fragment)
                    yield {"seed": seed, "who": f"control:{name}",
                           "correct": check.verdict(nums, lim), **nums}
    finally:
        capture.uninstall()


def fault_readings(cell_name: str, seeds, faults, seconds: float,
                   device: str = "cuda"):
    """Yield one record per seed and planted fault: a whole run of the
    cell with the fault in place."""
    import run as bench
    from portbench.faults import planted
    for seed in seeds:
        for name in faults:
            with planted(name) as number:
                res = bench.run(cell_name, seed, seconds, False,
                                device=device)
            yield {"seed": seed, "who": f"fault:{name}", "catches": number,
                   "correct": res["correct"], "attempted": res["attempted"],
                   **{k: c["value"] for k, c in res["checks"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default=None)
    ap.add_argument("--controls", default="int16,int8,bf16")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=1.0,
                    help="each fault run's window")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("[portbench] error: no CUDA card", file=sys.stderr)
        return 2
    from racon_tpu_torch.ops import kernels
    kernels._lib()
    seeds = [int(s) for s in args.seeds.split(",")]
    cs = ([int(s) for s in args.control_seeds.split(",")]
          if args.control_seeds else None)
    controls = [c for c in args.controls.split(",") if c]
    for rec in readings(args.workload, seeds, controls, control_seeds=cs):
        print(json.dumps(rec), flush=True)
    faults = [f for f in args.faults.split(",") if f]
    for rec in fault_readings(args.workload, cs or seeds, faults,
                              args.seconds):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
