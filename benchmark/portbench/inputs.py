"""A run's distinct jobs and the windows the check compares in each,
all drawn from the seed."""

from __future__ import annotations

import os
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

from portbench.jobs import sample_windows
from portbench.synth import Job, make_job


def target_lengths(job: Job) -> List[int]:
    """Lengths of the job's target records (one line of bases each)."""
    with open(job.targets, "rb") as fh:
        lines = fh.read().split(b"\n")
    step = 4 if lines[0].startswith(b"@") else 2
    return [len(lines[k + 1]) for k in range(0, len(lines) - step + 1, step)]


def prepare_inputs(config: dict, traffic: dict, seed: int, tmp: str
                   ) -> Tuple[List[Job], Dict[int, List[int]]]:
    n = int(traffic["distinct_jobs"])
    args = [(os.path.join(tmp, f"job{k}"), config, traffic, seed, k)
            for k in range(n)]
    if n == 1:
        inputs = [make_job(*args[0])]
    else:
        # The distinct jobs synthesise side by side, one process each
        # (spawned: this process may hold CUDA and threads); the pool's
        # processes have ended when the block closes.
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=n, mp_context=ctx) as pool:
            inputs = list(pool.map(make_job, *zip(*args)))
    rng = np.random.default_rng([seed, 1 << 20])
    w = int(config["window_length"])
    samples = {}
    for k, job in enumerate(inputs):
        per_target = [-(-n // w) for n in target_lengths(job)]
        samples[k] = sample_windows(rng, job.n_windows, per_target,
                                    traffic["sample"])
    return inputs, samples
