"""The comparison that decides ``correct``.

Every job of the window is judged; the plain reference
(``reference/``) runs once per distinct input, on the windows drawn for
it from the seed, after the window has closed. Each number has its own
limit (``limits/<cell>.json``, else ``limits/default.json``):

- ``failed_jobs``: jobs whose CLI exit code was not 0;
- ``targets_mismatch``: jobs whose parsed targets (names, lengths) or
  sequence count differ from the reference's parse;
- ``fasta_mismatch``: FASTA records (missing, extra or different) that
  are not the port's windows stitched in order under the reference's
  header (name, LN, RC from the reference's overlaps, XC);
- ``layers_mismatch``: sampled windows whose backbone or layers (begin,
  end, bases, qualities; the breaking points) differ from the
  reference's;
- ``consensus_mismatch_pct``: the share of sampled windows whose
  consensus (after the refinement rounds and the trim) or polished flag
  differs from the reference's.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

from portbench import jobs as jobs_mod
from portbench.spec import BENCH_DIR


def limits(cell: str) -> Dict[str, float]:
    d = os.path.join(BENCH_DIR, "limits")
    path = os.path.join(d, f"{cell}.json")
    if not os.path.isfile(path):
        path = os.path.join(d, "default.json")
    with open(path) as fh:
        return {k: float(v) for k, v in json.load(fh)["limits"].items()}


def expected_header(name: str, data: bytes, coverage: int, ratio: float,
                    fragment: bool) -> str:
    tags = "r" if fragment else ""
    return (f"{name}{tags} LN:i:{len(data)} RC:i:{coverage} "
            f"XC:f:{ratio:.6f}")


def compare(runs: List[jobs_mod.JobRun], refs: dict, samples: dict,
            fragment: bool) -> Dict[str, float]:
    """The numbers, over every job of the window."""
    failed = targets = fasta = layers = cons = n_windows = 0
    for run in runs:
        if run.rc != 0 or len(run.port) != 1:
            failed += 1
            continue
        port = run.port[0]
        ref = refs[run.input_index]
        if (port.target_names != ref.target_names
                or port.target_lengths != ref.target_lengths
                or port.n_sequences != ref.n_sequences):
            targets += 1
        cov = dict(zip(ref.target_names, ref.coverages))
        want = []
        for name, (data, ratio) in port.stitched.items():
            if ratio > 0:
                want.append((expected_header(name, data, cov.get(name, -1),
                                             ratio, fragment), data))
        got = jobs_mod.fasta_records(run.fasta)
        fasta += sum(1 for a, b in zip(got, want) if a != b) + \
            abs(len(got) - len(want))
        for g in samples[run.input_index]:
            n_windows += 1
            mine = port.windows.get(g)
            w = ref.windows[g]
            if mine is None:
                layers += 1
                cons += 1
                continue
            backbone, lays, consensus, polished = mine
            ref_lays = [(L.begin, L.end, L.data, L.quality)
                        for L in w.layers]
            if backbone != w.backbone or lays != ref_lays:
                layers += 1
            if consensus != w.consensus or polished != w.polished:
                cons += 1
    return {"failed_jobs": failed, "targets_mismatch": targets,
            "fasta_mismatch": fasta, "layers_mismatch": layers,
            "consensus_mismatch_pct":
                100.0 * cons / n_windows if n_windows else 0.0}


def verdict(numbers: Dict[str, float], lim: Dict[str, float]) -> bool:
    return all(numbers[k] <= lim[k] for k in numbers)
