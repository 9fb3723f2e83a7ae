"""Shared set-up of the benchmark's own tests: the benchmark's folder and
the checkout's root on ``sys.path``, and cells cut to a size the CPU
runs in seconds."""

import copy
import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (BENCH, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

with open(os.path.join(ROOT, "BENCHMARK.json")) as _fh:
    _WORKLOADS = json.load(_fh)["workloads"]
# The cells of BENCHMARK.json, and the traffic each names.
CELLS = [w["name"] for w in _WORKLOADS]
TRAFFIC = {w["name"]: w["traffic"] for w in _WORKLOADS}

# Each traffic mix cut to a job the port polishes on the CPU in a few
# seconds; every other parameter stays the mix's own.
TINY = {
    "contig-250kbp": {
        "contig_bp": [6000], "distinct_jobs": 1, "threads": 2,
        "read_length": {"dist": "lognormal", "n50": 2500, "sigma": 0.5,
                        "min": 800, "max": 5000, "length_seed": 1},
        "sample": {"clusters": 2, "windows": 3}},
    "chroms-1-3-6": {
        "contig_bp": [2000, 2500, 1500], "distinct_jobs": 1, "threads": 2,
        "read_length": {"dist": "lognormal", "n50": 1500, "sigma": 0.5,
                        "min": 600, "max": 2500, "length_seed": 2},
        "sample": {"clusters": 2, "windows": 3}},
    "ava-50kb": {
        "region_bp": 5000, "distinct_jobs": 1, "threads": 2,
        "read_length": {"dist": "lognormal", "n50": 2500, "sigma": 0.5,
                        "min": 1200, "max": 4000, "length_seed": 1},
        "min_overlap_bp": 500, "sample": {"targets": 2}},
}


@pytest.fixture
def tiny_cells(monkeypatch):
    """``spec.load_cell`` returning each cell with its traffic at the
    TINY size."""
    from portbench import spec
    orig = spec.load_cell

    def load(name, root=spec.ROOT):
        cell = orig(name, root)
        cell.traffic = copy.deepcopy(cell.traffic)
        cell.traffic.update(TINY[TRAFFIC[name]])
        return cell

    monkeypatch.setattr(spec, "load_cell", load)
    return load


def tiny_mix(config: str, traffic: str):
    """A configuration file and a traffic mix at its TINY size, by their
    file names, whether or not a cell names them."""
    with open(os.path.join(BENCH, "configs", config + ".json")) as fh:
        cfg = json.load(fh)
    with open(os.path.join(BENCH, "traffic", traffic + ".json")) as fh:
        mix = json.load(fh)
    mix.update(copy.deepcopy(TINY[traffic]))
    return cfg, mix
