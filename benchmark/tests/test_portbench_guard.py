"""What a run refuses: a host with no card, and a process that loaded JAX
or the JAX package (top-level module names compared whole: the port's
name begins with the JAX package's)."""

import ast
import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "racon_tpu"}


def test_a_run_with_no_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "ecoli_ont.polish", "--seed",
                        "4294967311", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA card" in p.stderr


_PROBE = r"""
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
{body}
print(json.dumps(sorted({{m.split('.', 1)[0] for m in sys.modules}})))
"""


def _top_names(body: str):
    code = _PROBE.format(bench=BENCH, root=ROOT, body=body)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax_nor_the_jax_package():
    """Every module a run loads, after a run of the smallest cell on the
    CPU path the tests use (the card's path loads the same modules)."""
    body = """
import copy
import run as bench
from portbench import spec
orig = spec.load_cell
def load(name, root=spec.ROOT):
    c = orig(name, root)
    c.traffic = copy.deepcopy(c.traffic)
    c.traffic.update({"contig_bp": [3000], "distinct_jobs": 1,
        "threads": 1, "read_length": {"dist": "lognormal", "n50": 1500,
        "sigma": 0.4, "min": 800, "max": 2500, "length_seed": 1},
        "sample": {"clusters": 1, "windows": 2}})
    return c
spec.load_cell = load
res = bench.run("ecoli_ont.polish", 3, 0.1, False, device="cpu")
assert res["correct"], res
"""
    names = _top_names(body)
    assert "racon_tpu_torch" in names          # the probe saw the port
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = _top_names("import reference.polish, reference.nw")
    assert not names & (FORBIDDEN | {"racon_tpu_torch", "portbench"})


@pytest.mark.parametrize("folder", ["reference", "portbench", "metrics",
                                    "counts"])
def test_sources_import_no_jax(folder):
    """A look at the imports written in the benchmark's sources, the
    reference's held to numpy, torch and the standard library."""
    d = os.path.join(BENCH, folder)
    allowed = {"numpy", "torch", "reference", "__future__", "re",
               "dataclasses", "typing"}
    for f in sorted(os.listdir(d)):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(d, f)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                top = m.split(".", 1)[0]
                assert top not in FORBIDDEN, (f, m)
                if folder == "reference":
                    assert top in allowed, (f, m)
