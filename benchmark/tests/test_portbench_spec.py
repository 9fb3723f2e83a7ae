"""The benchmark as data: BENCHMARK.json against its contract, every file
it names found by name, and an added file picked up with no edit."""

import json
import os
import re
import shutil

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_benchmark_json_keeps_to_its_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    # A full check of 24 cells fits 43200 s.
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + \
        [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) <= 64 * 1024


def test_every_named_piece_loads_as_data():
    from portbench import spec
    b = bench()
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.traffic["mode"] in ("contigs", "ava")
        assert cell.config["window_length"] == int(
            cell.config["racon_options"][1])
    for m in b["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)
    counts = spec.kernel_counts()
    assert set(counts) == {"band_fwd", "band_tile_fwd"}
    from racon_tpu_torch.ops import kernels
    assert all(hasattr(c, "SYMBOL") and callable(c.count) and
               callable(getattr(kernels, c.LAUNCH)) for c in counts.values())


def test_an_added_cell_metric_and_count_are_found(tmp_path, monkeypatch):
    """A copy of the benchmark with one more traffic mix, cell, per-layer
    metric and kernel count, all as new files and entries."""
    from portbench import spec
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    (root / "benchmark" / "traffic" / "contig-2mbp.json").write_text(
        json.dumps({"mode": "contigs", "contig_bp": [2000000]}))
    b["workloads"].append({"name": "ecoli_ont.big", "config":
                           "ecoli-k12-ont-r9", "traffic": "contig-2mbp",
                           "chips": 1, "why": "a bigger contig"})
    (root / "benchmark" / "metrics" / "jobs_in_window.py").write_text(
        "def read(run):\n    return float(len(run.jobs))\n")
    b["per_layer"].append({"name": "jobs_in_window", "unit": "jobs",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "polished_kbp_per_s",
                           "workloads": ["ecoli_ont.big"]})
    (root / "benchmark" / "counts" / "merge_votes.py").write_text(
        "SYMBOL = 'merge_votes_kernel'\nLAUNCH = 'merge_votes'\n\n"
        "def count(launch):\n    return 0, 0\n")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(spec, "BENCH_DIR", str(root / "benchmark"))
    cell = spec.load_cell("ecoli_ont.big", root=str(root))
    assert cell.traffic["contig_bp"] == [2000000]
    assert [m["name"] for m in cell.per_layer] == ["jobs_in_window"]

    class Run:
        jobs = [1, 2, 3]
    assert spec.metric_reader("jobs_in_window").read(Run) == 3.0
    assert "merge_votes" in spec.kernel_counts()


def test_a_missing_piece_is_refused():
    from portbench import spec
    with pytest.raises(spec.SpecError):
        spec.load_cell("no.such_cell")
    with pytest.raises(spec.SpecError):
        spec.metric_reader("no_such_metric")
