"""The benchmark as data: ``BENCHMARK.json`` at the checkout's root, and
the files it names, found by name under the benchmark's folder.

- a configuration is ``configs/<config>.json`` (the file its entry names);
- a traffic mix is ``traffic/<traffic>.json``;
- a per-layer metric is ``metrics/<metric>.py`` with ``read(run)``;
- a kernel's count of operations and bytes is ``counts/<kernel>.py``
  with ``SYMBOL`` (the device kernel's name) and ``count(launch)``.

Adding any of them is adding files and entries; the harness needs no
edit.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class SpecError(RuntimeError):
    """BENCHMARK.json or a file it names is missing or malformed."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError) as exc:
        raise SpecError(f"cannot read {path}: {exc}") from exc


def _load_json(path: str) -> dict:
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError) as exc:
        raise SpecError(f"cannot read {path}: {exc}") from exc


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[entry["config"]]["file"]))
    traffic = _load_json(os.path.join(BENCH_DIR, "traffic",
                                      entry["traffic"] + ".json"))
    return Cell(name, int(entry["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def _module(kind: str, name: str) -> ModuleType:
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    if not os.path.isfile(path):
        raise SpecError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> ModuleType:
    return _module("metrics", name)


def kernel_counts() -> Dict[str, ModuleType]:
    """Every kernel count under ``counts/``, by file name."""
    d = os.path.join(BENCH_DIR, "counts")
    return {f[:-3]: _module("counts", f[:-3]) for f in sorted(os.listdir(d))
            if f.endswith(".py") and not f.startswith("_")}
