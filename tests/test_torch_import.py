"""The port imports neither JAX nor anything of the JAX package.

A fresh interpreter imports ``racon_tpu_torch`` and every module of the
package, then reports which modules are loaded; a static scan checks
that no source file of the port, nor its scripts at the repository root,
names ``jax`` or ``racon_tpu.`` in an import statement.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "racon_tpu_torch")


def _port_modules():
    mods = []
    for dirpath, _dirs, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _sources():
    for dirpath, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    for script in ("chip_smoke.py", "band_edits.py", "merge_edits.py",
                   "walk_bench.py"):
        yield os.path.join(ROOT, script)


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "jaxlib"
            or name.startswith("jaxlib.") or name == "racon_tpu"
            or name.startswith("racon_tpu."))


def test_port_modules_found():
    mods = _port_modules()
    assert "racon_tpu_torch.ops.device_poa" in mods
    assert "racon_tpu_torch.ops.ovl_align" in mods
    assert "racon_tpu_torch.cli" in mods
    assert "racon_tpu_torch.sched.scheduler" in mods
    assert "racon_tpu_torch.pipeline.streaming" in mods
    assert "racon_tpu_torch.io.ingest" in mods
    for name in ("faults", "retry", "watchdog"):
        assert f"racon_tpu_torch.resilience.{name}" in mods
    assert "racon_tpu_torch.obs.trace" in mods


def test_import_loads_no_jax_and_no_reference_module():
    code = (
        "import importlib, json, sys\n"
        "import racon_tpu_torch\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if _forbidden(m)]
    assert bad == []


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_nothing_forbidden(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert [n for n in names if _forbidden(n)] == []
