"""More CLI cases: ``python -m racon_tpu_torch.cli --device cpu`` must print
byte-identical FASTA to ``python -m racon_tpu.cli --backend jax`` (the
reference, under JAX_PLATFORMS=cpu) on inputs test_torch_cli.py does not
cover: partial-length reads (2 contigs x 6 kb, 2.5 kb reads at 30x) with
PAF and with MHAP overlaps; then, on one such contig, gzipped inputs,
``-u`` with a second contig no read covers, ``-w 200 -q 5 -e 0.2``, and
the reference with its convergence scheduler on (its default; the other
cases run it with RACON_TPU_SCHED=0, as test_torch_cli.py does). Both
commands run concurrently, one thread each.
"""

import gzip
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from racon_tpu_torch.utils.synth import write_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(sched: bool):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    if sched:
        env.pop("RACON_TPU_SCHED", None)
    else:
        env["RACON_TPU_SCHED"] = "0"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_both(args, cwd, sched=False):
    env = _env(sched)
    ref = subprocess.Popen(
        [sys.executable, "-m", "racon_tpu.cli", "--backend", "jax", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, cwd=cwd)
    port = subprocess.Popen(
        [sys.executable, "-m", "racon_tpu_torch.cli", "--device", "cpu",
         *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        cwd=cwd)
    r_out, r_err = ref.communicate(timeout=600)
    p_out, p_err = port.communicate(timeout=600)
    assert ref.returncode == 0, r_err.decode()[-2000:]
    assert port.returncode == 0, p_err.decode()[-2000:]
    return r_out, p_out


def _partial(tmp_path, n_contigs=1):
    """n_contigs contigs x 6 kb, 2.5 kb reads at 30x, PAF overlaps."""
    return write_dataset(str(tmp_path), seed=21, n_contigs=n_contigs,
                         contig_len=6000, read_len=2500, coverage=30)


def _records(path):
    """(name, length) of each FASTA/FASTQ record in file order."""
    recs = []
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    step = 4 if lines[0].startswith(b"@") else 2
    for i in range(0, len(lines) - 1, step):
        recs.append((lines[i][1:].split()[0].decode(), len(lines[i + 1])))
    return recs


def _write_mhap(ds, path):
    """The PAF's overlaps as MHAP: 1-based read and contig indices, the
    read's strand bit, spans and lengths."""
    p = ds["paths"]
    reads = {n: i + 1 for i, (n, _) in enumerate(_records(p["reads"]))}
    contigs = {n: i + 1 for i, (n, _) in enumerate(_records(p["draft"]))}
    with open(p["overlaps"]) as src, open(path, "w") as dst:
        for line in src:
            f = line.split("\t")
            dst.write(f"{reads[f[0]]} {contigs[f[5]]} 0.1 100 "
                      f"{int(f[4] == '-')} {f[2]} {f[3]} {f[1]} 0 {f[7]} "
                      f"{f[8]} {f[6]}\n")


def _gzip(path):
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    return path + ".gz"


@pytest.mark.parametrize("overlaps", ["paf", "mhap"])
def test_partial_reads_byte_identical(tmp_path, overlaps):
    ds = _partial(tmp_path, n_contigs=2)
    p = ds["paths"]
    ovl = p["overlaps"]
    if overlaps == "mhap":
        ovl = str(tmp_path / "overlaps.mhap")
        _write_mhap(ds, ovl)
    ref, port = _run_both([p["reads"], ovl, p["draft"]], str(tmp_path))
    assert ref.count(b">") == 2 and len(ref) > 10000
    assert port == ref


def test_gzipped_inputs_byte_identical(tmp_path):
    p = _partial(tmp_path)["paths"]
    args = [_gzip(p["reads"]), _gzip(p["overlaps"]), _gzip(p["draft"])]
    ref, port = _run_both(args, str(tmp_path))
    assert ref.count(b">") == 1
    assert port == ref


def test_include_unpolished_byte_identical(tmp_path):
    """-u keeps a contig that no read covers."""
    p = _partial(tmp_path)["paths"]
    rng = np.random.default_rng(22)
    with open(p["draft"], "ab") as fh:
        fh.write(b">lonely\n" + np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, 3000)].tobytes() + b"\n")
    ref, port = _run_both(["-u", p["reads"], p["overlaps"], p["draft"]],
                          str(tmp_path))
    assert ref.count(b">") == 2 and b">lonely" in ref
    assert port == ref


def test_window_and_thresholds_byte_identical(tmp_path):
    p = _partial(tmp_path)["paths"]
    ref, port = _run_both(["-w", "200", "-q", "5", "-e", "0.2", p["reads"],
                           p["overlaps"], p["draft"]], str(tmp_path))
    assert ref.count(b">") == 1
    assert port == ref


def test_reference_scheduler_on_byte_identical(tmp_path):
    """The reference at its default, with its convergence scheduler."""
    p = _partial(tmp_path)["paths"]
    ref, port = _run_both([p["reads"], p["overlaps"], p["draft"]],
                          str(tmp_path), sched=True)
    assert ref.count(b">") == 1
    assert port == ref
