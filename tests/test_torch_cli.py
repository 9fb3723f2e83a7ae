"""End to end: ``python -m racon_tpu_torch.cli --device cpu`` must print
byte-identical FASTA to ``python -m racon_tpu.cli --backend jax`` (the
reference, run under JAX_PLATFORMS=cpu RACON_TPU_SCHED=0), on synthetic
inputs: a ~6 kb draft with 40 full-length noisy reads, FASTA and FASTQ
reads x PAF and SAM overlaps (contig polishing), and one fragment
correction (-f) case with an all-vs-all PAF. Both commands run
concurrently, one thread each.
"""

import os
import subprocess
import sys

import pytest

from racon_tpu_torch.utils.synth import write_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", RACON_TPU_SCHED="0",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run_both(args, cwd):
    env = _env()
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


@pytest.mark.parametrize("overlaps", ["paf", "sam"])
@pytest.mark.parametrize("reads", ["fasta", "fastq"])
def test_contig_polishing_byte_identical(tmp_path, reads, overlaps):
    ds = write_dataset(str(tmp_path), seed=11, contig_len=6000, coverage=40,
                       fastq=reads == "fastq", overlaps=overlaps)
    p = ds["paths"]
    ref, port = _run_both([p["reads"], p["overlaps"], p["draft"]],
                          str(tmp_path))
    assert ref.startswith(b">ctg0 ") and len(ref) > 5000
    assert port == ref


def test_fragment_correction_byte_identical(tmp_path):
    ds = write_dataset(str(tmp_path), seed=12, contig_len=2000, coverage=12,
                       fastq=True, ava=True)
    p = ds["paths"]
    ref, port = _run_both(["-f", p["reads"], p["ava"], p["reads"]],
                          str(tmp_path))
    assert ref.count(b">") >= 10
    assert port == ref


def test_no_gpu_without_device_cpu_fails(tmp_path):
    """Without a GPU and without --device cpu the CLI exits non-zero with
    a clear error instead of running on the CPU."""
    ds = write_dataset(str(tmp_path), seed=13, contig_len=1000, coverage=4)
    p = ds["paths"]
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch.cli", p["reads"],
         p["overlaps"], p["draft"]], capture_output=True, env=env,
        cwd=str(tmp_path), timeout=300)
    assert out.returncode != 0
    assert out.stdout == b""
    assert b"no CUDA device is available" in out.stderr
