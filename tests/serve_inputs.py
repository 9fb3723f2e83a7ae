"""Shared inputs and CLI runners of the service-core parity tests
(tests/test_torch_checkpoint.py, test_torch_cache.py,
test_torch_server.py): tiny polishing inputs made from a seed with numpy
(the JAX package's tests/test_server.py::_write_inputs), and both
packages' CLIs run in this process with their stdout captured."""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASES = np.frombuffer(b"ACGT", np.uint8)


def _mutate(rng, truth):
    out = []
    for b in truth:
        r = rng.random()
        if r < 0.03:
            continue
        if r < 0.06:
            out.append(BASES[rng.integers(0, 4)])
        else:
            out.append(b)
    return bytes(bytearray(out))


def write_inputs(d, n_contigs=2, n_reads=6, clen=300, seed=11):
    """``n_contigs`` drafts of ``clen`` bp, ``n_reads`` full-length noisy
    reads each, and a PAF; returns [reads, overlaps, draft]."""
    rng = np.random.default_rng(seed)
    drafts, reads, paf = [], [], []
    for ci in range(n_contigs):
        truth = BASES[rng.integers(0, 4, clen)]
        draft = _mutate(rng, truth)
        drafts.append(b">c%d\n%s\n" % (ci, draft))
        for i in range(n_reads):
            r = _mutate(rng, truth)
            name = f"c{ci}r{i}"
            reads.append(b">" + name.encode() + b"\n" + r + b"\n")
            paf.append(f"{name}\t{len(r)}\t0\t{len(r)}\t+\tc{ci}"
                       f"\t{len(draft)}\t0\t{len(draft)}"
                       f"\t{min(len(r), len(draft))}"
                       f"\t{max(len(r), len(draft))}\t60")
    os.makedirs(d, exist_ok=True)
    paths = [os.path.join(d, n) for n in ("reads.fasta", "ovl.paf",
                                          "draft.fasta")]
    with open(paths[2], "wb") as fh:
        fh.write(b"".join(drafts))
    with open(paths[0], "wb") as fh:
        fh.write(b"".join(reads))
    with open(paths[1], "w") as fh:
        fh.write("\n".join(paf) + "\n")
    return paths


def _capture(main, argv):
    out_b = io.BytesIO()
    out_t = io.TextIOWrapper(out_b, encoding="utf-8")
    err = io.StringIO()
    with contextlib.redirect_stdout(out_t), contextlib.redirect_stderr(err):
        rc = main(argv)
        out_t.flush()
    return rc, out_b.getvalue(), err.getvalue()


def port_cli(argv):
    """``python -m racon_tpu_torch.cli --device cpu ARGV`` in this
    process: (rc, stdout bytes, stderr text)."""
    from racon_tpu_torch import cli
    return _capture(cli.main, ["--device", "cpu", *argv])


def ref_cli(argv):
    """``python -m racon_tpu.cli --backend jax ARGV`` in this process (the
    reference, on the CPU): (rc, stdout bytes, stderr text)."""
    from racon_tpu import cli
    return _capture(cli.main, ["--backend", "jax", *argv])


def subprocess_env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               **extra)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def port_cli_subprocess(argv, timeout=300, **extra_env):
    """The port's CLI in a child process (for ``kill`` faults, which end
    the process): a CompletedProcess."""
    return subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch.cli", "--device", "cpu",
         *argv], capture_output=True, env=subprocess_env(**extra_env),
        cwd=ROOT, timeout=timeout)
