"""The port's wrapper tools against the JAX package's: rampler's
``split`` and ``subsample`` (file names and bytes, FASTA, FASTQ and
gzipped FASTQ, through the functions and through ``main``), and the
racon_wrapper equivalent (``--split``, ``--subsample``, ``--resume``,
``--num-shards``/``--shard-id``) on a 3-contig synthetic input on
``--device cpu``, its stdout byte for byte the reference wrapper's and
the reference CLI's one-shot polish. The reference polishes with
``--backend jax``.

Inputs: made from a seed with numpy (tests/serve_inputs.py for the
polishing input)."""

import gzip
import os

import numpy as np
import pytest

from racon_tpu.tools import rampler as rramp
from racon_tpu.tools import wrapper as rwrap
from racon_tpu_torch.tools import rampler as pramp
from racon_tpu_torch.tools import wrapper as pwrap

from serve_inputs import _capture, ref_cli, write_inputs

BASES = np.frombuffer(b"ACGTacgt", np.uint8)


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ("RACON_TPU_FAULTS", "RACON_TPU_PIPELINE",
                 "RACON_TPU_TRACE"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """60 reads of 50-2000 bases (some lowercase, some all-'!' qualities)
    as FASTQ, FASTA and gzipped FASTQ."""
    d = tmp_path_factory.mktemp("reads")
    rng = np.random.default_rng(1702)
    fq, fa = [], []
    for i in range(60):
        n = int(rng.integers(50, 2000))
        seq = bytes(BASES[rng.integers(0, 8 if i % 7 == 0 else 4, n)])
        qual = b"!" * n if i % 11 == 0 else \
            bytes(rng.integers(35, 74, n).astype(np.uint8))
        fq.append(b"@r%d desc\n%s\n+\n%s\n" % (i, seq, qual))
        fa.append(b">r%d\n%s\n" % (i, seq))
    paths = {}
    for name, blob in (("reads.fastq", b"".join(fq)),
                       ("reads.fasta", b"".join(fa))):
        p = d / name
        p.write_bytes(blob)
        paths[name] = str(p)
    p = d / "reads.fq.gz"
    p.write_bytes(gzip.compress(b"".join(fq)))
    paths["reads.fq.gz"] = str(p)
    return paths


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("name", ["reads.fastq", "reads.fasta",
                                  "reads.fq.gz"])
@pytest.mark.parametrize("chunk", [1, 5000, 20000, 10**9])
def test_split_matches_reference(tmp_path, reads, name, chunk):
    for d in ("p", "r"):
        os.makedirs(tmp_path / d)
    got = pramp.split(reads[name], chunk, str(tmp_path / "p"))
    want = rramp.split(reads[name], chunk, str(tmp_path / "r"))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert _files(tmp_path / "p") == _files(tmp_path / "r")
    if chunk in (1, 10**9):
        assert len(got) == (60 if chunk == 1 else 1)


@pytest.mark.parametrize("name", ["reads.fastq", "reads.fasta",
                                  "reads.fq.gz"])
@pytest.mark.parametrize("ref_len, cov", [(2000, 5), (10000, 3),
                                          (10**6, 50)])
def test_subsample_matches_reference(tmp_path, reads, name, ref_len, cov):
    for d in ("p", "r"):
        os.makedirs(tmp_path / d)
    got = pramp.subsample(reads[name], ref_len, cov, str(tmp_path / "p"))
    want = rramp.subsample(reads[name], ref_len, cov, str(tmp_path / "r"))
    assert os.path.basename(got) == os.path.basename(want)
    assert _files(tmp_path / "p") == _files(tmp_path / "r")
    out = open(got, "rb").read()
    kept = sum(out.count(b"%s%d\n" % (c, i)) for i in range(60)
               for c in (b"@r", b">r"))
    assert 0 < kept <= 60
    if ref_len == 10**6:   # p_keep = 1: every read kept
        assert kept == 60


def test_rampler_main_matches_reference(tmp_path, reads):
    for mod, d in ((pramp, "p"), (rramp, "r")):
        out = str(tmp_path / d)
        assert mod.main(["-o", out, "subsample", reads["reads.fastq"],
                         "3000", "2", "4"]) == 0
        assert mod.main(["-o", out, "split", reads["reads.fasta"],
                         "8000"]) == 0
        assert mod.main(["-o", out, "split", reads["reads.fasta"],
                         "0"]) == 1
        empty = tmp_path / f"empty_{d}.fasta"
        empty.write_bytes(b"")
        assert mod.main(["-o", out, "subsample", str(empty), "10",
                         "1"]) == 1
    assert _files(tmp_path / "p") == _files(tmp_path / "r")
    assert "reads_2x.fastq" in _files(tmp_path / "p")


# -------------------------------------------------------------- wrapper

@pytest.fixture(scope="module")
def polish_input(tmp_path_factory):
    """A 3-contig input (each read from one contig) and the reference
    CLI's one-shot bytes on it."""
    paths = write_inputs(str(tmp_path_factory.mktemp("wrap")), n_contigs=3,
                         seed=17)
    rc, ref, err = ref_cli(paths)
    assert rc == 0, err
    assert ref.count(b">") == 3
    return paths, ref


def _port(argv):
    return _capture(pwrap.main, [*argv, "--device", "cpu"])


def _ref(argv):
    return _capture(rwrap.main, [*argv, "--backend", "jax"])


def test_wrapper_split_resume_and_shards_match_reference(
        tmp_path, monkeypatch, polish_input):
    """``--split 1`` gives a chunk a contig; the combined FASTA is the
    reference wrapper's and the one-shot polish's bytes. With one chunk's
    output deleted, ``--resume`` polishes that chunk alone and gives the
    same bytes; ``--num-shards 3 --shard-id 1`` gives that chunk's bytes,
    as the reference's."""
    from racon_tpu_torch.models import polisher as ppolisher
    paths, one_shot = polish_input
    work = str(tmp_path / "work")
    argv = [*paths, "--split", "1", "--work-directory", work, "--resume"]
    rc, out, err = _port(argv)
    assert rc == 0, err
    rc, ref, err = _ref([*paths, "--split", "1", "--work-directory",
                         str(tmp_path / "rwork")])
    assert rc == 0, err
    assert out == ref == one_shot
    chunks = sorted(n for n in os.listdir(work) if n.startswith("chunk_"))
    assert chunks == ["chunk_0.fasta", "chunk_1.fasta", "chunk_2.fasta"]
    ino = {n: os.stat(os.path.join(work, n)).st_ino for n in chunks}
    os.unlink(os.path.join(work, "chunk_1.fasta"))
    made = []
    real = ppolisher.create_polisher
    monkeypatch.setattr(ppolisher, "create_polisher",
                        lambda *a, **k: made.append(a[2]) or real(*a, **k))
    rc, again, err = _port(argv)
    assert rc == 0, err
    assert again == one_shot
    assert [os.path.basename(t) for t in made] == ["draft_1.fasta"]
    assert {n: os.stat(os.path.join(work, n)).st_ino for n in chunks
            if n != "chunk_1.fasta"} == \
        {n: i for n, i in ino.items() if n != "chunk_1.fasta"}
    made.clear()
    rc, shard, err = _port([*argv, "--num-shards", "3", "--shard-id", "1"])
    assert rc == 0, err
    assert made == [] and shard.count(b">") == 1 and shard in one_shot
    rc, rshard, err = _ref([*paths, "--split", "1", "--work-directory",
                            str(tmp_path / "rwork"), "--resume",
                            "--num-shards", "3", "--shard-id", "1"])
    assert rc == 0, err
    assert shard == rshard


def test_wrapper_subsample_matches_reference(tmp_path, polish_input):
    """``--subsample`` keeps the reference's reads (its seeded draws), so
    the polished bytes are the reference wrapper's."""
    paths, _ = polish_input
    opts = ["--subsample", "300", "4"]
    rc, out, err = _port([*paths, *opts, "--work-directory",
                          str(tmp_path / "p")])
    assert rc == 0, err
    rc, ref, err = _ref([*paths, *opts, "--work-directory",
                         str(tmp_path / "r")])
    assert rc == 0, err
    assert out == ref and out.count(b">") >= 1
    assert _files(tmp_path / "p")["reads_4x.fasta"] == \
        _files(tmp_path / "r")["reads_4x.fasta"]


def test_wrapper_cuda_without_a_gpu_fails(tmp_path, polish_input):
    """The default device is the card; on a host without one the wrapper
    exits 1 with the DeviceError message and writes nothing."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    paths, _ = polish_input
    rc, out, err = _capture(pwrap.main, [*paths, "--work-directory",
                                         str(tmp_path / "w")])
    assert (rc, out) == (1, b"")
    assert "no CUDA device is available" in err


def test_wrapper_obs_dir_shard_carries_kernel_launches(
        tmp_path, monkeypatch, polish_input):
    """With ``RACON_TPU_OBS_DIR`` set, the wrapper keeps one metric shard
    there under the whole job's fingerprint, final at exit, carrying the
    process's kernel launches once it has polished a chunk; a
    ``--resume`` run that polishes nothing records none. On the CPU
    nothing launches, so a count is set by hand as if the card had."""
    from racon_tpu_torch.obs import fleet, metrics
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.server.engine import JobSpec
    paths, one_shot = polish_input
    monkeypatch.setattr(fleet, "_WRITER", None)
    monkeypatch.setitem(kernels.LAUNCHES, "band_fwd", 5)
    argv = [*paths, "--split", "1", "--work-directory",
            str(tmp_path / "work"), "--resume"]
    fp = JobSpec(*paths).fingerprint()
    seen = []
    for obs in ("first", "resumed"):
        metrics.reset()
        monkeypatch.setenv("RACON_TPU_OBS_DIR", str(tmp_path / obs))
        rc, out, err = _port(argv)
        assert rc == 0, err
        assert out == one_shot
        (shard,) = fleet.load_worker_shards(str(tmp_path / obs))
        last = shard["records"][-1]
        assert shard["clean"] and last["final"]
        assert last["run_fp"] == fp
        assert last["worker_id"] == f"wrapper-{os.getpid()}"
        seen.append({k: v for k, v in last["metrics"].items()
                     if k.startswith("kernel_launches_")})
    metrics.reset()
    assert seen == [{"kernel_launches_band_fwd": 5,
                     "kernel_launches_band_fwd_consensus": 5}, {}]
