"""The port's durable writes and checkpoint store against the JAX
package's: the atomicio helpers, the run fingerprint, CheckpointStore
(create, commit, commit_dropped, resume, torn-manifest recovery, the v2
segmented manifest and its compaction) byte for byte on disk, and the
CLI's --checkpoint-dir/--resume across both packages: the same inputs
give the same store files and stdout, a port CLI killed mid-run resumes
to the reference's bytes, and a store either package left half done
resumes under the other. Also the Polisher's target pruning
(skip_targets, restrict_targets).

Inputs: tests/serve_inputs.py (tiny drafts and reads from a seed)."""

import json
import os

import pytest

from racon_tpu.resilience import checkpoint as RC
from racon_tpu.resilience import faults as RF
from racon_tpu.utils import atomicio as RA
from racon_tpu_torch.obs import metrics
from racon_tpu_torch.resilience import checkpoint as PC
from racon_tpu_torch.resilience import faults as PF
from racon_tpu_torch.utils import atomicio as PA

from serve_inputs import (port_cli, port_cli_subprocess, ref_cli,
                          write_inputs)

STORE_FILES = ("meta.json", "manifest.jsonl", "contigs.fasta")


@pytest.fixture(autouse=True)
def clean_plane(monkeypatch):
    for name in ("RACON_TPU_FAULTS", "RACON_TPU_AVA_SEG",
                 "RACON_TPU_AVA_COMPACT", "RACON_TPU_CACHE"):
        monkeypatch.delenv(name, raising=False)
    for mod in (PF, RF):
        mod.configure(None)
    metrics.reset()
    yield
    for mod in (PF, RF):
        mod.configure(None)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Three contigs, and both CLIs' plain stdout on them."""
    paths = write_inputs(str(tmp_path_factory.mktemp("in")), n_contigs=3)
    rc, ref, err = ref_cli(paths)
    assert rc == 0, err
    rc, port, err = port_cli(paths)
    assert rc == 0, err
    assert port == ref and ref.count(b">") == 3
    return paths, ref


def _files(d):
    out = {}
    for n in STORE_FILES:
        with open(os.path.join(d, n), "rb") as fh:
            out[n] = fh.read()
    return out


# ------------------------------------------------------------- atomicio

def test_atomicio_matches_reference(tmp_path):
    for mod, sub in ((RA, "ref"), (PA, "port")):
        d = tmp_path / sub
        d.mkdir()
        mod.atomic_write_text(str(d / "a.txt"), "hello\n")
        mod.atomic_write_bytes(str(d / "b.bin"), b"\x00\x01")
        assert mod.publish_exclusive(str(d / "e"), b"first")
        assert not mod.publish_exclusive(str(d / "e"), b"second")
        with open(d / "f.jsonl", "ab") as fh:
            offs = [mod.append_fsync(fh, b'{"a": 1}\n', sync_dir=str(d)),
                    mod.append_fsync(fh, '{"b": 2}\n'.encode())]
            fh.write(b'{"c": 3')            # torn tail
        assert offs == [0, 9]
        mod.atomic_write_bytes(str(d / "g.tmp"), b"x")
        mod.atomic_finalize(str(d / "g.tmp"), str(d / "g"))
        assert sorted(os.listdir(d)) == ["a.txt", "b.bin", "e", "f.jsonl",
                                         "g"]
    for n in ("a.txt", "b.bin", "e", "f.jsonl", "g"):
        assert (tmp_path / "ref" / n).read_bytes() == \
            (tmp_path / "port" / n).read_bytes()
    got = PA.load_jsonl_prefix(str(tmp_path / "port" / "f.jsonl"))
    assert got == RA.load_jsonl_prefix(str(tmp_path / "ref" / "f.jsonl"))
    assert got == ([{"a": 1}, {"b": 2}], False)
    bad = lambda rec: rec["b"]                        # noqa: E731
    assert PA.load_jsonl_prefix(str(tmp_path / "port" / "f.jsonl"),
                                validate=bad) == ([], False)


@pytest.mark.parametrize("opts", [
    {}, {"window_length": 250, "match": 3},
    {"include_unpolished": True, "fragment_correction": True,
     "quality_threshold": 5.0, "error_threshold": 0.2, "gap": -6}])
def test_fingerprint_matches_reference(tmp_path, opts):
    from racon_tpu.server.engine import JobSpec as RJ
    from racon_tpu_torch.server.engine import JobSpec as PJ
    paths = write_inputs(str(tmp_path), n_contigs=1)
    ref, port = RJ(*paths, **opts), PJ(*paths, **opts)
    assert port.identity() == ref.identity()
    assert port.fingerprint() == ref.fingerprint()
    assert PC.run_fingerprint(port.identity(), paths) == \
        RC.run_fingerprint(ref.identity(), paths)


# ---------------------------------------------------------------- store

def _drive(mod, faults_mod, d, seg, monkeypatch):
    """The same commits through one package's store: a v1 (or, with
    ``seg``, v2) store, a torn manifest append at the second manifest
    write (the hard exit intercepted), then a resume and more commits."""
    monkeypatch.setenv("RACON_TPU_AVA_COMPACT", "2")

    class Died(Exception):
        pass

    def died(code):
        raise Died(code)

    monkeypatch.setattr(faults_mod, "hard_exit", died)
    store = mod.CheckpointStore.create(d, "f" * 64, segment_targets=seg)
    store.commit(0, b"c0 LN:i:3", b"ACG")
    store.commit_dropped(1)
    faults_mod.configure("ckpt/manifest:2!torn")
    with pytest.raises(Died):
        for tid in range(2, 12):
            store.commit(tid, b"c%d" % tid, b"AC" * tid)
    faults_mod.configure(None)
    store._shard.close()
    store._manifest.close()
    resumed = mod.CheckpointStore.resume(d, "f" * 64)
    kept = sorted(resumed.committed)
    for tid in range(kept[-1] + 1 if kept else 0, kept[-1] + 4):
        resumed.commit(tid, b"r%d" % tid, b"T" * (tid + 1))
    resumed.commit_dropped(40)
    emitted = {t: resumed.read_emitted(t) for t in sorted(resumed.committed)}
    resumed.close()
    return kept, emitted


@pytest.mark.parametrize("seg", [0, 4])
def test_store_recovery_matches_reference(tmp_path, monkeypatch, seg):
    ref = _drive(RC, RF, str(tmp_path / "ref"), seg, monkeypatch)
    port = _drive(PC, PF, str(tmp_path / "port"), seg, monkeypatch)
    assert port == ref
    assert ref[0], "nothing survived the torn append"
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "ref"))
    # Each package resumes the other's store.
    for mod, other in ((PC, "ref"), (RC, "port")):
        s = mod.CheckpointStore.resume(str(tmp_path / other), "f" * 64)
        assert {t: s.read_emitted(t) for t in sorted(s.committed)} == ref[1]
        s.close()
    snap = metrics.registry().snapshot()
    assert snap["res_ckpt_resumes"] >= 2 and snap["res_ckpt_commits"] >= 4


def test_resume_refuses_another_run(tmp_path):
    d = str(tmp_path / "s")
    PC.CheckpointStore.create(d, "a" * 64).close()
    with pytest.raises(PC.CheckpointError) as port:
        PC.CheckpointStore.resume(d, "b" * 64)
    with pytest.raises(RC.CheckpointError) as ref:
        RC.CheckpointStore.resume(d, "b" * 64)
    assert str(port.value).replace("racon_tpu_torch::", "racon_tpu::") \
        == str(ref.value)
    with pytest.raises(PC.CheckpointError):
        PC.CheckpointStore.resume(str(tmp_path / "none"), "a" * 64)


@pytest.mark.parametrize("method, ids", [
    ("skip_targets", {0, 2}), ("skip_targets", set()),
    ("restrict_targets", {1}), ("restrict_targets", {5})])
def test_polisher_target_pruning_matches_reference(method, ids):
    """Polisher.skip_targets (the resume path) and restrict_targets (a
    ledger shard's) keep the same windows, in order, as the JAX
    package's."""
    from types import SimpleNamespace

    from racon_tpu.models.polisher import Polisher as RP
    from racon_tpu_torch.models.polisher import Polisher as PP
    wins = [SimpleNamespace(id=t, rank=r) for t in range(3) for r in range(4)]
    ref, port = SimpleNamespace(windows=wins), SimpleNamespace(windows=wins)
    assert getattr(PP, method)(port, ids) == getattr(RP, method)(ref, ids)
    assert port.windows == ref.windows


# ------------------------------------------------------------------ CLI

def test_cli_store_files_match_reference(tmp_path, inputs):
    paths, base = inputs
    rc, ref, err = ref_cli([*paths, "--checkpoint-dir",
                            str(tmp_path / "ref")])
    assert rc == 0, err
    rc, port, err = port_cli([*paths, "--checkpoint-dir",
                              str(tmp_path / "port")])
    assert rc == 0, err
    assert port == ref == base
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "ref"))


def test_cli_killed_then_resumed_gives_reference_bytes(tmp_path, inputs):
    """The port's CLI killed at its second commit (rc 137, one contig
    durable) resumes to the reference's bytes; the reference's CLI
    resumes the same half-done store to the same bytes."""
    paths, base = inputs
    d = str(tmp_path / "ck")
    killed = port_cli_subprocess([*paths, "--checkpoint-dir", d],
                                 RACON_TPU_FAULTS="ckpt/commit:1!kill")
    assert killed.returncode == 137, killed.stderr.decode()[-2000:]
    with open(os.path.join(d, "manifest.jsonl")) as fh:
        recs = [json.loads(ln) for ln in fh]
    assert [r.get("tid") for r in recs] == [None, 0]
    half = _files(d)
    rc, out, err = port_cli([*paths, "--checkpoint-dir", d, "--resume"])
    assert rc == 0, err
    assert out == base
    assert "resuming: 1 contig(s)" in err
    assert "skipping recompute of 1 window(s)" in err
    for n, blob in half.items():
        with open(os.path.join(d, n), "wb") as fh:
            fh.write(blob)
    rc, out, err = ref_cli([*paths, "--checkpoint-dir", d, "--resume"])
    assert rc == 0, err
    assert out == base


def test_reference_half_done_store_resumes_under_port(tmp_path, inputs,
                                                      monkeypatch):
    """A reference CLI run that died after its second commit (its hard
    exit intercepted) leaves a store the port's CLI resumes to the same
    bytes, re-emitting two contigs from the shard."""
    paths, base = inputs
    d = str(tmp_path / "ck")

    class Died(BaseException):
        pass

    def died(code):
        raise Died(code)

    monkeypatch.setattr(RF, "hard_exit", died)
    monkeypatch.setenv("RACON_TPU_FAULTS", "ckpt/commit:2!kill")
    RF._ARMED = False
    with pytest.raises(Died):
        ref_cli([*paths, "--checkpoint-dir", d])
    monkeypatch.delenv("RACON_TPU_FAULTS")
    RF.configure(None)
    rc, out, err = port_cli([*paths, "--checkpoint-dir", d, "--resume"])
    assert rc == 0, err
    assert out == base
    assert "resuming: 2 contig(s)" in err
    assert metrics.registry().get("res_ckpt_skips") == 2


def test_cli_checkpoint_flag_errors(tmp_path, inputs):
    paths, _ = inputs
    rc, out, err = port_cli([*paths, "--resume"])
    assert rc == 1 and out == b""
    assert "--resume requires --checkpoint-dir" in err
    rc, out, err = port_cli([*paths, "--checkpoint-dir",
                             str(tmp_path / "none"), "--resume"])
    assert rc == 1 and out == b"" and "cannot resume" in err
    d = str(tmp_path / "ck")
    assert port_cli([*paths, "--checkpoint-dir", d])[0] == 0
    rc, out, err = port_cli([*paths, "-w", "250", "--checkpoint-dir", d,
                             "--resume"])
    assert rc == 1 and out == b"" and "refusing to resume" in err
