"""The port's work ledger and ledger workers against the JAX package's:
the shard partition, lease claim, steal and fencing, torn leases, splits
(depth cap, torn-split invisibility), release, the merge pseudo-shard,
the CLI's ledger flags, and whole fleets driven through both CLIs in this
process — a one-worker ledger, an eviction with a steal and a resume, and
a ledger one package started and the other finished, in both directions.
Every merged FASTA must equal both packages' serial bytes. Also the
structural target scan (``scan_sequence_index``), the length-weighted
partition and the ava planner, equal to the reference's on seeded inputs.

The reference's fleet runs use its host engine (``--backend native``): a
ledger, its shard stores and the merge do not depend on the engine (the
run fingerprint leaves the backend out), and its device engine costs
seconds a run on the CPU. The module's fixture holds the reference's
serial bytes on both engines equal to the port's.

Inputs: tests/serve_inputs.py (tiny drafts and reads from a seed)."""

import gzip
import json
import os

import numpy as np
import pytest

from racon_tpu.distributed import ledger as RL
from racon_tpu.obs import fleet as RFLEET
from racon_tpu.obs import metrics as RM
from racon_tpu.resilience import faults as RF
from racon_tpu_torch.distributed import LeaseLost, LedgerError, WorkLedger
from racon_tpu_torch.distributed import ledger as dledger
from racon_tpu_torch.obs import fleet as PFLEET
from racon_tpu_torch.obs import metrics
from racon_tpu_torch.resilience import checkpoint as ckpt
from racon_tpu_torch.resilience import faults

from serve_inputs import _capture, port_cli, ref_cli, write_inputs

N_CONTIGS = 3


@pytest.fixture(autouse=True)
def dist_clean(monkeypatch):
    for name in ("RACON_TPU_FAULTS", "RACON_TPU_DIST_SHARDS",
                 "RACON_TPU_SPLIT", "RACON_TPU_SPLIT_DEPTH",
                 "RACON_TPU_SPLIT_AFTER_S", "RACON_TPU_OBS_DIR",
                 "RACON_TPU_AVA_WEIGHTED", "RACON_TPU_AVA_COMPILE_BUDGET",
                 "RACON_TPU_TRACE_CTX", "RACON_TPU_METRICS_PORT",
                 "RACON_TPU_PIPELINE"):
        monkeypatch.delenv(name, raising=False)
    for mod in (faults, RF):
        mod.configure(None)
    for mod in (metrics, RM):
        mod.reset()
    PFLEET._WRITER = RFLEET._WRITER = None
    yield
    for mod in (faults, RF):
        mod.configure(None)
    PFLEET._WRITER = RFLEET._WRITER = None


def ref_native(argv):
    """The reference's CLI on its host engine, in this process."""
    from racon_tpu import cli
    return _capture(cli.main, ["--backend", "native", *argv])


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Three contigs, and both packages' serial stdout on them (the
    reference's on its device and host engines)."""
    paths = write_inputs(str(tmp_path_factory.mktemp("in")),
                         n_contigs=N_CONTIGS)
    rc, ref, err = ref_cli(paths)
    assert rc == 0, err
    rc, native, err = ref_native(paths)
    assert rc == 0, err
    rc, port, err = port_cli(paths)
    assert rc == 0, err
    assert port == ref == native and ref.count(b">") == N_CONTIGS
    return paths, ref


# ------------------------------------------------------------ partition


def test_fault_site_dist_claim_injects_then_claims(tmp_path):
    led = WorkLedger.open(str(tmp_path / "ledger"), "fp1", n_targets=4,
                          workers=2)
    faults.configure("dist/claim:0")
    with pytest.raises(faults.InjectedFault):
        led.claim_shard("w0")
    claim = led.claim_shard("w0")
    assert claim is not None and claim.worker == "w0"
    assert metrics.registry().snapshot()["res_fault_injected_total"] == 1


def test_partition_bounds_balanced():
    assert dledger._partition(6, 3) == [0, 2, 4, 6]
    assert dledger._partition(7, 3) == [0, 3, 5, 7]
    assert dledger._partition(2, 2) == [0, 1, 2]
    assert dledger._partition(3, 3) == [0, 1, 2, 3]
    rng = np.random.default_rng(3)
    for _ in range(50):
        n = int(rng.integers(1, 500))
        k = int(rng.integers(1, n + 1))
        assert dledger._partition(n, k) == RL._partition(n, k)


def test_open_publishes_once_and_joins(tmp_path, monkeypatch):
    d = str(tmp_path / "ledger")
    a = WorkLedger.open(d, "fp1", n_targets=6, workers=2)
    assert a.n_shards == 4 and a.bounds[-1] == 6
    # A joiner with other flags adopts the published partition.
    b = WorkLedger.open(d, "fp1", n_targets=6, workers=7, lease_s=1.0)
    assert b.bounds == a.bounds and b.lease_s == a.lease_s
    with pytest.raises(LedgerError, match="fingerprint"):
        WorkLedger.open(d, "fp2", n_targets=6)
    with pytest.raises(LedgerError, match="target count"):
        WorkLedger.open(d, "fp1", n_targets=5)
    with pytest.raises(LedgerError, match="empty target set"):
        WorkLedger.open(str(tmp_path / "x"), "fp1", n_targets=0)
    # The published meta.json is the reference's, byte for byte, and
    # each package opens the other's.
    r = RL.WorkLedger.open(str(tmp_path / "ref"), "fp1", n_targets=6,
                           workers=2)
    assert (tmp_path / "ref" / "meta.json").read_bytes() == \
        (tmp_path / "ledger" / "meta.json").read_bytes()
    assert RL.WorkLedger.open(d, "fp1", n_targets=6).bounds == a.bounds
    assert WorkLedger.open(r.directory, "fp1").bounds == r.bounds
    monkeypatch.setenv(dledger.ENV_SHARDS, "3")
    c = WorkLedger.open(str(tmp_path / "env"), "fp1", n_targets=6)
    assert c.n_shards == 3


def test_claim_lifecycle_and_done(tmp_path):
    led = WorkLedger.open(str(tmp_path / "l"), "fp", n_targets=4,
                          workers=1)  # 2 shards
    a = led.claim_shard("A")
    b = led.claim_shard("B")
    assert (a.shard, b.shard) == (0, 1) and not a.stolen
    assert led.claim_shard("C") is None
    led.verify(a)
    old = a.deadline
    led.renew(a)
    assert a.deadline >= old
    led.complete(a, n_committed=2)
    assert led.is_done("shard_0") and not led.shards_done()
    assert led.claim_shard("C") is None
    led.complete(b)
    assert led.shards_done()
    ev = [e["ev"] for e in led.events()]
    assert ev.count("claim") == 2 and ev.count("complete") == 2


def test_steal_after_expiry_fences_victim(tmp_path):
    led = WorkLedger.open(str(tmp_path / "l"), "fp", n_targets=2,
                          workers=1, n_shards=1)
    a = led.claim_shard("A")
    assert led.claim_shard("B") is None
    faults.configure("skew=9999")
    b = led.claim_shard("B")
    assert b is not None and b.stolen and b.epoch == a.epoch + 1
    faults.configure(None)
    with pytest.raises(LeaseLost):
        led.renew(a)
    with pytest.raises(LeaseLost):
        led.complete(a)
    led.renew(b)
    led.complete(b)
    snap = metrics.registry().snapshot()
    assert snap["dist_shards_stolen"] == 1
    assert snap["dist_leases_expired"] == 1
    assert snap["dist_leases_lost"] == 2
    assert "dist_steal_latency_s" in snap


@pytest.mark.parametrize("torn", [b'{"worker": "A", "dead', b"[1, 2]\n"])
def test_torn_lease_is_stealable(tmp_path, torn):
    led = WorkLedger.open(str(tmp_path / "l"), "fp", n_targets=2,
                          workers=1, n_shards=1)
    with open(led._lease_path("shard_0"), "wb") as fh:
        fh.write(torn)
    c = led.claim_shard("B")
    assert c is not None and c.stolen


def test_merge_guards(tmp_path):
    led = WorkLedger.open(str(tmp_path / "l"), "fp", n_targets=2,
                          workers=1, n_shards=1)
    with pytest.raises(LedgerError, match="still pending"):
        led.merge()
    claim = led.claim_shard("A")
    store = ckpt.CheckpointStore.create(led.shard_ckpt_dir(0),
                                        led.shard_fp(0))
    store.commit(0, b"c0", b"AAAA")
    store.close()
    led.complete(claim)
    with pytest.raises(LedgerError, match="no committed record"):
        led.merge()


def test_merge_orders_and_concatenates(tmp_path):
    """The merge of shard stores written by either package: out.fasta in
    target order, dropped targets emitting nothing."""
    from racon_tpu.resilience import checkpoint as rckpt
    led = WorkLedger.open(str(tmp_path / "l"), "fp", n_targets=4,
                          workers=1)  # bounds [0,2,4]
    for k, mod in enumerate((ckpt, rckpt)):
        claim = led.claim_shard(f"W{k}")
        assert led.shard_fp(k) == rckpt.shard_fingerprint("fp", k)
        store = mod.CheckpointStore.create(led.shard_ckpt_dir(k),
                                           led.shard_fp(k))
        lo, hi = led.shard_range(k)
        for tid in range(lo, hi):
            if tid == 1:
                store.commit_dropped(tid)
            else:
                store.commit(tid, b"c%d" % tid, b"A" * (tid + 1))
        store.close()
        led.complete(claim)
    nbytes, emitted = led.merge()
    assert emitted == 3
    data = open(led.out_path, "rb").read()
    assert len(data) == nbytes
    assert data == b">c0\nA\n>c2\nAAA\n>c3\nAAAA\n"
    assert RL.WorkLedger.attach(led.directory).merge() == (nbytes, 3)


# ---------------------------------------------------------------- split


def test_split_publishes_child_and_shrinks_parent(tmp_path):
    led = WorkLedger.open(str(tmp_path / "l"), "fp", n_targets=6,
                          workers=1, n_shards=1)
    a = led.claim_shard("A")
    child = led.split(a, 2)
    assert child is not None
    assert (child.start, child.end) == (2, 6)
    assert child.parent == "shard_0" and child.root == 0
    assert a.info.end == 2
    infos = {i.name: (i.start, i.end) for i in led.all_shards()}
    assert infos == {"shard_0": (0, 2), child.name: (2, 6)}
    assert sorted(led.pending_shards()) == sorted(["shard_0", child.name])
    assert dledger.split_depth(child.name) == 1
    b = led.claim_shard("B")
    assert b is not None and b.name == child.name and not b.stolen
    ev = [e for e in led.events() if e.get("ev") == "split"]
    assert len(ev) == 1 and ev[0]["child"] == child.name
    assert metrics.registry().snapshot()["dist_splits_total"] == 1
    # The reference sees the same carve in the port's files.
    ref = RL.WorkLedger.attach(led.directory)
    assert [(i.name, i.start, i.end) for i in ref.all_shards()] == \
        [(i.name, i.start, i.end) for i in led.all_shards()]


def test_split_guards(tmp_path):
    led = WorkLedger.open(str(tmp_path / "l"), "fp", n_targets=4,
                          workers=1, n_shards=1)
    a = led.claim_shard("A")
    for cut in (0, 4, 9):
        with pytest.raises(LedgerError, match="outside the held"):
            led.split(a, cut)
    m = led.claim_merge("A")
    with pytest.raises(LedgerError, match="only shard claims"):
        led.split(m, 1)
    faults.configure("skew=9999")
    b = led.claim_shard("B")
    faults.configure(None)
    assert b is not None and b.stolen
    with pytest.raises(LeaseLost):
        led.split(a, 2)
    assert len(led.all_shards()) == 1


def test_torn_split_is_invisible(tmp_path, monkeypatch):
    class _Died(BaseException):
        pass

    monkeypatch.setattr(
        dledger, "hard_exit",
        lambda code: (_ for _ in ()).throw(_Died(code)))
    led = WorkLedger.open(str(tmp_path / "l"), "fp", n_targets=4,
                          workers=1, n_shards=1)
    a = led.claim_shard("A")
    faults.configure("dist/split:0!torn")
    with pytest.raises(_Died):
        led.split(a, 2)
    faults.configure(None)
    assert any(fn.endswith(dledger.RANGE_SUFFIX)
               for fn in os.listdir(str(tmp_path / "l")))
    assert [(i.name, i.start, i.end) for i in led.all_shards()] == \
        [("shard_0", 0, 4)]
    assert led.pending_shards() == ["shard_0"]
    assert [i.name for i in RL.WorkLedger.attach(
        led.directory).all_shards()] == ["shard_0"]


def test_release_is_fenced_and_hands_off_instantly(tmp_path):
    led = WorkLedger.open(str(tmp_path / "l"), "fp", n_targets=4,
                          workers=1, n_shards=1)
    a = led.claim_shard("A")
    faults.configure("skew=9999")
    b = led.claim_shard("B")
    faults.configure(None)
    assert b is not None and b.stolen
    led.release(a)          # stale nonce: a no-op, B keeps it
    led.renew(b)
    child = led.split(b, 2)
    assert child is not None
    led.complete(b, n_committed=2)
    c = led.claim_shard("C")
    assert c is not None and c.name == child.name
    led.release(c)
    d = led.claim_shard("D")
    assert d is not None and d.name == child.name
    assert d.epoch == c.epoch + 1 and not d.stolen
    ev = [e["ev"] for e in led.events()]
    assert ev.count("release") == 1 and ev.count("steal") == 1


def test_split_depth_cap_blocks_cascade(tmp_path, monkeypatch):
    import io

    from racon_tpu_torch.distributed import worker as dworker
    monkeypatch.setenv(dworker.ENV_SPLIT_AFTER, "0")
    monkeypatch.setattr(dworker, "_live_workers", lambda d: 99)
    led = WorkLedger.open(str(tmp_path / "l"), "fp", n_targets=8,
                          workers=1, n_shards=1)
    log = io.StringIO()
    a = led.claim_shard("A")
    assert dworker._maybe_split(led, a, 1, 0.0, log)
    assert a.info.end == 2
    b = led.claim_shard("B")
    assert b is not None and dledger.split_depth(b.name) == 1
    assert not dworker._maybe_split(led, b, b.info.start, 0.0, log)
    monkeypatch.setenv(dledger.ENV_SPLIT_DEPTH, "2")
    assert dworker._maybe_split(led, b, b.info.start, 0.0, log)


# ------------------------------------------------------ the CLI's flags


@pytest.mark.parametrize("extra, msg", [
    (["--checkpoint-dir", "CK"], "manages per-shard checkpoints"),
    (["--workers", "0"], "invalid --workers"),
    (["--lease-s", "0"], "invalid --lease-s"),
    (["--cache-dir", "CA"], "does not compose with --ledger-dir")])
def test_cli_flag_conflicts(tmp_path, inputs, extra, msg):
    paths, _ = inputs
    extra = [str(tmp_path / e) if e in ("CK", "CA") else e for e in extra]
    argv = [*paths, "--ledger-dir", str(tmp_path / "l"), *extra]
    rc, _, err = port_cli(argv)
    assert rc == 1 and msg in err
    rc, _, rerr = ref_native(argv)
    assert rc == 1 and msg in rerr
    assert not os.path.exists(tmp_path / "l")


def test_autoscale_needs_a_ledger(inputs):
    rc, _, err = port_cli([*inputs[0], "--autoscale"])
    assert rc == 1 and "--autoscale requires --ledger-dir" in err


# ---------------------------------------------------------- CLI fleets


def _manifest_tids(led):
    tids = []
    for info in led.all_shards():
        man = os.path.join(led.shard_ckpt_dir(info), ckpt.MANIFEST_NAME)
        for line in open(man, "rb").read().splitlines():
            rec = json.loads(line)
            if rec.get("ev") == "contig":
                tids.append(rec["tid"])
    return sorted(tids)


def test_ledger_cli_byte_identity(tmp_path, inputs):
    """One worker, the whole fleet: the merged stdout is the serial
    bytes, with the reference's dist_* accounting; a late joiner emits
    nothing."""
    paths, base = inputs
    ld = str(tmp_path / "ledger")
    rc, out, err = port_cli([*paths, "--ledger-dir", ld, "--worker-id",
                             "solo"])
    assert rc == 0, err
    assert out == base
    snap = metrics.registry().snapshot()
    assert snap["dist_shards"] == 2 and snap["dist_n_targets"] == 3
    assert snap["dist_claims"] == 2
    assert snap["dist_shards_completed"] == 2
    assert snap["dist_contigs_polished"] == 3
    assert snap["dist_merges"] == 1
    assert "dist_shards_stolen" not in snap
    assert snap["poa_windows_total"] > 0
    assert open(os.path.join(ld, dledger.OUT_NAME), "rb").read() == base
    meta = json.load(open(os.path.join(ld, dledger.META_NAME)))
    from racon_tpu.io.parsers import scan_sequence_index
    assert meta["target_offsets"] == scan_sequence_index(paths[2])[1]
    assert _manifest_tids(WorkLedger.attach(ld)) == [0, 1, 2]
    # The worker's metric shard ends with its final snapshot.
    shards = PFLEET.load_worker_shards(os.path.join(ld, "obs"))
    assert [s["records"][-1]["final"] for s in shards] == [True]
    metrics.reset()
    rc, again, err = port_cli([*paths, "--ledger-dir", ld, "--worker-id",
                               "late"])
    assert rc == 0 and again == b""
    assert "already published" in err
    assert "dist_contigs_polished" not in metrics.registry().snapshot()


def test_eviction_steal_resume_byte_identity(tmp_path, inputs,
                                            monkeypatch):
    """A worker dies between contigs (an injected fault at its second
    dist/contig, one shard); a thief with a skewed lease clock steals the
    shard, resumes the committed contig, polishes only the rest, and
    merges to the serial bytes."""
    paths, base = inputs
    monkeypatch.setenv(dledger.ENV_SHARDS, "1")
    ld = str(tmp_path / "ledger")
    faults.configure("dist/contig:1")
    with pytest.raises(faults.InjectedFault):
        port_cli([*paths, "--ledger-dir", ld, "--worker-id", "victim"])
    led = WorkLedger.attach(ld)
    assert not led.is_done("shard_0")
    metrics.reset()
    faults.configure("skew=1e9")
    rc, out, err = port_cli([*paths, "--ledger-dir", ld, "--worker-id",
                             "thief"])
    assert rc == 0, err
    assert out == base
    snap = metrics.registry().snapshot()
    assert snap["dist_shards_stolen"] == 1
    assert snap["dist_contigs_resumed"] == 1
    assert snap["dist_contigs_polished"] == 2
    assert snap["dist_contigs_repolished"] == 2
    assert snap["dist_recovery_wall_s"] >= 0
    assert _manifest_tids(led) == [0, 1, 2]


@pytest.mark.parametrize("victim, thief", [("reference", "port"),
                                           ("port", "reference")])
def test_cross_package_ledger(tmp_path, inputs, monkeypatch, victim,
                              thief):
    """A ledger one package started and the other finished: the victim
    dies at its second dist/contig (raise), the thief (skew=1e9) steals
    the shard, resumes the victim's committed contig from its store and
    merges the serial bytes of both packages."""
    paths, base = inputs
    monkeypatch.setenv(dledger.ENV_SHARDS, "1")
    ld = str(tmp_path / "ledger")
    run = {"reference": ref_native, "port": port_cli}
    inj = {"reference": RF, "port": faults}
    inj[victim].configure("dist/contig:1")
    with pytest.raises(inj[victim].InjectedFault):
        run[victim]([*paths, "--ledger-dir", ld, "--worker-id", "victim"])
    inj[victim].configure(None)
    inj[thief].configure("skew=1e9")
    for mod in (metrics, RM):
        mod.reset()
    rc, out, err = run[thief]([*paths, "--ledger-dir", ld,
                               "--worker-id", "thief"])
    assert rc == 0, err
    assert out == base
    snap = (metrics if thief == "port" else RM).registry().snapshot()
    assert snap["dist_shards_stolen"] == 1
    assert snap["dist_contigs_resumed"] == 1
    assert snap["dist_contigs_polished"] == 2
    assert _manifest_tids(WorkLedger.attach(ld)) == [0, 1, 2]


# ------------------------------------------ scan, partition and planner


def _sequence_files(d):
    """Plain and gzipped FASTA (single- and multi-line) and FASTQ."""
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", np.uint8)
    fa, fa_wrapped, fq = [], [], []
    for i in range(40):
        seq = bases[rng.integers(0, 4, int(rng.integers(1, 900)))].tobytes()
        qual = bytes(rng.integers(33, 74, len(seq)).astype(np.uint8))
        fa.append(b">r%d desc\n%s\n" % (i, seq))
        fa_wrapped.append(b">r%d\n" % i + b"".join(
            seq[j:j + 60] + b"\n" for j in range(0, len(seq), 60)))
        fq.append(b"@r%d\n%s\n+\n%s\n" % (i, seq, qual))
        if i % 7 == 0:
            fa.append(b"\n")
    files = {"a.fasta": b"".join(fa), "b.fa": b"".join(fa_wrapped),
             "c.fastq": b"".join(fq), "d.fq": b"".join(fq)[:-1]}
    out = []
    for name, data in files.items():
        for gz in (False, True):
            p = os.path.join(d, name + (".gz" if gz else ""))
            with (gzip.open(p, "wb") if gz else open(p, "wb")) as fh:
                fh.write(data)
            out.append(p)
    return out


@pytest.mark.parametrize("ingest", ["1", "0"])
def test_scan_sequence_index_matches_reference(tmp_path, monkeypatch,
                                               ingest):
    from racon_tpu.io.parsers import ParseError as RParseError
    from racon_tpu.io.parsers import scan_sequence_index as rscan
    from racon_tpu_torch.io.parsers import ParseError, scan_sequence_index
    monkeypatch.setenv("RACON_TPU_INGEST", ingest)
    for p in _sequence_files(str(tmp_path)):
        got = scan_sequence_index(p)
        assert got == rscan(p), p
        assert got[0] == 40
    bad = tmp_path / "bad.fastq"
    bad.write_bytes(b"@a\nAC\n+\nII\n@b\nACG\n+\nI\n")
    bad2 = tmp_path / "bad2.fastq"
    bad2.write_bytes(b"@a\nAC\n+\nII\nxb\nAC\n+\nII\n")
    for p in (bad, bad2):
        with pytest.raises(RParseError) as ref:
            rscan(str(p))
        with pytest.raises(ParseError) as port:
            scan_sequence_index(str(p))
        assert port.value.offset == ref.value.offset
    # A truncated gzip stream: a ParseError at an offset inside the data.
    data = (tmp_path / "a.fasta").read_bytes() * 700   # > 2 read blocks
    whole = gzip.compress(data)
    trunc = tmp_path / "trunc.fasta.gz"
    trunc.write_bytes(whole[:len(whole) // 2])
    with pytest.raises(ParseError, match="corrupt or truncated") as port:
        scan_sequence_index(str(trunc))
    assert 0 < port.value.offset <= len(data)


def test_weighted_bounds_match_reference(monkeypatch):
    from racon_tpu.ava import partition as RP
    from racon_tpu_torch.ava import partition as PP
    rng = np.random.default_rng(9)
    for _ in range(40):
        n = int(rng.integers(1, 300))
        gaps = rng.lognormal(6, 1.5, n).astype(np.int64) + 1
        offsets = [0] + np.cumsum(gaps)[:-1].tolist()
        for k in (1, 2, 3, min(n, 7), n):
            assert PP.weighted_bounds(n, k, offsets) == \
                RP.weighted_bounds(n, k, offsets)
    assert PP.weights_from_offsets([]) == RP.weights_from_offsets([]) == []
    assert PP.weighted_bounds(3, 2, [0, 5]) is None
    monkeypatch.setenv(PP.ENV_AVA_WEIGHTED, "off")
    assert PP.weighted_bounds(3, 2, [0, 5, 9]) is None
    assert RP.weighted_bounds(3, 2, [0, 5, 9]) is None


@pytest.mark.parametrize("budget", ["", "1", "3", "40"])
def test_plan_buckets_match_reference(monkeypatch, budget):
    from racon_tpu.ava import planner as RPL
    from racon_tpu.obs.metrics import record_ava_plan as r_record
    from racon_tpu_torch.ava import planner as PPL
    from racon_tpu_torch.obs.metrics import record_ava_plan
    monkeypatch.setenv(PPL.ENV_AVA_COMPILE_BUDGET, budget)
    rng = np.random.default_rng(int(budget or 0))
    for wl in (100, 500, 2000):
        lengths = np.sort(rng.lognormal(8, 1.2, 200)).astype(int).tolist()
        offsets = [0] + np.cumsum(lengths)[:-1].tolist()
        got = PPL.plan_buckets(PPL.lengths_from_offsets(offsets),
                               window_length=wl)
        want = RPL.plan_buckets(RPL.lengths_from_offsets(offsets),
                                window_length=wl)
        assert tuple(got) == tuple(want)
        assert got.n_buckets == want.n_buckets <= got.budget
        record_ava_plan(got)
        r_record(want)
        assert {k: v for k, v in metrics.registry().snapshot().items()
                if k.startswith("ava_")} == \
            {k: v for k, v in RM.registry().snapshot().items()
             if k.startswith("ava_")}
    monkeypatch.setenv(PPL.ENV_AVA_COMPILE_BUDGET, "zero")
    with pytest.raises(ValueError, match="positive bucket count"):
        PPL.plan_buckets([5])
    with pytest.raises(ValueError, match="at least one target"):
        PPL.plan_buckets([], budget=2)


def test_terminal_breach_self_evicts_and_releases(tmp_path, inputs,
                                                  monkeypatch):
    """A terminal watchdog breach inside a shard: the worker releases its
    lease, counts a self-eviction and the CLI exits 75; a successor
    claims the released shard at once (no steal) and merges the serial
    bytes."""
    from racon_tpu_torch.resilience import watchdog
    paths, base = inputs
    ld = str(tmp_path / "ledger")
    monkeypatch.setattr(watchdog, "is_terminal",
                        lambda exc: isinstance(exc, faults.InjectedFault))
    faults.configure("dist/contig:0")
    rc, out, err = port_cli([*paths, "--ledger-dir", ld, "--worker-id",
                             "sick"])
    assert rc == watchdog.EXIT_SELF_EVICT == 75 and out == b""
    assert "self-evicting from shard 0" in err
    assert metrics.registry().snapshot()["dist_self_evictions"] == 1
    led = WorkLedger.attach(ld)
    assert [e["ev"] for e in led.events()] == ["claim", "release"]
    faults.configure(None)
    metrics.reset()
    rc, out, err = port_cli([*paths, "--ledger-dir", ld, "--worker-id",
                             "next"])
    assert rc == 0 and out == base, err
    assert "dist_shards_stolen" not in metrics.registry().snapshot()
