"""The port's two-tier result cache against the JAX package's:
``window_digest`` equal across packages on the same windows, CAS entry
files byte for byte (each package loads the other's), a Tier-1 hit that
replays the same bytes with no consensus call, a corrupt or torn entry
demoted to a miss and quarantined, the window memo's spill and its
verify, and the batcher's memo hits that never reach the engine.

Inputs: windows built from a seed with numpy; CLI runs on
tests/serve_inputs.py's tiny inputs."""

import os

import numpy as np
import pytest

from racon_tpu.cache import cas as RCAS
from racon_tpu.cache import memo as RMEMO
from racon_tpu.models.window import Window as RWindow
from racon_tpu.models.window import WindowType as RType
from racon_tpu_torch.cache import cas as PCAS
from racon_tpu_torch.cache import memo as PMEMO
from racon_tpu_torch.models.window import Window as PWindow
from racon_tpu_torch.models.window import WindowType as PType
from racon_tpu_torch.obs import metrics
from racon_tpu_torch.resilience import faults as PF

from serve_inputs import port_cli, write_inputs

BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ("RACON_TPU_FAULTS", "RACON_TPU_CACHE",
                 "RACON_TPU_CACHE_MAX_MB"):
        monkeypatch.delenv(name, raising=False)
    PF.configure(None)
    metrics.reset()
    yield
    PF.configure(None)


def _windows(seed, n=6):
    """The same random windows in both packages' Window types (some
    with qualities, some layers without)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(rng.integers(20, 60))
        bb = BASES[rng.integers(0, 4, L)].tobytes()
        bq = None if i % 2 else bytes(rng.integers(33, 74, L).astype(
            np.uint8))
        pair = (RWindow(i, i, RType.TGS if i % 3 else RType.NGS, bb, bq),
                PWindow(i, i, PType.TGS if i % 3 else PType.NGS, bb, bq))
        for _ in range(int(rng.integers(0, 5))):
            b = int(rng.integers(0, L - 2))
            e = int(rng.integers(b + 1, L))
            data = BASES[rng.integers(0, 4, e - b + 3)].tobytes()
            q = None if bq is None else bytes(
                rng.integers(33, 74, len(data)).astype(np.uint8))
            for w in pair:
                w.add_layer(data, q, b, e)
        out.append(pair)
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_window_digest_matches_reference(seed):
    key = (5, -4, -8, "cuda", 1)
    rm, pm = RMEMO.WindowMemo(key), PMEMO.WindowMemo(key)
    digests = set()
    for rw, pw in _windows(seed):
        assert PMEMO.window_digest(b"s", pw) == \
            RMEMO.window_digest(b"s", rw)
        assert pm.digest(pw) == rm.digest(rw)
        digests.add(pm.digest(pw))
    assert len(digests) == 6


def _records():
    return [(0, b"c0 LN:i:4 RC:i:2 XC:f:1.000000", b"ACGT"),
            (1, None, b""), (2, b"c2", b"GGGTTT")]


def test_cas_entries_match_reference(tmp_path):
    key = "ab" * 32
    ref = RCAS.ResultCache(str(tmp_path / "ref"))
    port = PCAS.ResultCache(str(tmp_path / "port"))
    assert ref.store(key, _records()) and port.store(key, _records())
    for rel in (("objects", key), ("index.json",)):
        assert (tmp_path.joinpath("port", *rel)).read_bytes() == \
            (tmp_path.joinpath("ref", *rel)).read_bytes()
    # Each package loads the other's entry (fresh instances: recovery
    # from the published index).
    assert PCAS.ResultCache(str(tmp_path / "ref")).load(key) == _records()
    assert RCAS.ResultCache(str(tmp_path / "port")).load(key) == _records()
    assert port.window_spill_dir((5, -4, -8)) == \
        os.path.join(str(tmp_path / "port"), "windows",
                     ref.window_spill_dir((5, -4, -8))[-12:])
    assert port.stats() == ref.stats()


def test_corrupt_entry_demotes_to_miss(tmp_path):
    key = "cd" * 32
    cache = PCAS.ResultCache(str(tmp_path))
    cache.store(key, _records())
    obj = tmp_path / "objects" / key
    raw = bytearray(obj.read_bytes())
    raw[-1] ^= 1
    obj.write_bytes(bytes(raw))
    assert cache.load(key) is None
    assert not obj.exists() and (tmp_path / "objects" /
                                 (key + ".quarantine")).exists()
    assert cache.load(key) is None           # gone from the index
    cache.store(key, _records())
    PF.configure("cache/load:0!torn")        # a torn read
    assert cache.load(key) is None
    PF.configure(None)
    snap = metrics.registry().snapshot()
    assert snap["cache_verify_fail_total"] == 2
    assert snap["cache_misses_total"] == 3 and "cache_hits_total" not in snap
    PF.configure("cache/store:0")            # an injected store failure
    assert cache.store(key, _records()) is False
    assert cache.load(key) is None


def test_cas_evicts_to_its_bound(tmp_path):
    cache = PCAS.ResultCache(str(tmp_path), max_bytes=300)
    for i in range(4):
        cache.store(f"{i:064x}", _records())
    assert cache.stats()["entries"] < 4
    assert cache.load(f"{3:064x}") == _records()
    assert metrics.registry().get("cache_evictions_total") >= 1


def test_window_memo_spill_verify(tmp_path):
    memo = PMEMO.WindowMemo((5, -4, -8), max_entries=1,
                            spill_dir=str(tmp_path))
    (_, a), (_, b) = _windows(3, 2)
    assert memo.put(a) is None               # no consensus yet
    a.consensus, a.polished = b"ACGT", True
    b.consensus, b.polished = b"TT", False
    assert memo.put(a) == 4 and memo.put(b) == 2
    assert len(memo) == 1 and os.listdir(tmp_path)
    assert memo.get(a) == (b"ACGT", True)    # from the spill
    spill = tmp_path / os.listdir(tmp_path)[0]
    spill.write_bytes(spill.read_bytes()[:-1] + b"X")
    assert memo.get(a) is None and not spill.exists()
    assert metrics.registry().get("cache_verify_fail_total") == 1


class _CountingEngine:
    def __init__(self):
        self.calls = 0

    def consensus_windows(self, windows):
        self.calls += 1
        for w in windows:
            w.consensus, w.polished = bytes(w.backbone)[::-1], True
        return len(windows)


def test_batcher_memo_hits_skip_the_engine():
    from racon_tpu_torch.server.batch import CrossRequestBatcher
    eng = _CountingEngine()
    memo = PMEMO.WindowMemo((5, -4, -8))
    b = CrossRequestBatcher(eng, capacity=8, wait_s=0.0, queue_cap=4,
                            memo=memo).start()
    try:
        first = [pw for _, pw in _windows(4)]
        assert b.consensus("j1", "acme", first) == 6
        again = [pw for _, pw in _windows(4)]
        assert b.consensus("j2", "acme", again) == 6
    finally:
        b.close()
    assert eng.calls == 1
    assert [w.consensus for w in again] == [w.consensus for w in first]
    snap = metrics.registry().snapshot()
    assert snap["cache_hits_total"] == 6 and snap["cache_misses_total"] == 6
    assert snap["cache_stores_total"] == 6


def test_cli_tier1_hit_replays_with_no_consensus_call(tmp_path,
                                                      monkeypatch):
    from racon_tpu_torch.ops.poa import PoaEngine
    paths = write_inputs(str(tmp_path / "in"))
    cache = str(tmp_path / "cache")
    rc, first, err = port_cli([*paths, "--cache-dir", cache])
    assert rc == 0, err
    calls = []
    real = PoaEngine.consensus_windows

    def counting(self, windows):
        calls.append(len(windows))
        return real(self, windows)

    monkeypatch.setattr(PoaEngine, "consensus_windows", counting)
    rc, again, err = port_cli([*paths, "--cache-dir", cache])
    assert rc == 0, err
    assert again == first and first.count(b">") == 2
    assert calls == [] and "zero consensus dispatches" in err
    # RACON_TPU_CACHE=0 turns the cache off: the run recomputes.
    monkeypatch.setenv("RACON_TPU_CACHE", "0")
    rc, off, err = port_cli([*paths, "--cache-dir", cache])
    assert rc == 0 and off == first and calls
