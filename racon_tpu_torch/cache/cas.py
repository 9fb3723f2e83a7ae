"""Tier 1: the job-level content-addressed result store (port of the
JAX package's ``cache/cas.py``; same entry files, byte for byte).

One entry per job fingerprint (:meth:`JobSpec.fingerprint` — scoring
config plus the content digests of all three inputs), holding the
job's committed contig records exactly as the checkpoint store would
replay them. An entry is a single object file::

    {"schema": 1, "key": ..., "digest": ..., "records": [...]}\\n
    <payload bytes — every record's data, concatenated in order>

The header's ``digest`` is sha256 over the canonical records metadata
plus the payload, so *any* corruption — a flipped bit, a torn tail, a
truncated write — is caught on load. The safety contract is strict:

- **Verify on hit.** A hit is only served after the digest recomputes
  clean. Anything else demotes to a miss, increments
  ``cache_verify_fail_total``, and quarantines the object (renamed to
  ``*.quarantine`` so the evidence survives but can never be served).
  A poisoned cache can cost recompute time; it can never change
  output bytes.
- **Atomic publication.** Object files and the LRU index are written
  via :mod:`racon_tpu_torch.utils.atomicio`, so a crash mid-store leaves
  either the old state or the new — never a half-entry. Recovery is
  journal-aware: the constructor reloads the index, drops entries
  whose object vanished, and does *not* re-hash payloads (that work
  happens per hit, where it pays).
- **Bounded.** ``RACON_TPU_CACHE_MAX_MB`` bounds total object bytes;
  eviction is LRU over an integer recency sequence (no wallclock —
  DET001) and republishes the index atomically.

Fault sites: ``cache/store`` fires *before* the object write (an
injected failure skips the store; the job result is unaffected);
``cache/load`` supports the ``!torn`` action, which truncates the
just-read object bytes in process to simulate reading a torn entry,
which verify-on-hit must demote to a miss.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

from racon_tpu_torch.obs.metrics import record_cache
from racon_tpu_torch.resilience.faults import InjectedFault, maybe_fault, \
    maybe_torn
from racon_tpu_torch.utils import env
from racon_tpu_torch.utils.atomicio import atomic_write_bytes, \
    atomic_write_text

ENV_CACHE_MAX_MB = env.CACHE_MAX_MB

_SCHEMA = 1
_INDEX = "index.json"

# A record is (tid, name, data): name None marks a dropped target
# (committed with no emission — checkpoint.commit_dropped).
Record = Tuple[int, Optional[bytes], bytes]


class CacheError(RuntimeError):
    """Raised for unusable cache roots; never for entry corruption
    (corruption is demoted to a miss, not an error)."""


def records_from_store(store) -> List[Record]:
    """Derive the CAS records for a finished job from its checkpoint
    store: the exact inverse of the ``b">" + name + b"\\n" + data +
    b"\\n"`` blob each commit wrote, in tid order so replay reproduces
    the committed stream byte for byte."""
    records: List[Record] = []
    for tid in sorted(store.committed):
        blob = store.read_emitted(tid)
        if blob is None:
            records.append((tid, None, b""))
        else:
            nl = blob.index(b"\n")
            records.append((tid, bytes(blob[1:nl]),
                            bytes(blob[nl + 1:-1])))
    return records


def replay_records(records: List[Record], emit=None, store=None) -> int:
    """Replay verified CAS records through the same emit-then-commit
    order polish_job uses, so streams, journals, and restart recovery
    see a cache hit exactly as they would a fresh run. Returns the
    number of emitted (non-dropped) records."""
    n = 0
    for tid, name, data in records:
        if name is None:
            if store is not None:
                store.commit_dropped(tid)
            continue
        if emit is not None:
            emit(b">" + name + b"\n" + data + b"\n")
        if store is not None:
            store.commit(tid, name, data)
        n += 1
    return n


def _encode(key: str, records: List[Record]) -> bytes:
    meta = [{"tid": tid,
             "name": None if name is None else name.decode("latin-1"),
             "len": len(data)} for tid, name, data in records]
    payload = b"".join(data for _, _, data in records)
    meta_json = json.dumps(meta, sort_keys=True,
                           separators=(",", ":"))
    digest = hashlib.sha256(meta_json.encode() + payload).hexdigest()
    header = json.dumps({"schema": _SCHEMA, "key": key,
                         "digest": digest, "records": meta},
                        sort_keys=True, separators=(",", ":"))
    return header.encode() + b"\n" + payload


def _decode_verify(key: str, raw: bytes) -> Optional[List[Record]]:
    """Parse and digest-check an object file; ``None`` on *any*
    defect — the caller treats that as a miss and quarantines."""
    try:
        nl = raw.index(b"\n")
        head = json.loads(raw[:nl].decode())
        if head.get("schema") != _SCHEMA or head.get("key") != key:
            return None
        meta = head["records"]
        payload = raw[nl + 1:]
        if len(payload) != sum(int(m["len"]) for m in meta):
            return None
        meta_json = json.dumps(meta, sort_keys=True,
                               separators=(",", ":"))
        if hashlib.sha256(meta_json.encode() +
                          payload).hexdigest() != head["digest"]:
            return None
        records: List[Record] = []
        off = 0
        for m in meta:
            ln = int(m["len"])
            name = m["name"]
            records.append((int(m["tid"]),
                            None if name is None
                            else name.encode("latin-1"),
                            payload[off:off + ln]))
            off += ln
        return records
    except (ValueError, KeyError, TypeError, UnicodeDecodeError):
        return None


class ResultCache:
    """The on-disk CAS. Thread-safe: the daemon's worker pool stores
    and probes concurrently; all index state is guarded by one lock
    and published atomically."""

    def __init__(self, directory: str,
                 max_bytes: Optional[int] = None) -> None:
        self.directory = directory
        self.objects = os.path.join(directory, "objects")
        try:
            os.makedirs(self.objects, exist_ok=True)
        except OSError as exc:
            raise CacheError(
                f"[racon_tpu_torch::cache] unusable cache root "
                f"{directory!r}: {exc}") from exc
        if max_bytes is None:
            max_bytes = int(env.read(ENV_CACHE_MAX_MB)) * 1024 * 1024
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict] = {}  # guarded-by: _lock
        self._seq = 0                        # guarded-by: _lock
        self._recover()

    # ------------------------------------------------------------ index

    def _index_path(self) -> str:
        return os.path.join(self.directory, _INDEX)

    def _object_path(self, key: str) -> str:
        return os.path.join(self.objects, key)

    def _recover(self) -> None:
        """Journal-aware recovery: the atomically-published index is
        complete-or-absent, so reload it wholesale, drop entries whose
        object file is gone, and trust payloads until a hit verifies
        them — a restart never re-hashes the world."""
        try:
            with open(self._index_path()) as fh:
                idx = json.load(fh)
        except (OSError, ValueError):
            return
        if not isinstance(idx, dict) or idx.get("schema") != _SCHEMA:
            return
        with self._lock:
            for key, ent in sorted(idx.get("entries", {}).items()):
                if os.path.isfile(self._object_path(key)):
                    self._entries[key] = {"bytes": int(ent["bytes"]),
                                          "seq": int(ent["seq"])}
            self._seq = max([int(idx.get("seq", 0))] +
                            [e["seq"] for e in self._entries.values()])

    def _publish_index_locked(self) -> None:
        atomic_write_text(self._index_path(), json.dumps(
            {"schema": _SCHEMA, "seq": self._seq,
             "entries": self._entries}, sort_keys=True))

    # ------------------------------------------------------- store/load

    def store(self, key: str, records: List[Record]) -> bool:
        """Write an entry, LRU-evict past the byte bound, republish
        the index. An injected ``cache/store`` fault skips the store
        and returns False — the caller's job result is never coupled
        to cache health."""
        try:
            maybe_fault("cache/store")
        except InjectedFault:
            return False
        blob = _encode(key, records)
        atomic_write_bytes(self._object_path(key), blob)
        evicted: List[Tuple[str, int]] = []
        with self._lock:
            self._seq += 1
            self._entries[key] = {"bytes": len(blob),
                                  "seq": self._seq}
            # Evict by ascending recency seq (integer, no wallclock —
            # DET001) until under the bound; the just-stored entry
            # always survives so an oversized single job degrades to
            # cache-of-one, not thrash.
            total = sum(e["bytes"] for e in self._entries.values())
            while total > self.max_bytes and len(self._entries) > 1:
                victim = min((k for k in self._entries if k != key),
                             key=lambda k: self._entries[k]["seq"],
                             default=None)
                if victim is None:
                    break
                ent = self._entries.pop(victim)
                total -= ent["bytes"]
                try:
                    os.remove(self._object_path(victim))
                except OSError:
                    pass
                evicted.append((victim, ent["bytes"]))
            self._publish_index_locked()
        record_cache("job", "store", nbytes=len(blob))
        for _, _nb in evicted:
            record_cache("job", "evict")
        return True

    def load(self, key: str) -> Optional[List[Record]]:
        """Probe for a verified entry. Misses, unreadable objects, and
        any verification defect return ``None``; defects additionally
        quarantine the object so it is never probed again."""
        with self._lock:
            ent = self._entries.get(key)
        if ent is None:
            record_cache("job", "miss")
            return None
        try:
            with open(self._object_path(key), "rb") as fh:
                raw = fh.read()
        except OSError:
            raw = b""
        if maybe_torn("cache/load"):
            # Poisoning drill: the reader sees a torn entry — keep
            # only a prefix so the digest cannot recompute clean.
            raw = raw[:max(0, len(raw) // 2)]
        records = _decode_verify(key, raw)
        if records is None:
            self._quarantine(key)
            record_cache("job", "verify_fail")
            record_cache("job", "miss")
            return None
        with self._lock:
            if key in self._entries:
                self._seq += 1
                self._entries[key]["seq"] = self._seq
                self._publish_index_locked()
        record_cache("job", "hit")
        return records

    def _quarantine(self, key: str) -> None:
        with self._lock:
            self._entries.pop(key, None)
            self._publish_index_locked()
        path = self._object_path(key)
        try:
            os.replace(path, path + ".quarantine")
        except OSError:
            pass

    # ------------------------------------------------------------ misc

    def window_spill_dir(self, scoring_key) -> str:
        """A per-scoring-config spill directory for Tier-2 memo
        eviction, namespaced by config digest so incompatible scoring
        runs can never cross-pollinate."""
        slug = hashlib.sha256(repr(scoring_key).encode()).hexdigest()
        return os.path.join(self.directory, "windows", slug[:12])

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries),
                    "bytes": sum(e["bytes"]
                                 for e in self._entries.values())}
