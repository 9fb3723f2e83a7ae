"""Tier 2: window-level consensus memoization for the batcher (port of
the JAX package's ``cache/memo.py``; same digests).

Consensus is a pure function of (window content, scoring config) —
the determinism invariant the serial/serve differential tests pin —
so a window's finished consensus can be keyed by a digest of exactly
those inputs and replayed for any later window with identical
content, whatever job or tenant it arrives from. The cross-request
batcher probes this store before packing windows into a dispatch:
hits skip the device entirely and splice straight into ordered
retirement, so a job that partially overlaps earlier work dispatches
only the delta.

The store is an in-memory LRU (``OrderedDict`` over an integer
recency order — no wallclock, DET001) bounded by entry count; evicted
entries spill to per-scoring-config files when a spill directory is
given (the daemon points it under the Tier-1 cache root). Spill files
carry their own sha256 and are verified on read — a torn or corrupt
spill demotes to a miss and is unlinked, mirroring the Tier-1
verify-on-hit contract. One :class:`WindowMemo` belongs to exactly
one batcher, i.e. one scoring config; the scoring key is folded into
every digest anyway, so even a misrouted spill directory cannot serve
a value computed under different scoring.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

from racon_tpu_torch.obs.metrics import record_cache
from racon_tpu_torch.utils.atomicio import atomic_write_bytes

# Memo value: (consensus bytes, polished flag) exactly as
# Window.apply_consensus left them — post coverage-trim, so a hit
# never re-runs trimming.
Value = Tuple[bytes, bool]

_DEFAULT_MAX_ENTRIES = 4096


def _blob(x: Optional[bytes]) -> bytes:
    """Length-prefix with a None marker so (b"", None) and adjacent
    field boundaries cannot collide."""
    if x is None:
        return b"N"
    b = bytes(x)
    return b"B%d:" % len(b) + b


def window_digest(scoring: bytes, window) -> str:
    """The content digest that names a window's consensus: scoring
    config + window type + backbone (+quality) + every layer's
    (data, quality, begin, end) in insertion order."""
    h = hashlib.sha256()
    h.update(scoring)
    h.update(b"|t%d|" % int(window.type.value))
    h.update(_blob(window.backbone))
    h.update(_blob(window.backbone_quality))
    for i in range(len(window.layer_data)):
        h.update(b"|L|")
        h.update(_blob(window.layer_data[i]))
        h.update(_blob(window.layer_quality[i]))
        h.update(b"%d:%d" % (int(window.layer_begin[i]),
                             int(window.layer_end[i])))
    return h.hexdigest()


class WindowMemo:
    """Bounded, spillable consensus memo. Thread-safe; the batcher's
    staging thread and the submitting request threads both touch it."""

    def __init__(self, scoring_key, max_entries: Optional[int] = None,
                 spill_dir: Optional[str] = None) -> None:
        self._scoring = hashlib.sha256(
            repr(scoring_key).encode()).digest()
        self._max = max_entries or _DEFAULT_MAX_ENTRIES
        self._spill_dir = spill_dir
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._mem: "OrderedDict[str, Value]" = \
            OrderedDict()  # guarded-by: _lock

    def digest(self, window) -> str:
        return window_digest(self._scoring, window)

    # ------------------------------------------------------------ spill

    def _spill_path(self, key: str) -> str:
        return os.path.join(self._spill_dir, key)

    def _spill_read(self, key: str) -> Optional[Value]:
        """Verified spill read: sha256(flag + consensus) header; any
        mismatch (torn write survivor, bit rot) unlinks the file and
        reads as a miss."""
        if self._spill_dir is None:
            return None
        try:
            with open(self._spill_path(key), "rb") as fh:
                raw = fh.read()
        except OSError:
            return None
        if len(raw) < 33 or \
                hashlib.sha256(raw[32:]).digest() != raw[:32]:
            try:
                os.remove(self._spill_path(key))
            except OSError:
                pass
            record_cache("window", "verify_fail")
            return None
        return raw[33:], raw[32:33] == b"P"

    # -------------------------------------------------------- get / put

    def get(self, window) -> Optional[Value]:
        """Probe by content digest; refreshes recency on an in-memory
        hit and falls back to the spill tier. Returns None on miss —
        accounting is the batcher's job (it aggregates per chunk)."""
        key = self.digest(window)
        with self._lock:
            val = self._mem.get(key)
            if val is not None:
                self._mem.move_to_end(key)
                return val
        return self._spill_read(key)

    def put(self, window) -> Optional[int]:
        """Memoize a finished window's consensus. Returns the stored
        byte count, or None when there is nothing to store (consensus
        never produced). Overflow evicts the least-recently-used entry
        to the spill tier (or drops it when no spill dir is set)."""
        if window.consensus is None:
            return None
        key = self.digest(window)
        val = (bytes(window.consensus), bool(window.polished))
        spilled: List[Tuple[str, Value]] = []
        with self._lock:
            self._mem[key] = val
            self._mem.move_to_end(key)
            while len(self._mem) > self._max:
                old_key, old_val = self._mem.popitem(last=False)
                spilled.append((old_key, old_val))
        for old_key, (cons, polished) in spilled:
            if self._spill_dir is not None:
                body = (b"P" if polished else b"U") + cons
                atomic_write_bytes(
                    self._spill_path(old_key),
                    hashlib.sha256(body).digest() + body)
            record_cache("window", "evict")
        return len(val[0])

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)
