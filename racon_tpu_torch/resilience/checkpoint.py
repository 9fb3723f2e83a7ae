"""Contig-granular checkpoint/resume for preemption-safe polishing.

Port of the JAX package's ``resilience/checkpoint.py``, byte for byte on
disk: a store either package's CLI wrote resumes under the other's, and
the same inputs and options give the same fingerprint in both (the
config dict is ``server.engine.JobSpec.identity()``, whose ``version``
is the same ``__version__`` in both packages).

A polishing run's unit of durable progress is the **contig**: the
polisher retires targets in input order (serial loop and SliceTracker
pipeline alike), so "contigs 0..k committed" fully describes a partial
run. The store keeps three files in ``--checkpoint-dir``:

``meta.json``
    ``{"schema": 1, "fingerprint": "<hex>"}`` — written atomically
    (utils/atomicio) when the store is created. The fingerprint hashes
    every output-affecting CLI setting plus the sha256 of each input
    file, so ``--resume`` refuses to splice contigs from a different
    run configuration into this one.

``contigs.fasta``
    The shard: each committed contig's exact emitted bytes
    (``>name\\ndata\\n``) appended and fsync'd. Re-emission on resume
    slices this file, so resumed stdout is byte-identical by
    construction, not by re-serialization.

``manifest.jsonl``
    A begin header ``{"ev": "begin", "schema": 1, "fingerprint": ...}``
    then one record per committed target:
    ``{"ev": "contig", "tid": N, "name": ..., "offset": O, "length": L}``
    or ``{"ev": "contig", "tid": N, "emitted": false}`` for targets the
    run dropped (--drop-unpolished semantics must survive resume too).

**Segmented manifests (v2).** An ava run (docs/AVA.md) commits
millions of read-sized targets; one fsync'd manifest record per target
is exactly the cost that cannot survive that scale. A store created
with ``segment_targets > 0`` writes a v2 manifest: the header gains
``"manifest": 2, "seg_targets": N`` and commits amortize into
run-length **segment** records —
``{"ev": "seg", "start": A, "end": B, "offset": O, "lengths": [...]}``
covering targets ``[A, B)`` whose blobs sit contiguously at shard
offset ``O`` (a zero length marks a dropped target; emitted blobs are
never shorter than 3 bytes, so zero is unambiguous). Commits buffer:
each shard write is flushed (``read_emitted`` still slices live bytes)
but the fsync-pair — shard fsync, then one manifest append — happens
once per **seal** (buffer full, a target-id discontinuity, or close).
Every ``RACON_TPU_AVA_COMPACT`` seals the manifest is compacted:
adjacent contiguous segments merge and the file is atomically
rewritten, so manifest size is O(segments), not O(targets). The torn
recovery contract is unchanged — the longest valid manifest prefix
wins, a crash forfeits at most the one unsealed segment (recomputed on
resume), and v2 code resumes v1 stores as before (``resume`` takes the
mode from the manifest header, not from the caller).

Crash consistency is ordering, not locking: the shard append is fsync'd
**before** its manifest record is appended (also fsync'd), so a
manifest record always points at durable shard bytes. The first append
after creating the store also fsyncs the *directory* — file fsync
alone does not make a fresh file's directory entry durable, so without
it a power loss could erase the whole store, committed contigs
included. On resume the store takes the longest valid manifest prefix
(a torn tail line — a partially-written final record — is dropped and
the manifest rewritten atomically), then truncates the shard to the
last referenced byte — orphaned shard bytes from a crash between the
two appends are discarded and that contig recomputes.

Commits pass through the ``ckpt/commit`` fault site (before the shard
append) and the ``ckpt/manifest`` site (between the shard and manifest
appends — the mid-commit eviction window; a ``torn`` action there
writes half the manifest record and hard-exits), so the kill-mid-commit
and torn-manifest scenarios are reproducible.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, IO, Iterable, Optional

from racon_tpu_torch.utils import env
from racon_tpu_torch.utils.atomicio import (append_fsync, atomic_write_text,
                                      fsync_dir, load_jsonl_prefix)

SCHEMA = 1
MANIFEST_V2 = 2
META_NAME = "meta.json"
SHARD_NAME = "contigs.fasta"
MANIFEST_NAME = "manifest.jsonl"

ENV_AVA_COMPACT = env.AVA_COMPACT
DEFAULT_COMPACT_EVERY = 64


def compact_every() -> int:
    """Sealed segments between v2 manifest compaction rewrites
    (``0`` disables compaction; malformed values disable it too —
    compaction is an optimization, never a correctness lever)."""
    raw = env.read(ENV_AVA_COMPACT).strip()
    if not raw:
        return DEFAULT_COMPACT_EVERY
    try:
        return max(0, int(raw))
    except ValueError:
        return 0


class CheckpointError(ValueError):
    """Unusable checkpoint directory: fingerprint mismatch, missing or
    corrupt metadata. Deliberately a hard error — silently recomputing
    would mask operator mistakes (wrong dir, changed inputs)."""


def file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def run_fingerprint(config: Dict, paths: Iterable[str]) -> str:
    """Hash of the output-affecting run identity.

    ``config`` holds every CLI setting that changes emitted bytes
    (scores, window length, rounds, quality/trimming flags...);
    ``paths`` are the input files, digested by content so a re-sorted
    or edited FASTQ invalidates old checkpoints even under the same
    filename.
    """
    ident = {
        "schema": SCHEMA,
        "config": config,
        "inputs": [{"path": os.path.basename(p),
                    "sha256": file_digest(p)} for p in paths],
    }
    blob = json.dumps(ident, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def shard_fingerprint(run_fp: str, shard) -> str:
    """Fingerprint of one work-ledger shard (distributed/ledger.py): the
    run identity plus the shard key, so per-shard stores cannot be
    spliced into another shard or run. Base shards key by partition
    index (int), split children by their lineage suffix (str, e.g.
    "1s1_1"). The JAX package's hash, so either package's ledger
    worker resumes the other's shard stores."""
    key = int(shard) if not isinstance(shard, str) else shard
    return hashlib.sha256(f"{run_fp}:shard:{key}"
                          .encode()).hexdigest()


class CheckpointStore:
    """Append-only contig store bound to one run fingerprint.

    Use :meth:`create` for a fresh run (``--checkpoint-dir``) and
    :meth:`resume` to continue one (``--resume``). ``committed`` maps
    target index → manifest record for everything durably stored.
    """

    def __init__(self, directory: str, fingerprint: str):
        self.directory = directory
        self.fingerprint = fingerprint
        self.committed: Dict[int, Dict] = {}
        self._shard: Optional[IO[bytes]] = None
        self._manifest: Optional[IO[bytes]] = None
        # The first commit after open fsyncs the directory so the
        # shard/manifest *entries* are durable, not just their bytes.
        self._dir_synced = False
        #: Targets per v2 manifest segment; 0 = v1 per-target records.
        self.segment_targets = 0
        # Open-segment state (v2): buffered (tid, blob_len) pairs —
        # contiguous by construction (a discontinuity seals first) —
        # the shard offset where the segment starts, and the shard end
        # including flushed-but-unsealed bytes (the file handle's
        # position is not consulted after open).
        self._seg: list = []
        self._seg_offset = 0
        self._shard_pos = 0
        # Sealed segment records since the last compaction rewrite.
        self._seg_log: list = []
        self._sealed_since_compact = 0
        self._compact_every = 0

    # -------------------------------------------------- construction
    @property
    def meta_path(self) -> str:
        return os.path.join(self.directory, META_NAME)

    @property
    def shard_path(self) -> str:
        return os.path.join(self.directory, SHARD_NAME)

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME)

    @classmethod
    def create(cls, directory: str, fingerprint: str, *,
               segment_targets: int = 0) -> "CheckpointStore":
        """Start a fresh store, replacing any previous contents.
        ``segment_targets > 0`` selects the v2 segmented manifest
        (``ava.seg_targets_for`` picks it for fragment-correction
        runs); the mode is recorded in the manifest header, so resume
        never needs to be told."""
        os.makedirs(directory, exist_ok=True)
        store = cls(directory, fingerprint)
        store.segment_targets = max(0, int(segment_targets))
        for path in (store.shard_path, store.manifest_path):
            if os.path.exists(path):
                os.remove(path)
        atomic_write_text(store.meta_path, json.dumps(
            {"schema": SCHEMA, "fingerprint": fingerprint},
            sort_keys=True) + "\n")
        store._shard = open(store.shard_path, "ab")
        store._manifest = open(store.manifest_path, "ab")
        header = {"ev": "begin", "schema": SCHEMA,
                  "fingerprint": fingerprint}
        if store.segment_targets:
            header["manifest"] = MANIFEST_V2
            header["seg_targets"] = store.segment_targets
            store._compact_every = compact_every()
        append_fsync(store._manifest, (json.dumps(
            header, sort_keys=True) + "\n").encode(),
            sync_dir=directory)
        return store

    @classmethod
    def resume(cls, directory: str,
               fingerprint: str) -> "CheckpointStore":
        """Open an existing store, refusing on any identity mismatch."""
        store = cls(directory, fingerprint)
        try:
            with open(store.meta_path, "r", encoding="utf-8") as fh:
                meta = json.load(fh)
        except (OSError, ValueError) as exc:
            raise CheckpointError(
                f"[racon_tpu_torch::checkpoint] cannot resume from "
                f"{directory!r}: unreadable {META_NAME} ({exc})") from exc
        if meta.get("schema") != SCHEMA:
            raise CheckpointError(
                f"[racon_tpu_torch::checkpoint] {directory!r} has schema "
                f"{meta.get('schema')!r}, this build writes {SCHEMA}")
        if meta.get("fingerprint") != fingerprint:
            raise CheckpointError(
                f"[racon_tpu_torch::checkpoint] refusing to resume: "
                f"checkpoint fingerprint {meta.get('fingerprint')!r} "
                f"does not match this run ({fingerprint!r}) — inputs "
                "or output-affecting options changed")
        store._recover()
        return store

    def _recover(self) -> None:
        """Longest-valid-prefix manifest recovery + shard truncation.

        Tolerates a final partially-written JSONL line (a torn append
        from a mid-commit crash) by truncating to the last valid
        record instead of raising — the shared
        ``atomicio.load_jsonl_prefix`` discipline."""
        def _check(rec):
            if rec.get("ev") == "contig":
                if "offset" in rec:
                    _ = (int(rec["tid"]), int(rec["offset"]),
                         int(rec["length"]), rec["name"])
                else:
                    _ = (int(rec["tid"]), rec["emitted"])
            elif rec.get("ev") == "seg":
                start, end = int(rec["start"]), int(rec["end"])
                lengths = rec["lengths"]
                if (not isinstance(lengths, list)
                        or len(lengths) != end - start
                        or end <= start):
                    raise ValueError("malformed seg record")
                _ = (int(rec["offset"]), [int(x) for x in lengths])

        try:
            records, clean = load_jsonl_prefix(self.manifest_path,
                                               validate=_check)
        except OSError as exc:
            raise CheckpointError(
                f"[racon_tpu_torch::checkpoint] cannot resume: unreadable "
                f"{MANIFEST_NAME} ({exc})") from exc
        torn = not clean
        if not records or records[0].get("ev") != "begin":
            raise CheckpointError(
                f"[racon_tpu_torch::checkpoint] cannot resume: "
                f"{MANIFEST_NAME} missing begin header")
        if records[0].get("fingerprint") != self.fingerprint:
            raise CheckpointError(
                "[racon_tpu_torch::checkpoint] refusing to resume: manifest "
                "header fingerprint does not match this run")

        if records[0].get("manifest") == MANIFEST_V2:
            # The store's mode travels in its header, not in caller
            # arguments — resume paths stay signature-compatible.
            self.segment_targets = max(
                1, int(records[0].get("seg_targets", 1)))
            self._compact_every = compact_every()

        shard_size = os.path.getsize(self.shard_path) \
            if os.path.exists(self.shard_path) else 0
        shard_end = 0
        valid = [records[0]]
        for rec in records[1:]:
            ev = rec.get("ev")
            if ev == "contig":
                if "offset" in rec:
                    end = int(rec["offset"]) + int(rec["length"])
                    if end > shard_size:
                        # Manifest record without its shard bytes: only
                        # possible with external tampering (the write
                        # order forbids it) — stop trusting from here
                        # on.
                        break
                    shard_end = max(shard_end, end)
            elif ev == "seg":
                end = int(rec["offset"]) + sum(
                    int(x) for x in rec["lengths"])
                if end > shard_size:
                    break
                shard_end = max(shard_end, end)
            else:
                continue
            valid.append(rec)

        if torn or len(valid) != len(records):
            data = b"".join(json.dumps(r, sort_keys=True).encode()
                            + b"\n" for r in valid)
            from racon_tpu_torch.utils.atomicio import atomic_write_bytes
            atomic_write_bytes(self.manifest_path, data)
        if shard_size > shard_end:
            # Orphaned tail from a crash between shard append and
            # manifest append (v1) or an unsealed segment's flushed
            # blobs (v2): discard, those targets recompute.
            with open(self.shard_path, "r+b") as fh:
                fh.truncate(shard_end)
                fh.flush()
                os.fsync(fh.fileno())
            fsync_dir(self.directory)

        for rec in valid[1:]:
            if rec.get("ev") == "seg":
                # Expand the run-length segment into the same
                # per-target records a v1 manifest would have held —
                # nothing downstream (read_emitted, the CAS replay,
                # the merge) knows which manifest flavor fed it.
                off = int(rec["offset"])
                for i, ln in enumerate(rec["lengths"]):
                    tid = int(rec["start"]) + i
                    ln = int(ln)
                    if ln == 0:
                        self.committed[tid] = {
                            "ev": "contig", "tid": tid,
                            "emitted": False}
                    else:
                        self.committed[tid] = {
                            "ev": "contig", "tid": tid,
                            "offset": off, "length": ln}
                        off += ln
                self._seg_log.append(rec)
            else:
                self.committed[int(rec["tid"])] = rec

        from racon_tpu_torch.obs.metrics import record_ckpt
        record_ckpt("resume", len(self.committed), shard_end)

        self._shard = open(self.shard_path, "ab")
        self._manifest = open(self.manifest_path, "ab")
        self._shard_pos = shard_end
        self._seg_offset = shard_end

    # ---------------------------------------------------- operations
    def _append_manifest(self, rec: Dict) -> None:
        """The committing write. ``ckpt/manifest`` is the mid-commit
        eviction window (after the shard append, before this one); a
        ``torn`` fault there makes half the record durable and
        hard-exits — exactly the partially-written final line
        :func:`_recover` must drop."""
        from racon_tpu_torch.resilience.faults import hard_exit, maybe_torn
        data = (json.dumps(rec, sort_keys=True) + "\n").encode()
        sync = None if self._dir_synced else self.directory
        if maybe_torn("ckpt/manifest"):
            append_fsync(self._manifest, data[:max(1, len(data) // 2)],
                         sync_dir=sync)
            hard_exit(137)
        append_fsync(self._manifest, data, sync_dir=sync)
        self._dir_synced = True

    def _buffer_commit(self, tid: int, off: int,
                       blob_len: int) -> None:
        """Add one committed target to the open v2 segment, sealing
        first on a target-id discontinuity (segments are run-length
        encodings — they must stay contiguous) and after when the
        buffer reaches the segment size. ``off`` is where the target's
        blob landed in the shard: a segment's offset is its FIRST
        blob's offset, anchored here rather than at seal time because
        a discontinuity seal runs after the new blob was already
        written past the sealed segment's end."""
        tid = int(tid)
        if self._seg and tid != self._seg[-1][0] + 1:
            self._seal_segment()
        if not self._seg:
            self._seg_offset = int(off)
        self._seg.append((tid, blob_len))
        if len(self._seg) >= self.segment_targets:
            self._seal_segment()

    def _seal_segment(self) -> None:
        """Make the open segment durable: one shard fsync covering
        every buffered blob, then one manifest append — the same
        shard-before-manifest ordering as a v1 commit, amortized over
        ``segment_targets`` targets. ``ckpt/manifest`` faults fire
        here, so the torn-manifest drill lands exactly on a segment
        boundary."""
        if not self._seg:
            return
        from racon_tpu_torch.obs.metrics import record_ckpt
        self._shard.flush()
        os.fsync(self._shard.fileno())
        lengths = [ln for _, ln in self._seg]
        rec = {"ev": "seg", "start": self._seg[0][0],
               "end": self._seg[-1][0] + 1,
               "offset": self._seg_offset, "lengths": lengths}
        self._append_manifest(rec)
        self._seg_log.append(rec)
        self._seg = []
        record_ckpt("seal", rec["start"], sum(lengths))
        self._sealed_since_compact += 1
        if (self._compact_every
                and self._sealed_since_compact >= self._compact_every):
            self._compact()

    def _compact(self) -> None:
        """Rewrite the v2 manifest with adjacent contiguous segments
        merged — amortized O(segments) manifest size no matter how
        long the run. The rewrite is atomic (write-temp + rename), so
        a crash mid-compaction leaves the previous manifest intact;
        byte-identity of recovery before and after is the compaction
        test's contract."""
        merged: list = []
        for rec in self._seg_log:
            prev = merged[-1] if merged else None
            if (prev is not None
                    and int(prev["end"]) == int(rec["start"])
                    and int(prev["offset"])
                    + sum(int(x) for x in prev["lengths"])
                    == int(rec["offset"])):
                prev["lengths"] = list(prev["lengths"]) \
                    + list(rec["lengths"])
                prev["end"] = rec["end"]
            else:
                merged.append(dict(rec))
        header = {"ev": "begin", "schema": SCHEMA,
                  "fingerprint": self.fingerprint,
                  "manifest": MANIFEST_V2,
                  "seg_targets": self.segment_targets}
        data = b"".join(json.dumps(r, sort_keys=True).encode() + b"\n"
                        for r in [header] + merged)
        from racon_tpu_torch.obs.metrics import record_ckpt
        from racon_tpu_torch.utils.atomicio import atomic_write_bytes
        self._manifest.close()
        atomic_write_bytes(self.manifest_path, data)
        self._manifest = open(self.manifest_path, "ab")
        self._seg_log = merged
        self._sealed_since_compact = 0
        record_ckpt("compaction", 0, len(data))

    def commit(self, tid: int, name: bytes, data: bytes) -> None:
        """Durably store target ``tid``'s emitted FASTA record.

        Write order is the crash-consistency contract: shard bytes
        reach disk before the manifest record that references them, and
        the first commit also fsyncs the directory so the files'
        entries survive power loss. A v2 store flushes the shard write
        immediately (so ``read_emitted`` serves live bytes) but defers
        the fsync-pair to the segment seal — the target is durable only
        once its segment is."""
        if self._shard is None or self._manifest is None:
            raise CheckpointError(
                "[racon_tpu_torch::checkpoint] commit on a closed store")
        from racon_tpu_torch.obs.metrics import record_ckpt
        from racon_tpu_torch.resilience.faults import maybe_fault
        maybe_fault("ckpt/commit")
        blob = b">" + name + b"\n" + data + b"\n"
        if self.segment_targets:
            off = self._shard_pos
            self._shard.write(blob)
            self._shard.flush()
            self._shard_pos = off + len(blob)
            rec = {"ev": "contig", "tid": int(tid),
                   "offset": off, "length": len(blob)}
            self.committed[int(tid)] = rec
            record_ckpt("commit", tid, len(blob))
            self._buffer_commit(tid, off, len(blob))
            return
        off = append_fsync(self._shard, blob,
                           sync_dir=None if self._dir_synced
                           else self.directory)
        self._shard_pos = off + len(blob)
        rec = {"ev": "contig", "tid": int(tid),
               "name": name.decode("utf-8", "replace"),
               "offset": off, "length": len(blob)}
        self._append_manifest(rec)
        self.committed[int(tid)] = rec
        record_ckpt("commit", tid, len(blob))

    def commit_dropped(self, tid: int) -> None:
        """Record that ``tid`` completed but emits nothing (a dropped
        unpolished target) — resume must skip its compute too."""
        if self._manifest is None:
            raise CheckpointError(
                "[racon_tpu_torch::checkpoint] commit on a closed store")
        from racon_tpu_torch.obs.metrics import record_ckpt
        from racon_tpu_torch.resilience.faults import maybe_fault
        maybe_fault("ckpt/commit")
        rec = {"ev": "contig", "tid": int(tid), "emitted": False}
        if self.segment_targets:
            self.committed[int(tid)] = rec
            record_ckpt("commit", tid, 0)
            self._buffer_commit(tid, self._shard_pos, 0)
            return
        self._append_manifest(rec)
        self.committed[int(tid)] = rec
        record_ckpt("commit", tid, 0)

    def read_emitted(self, tid: int) -> Optional[bytes]:
        """The exact bytes originally emitted for ``tid`` (None for a
        dropped target) — sliced from the shard, not re-serialized."""
        rec = self.committed[int(tid)]
        if "offset" not in rec:
            return None
        with open(self.shard_path, "rb") as fh:
            fh.seek(int(rec["offset"]))
            blob = fh.read(int(rec["length"]))
        if len(blob) != int(rec["length"]):
            raise CheckpointError(
                f"[racon_tpu_torch::checkpoint] shard truncated under "
                f"manifest record for target {tid}")
        return blob

    def close(self) -> None:
        if self._seg and self._shard is not None \
                and self._manifest is not None:
            # A v2 store seals its partial tail segment on the way
            # out, so a closed store always has a fully sealed
            # manifest.
            self._seal_segment()
        for fh in (self._shard, self._manifest):
            if fh is not None:
                try:
                    fh.close()
                except OSError:
                    pass
        self._shard = self._manifest = None

    def __enter__(self) -> "CheckpointStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
