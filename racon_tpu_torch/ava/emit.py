"""Streaming record emission for assembly-scale result sets (port of
the JAX package's ``ava/emit.py``).

A kC job emits tens of contigs; holding them as a list of Python bytes
objects (server/jobs.Job.chunks) is free. An ava job emits one record
PER READ — millions of small blobs whose object headers alone dwarf the
payload, pinned for the job's whole lifetime so ``/stream`` can replay
them. Two pieces fix that without changing any caller-visible byte:

- :class:`RecordSpool` — the Job result sink. Records accumulate
  in-memory until ``RACON_TPU_SERVE_SPOOL_MB`` worth of bytes, then
  the whole stream spills to one append-only scratch file
  (``result.spool`` in the job directory) and later records go
  straight to disk. ``read_all`` returns the identical concatenation
  either way, so ``/stream`` and the CAS never know which side of the
  threshold the job landed on.
- :func:`iter_fasta_records` — one record at a time off a FASTA file
  (the fleet re-commit loop's reader), so a 10 GB merged output costs
  one record of memory, not two copies of the file.

The spool file is scratch, not durable state: it is rebuilt from the
job's checkpoint store on daemon restart (``jobs.rebuild_result``),
exactly like the in-memory chunk list it replaces.
"""

from __future__ import annotations

import os
import threading
from typing import Iterator, List, Optional

from racon_tpu_torch.utils import env

ENV_SERVE_SPOOL = env.SERVE_SPOOL_MB
DEFAULT_SPOOL_MB = 8
SPOOL_FILE = "result.spool"


def spool_limit_bytes() -> int:
    """In-memory result bytes a job may hold before spilling. A
    non-positive or malformed value means "never spill" — the pre-spool
    behavior, and the right call for test rigs with no job directory."""
    raw = env.read(ENV_SERVE_SPOOL).strip()
    if not raw:
        return DEFAULT_SPOOL_MB << 20
    try:
        mb = int(raw)
    except ValueError:
        return 0
    return mb << 20 if mb > 0 else 0


class RecordSpool:
    """Bounded-memory, append-only byte stream with replay.

    Appends are cheap list appends until the in-memory total crosses
    the spill threshold; from then on every record goes straight to the
    scratch file. The stream is strictly append-ordered in both phases,
    so ``read_all`` is always the exact concatenation of every record
    ever appended — the invariant the daemon's ``/stream`` replay and
    the CAS key derivation both rest on. Thread-safe: the job runner
    appends while HTTP streamers read."""

    def __init__(self, directory: Optional[str] = None,
                 limit_bytes: Optional[int] = None):
        self._limit = spool_limit_bytes() if limit_bytes is None \
            else max(0, int(limit_bytes))
        self._path = os.path.join(directory, SPOOL_FILE) \
            if directory else None
        self._lock = threading.Lock()
        self._chunks: List[bytes] = []
        self._mem = 0
        self._total = 0
        self._file = None

    @property
    def spilled(self) -> bool:
        return self._file is not None

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._total

    def append(self, blob: bytes) -> None:
        with self._lock:
            self._total += len(blob)
            if self._file is not None:
                self._file.write(blob)
                return
            self._chunks.append(blob)
            self._mem += len(blob)
            if (self._path is not None and self._limit > 0
                    and self._mem > self._limit):
                self._spill()

    def _spill(self) -> None:
        # Scratch, not durable state (no fsync, no atomic rename): a
        # crash loses nothing the checkpoint store can't rebuild.
        if os.path.exists(self._path):
            os.remove(self._path)
        fh = open(self._path, "ab")
        for chunk in self._chunks:
            fh.write(chunk)
        self._file = fh
        self._chunks = []
        self._mem = 0

    def read_all(self) -> bytes:
        """The full stream so far — identical bytes whether or not the
        spool has spilled."""
        with self._lock:
            if self._file is None:
                return b"".join(self._chunks)
            self._file.flush()
            with open(self._path, "rb") as fh:
                return fh.read()

    def reset(self) -> None:
        """Drop everything (restart rebuild repopulates from the
        checkpoint store)."""
        with self._lock:
            self._chunks = []
            self._mem = 0
            self._total = 0
            if self._file is not None:
                self._file.close()
                self._file = None
            if self._path is not None and os.path.exists(self._path):
                os.remove(self._path)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


def iter_fasta_records(path: str) -> Iterator[bytes]:
    """Stream per-record byte runs off a FASTA file, splitting at ``>``
    record starts — record-for-record identical to splitting the whole
    blob in memory for any ``\\n``-terminated FASTA (which the merge
    output is: it concatenates per-record emissions that each end in a
    newline). Holds one record at a time."""
    record: List[bytes] = []
    with open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b">"):
                if record:
                    yield b"".join(record)
                record = [line]
            elif record:
                record.append(line)
        if record:
            yield b"".join(record)
