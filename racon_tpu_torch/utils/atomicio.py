"""Durable file writes: the one place the tmp+rename+fsync dance lives.

The port of the JAX package's ``utils/atomicio.py``. The tracer's JSONL
finalization (obs/trace.py), the checkpoint store
(resilience/checkpoint.py), the result cache (cache/), the daemon's job
journal (server/jobs.py) and the gateway lease (gateway/ha.py) share
these helpers, so every file the port promises to be "complete or
absent" goes through the same sequence:

1. write to ``<path>.tmp.<pid>.<thread>`` in the destination directory
   (same filesystem, so the rename is atomic; the thread id keeps two
   threads of the daemon writing one path from sharing a tmp file),
2. flush + ``os.fsync`` the tmp file (data durable before it becomes
   visible),
3. ``os.replace`` onto the final name (readers see old-or-new, never a
   torn file),
4. best-effort fsync of the directory (the rename itself durable).

Appending stores (the checkpoint shard/manifest) instead use
:func:`append_fsync` per record and rely on record ordering for
atomicity — the caller documents which write commits.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Union


def _tmp_name(path: str, kind: str) -> str:
    """A tmp file beside ``path`` no other process or thread uses."""
    return f"{path}.{kind}.{os.getpid()}.{threading.get_ident()}"


def fsync_dir(path: str) -> None:
    """Best-effort directory fsync so a rename/append survives power
    loss; silently skipped where directories cannot be opened (e.g.
    some network filesystems)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically (tmp + fsync + rename)."""
    d = os.path.dirname(os.path.abspath(path))
    tmp = _tmp_name(path, "tmp")
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    fsync_dir(d)


def atomic_write_text(path: str, text: str,
                      encoding: str = "utf-8") -> None:
    atomic_write_bytes(path, text.encode(encoding))


class atomic_writer:
    """Context manager for a streaming atomic write: yields a binary
    handle on ``<path>.tmp.<pid>``; a clean exit fsyncs it and renames
    it onto ``path``, an exception removes it and re-raises, so readers
    of ``path`` see old or new, never a partial file, even when the
    writer dies mid-stream. For payloads too large to buffer (the work
    ledger's merged FASTA); :func:`atomic_write_bytes` is the one-shot
    form."""

    def __init__(self, path: str):
        self.path = path
        self.tmp = f"{path}.tmp.{os.getpid()}"
        self._fh = None

    def __enter__(self):
        self._fh = open(self.tmp, "wb")
        return self._fh

    def __exit__(self, exc_type, exc, tb) -> bool:
        fh = self._fh
        self._fh = None
        if exc_type is not None:
            try:
                fh.close()
            finally:
                try:
                    os.remove(self.tmp)
                except OSError:
                    pass
            return False
        fh.flush()
        os.fsync(fh.fileno())
        fh.close()
        os.replace(self.tmp, self.path)
        fsync_dir(os.path.dirname(os.path.abspath(self.path)))
        return False


def atomic_finalize(tmp_path: str, final_path: str) -> None:
    """Promote an already-written (and closed) tmp file to its final
    name atomically. The caller is responsible for having fsync'd the
    tmp file's contents if it needs durability, not just atomicity."""
    os.replace(tmp_path, final_path)
    fsync_dir(os.path.dirname(os.path.abspath(final_path)))


def append_fsync(fh, data: Union[bytes, str],
                 sync_dir: Optional[str] = None) -> int:
    """Append one record to an open file and make it durable; returns
    the record's start offset (the caller's manifest pointer).

    The offset is taken by seeking to the end first, so a handle that
    raced another appender still records where *its* bytes landed, not a
    stale position.

    ``sync_dir``: also fsync the containing directory. File fsync alone
    does not make the file's *directory entry* durable — a freshly
    created store could lose whole files (committed contigs included)
    on power loss. Callers pass the directory on the first append after
    creating a file; later appends don't need it.
    """
    off = fh.seek(0, os.SEEK_END)
    fh.write(data)
    fh.flush()
    os.fsync(fh.fileno())
    if sync_dir is not None:
        fsync_dir(sync_dir)
    return off


def publish_exclusive(path: str, data: bytes) -> bool:
    """Atomically publish ``data`` at ``path`` iff nothing is there yet.

    The first-claim primitive of the gateway lease: the bytes
    are fully written and fsync'd in a tmp file, then ``os.link``ed to
    the final name — link fails with EEXIST if any other process
    published first, so readers only ever see complete files and
    exactly one publisher wins. Returns True for the winner.
    """
    d = os.path.dirname(os.path.abspath(path))
    tmp = _tmp_name(path, "pub")
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    try:
        os.link(tmp, path)
        won = True
    except FileExistsError:
        won = False
    finally:
        try:
            os.remove(tmp)
        except OSError:
            pass
    if won:
        fsync_dir(d)
    return won


def load_jsonl_prefix(path: str, validate=None):
    """Read a JSONL file's longest valid record prefix.

    Crash-tolerant by construction: a final partially-written line (no
    trailing newline — a torn append), a JSON-invalid line, a non-object
    record, or a record ``validate(rec)`` rejects all end the prefix
    there instead of raising — everything before it is still trusted.
    Returns ``(records, clean)``; ``clean`` is False when anything was
    dropped, so callers know to rewrite the file.
    """
    import json
    with open(path, "rb") as fh:
        raw = fh.read()
    records = []
    lines = raw.split(b"\n")
    clean = not lines or lines[-1] == b""
    for line in lines[:-1] if lines else []:
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict):
                raise ValueError("non-object JSONL record")
            if validate is not None:
                validate(rec)
        except (ValueError, KeyError, TypeError, AttributeError):
            clean = False
            break
        records.append(rec)
    return records, clean
