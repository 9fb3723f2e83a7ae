"""Chunk-parallel gzip/BGZF inflate for the ingest plane — port of the
JAX package's ``io/inflate.py``.

Decompression parallelizes cleanly because zlib releases the GIL: a plain
``ThreadPoolExecutor`` gives real concurrency without copying data across
processes.

Reader selection for a ``.gz`` input (:func:`open_gzip_source`):

- **BGZF** (bgzip/htslib output): every member carries the ``BC`` extra
  subfield with the compressed block size, so block boundaries are read
  straight out of the headers and all blocks inflate concurrently on the
  pool.
- **Multi-member gzip** (concatenated ``gzip.compress`` outputs, pigz
  ``--independent``): member starts are found by scanning the mmap'd
  compressed bytes for gzip magic candidates; candidates inflate
  speculatively in file order and a chain walk confirms them — a member
  is real iff the previously confirmed member ends exactly at its offset,
  so a false candidate (magic bytes inside compressed data) costs one
  wasted inflate and never corrupts the stream.
- **Single-member gzip**: no intra-file parallelism exists, so a producer
  thread streams the inflate through a bounded queue and decompression
  overlaps the consumer's parsing instead.

Every source yields plain ``bytes`` blocks whose concatenation is
byte-identical to ``gzip.open(path).read()``; the parsers' ``_block_lines``
takes either a file object or one of these sources.

Errors: mid-member truncation and corrupt deflate streams raise
:class:`~racon_tpu_torch.io.parsers.ParseError` naming the member ordinal
and carrying the member's *compressed* byte offset (unlike parse errors,
whose offsets are decompressed-stream positions). The pool width is
``RACON_TPU_INGEST_WORKERS`` (default: cores, 2 to 8).
"""

from __future__ import annotations

import gzip
import mmap
import os
import threading
import time
import zlib
from typing import Iterator, List, Optional, Tuple

from racon_tpu_torch.io.parsers import ParseError
from racon_tpu_torch.pipeline import metrics
from racon_tpu_torch.pipeline.queues import (BoundedQueue, PipelineAborted,
                                             QueueClosed)
from racon_tpu_torch.utils import env

ENV_WORKERS = env.INGEST_WORKERS

_MAGIC = b"\x1f\x8b"
#: gzip magic + CM=8 (deflate) — the member-start candidate pattern.
_MEMBER_MAGIC = b"\x1f\x8b\x08"
#: Compressed-feed granularity for member inflate.
_FEED = 1 << 20
#: In-flight inflate jobs per worker (bounds decompressed buffering).
_LOOKAHEAD = 4
#: Inflated blocks the single-member stream may run ahead of its reader.
_STREAM_DEPTH = 4


def inflate_workers() -> int:
    """Inflate pool width: ``RACON_TPU_INGEST_WORKERS`` or a core-count
    default (capped — inflate saturates memory bandwidth long before it
    needs every core of a large host)."""
    val = env.read(ENV_WORKERS)
    if val:
        try:
            n = int(val)
        except ValueError as exc:
            raise ValueError(f"[racon_tpu_torch::io] invalid "
                             f"{ENV_WORKERS}={val!r}") from exc
        if n > 0:
            return n
    return max(2, min(8, os.cpu_count() or 2))


def bgzf_block_size(buf, off: int, size: int) -> Optional[int]:
    """Total compressed length of the BGZF block at ``off`` (BSIZE+1),
    or None when the member there has no ``BC`` extra subfield (not
    BGZF) or the header itself is short/malformed."""
    if off + 18 > size:
        return None
    if buf[off:off + 3] != _MEMBER_MAGIC or not buf[off + 3] & 4:
        return None  # not gzip/deflate, or FEXTRA unset
    xlen = buf[off + 10] | buf[off + 11] << 8
    if off + 12 + xlen > size:
        return None
    p = off + 12
    end = p + xlen
    while p + 4 <= end:
        si1, si2 = buf[p], buf[p + 1]
        slen = buf[p + 2] | buf[p + 3] << 8
        if si1 == 66 and si2 == 67 and slen == 2 and p + 6 <= end:
            return (buf[p + 4] | buf[p + 5] << 8) + 1
        p += 4 + slen
    return None


class _MemberError(Exception):
    """Internal: one member failed to inflate; the chain walk converts
    it to the ordinal-bearing ParseError."""

    def __init__(self, offset: int, reason: str):
        super().__init__(reason)
        self.offset = offset
        self.reason = reason


def _inflate_member(mm, start: int, size: int) -> Tuple[bytes, int, float]:
    """Inflate the complete gzip member starting at ``start``; returns
    (payload, end offset, seconds in zlib). zlib verifies the member
    CRC at eof, so a corrupt payload cannot pass silently."""
    d = zlib.decompressobj(zlib.MAX_WBITS | 16)
    out: List[bytes] = []
    pos = start
    t0 = time.perf_counter()
    try:
        while not d.eof:
            if pos >= size:
                raise _MemberError(start, "truncated mid-member")
            chunk = mm[pos:pos + _FEED]
            out.append(d.decompress(chunk))
            pos += len(chunk)
    except zlib.error as exc:
        raise _MemberError(start, f"corrupt deflate stream ({exc})")
    end = pos - len(d.unused_data)
    return b"".join(out), end, time.perf_counter() - t0


class ByteSource:
    """Iterable-of-blocks context manager; ``mode`` names the plan (the
    module docstring's selection)."""

    mode = "?"

    def __init__(self, path: str):
        self.path = path

    def blocks(self) -> Iterator[bytes]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[bytes]:
        return self.blocks()

    def __enter__(self) -> "ByteSource":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def close(self) -> None:
        pass

    def _record(self, bytes_in: int, bytes_out: int, seconds: float,
                blocks: int) -> None:
        if blocks:
            metrics.record_ingest_inflate(self.mode, bytes_in, bytes_out,
                                          seconds, blocks)


class _EmptySource(ByteSource):
    """A zero-byte .gz: the serial reader yields nothing, so do we."""

    mode = "empty"

    def blocks(self) -> Iterator[bytes]:
        return iter(())


class _PooledSource(ByteSource):
    """Shared mmap + worker pool for the parallel (bgzf/members) plans."""

    def __init__(self, path: str, fh, mm):
        super().__init__(path)
        self._fh = fh
        self._mm = mm
        self._pool = None

    def _executor(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=inflate_workers(),
                thread_name_prefix="racon-inflate")
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class BgzfSource(_PooledSource):
    """All block boundaries come from the BC headers; every block is an
    independent gzip member inflated concurrently, yielded in order."""

    mode = "bgzf"

    def _walk(self) -> List[Tuple[int, int]]:
        mm, size = self._mm, len(self._mm)
        spans: List[Tuple[int, int]] = []
        off = 0
        while off < size:
            bs = bgzf_block_size(mm, off, size)
            if bs is None or off + bs > size:
                what = ("truncated mid-member" if bs is not None
                        else "malformed or truncated header")
                raise ParseError(
                    f"[racon_tpu_torch::io] error: BGZF member {len(spans)} "
                    f"of {self.path} {what} at compressed offset {off}",
                    offset=off)
            spans.append((off, bs))
            off += bs
        return spans

    def blocks(self) -> Iterator[bytes]:
        spans = self._walk()
        pool = self._executor()
        window = inflate_workers() * _LOOKAHEAD
        bytes_out = 0
        inflate_s = 0.0
        n = 0
        pending: List = []
        nxt = 0

        def _submit_one() -> None:
            nonlocal nxt
            pending.append(pool.submit(_inflate_member, self._mm,
                                       spans[nxt][0], len(self._mm)))
            nxt += 1

        try:
            while nxt < len(spans) and nxt < window:
                _submit_one()
            i = 0
            while pending:
                fut = pending.pop(0)
                if nxt < len(spans):
                    _submit_one()
                try:
                    payload, end, dt = fut.result()
                except _MemberError as exc:
                    raise ParseError(
                        f"[racon_tpu_torch::io] error: BGZF member {i} of "
                        f"{self.path} {exc.reason} at compressed offset "
                        f"{exc.offset}", offset=exc.offset) from exc
                if end != spans[i][0] + spans[i][1]:
                    raise ParseError(
                        f"[racon_tpu_torch::io] error: BGZF member {i} of "
                        f"{self.path} ends at {end}, header promised "
                        f"{spans[i][0] + spans[i][1]} (compressed offset "
                        f"{spans[i][0]})", offset=spans[i][0])
                bytes_out += len(payload)
                inflate_s += dt
                n += 1
                i += 1
                if payload:
                    yield payload
        finally:
            self._record(len(self._mm) if self._mm is not None else 0,
                         bytes_out, inflate_s, n)


class MemberSource(_PooledSource):
    """Plain multi-member gzip: candidate starts from a magic scan,
    speculative parallel inflate, chain-walk confirmation."""

    mode = "members"

    def __init__(self, path: str, fh, mm, candidates: List[int]):
        super().__init__(path, fh, mm)
        self._cands = candidates

    def blocks(self) -> Iterator[bytes]:
        mm, size = self._mm, len(self._mm)
        pool = self._executor()
        window = inflate_workers() * _LOOKAHEAD
        futures = {}
        submitted = 0
        idx_of = {c: i for i, c in enumerate(self._cands)}
        bytes_out = 0
        inflate_s = 0.0
        n = 0

        def _submit_to(limit: int) -> None:
            nonlocal submitted
            while submitted < len(self._cands) and submitted <= limit:
                c = self._cands[submitted]
                futures[c] = pool.submit(_inflate_member, mm, c, size)
                submitted += 1

        try:
            cur = 0
            while cur < size:
                i = idx_of.get(cur)
                if i is None:
                    # The previous member ended at bytes that are not a
                    # gzip member start: trailing garbage, or a stream
                    # cut inside the final member's trailer.
                    raise ParseError(
                        f"[racon_tpu_torch::io] error: gzip member {n} of "
                        f"{self.path} is followed by non-gzip bytes at "
                        f"compressed offset {cur} (corrupt or truncated "
                        "multi-member stream)", offset=cur)
                _submit_to(i + window)
                try:
                    payload, end, dt = futures.pop(cur).result()
                except _MemberError as exc:
                    raise ParseError(
                        f"[racon_tpu_torch::io] error: gzip member {n} of "
                        f"{self.path} {exc.reason} at compressed offset "
                        f"{exc.offset}", offset=exc.offset) from exc
                bytes_out += len(payload)
                inflate_s += dt
                n += 1
                cur = end
                if payload:
                    yield payload
        finally:
            self._record(size, bytes_out, inflate_s, n)


class StreamSource(ByteSource):
    """Single-member gzip: no block boundaries to parallelize over, so
    a producer thread inflates ahead through a bounded queue, which still
    overlaps decompression with downstream parsing. An inflate error
    reaches the consumer after the blocks inflated before it (the JAX
    package's copy drops them, so its error offset depends on how far
    the consumer had read)."""

    mode = "stream"

    def __init__(self, path: str):
        super().__init__(path)
        self._thread: Optional[threading.Thread] = None
        self._q = None

    def blocks(self) -> Iterator[bytes]:
        q = BoundedQueue("inflate_stream", _STREAM_DEPTH)
        self._q = q
        err: List[BaseException] = []
        stats = {"out": 0, "s": 0.0, "n": 0}

        def _produce() -> None:
            try:
                with gzip.open(self.path, "rb") as f:
                    while True:
                        t0 = time.perf_counter()
                        data = f.read(_FEED)
                        stats["s"] += time.perf_counter() - t0
                        if not data:
                            break
                        stats["out"] += len(data)
                        stats["n"] += 1
                        q.put(data)
                q.close()
            except PipelineAborted:
                pass
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                # Close, not abort: the consumer still gets every block
                # inflated before the failure, so the parser's offset is
                # where the stream broke, whatever the threads' timing.
                err.append(exc)
                q.close()

        t = threading.Thread(target=_produce, name="racon-inflate-stream",
                             daemon=True)
        self._thread = t
        t.start()
        try:
            while True:
                try:
                    data = q.get()
                except QueueClosed:
                    t.join(timeout=10)
                    if err:
                        raise err[0]
                    return
                yield data
        finally:
            q.abort()
            t.join(timeout=10)
            self._record(os.path.getsize(self.path), stats["out"],
                         stats["s"], stats["n"])

    def close(self) -> None:
        if self._q is not None:
            self._q.abort()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


def open_gzip_source(path: str) -> ByteSource:
    """Pick the inflate plan for a ``.gz`` input (module docstring)."""
    size = os.path.getsize(path)
    if size == 0:
        return _EmptySource(path)
    fh = open(path, "rb")
    try:
        mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
    except (ValueError, OSError):
        fh.close()
        return StreamSource(path)
    if bgzf_block_size(mm, 0, size) is not None:
        return BgzfSource(path, fh, mm)
    cands = [0]
    i = mm.find(_MEMBER_MAGIC, 1)
    while i != -1:
        cands.append(i)
        i = mm.find(_MEMBER_MAGIC, i + 1)
    if len(cands) > 1:
        return MemberSource(path, fh, mm, cands)
    mm.close()
    fh.close()
    return StreamSource(path)
