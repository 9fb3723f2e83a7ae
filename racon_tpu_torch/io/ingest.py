"""The ingest gate and the mmap'd index-first sequence readers — port of
the JAX package's ``io/ingest.py``.

For *uncompressed* FASTA/FASTQ the bytes are already random-access on
disk: the readers here mmap the file, find the record structure with one
vectorized numpy pass (newline positions and header starts), and hand
every record payload to :class:`~racon_tpu_torch.models.sequence.Sequence`
as a ``memoryview`` slice of the map. ``ops/encode.py`` reads any buffer
with ``np.frombuffer``, so a single-line record goes from the map to a
window slice to the device encode with no intermediate ``bytes`` copy.

Zero-copy contract: on the mmap path the ONLY place a record payload may
become ``bytes`` is :func:`_materialize` / :func:`_materialize_join`, a
counting shim. Multi-line records (wrapped FASTA) must join and count; a
file with one line a record counts zero.

Lifetime: the readers never close the map — every ``memoryview`` sliced
from it keeps it (and its pages) alive, and closing it under live views
would raise ``BufferError``. The map goes with the last record that
references it.

Gate: ``RACON_TPU_INGEST`` — **default on**; ``0``/``false`` forces the
serial readers everywhere (parsers, prefetch, inflate). The two paths give
the same records, offsets and polished output.

Fault sites, as the reference's: the serial readers consult ``io/read``
once a *line*, the indexed readers once a *record* (they have no lines),
and :func:`prefetch_ok` drops the prefetch *threads* (not the readers)
while a fault plan names an ``io/*`` site, because files parsing at once
would race one process-wide site counter.
"""

from __future__ import annotations

import mmap
import os
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from racon_tpu_torch.io import parsers as _p
from racon_tpu_torch.io.parsers import ParseError, Parser
from racon_tpu_torch.models.sequence import Sequence
from racon_tpu_torch.resilience.faults import maybe_fault
from racon_tpu_torch.utils import env

ENV_INGEST = env.INGEST


def ingest_enabled() -> bool:
    """The ingest gate: default ON, ``RACON_TPU_INGEST=0`` (or ``false``)
    is the serial escape hatch — the mirror image of the pipeline gate,
    which defaults off."""
    return env.read(ENV_INGEST) not in ("0", "false")


def prefetch_ok() -> bool:
    """Whether background ingest prefetch threads may run: the gate is on
    AND no fault plan names an ``io/*`` site (module docstring)."""
    if not ingest_enabled():
        return False
    from racon_tpu_torch.resilience.faults import get_injector
    inj = get_injector()
    if inj is not None and any(s.startswith("io/") for s in inj.sites()):
        return False
    return True


# ------------------------------------------------- zero-copy accounting

_mat_lock = threading.Lock()
_mat_count = 0


def _materialize(view) -> bytes:
    """The counted escape hatch: the only place the mmap path may turn
    a record payload view into ``bytes``."""
    global _mat_count
    with _mat_lock:
        _mat_count += 1
    return bytes(view)


def _materialize_join(views: List) -> bytes:
    """Multi-line record payloads must concatenate — one counted copy."""
    global _mat_count
    with _mat_lock:
        _mat_count += 1
    return b"".join(views)


def materialized_copies() -> int:
    """How many record payloads the mmap path has copied to ``bytes``
    since :func:`reset_materialized` — the zero-copy invariant gauge."""
    with _mat_lock:
        return _mat_count


def reset_materialized() -> None:
    global _mat_count
    with _mat_lock:
        _mat_count = 0


# ------------------------------------------------------ mmap line index

class _LineIndex:
    """One vectorized structural pass over an mmap'd text file: numpy
    newline scan → per-line (start, end) spans, no split, no copies."""

    __slots__ = ("mm", "view", "arr", "starts", "ends", "size")

    def __init__(self, path: str):
        size = os.path.getsize(path)
        self.size = size
        if size == 0:
            self.mm = None
            self.view = memoryview(b"")
            self.arr = np.empty(0, np.uint8)
            self.starts = np.empty(0, np.int64)
            self.ends = np.empty(0, np.int64)
            return
        with open(path, "rb") as fh:
            self.mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        self.view = memoryview(self.mm)
        self.arr = np.frombuffer(self.mm, np.uint8)
        nl = np.flatnonzero(self.arr == 0x0A).astype(np.int64)
        starts = np.concatenate([np.zeros(1, np.int64), nl + 1])
        ends = np.append(nl, np.int64(size))
        if starts[-1] >= size:  # file ends with '\n': no phantom line
            starts = starts[:-1]
            ends = ends[:-1]
        self.starts = starts
        self.ends = ends

    def span(self, i: int) -> Tuple[int, int]:
        """Line i's content span with trailing CRs stripped (the exact
        ``rstrip(b"\\r")`` the block reader applies)."""
        s = int(self.starts[i])
        e = int(self.ends[i])
        while e > s and self.arr[e - 1] == 0x0D:
            e -= 1
        return s, e

    def first_byte(self, i: int) -> int:
        """Line i's first content byte, or -1 when the line is empty."""
        s, e = int(self.starts[i]), int(self.ends[i])
        return int(self.arr[s]) if e > s else -1


def _decode_name(idx: _LineIndex, s: int, e: int) -> str:
    """Header (sans marker) → name: first whitespace-delimited token,
    bioparser semantics. Names always materialize (they become str)."""
    return _p._first_token(bytes(idx.view[s:e])).decode()


# ----------------------------------------------- index-first readers

class IndexedFastaParser(Parser):
    """mmap index-first FASTA reader: drop-in for
    :class:`~racon_tpu_torch.io.parsers.FastaParser` on plain files, with
    record payloads as zero-copy ``memoryview`` slices (single-line
    records) or one counted join (wrapped records). Record order,
    names, bytes, budget accounting, and error offsets are identical to
    the serial reader — the ``RACON_TPU_INGEST=0`` differential is the
    contract."""

    def _records(self) -> Iterator[Tuple[Sequence, int]]:
        idx = _LineIndex(self.path)
        n_lines = len(idx.starts)
        name: Optional[str] = None
        spans: List[Tuple[int, int]] = []
        last_end = 0
        for i in range(n_lines):
            fb = idx.first_byte(i)
            s, e = idx.span(i)
            if fb == 0x3E:  # '>'
                if name is not None:
                    maybe_fault("io/read")
                    self._pos = last_end
                    yield self._emit(idx, name, spans)
                name = _decode_name(idx, s + 1, e)
                spans = []
            elif e > s:
                if name is None:
                    raise ParseError(
                        f"[racon_tpu_torch::io] error: malformed FASTA file "
                        f"{self.path}", offset=s)
                spans.append((s, e))
            last_end = min(int(idx.ends[i]) + 1, idx.size)
        if name is not None:
            maybe_fault("io/read")
            self._pos = last_end
            yield self._emit(idx, name, spans)

    @staticmethod
    def _emit(idx: _LineIndex, name: str,
              spans: List[Tuple[int, int]]) -> Tuple[Sequence, int]:
        if len(spans) == 1:
            s, e = spans[0]
            data = idx.view[s:e]
        elif spans:
            data = _materialize_join([idx.view[s:e] for s, e in spans])
        else:
            data = b""
        return Sequence(name, data), len(name) + len(data)


class IndexedFastqParser(Parser):
    """mmap index-first FASTQ reader (see :class:`IndexedFastaParser`).
    Quality payloads are views too; the all-``!`` and below-``!``
    checks run on the numpy index array without copying."""

    def _records(self) -> Iterator[Tuple[Sequence, int]]:
        idx = _LineIndex(self.path)
        n_lines = len(idx.starts)
        i = 0
        while i < n_lines:
            s, e = idx.span(i)
            if e <= s:
                i += 1
                continue
            rec_off = s
            if idx.first_byte(i) != 0x40:  # '@'
                raise ParseError(
                    f"[racon_tpu_torch::io] error: malformed FASTQ file "
                    f"{self.path}", offset=rec_off)
            name = _decode_name(idx, s + 1, e)
            i += 1
            data_spans: List[Tuple[int, int]] = []
            dlen = 0
            while True:
                if i >= n_lines:
                    raise ParseError(
                        f"[racon_tpu_torch::io] error: truncated FASTQ "
                        f"file {self.path} — EOF inside the record "
                        f"starting", offset=rec_off)
                s, e = idx.span(i)
                if idx.first_byte(i) == 0x2B:  # '+'
                    i += 1
                    break
                if e > s:
                    data_spans.append((s, e))
                    dlen += e - s
                i += 1
            qual_spans: List[Tuple[int, int]] = []
            qlen = 0
            while qlen < dlen:
                if i >= n_lines:
                    raise ParseError(
                        f"[racon_tpu_torch::io] error: truncated FASTQ "
                        f"file {self.path} — EOF inside the record "
                        f"starting", offset=rec_off)
                s, e = idx.span(i)
                if e > s:
                    qual_spans.append((s, e))
                    qlen += e - s
                i += 1
            if qlen != dlen:
                raise ParseError(
                    f"[racon_tpu_torch::io] error: quality length mismatch "
                    f"in {self.path} for record '{name}' (sequence "
                    f"{dlen}, quality {qlen})", offset=rec_off)
            bad = any(int(idx.arr[s:e].min()) < 33
                      for s, e in qual_spans if e > s)
            if bad:
                raise ParseError(
                    f"[racon_tpu_torch::io] error: malformed quality string "
                    f"(byte below '!') in {self.path}", offset=rec_off)
            maybe_fault("io/read")
            data = self._payload(idx, data_spans)
            quality = self._payload(idx, qual_spans)
            self._pos = min((int(idx.ends[i - 1]) + 1) if i else 0,
                            idx.size)
            yield Sequence(name, data, quality), len(name) + 2 * dlen

    @staticmethod
    def _payload(idx: _LineIndex, spans: List[Tuple[int, int]]):
        if len(spans) == 1:
            s, e = spans[0]
            return idx.view[s:e]
        if spans:
            return _materialize_join([idx.view[s:e] for s, e in spans])
        return b""


def indexed_ok(path: str) -> bool:
    """Whether the mmap index-first plane applies: plain (uncompressed)
    file with the gate on."""
    return ingest_enabled() and not path.endswith(".gz")
