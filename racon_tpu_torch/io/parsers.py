"""Streaming sequence / overlap format parsers (bioparser equivalent).

Covers the reference's five input formats — FASTA, FASTQ, MHAP, PAF, SAM — all
optionally gzip-compressed, with chunked (byte-budgeted) streaming so
genome-scale inputs never have to be fully resident
(reference API surface: bioparser createParser/parse_objects, called at
src/polisher.cpp:78-124, 172-283; 1 GiB chunking constant at
src/polisher.cpp:22).

Parsers yield *record tuples*; the domain constructors live in
racon_tpu_torch.models. This mirrors the reference split where bioparser invokes
format-specific friend constructors (src/sequence.hpp:56-57,
src/overlap.hpp:71-73).

A C++ accelerated scanner can replace the hot tokenizing path later; the
Python implementations here are already line/block based (no per-char
loops) and handle multi-line FASTA and standard 4-line FASTQ.
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from racon_tpu_torch.models.sequence import Sequence
from racon_tpu_torch.models.overlap import Overlap
from racon_tpu_torch.resilience.faults import InjectedFault, maybe_fault

# Matches the reference's parse chunk size (src/polisher.cpp:22).
CHUNK_SIZE = 1024 * 1024 * 1024

_FASTA_EXTS = (".fasta", ".fa", ".fasta.gz", ".fa.gz")
_FASTQ_EXTS = (".fastq", ".fq", ".fastq.gz", ".fq.gz")


def _open(path: str) -> io.BufferedReader:
    if path.endswith(".gz"):
        return gzip.open(path, "rb")  # type: ignore[return-value]
    return open(path, "rb")


def _open_source(path: str):
    """The ingest-aware open of the parsers: with ``RACON_TPU_INGEST`` on
    (the default), a ``.gz`` input opens as an io/inflate.py ByteSource —
    a context-managed iterable of decompressed blocks, inflated on a
    worker pool (BGZF, multi-member) or a producer thread (one member),
    byte-identical to ``gzip.open``; :func:`_block_lines` takes either.
    With the gate off, or a plain file: the file object."""
    if path.endswith(".gz"):
        from racon_tpu_torch.io.ingest import ingest_enabled
        if ingest_enabled():
            from racon_tpu_torch.io.inflate import open_gzip_source
            return open_gzip_source(path)
    return _open(path)


def _first_token(line: bytes) -> bytes:
    """Name = characters up to the first whitespace (bioparser semantics)."""
    for i, ch in enumerate(line):
        if ch in (0x20, 0x09):
            return line[:i]
    return line


class ParseError(RuntimeError):
    """Parser failure. ``offset``, when known, is the byte offset into
    the (decompressed) stream where the offending record begins — with
    chunked ``parse(max_bytes)`` streaming, "line number" is meaningless
    to a caller that resumed mid-file, but a byte offset can be handed
    straight to ``dd``/``tail -c`` for inspection."""

    def __init__(self, message: str, offset: Optional[int] = None):
        if offset is not None:
            message = f"{message} (at byte offset {offset})"
        super().__init__(message)
        self.offset = offset


class Parser:
    """Base streaming parser with reset() / parse(max_bytes) interface.

    parse(max_bytes) returns (records, more_remaining) like the reference's
    ``parse_objects(dst, max_bytes) -> bool`` (src/polisher.cpp:173,201,283).
    max_bytes < 0 parses everything.
    """

    def __init__(self, path: str):
        if not os.path.isfile(path):
            raise ParseError(f"[racon_tpu_torch::io] error: unable to open file {path}")
        self.path = path
        self._iter: Optional[Iterator] = None
        self._failed = False
        self._pos = 0

    def reset(self) -> None:
        self._iter = None
        self._failed = False
        self._pos = 0

    def _records(self) -> Iterator[Tuple[object, int]]:
        raise NotImplementedError

    def _lines(self, f) -> Iterator[Tuple[bytes, int, int]]:
        """:func:`_block_lines` plus the high-water stream offset, so a
        failure raised by ``read()`` itself still gets a byte offset; and
        the ``io/read`` fault site, once a line."""
        for ln, nb, off in _block_lines(f):
            self._pos = off + nb
            maybe_fault("io/read")
            yield ln, nb, off

    def parse(self, max_bytes: int = -1) -> Tuple[List[object], bool]:
        """One chunk of records, plus whether more remain.

        Repeated calls are safe to interleave with downstream
        consumption of earlier chunks: every returned record owns fresh
        immutable ``bytes`` (sliced out of the read blocks, never views
        into a shared mutable buffer), so the streaming pipeline's build
        stage can keep parsing while other threads still hold records
        from previous chunks.
        """
        if self._failed:
            raise ParseError(
                f"[racon_tpu_torch::io] error: parser for {self.path} previously "
                "failed; call reset() before reuse")
        if self._iter is None:
            self._iter = self._records()
        out: List[object] = []
        consumed = 0
        try:
            for rec, nbytes in self._iter:
                out.append(rec)
                consumed += nbytes
                if 0 <= max_bytes <= consumed:
                    return out, True
        except ParseError:
            # The inflate plane's own errors (member ordinal, compressed
            # offset) pass through unchanged but poison the parser too.
            self._failed = True
            raise
        except (gzip.BadGzipFile, EOFError, OSError) as exc:
            # A mislabelled .gz (or truncated stream) must surface as this
            # parser's own error contract, not a raw gzip exception. Mark
            # the parser failed so a retried parse() cannot masquerade as a
            # clean EOF. The offset is the high-water mark of complete
            # lines — the stream broke at or just past it.
            self._failed = True
            raise ParseError(
                f"[racon_tpu_torch::io] error: corrupt or mislabelled input file "
                f"{self.path} ({exc})", offset=self._pos) from exc
        except InjectedFault as exc:
            # An io/read or io/inflate fault models the stream failure
            # above, and converts the same way: typed, offset-bearing,
            # the parser poisoned.
            self._failed = True
            raise ParseError(
                f"[racon_tpu_torch::io] error: read failure in {self.path} "
                f"({exc})", offset=self._pos) from exc
        self._iter = iter(())  # exhausted
        return out, False


def _block_lines(f, block: int = 1 << 22
                 ) -> Iterator[Tuple[bytes, int, int]]:
    """Yield (line, nbytes, offset) via block reads + split; line is
    newline/CR stripped, nbytes is the exact on-stream length including
    the line terminator (for byte-budgeted chunking), offset the byte
    position of the line's start in the decompressed stream (for
    :class:`ParseError` diagnostics).

    Per-line ``readline`` on a gzip stream pays Python call overhead for
    every line — a genome-scale cost (tens of millions of lines at 30x
    human coverage); one 4 MB read + one split amortizes it away.
    """
    if hasattr(f, "read"):
        blocks_iter = iter(lambda: f.read(block), b"")
    else:
        # An ingest ByteSource (io/inflate.py): already an iterable of
        # decompressed blocks; empty blocks are skipped, not EOF.
        blocks_iter = (b for b in f if b)
    tail: List[bytes] = []          # blocks of the current partial line
    pos = 0                         # stream offset of the current line
    for data in blocks_iter:
        if b"\n" not in data:
            # No terminator in this block: defer the join, or a single
            # line longer than the block size (one-contig-per-line
            # drafts) turns quadratic in re-concatenation.
            tail.append(data)
            continue
        parts = (b"".join(tail) + data if tail else data).split(b"\n")
        last = parts.pop()
        tail = [last] if last else []
        for ln in parts:
            nb = len(ln) + 1
            yield ln.rstrip(b"\r"), nb, pos
            pos += nb
    if tail:
        last = b"".join(tail)
        yield last.rstrip(b"\r"), len(last), pos


class FastaParser(Parser):
    def _records(self) -> Iterator[Tuple[Sequence, int]]:
        name: Optional[bytes] = None
        chunks: List[bytes] = []
        with _open_source(self.path) as f:
            for line, _, off in self._lines(f):
                if line.startswith(b">"):
                    if name is not None:
                        data = b"".join(chunks)
                        yield Sequence(name.decode(), data), len(name) + len(data)
                    name = _first_token(line[1:])
                    chunks = []
                elif line:
                    if name is None:
                        raise ParseError(
                            f"[racon_tpu_torch::io] error: malformed FASTA file "
                            f"{self.path}", offset=off)
                    chunks.append(line)
            if name is not None:
                data = b"".join(chunks)
                yield Sequence(name.decode(), data), len(name) + len(data)


class FastqParser(Parser):
    def _records(self) -> Iterator[Tuple[Sequence, int]]:
        with _open_source(self.path) as f:
            lines = self._lines(f)
            while True:
                header, _, rec_off = next(lines, (None, 0, 0))
                if header is None:
                    return
                if not header:
                    continue
                if not header.startswith(b"@"):
                    raise ParseError(
                        f"[racon_tpu_torch::io] error: malformed FASTQ file "
                        f"{self.path}", offset=rec_off)
                name = _first_token(header[1:])
                # Sequence lines until '+' separator (tolerates multi-line).
                data_chunks: List[bytes] = []
                while True:
                    line, _, _ = next(lines, (None, 0, 0))
                    if line is None:
                        # EOF inside a record: report where the partial
                        # record begins, not just which file broke.
                        raise ParseError(
                            f"[racon_tpu_torch::io] error: truncated FASTQ "
                            f"file {self.path} — EOF inside the record "
                            f"starting", offset=rec_off)
                    if line.startswith(b"+"):
                        break
                    data_chunks.append(line)
                data = b"".join(data_chunks)
                qual_chunks: List[bytes] = []
                qlen = 0
                while qlen < len(data):
                    line, _, _ = next(lines, (None, 0, 0))
                    if line is None:
                        raise ParseError(
                            f"[racon_tpu_torch::io] error: truncated FASTQ "
                            f"file {self.path} — EOF inside the record "
                            f"starting", offset=rec_off)
                    qual_chunks.append(line)
                    qlen += len(line)
                quality = b"".join(qual_chunks)
                if len(quality) != len(data):
                    # Silently mis-sized quality would flow into window
                    # weighting downstream; name the record and where it
                    # begins so the input is fixable.
                    raise ParseError(
                        f"[racon_tpu_torch::io] error: quality length mismatch "
                        f"in {self.path} for record '{name.decode()}' "
                        f"(sequence {len(data)}, quality {len(quality)})",
                        offset=rec_off)
                # Phred bytes below '!' (33) would decode to negative
                # weights; reject here so every downstream consumer (host
                # and device consensus paths) can assume weights >= 0 by
                # construction instead of each clipping differently.
                if quality and int(
                        np.frombuffer(quality, np.uint8).min()) < 33:
                    raise ParseError(
                        f"[racon_tpu_torch::io] error: malformed quality string "
                        f"(byte below '!') in {self.path}", offset=rec_off)
                yield Sequence(name.decode(), data, quality), len(name) + 2 * len(data)


class MhapParser(Parser):
    """MHAP: 12 space-separated columns
    (a_id b_id accuracy shared_minmers a_rc a_begin a_end a_len b_rc b_begin
    b_end b_len) — reference ctor at src/overlap.cpp:15-27."""

    def _records(self) -> Iterator[Tuple[Overlap, int]]:
        with _open_source(self.path) as f:
            for line, nb, off in self._lines(f):
                if not line:
                    continue
                t = line.split()
                if len(t) < 12:
                    raise ParseError(
                        f"[racon_tpu_torch::io] error: malformed MHAP file "
                        f"{self.path}", offset=off)
                yield Overlap.from_mhap(
                    int(t[0]), int(t[1]), float(t[2]), int(t[3]),
                    int(t[4]), int(t[5]), int(t[6]), int(t[7]),
                    int(t[8]), int(t[9]), int(t[10]), int(t[11]),
                ), nb


class PafParser(Parser):
    """PAF: >=12 tab-separated columns (qname qlen qstart qend strand tname
    tlen tstart tend matches alnlen mapq ...) — reference ctor at
    src/overlap.cpp:29-42."""

    def _records(self) -> Iterator[Tuple[Overlap, int]]:
        with _open_source(self.path) as f:
            for line, nb, off in self._lines(f):
                if not line:
                    continue
                t = line.split(b"\t")
                if len(t) < 12:
                    raise ParseError(
                        f"[racon_tpu_torch::io] error: malformed PAF file "
                        f"{self.path}", offset=off)
                yield Overlap.from_paf(
                    t[0].decode(), int(t[1]), int(t[2]), int(t[3]),
                    t[4].decode(), t[5].decode(), int(t[6]), int(t[7]),
                    int(t[8]),
                ), nb


class SamParser(Parser):
    """SAM: 11+ tab-separated columns; header lines (@...) skipped —
    reference ctor at src/overlap.cpp:44-108."""

    def _records(self) -> Iterator[Tuple[Overlap, int]]:
        with _open_source(self.path) as f:
            for line, nb, off in self._lines(f):
                if line.startswith(b"@"):
                    continue
                if not line:
                    continue
                t = line.split(b"\t")
                if len(t) < 11:
                    raise ParseError(
                        f"[racon_tpu_torch::io] error: malformed SAM file "
                        f"{self.path}", offset=off)
                yield Overlap.from_sam(
                    t[0].decode(), int(t[1]), t[2].decode(), int(t[3]),
                    t[5].decode(),
                ), nb


def scan_sequence_index(path: str) -> Tuple[int, List[int]]:
    """(record count, per-record byte offsets) of a FASTA/FASTQ file
    without materializing any sequence: one pass over the record
    structure. Offsets are each record header's byte position in the
    decompressed stream (the :class:`ParseError` convention).

    The work ledger (distributed/ledger.py) publishes this index in its
    meta.json once: only the worker that publishes the ledger pays the
    pass; every later joiner adopts the published count."""
    from racon_tpu_torch.io.ingest import indexed_ok, scan_index_mmap
    if indexed_ok(path) and path.endswith(_FASTA_EXTS + _FASTQ_EXTS):
        return scan_index_mmap(path)
    offsets: List[int] = []
    hw = [0]                 # high-water offset for stream-level errors

    def _tracked(f) -> Iterator[Tuple[bytes, int, int]]:
        for ln, nb, off in _block_lines(f):
            hw[0] = off + nb
            yield ln, nb, off

    try:
        return _scan_index(path, offsets, _tracked)
    except (gzip.BadGzipFile, EOFError, OSError) as exc:
        raise ParseError(
            f"[racon_tpu_torch::io] error: corrupt or truncated sequence "
            f"file {path} ({exc})", offset=hw[0]) from exc


def _scan_index(path: str, offsets: List[int],
                lines_of) -> Tuple[int, List[int]]:
    if path.endswith(_FASTA_EXTS):
        with _open_source(path) as f:
            for line, _, off in lines_of(f):
                if line.startswith(b">"):
                    offsets.append(off)
    elif path.endswith(_FASTQ_EXTS):
        with _open_source(path) as f:
            lines = lines_of(f)
            while True:
                header, _, rec_off = next(lines, (None, 0, 0))
                if header is None:
                    break
                if not header:
                    continue
                if not header.startswith(b"@"):
                    raise ParseError(
                        f"[racon_tpu_torch::io] error: malformed FASTQ "
                        f"file {path}", offset=rec_off)
                offsets.append(rec_off)
                dlen = 0
                while True:
                    line, _, _ = next(lines, (None, 0, 0))
                    if line is None:
                        raise ParseError(
                            f"[racon_tpu_torch::io] error: truncated "
                            f"FASTQ file {path} — EOF inside the record "
                            f"starting", offset=rec_off)
                    if line.startswith(b"+"):
                        break
                    dlen += len(line)
                qlen = 0
                while qlen < dlen:
                    line, _, _ = next(lines, (None, 0, 0))
                    if line is None:
                        raise ParseError(
                            f"[racon_tpu_torch::io] error: truncated "
                            f"FASTQ file {path} — EOF inside the record "
                            f"starting", offset=rec_off)
                    qlen += len(line)
                if qlen != dlen:
                    raise ParseError(
                        f"[racon_tpu_torch::io] error: quality length "
                        f"mismatch in {path} (sequence {dlen}, quality "
                        f"{qlen})", offset=rec_off)
    else:
        raise _unsupported_sequence_format(path)
    return len(offsets), offsets


def _unsupported_sequence_format(path: str) -> ParseError:
    return ParseError(
        f"[racon_tpu_torch::create_polisher] error: file {path} has "
        "unsupported format extension (valid extensions: .fasta, "
        ".fasta.gz, .fa, .fa.gz, .fastq, .fastq.gz, .fq, .fq.gz)!")


def create_sequence_parser(path: str) -> Parser:
    """Extension-dispatched sequence parser (src/polisher.cpp:78-92).

    Plain FASTA/FASTQ with ``RACON_TPU_INGEST`` on go to the mmap
    index-first readers (io/ingest.py: the same records, payloads as
    zero-copy views); ``.gz`` inputs and the gate off use the streaming
    readers, whose ``.gz`` open goes through the parallel inflate when the
    gate is on."""
    from racon_tpu_torch.io.ingest import (IndexedFastaParser,
                                           IndexedFastqParser, indexed_ok)
    if path.endswith(_FASTA_EXTS):
        return IndexedFastaParser(path) if indexed_ok(path) \
            else FastaParser(path)
    if path.endswith(_FASTQ_EXTS):
        return IndexedFastqParser(path) if indexed_ok(path) \
            else FastqParser(path)
    raise _unsupported_sequence_format(path)


def create_overlap_parser(path: str) -> Parser:
    """Extension-dispatched overlap parser (src/polisher.cpp:94-108)."""
    if path.endswith((".mhap", ".mhap.gz")):
        return MhapParser(path)
    if path.endswith((".paf", ".paf.gz")):
        return PafParser(path)
    if path.endswith((".sam", ".sam.gz")):
        return SamParser(path)
    raise ParseError(
        f"[racon_tpu_torch::create_polisher] error: file {path} has unsupported format "
        "extension (valid extensions: .mhap, .mhap.gz, .paf, .paf.gz, .sam, "
        ".sam.gz)!"
    )
