"""Sequence container: read / contig with optional quality.

TPU-first re-design of the reference's Sequence class
(reference: src/sequence.{hpp,cpp}). Data is kept as immutable Python
``bytes`` on the host; device-side packing happens per window batch in
racon_tpu.models.window. Reverse complements are built lazily via a
translate table instead of a char loop.

Behavioral parity points (cited against the reference):
- FASTA/FASTQ data is uppercased on construction (src/sequence.cpp:19-28).
- A FASTQ quality string whose Phred values are all zero (all ``!``) is
  treated as "no quality" (src/sequence.cpp:34-42).
- ``transmute(has_name, has_data, has_reverse_data)`` frees unneeded
  strings / builds the reverse complement (src/sequence.cpp:86-100).
- Reverse complement maps A<->T, C<->G and copies any other character
  verbatim; quality is reversed (src/sequence.cpp:49-84).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from racon_tpu_torch.ops.encode import reverse_complement


def _upper(data):
    """``bytes.upper`` that preserves zero-copy ``memoryview`` payloads
    (io/ingest.py mmap plane): a vectorized lowercase scan first — the
    overwhelmingly common all-uppercase FASTA/FASTQ keeps its view; any
    lowercase base falls back to one uppercased ``bytes`` copy."""
    if isinstance(data, (bytes, bytearray)):
        return data.upper()
    arr = np.frombuffer(data, dtype=np.uint8)
    if bool(np.any((arr >= 0x61) & (arr <= 0x7A))):
        return bytes(data).upper()
    return data


def _all_bang(quality) -> bool:
    """All-``!`` check without materializing a view payload."""
    if isinstance(quality, (bytes, bytearray)):
        return quality.count(b"!") == len(quality)
    arr = np.frombuffer(quality, dtype=np.uint8)
    return bool(np.all(arr == 0x21)) if arr.size else True


class Sequence:
    __slots__ = (
        "name",
        "data",
        "quality",
        "reverse_complement",
        "reverse_quality",
        "_quality_prefix",
        "_reverse_quality_prefix",
    )

    def __init__(self, name: str, data: bytes, quality: Optional[bytes] = None):
        self.name = name
        self.data = _upper(data)
        # All-'!' quality (Phred sum == 0) counts as no quality.
        if quality is not None and _all_bang(quality):
            quality = None
        self.quality = quality
        self.reverse_complement: Optional[bytes] = None
        self.reverse_quality: Optional[bytes] = None
        self._quality_prefix: Optional[np.ndarray] = None
        self._reverse_quality_prefix: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.data)

    def create_reverse_complement(self) -> None:
        if self.reverse_complement is not None:
            return
        self.reverse_complement = reverse_complement(self.data)
        if self.quality is not None:
            qual = self.quality
            if not isinstance(qual, (bytes, bytearray)):
                qual = bytes(qual)  # mmap view: [::-1] is non-contiguous
            self.reverse_quality = qual[::-1]

    def transmute(self, has_name: bool, has_data: bool, has_reverse_data: bool) -> None:
        """Free unneeded fields / build reverse complement.

        Mirrors src/sequence.cpp:86-100: drop the name when unused, build the
        reverse complement when some overlap needs the reverse strand, drop
        forward data (and quality) when nothing references it.
        """
        if not has_name:
            self.name = ""
        if has_reverse_data:
            self.create_reverse_complement()
        if not has_data:
            self.data = b""
            self.quality = None
            self._quality_prefix = None

    # -- quality prefix sums: O(1) mean window quality for the layer filter --

    def quality_prefix(self, reverse: bool) -> Optional[np.ndarray]:
        """Prefix sums of (phred byte - 33) for fast mean-quality queries.

        The reference computes per-layer average quality with a scalar loop
        (src/polisher.cpp:409-413); we precompute a cumulative sum per
        sequence once so each layer's mean is two lookups.
        """
        qual = self.reverse_quality if reverse else self.quality
        if qual is None:
            return None
        cache = "_reverse_quality_prefix" if reverse else "_quality_prefix"
        pref = getattr(self, cache)
        if pref is None:
            vals = np.frombuffer(qual, dtype=np.uint8).astype(np.int64) - 33
            pref = np.concatenate([[0], np.cumsum(vals)])
            setattr(self, cache, pref)
        return pref

    def mean_quality(self, begin: int, end: int, reverse: bool) -> Optional[float]:
        """Mean Phred quality over [begin, end) on the chosen strand."""
        pref = self.quality_prefix(reverse)
        if pref is None or end <= begin:
            return None
        return float(pref[end] - pref[begin]) / (end - begin)
