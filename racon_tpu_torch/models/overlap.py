"""Overlap: normalized read<->target overlap in one of three input formats.

Re-design of the reference's Overlap class (src/overlap.{hpp,cpp}).
Semantics reproduced (with citations):

- MHAP constructor (src/overlap.cpp:15-27): 1-based numeric ids -> id-1,
  strand = a_rc XOR b_rc, length = max span, error = 1 - min/max span.
- PAF constructor (src/overlap.cpp:29-42): names kept, strand from the
  orientation column, same length/error estimate.
- SAM constructor (src/overlap.cpp:44-108): unmapped flag 0x4 -> invalid,
  strand from flag 0x10, 1-based POS -> 0-based t_begin, q_begin from the
  leading S/H clip, alignment lengths from the CIGAR walk, query coords
  flipped onto the reverse strand.
- transmute (src/overlap.cpp:129-177): resolve query via name+"q" or
  id<<1|0, target via name+"t" or id<<1|1; fatal on length disagreement;
  SAM t_length backfilled from the target sequence.
- find_breaking_points (src/overlap.cpp:179-282): missing CIGAR -> global
  alignment of the (strand-selected) query span vs the target span; then a
  CIGAR walk records the first/last matched base per window-length bucket
  of the target. The reference walks base-by-base; here the walk is
  vectorized over CIGAR runs (numpy), and the alignment itself is batched
  at the polisher level (C++ banded NW / TPU kernel) instead of one edlib
  call per overlap inside a thread pool.

Breaking points are stored as an (n_windows_touched, 4) int64 array of
rows (first_t, first_q, last_t_plus1, last_q_plus1) — the flat pair vector
of the reference, two pairs per touched window (src/overlap.cpp:247-254).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence as Seq

import numpy as np

_CIGAR_RE = re.compile(rb"(\d+)([MIDNSHP=X])")

class PolisherError(RuntimeError):
    """Fatal input error (reference exits with fprintf+exit(1))."""


def decompose_cigar(cigar: bytes):
    """CIGAR string -> (lengths int64[R], ops uint8[R])."""
    lens: List[int] = []
    ops: List[int] = []
    for m in _CIGAR_RE.finditer(cigar):
        lens.append(int(m.group(1)))
        ops.append(m.group(2)[0])
    return np.asarray(lens, dtype=np.int64), np.asarray(ops, dtype=np.uint8)


class Overlap:
    __slots__ = (
        "q_name", "q_id", "q_begin", "q_end", "q_length",
        "t_name", "t_id", "t_begin", "t_end", "t_length",
        "strand", "length", "error", "cigar",
        "is_valid", "is_transmuted", "breaking_points",
    )

    def __init__(self):
        self.q_name: Optional[str] = None
        self.q_id: int = 0
        self.q_begin = self.q_end = self.q_length = 0
        self.t_name: Optional[str] = None
        self.t_id: int = 0
        self.t_begin = self.t_end = self.t_length = 0
        self.strand = False
        self.length = 0
        self.error = 0.0
        self.cigar: bytes = b""
        self.is_valid = True
        self.is_transmuted = False
        self.breaking_points: Optional[np.ndarray] = None

    # ---------------------------------------------------------------- ctors

    @classmethod
    def from_mhap(cls, a_id: int, b_id: int, accuracy: float, minmers: int,
                  a_rc: int, a_begin: int, a_end: int, a_length: int,
                  b_rc: int, b_begin: int, b_end: int, b_length: int) -> "Overlap":
        o = cls()
        o.q_id = a_id - 1
        o.q_begin, o.q_end, o.q_length = a_begin, a_end, a_length
        o.t_id = b_id - 1
        o.t_begin, o.t_end, o.t_length = b_begin, b_end, b_length
        o.strand = bool(a_rc ^ b_rc)
        o._span_stats()
        return o

    @classmethod
    def from_paf(cls, q_name: str, q_length: int, q_begin: int, q_end: int,
                 orientation: str, t_name: str, t_length: int, t_begin: int,
                 t_end: int) -> "Overlap":
        o = cls()
        o.q_name = q_name
        o.q_begin, o.q_end, o.q_length = q_begin, q_end, q_length
        o.t_name = t_name
        o.t_begin, o.t_end, o.t_length = t_begin, t_end, t_length
        o.strand = orientation == "-"
        o._span_stats()
        return o

    @classmethod
    def from_sam(cls, q_name: str, flag: int, t_name: str, pos: int,
                 cigar: str) -> "Overlap":
        o = cls()
        o.q_name = q_name
        o.t_name = t_name
        o.t_begin = pos - 1
        o.strand = bool(flag & 0x10)
        o.is_valid = not (flag & 0x4)
        o.cigar = cigar.encode()
        if len(o.cigar) < 2:
            if o.is_valid:
                raise PolisherError(
                    "[racon_tpu_torch::Overlap] error: missing alignment from SAM object!")
            return o
        lens, ops = decompose_cigar(o.cigar)
        if len(lens) == 0:
            if o.is_valid:
                raise PolisherError(
                    "[racon_tpu_torch::Overlap] error: missing alignment from SAM object!")
            return o
        # Leading S/H clip gives q_begin (src/overlap.cpp:60-69 parses the
        # first number in the CIGAR when the first op is a clip).
        q_begin = int(lens[0]) if ops[0] in (ord("S"), ord("H")) else 0
        q_aln = int(lens[np.isin(ops, [ord("M"), ord("="), ord("X"), ord("I")])].sum())
        t_aln = int(lens[np.isin(ops, [ord("M"), ord("="), ord("X"), ord("D"),
                                       ord("N")])].sum())
        clip = int(lens[np.isin(ops, [ord("S"), ord("H")])].sum())
        o.q_begin = q_begin
        o.q_end = q_begin + q_aln
        o.q_length = clip + q_aln
        if o.strand:
            o.q_begin, o.q_end = o.q_length - o.q_end, o.q_length - o.q_begin
        o.t_end = o.t_begin + t_aln
        o.t_length = 0  # backfilled at transmute (src/overlap.cpp:173-174)
        o.length = max(q_aln, t_aln)
        o.error = 1 - min(q_aln, t_aln) / o.length if o.length else 1.0
        return o

    def _span_stats(self) -> None:
        self.length = max(self.q_end - self.q_begin, self.t_end - self.t_begin)
        self.error = (1 - min(self.q_end - self.q_begin,
                              self.t_end - self.t_begin) / self.length
                      if self.length else 1.0)

    # ----------------------------------------------------------- transmute

    def transmute(self, sequences: Seq, name_to_id: Dict[str, int],
                  id_to_id: Dict[int, int]) -> None:
        """Resolve query/target references to sequence indices
        (src/overlap.cpp:129-177)."""
        if not self.is_valid or self.is_transmuted:
            return

        if self.q_name is not None:
            qid = name_to_id.get(self.q_name + "q")
            if qid is None:
                self.is_valid = False
                return
            self.q_id = qid
            self.q_name = None
        else:
            qid = id_to_id.get(self.q_id << 1 | 0)
            if qid is None:
                self.is_valid = False
                return
            self.q_id = qid

        if self.q_length != len(sequences[self.q_id].data):
            raise PolisherError(
                "[racon_tpu_torch::Overlap::transmute] error: unequal lengths in "
                f"sequence and overlap file for sequence {sequences[self.q_id].name}!")

        if self.t_name is not None:
            tid = name_to_id.get(self.t_name + "t")
            if tid is None:
                self.is_valid = False
                return
            self.t_id = tid
            self.t_name = None
        else:
            tid = id_to_id.get(self.t_id << 1 | 1)
            if tid is None:
                self.is_valid = False
                return
            self.t_id = tid

        if self.t_length != 0 and self.t_length != len(sequences[self.t_id].data):
            raise PolisherError(
                "[racon_tpu_torch::Overlap::transmute] error: unequal lengths in "
                f"target and overlap file for target {sequences[self.t_id].name}!")

        self.t_length = len(sequences[self.t_id].data)
        self.is_transmuted = True

    # ------------------------------------------------- breaking points

    @property
    def needs_alignment(self) -> bool:
        """True when a global alignment is still required (PAF/MHAP inputs)."""
        return self.is_transmuted and len(self.cigar) == 0 and \
            self.breaking_points is None

    def alignment_operands(self, sequences: Seq):
        """(query_bytes, target_bytes) for the global alignment, strand
        selected exactly as the reference does (src/overlap.cpp:194-197)."""
        seq = sequences[self.q_id]
        if self.strand:
            if seq.reverse_complement is None:
                seq.create_reverse_complement()
            q = seq.reverse_complement[self.q_length - self.q_end:
                                      self.q_length - self.q_begin]
        else:
            q = seq.data[self.q_begin:self.q_end]
        t = sequences[self.t_id].data[self.t_begin:self.t_end]
        return q, t

    def find_breaking_points(self, sequences: Seq, window_length: int,
                             aligner=None) -> None:
        """Populate breaking_points; aligns first when no CIGAR is present.

        ``aligner(q_bytes, t_bytes) -> cigar bytes`` is injected (native
        banded-NW or TPU batch kernel); the polisher normally pre-fills
        ``self.cigar`` for whole batches instead.
        """
        if not self.is_transmuted:
            raise PolisherError(
                "[racon_tpu_torch::Overlap::find_breaking_points] error: "
                "overlap is not transmuted!")
        if self.breaking_points is not None:
            return
        if len(self.cigar) == 0:
            if aligner is None:
                raise PolisherError(
                    "[racon_tpu_torch::Overlap::find_breaking_points] error: "
                    "no CIGAR and no aligner provided!")
            q, t = self.alignment_operands(sequences)
            self.cigar = aligner(q, t)
        self.breaking_points = breaking_points_from_cigar(
            self.cigar, self.t_begin, self.t_end,
            self.q_begin if not self.strand else self.q_length - self.q_end,
            window_length)
        self.cigar = b""  # freed after use (src/overlap.cpp:281)


def breaking_points_from_cigar(cigar: bytes, t_begin: int, t_end: int,
                               q_start: int, window_length: int) -> np.ndarray:
    """Vectorized equivalent of the reference's base-by-base CIGAR walk
    (src/overlap.cpp:216-281).

    Returns int64[(n_touched_windows, 4)] rows
    (first_match_t, first_match_q, last_match_t+1, last_match_q+1),
    windows keyed by t // window_length, ascending.
    """
    lens, ops = decompose_cigar(cigar)
    if len(lens) == 0:
        return np.zeros((0, 4), dtype=np.int64)

    q_adv = np.where(np.isin(ops, [ord("M"), ord("="), ord("X"), ord("I")]), lens, 0)
    t_adv = np.where(np.isin(ops, [ord("M"), ord("="), ord("X"), ord("D"),
                                   ord("N")]), lens, 0)
    q_pos = q_start + np.concatenate([[0], np.cumsum(q_adv)[:-1]])
    t_pos = t_begin + np.concatenate([[0], np.cumsum(t_adv)[:-1]])

    is_match = np.isin(ops, [ord("M"), ord("="), ord("X")])
    t0 = t_pos[is_match]
    q0 = q_pos[is_match]
    n = lens[is_match]
    # Clamp the walk at t_end: the reference's base-by-base loop never steps a
    # target pointer past t_end, so a truncated/inconsistent CIGAR stays
    # bounded instead of silently diverging (src/overlap.cpp:232-279).
    n = np.minimum(n, np.maximum(t_end - t0, 0))
    keep = n > 0
    t0, q0, n = t0[keep], q0[keep], n[keep]
    if len(t0) == 0:
        return np.zeros((0, 4), dtype=np.int64)

    W = window_length
    w0 = t0 // W
    w1 = (t0 + n - 1) // W
    counts = w1 - w0 + 1
    total = int(counts.sum())
    run_idx = np.repeat(np.arange(len(t0)), counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    win = w0[run_idx] + (np.arange(total) - starts[run_idx])

    ts = np.maximum(t0[run_idx], win * W)
    te = np.minimum(t0[run_idx] + n[run_idx] - 1, win * W + W - 1)
    fq = q0[run_idx] + (ts - t0[run_idx])
    lq = q0[run_idx] + (te - t0[run_idx]) + 1

    # win is non-decreasing; take first/last entry per distinct window.
    firsts = np.flatnonzero(np.diff(win, prepend=win[0] - 1))
    lasts = np.concatenate([firsts[1:] - 1, [total - 1]])
    return np.stack([ts[firsts], fq[firsts], te[lasts] + 1, lq[lasts]],
                    axis=1).astype(np.int64)
