"""The plain reference of one polishing job, for a sample of its windows.

racon's semantics, written again in NumPy and plain PyTorch from the
input files alone (a frozen restatement of the port's host path, which
follows the original racon: src/polisher.cpp, overlap.cpp, window.cpp):

1. parse the targets, the reads and the overlaps (FASTA/FASTQ, PAF, SAM,
   MHAP); resolve names or ids, drop overlaps above the error threshold
   and self overlaps, and in contig mode keep the longest overlap of each
   read (the last of equal lengths);
2. breaking points of every overlap that touches a sampled window: the
   SAM CIGAR, or a global alignment of the strand-selected query span to
   the target span under edit-distance scoring (0, -1, -1), walked for
   the first and last matched base of each window;
3. each sampled window's backbone and layers, with the 2%-span and
   mean-quality filters;
4. each window's consensus: every layer aligned (5, -4, -8) to its slice
   of the anchor, votes merged per column on the anchor's coordinates,
   three refinement rounds and a final one against the last consensus,
   the ends trimmed below half the coverage.

``vote_dtype`` is the type the vote sums accumulate in: float64 for the
reference; a lower precision (bfloat16, float8_e4m3fn) for the control,
every add rounded to it in job order.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from reference import nw

ALPHABET = 5
EPS = 1e-3
_ENC = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _ENC[_c] = _i
    _ENC[ord(chr(_c).lower())] = _i
_DEC = np.frombuffer(b"ACGTN", np.uint8)
_COMP = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")
_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")


class InputRejected(RuntimeError):
    """The input breaks a rule racon rejects it for."""


def encode(data: bytes) -> np.ndarray:
    return _ENC[np.frombuffer(data, np.uint8)]


def revcomp(data: bytes) -> bytes:
    return data.translate(_COMP)[::-1]


@dataclass
class Record:
    name: str
    data: bytes
    quality: Optional[bytes]


def read_sequences(path: str) -> List[Record]:
    with open(path, "rb") as fh:
        blob = fh.read()
    out: List[Record] = []
    if blob.startswith(b"@"):
        lines = blob.split(b"\n")
        for k in range(0, len(lines) - 3, 4):
            name = lines[k][1:].split()[0].decode()
            qual = lines[k + 3]
            if qual.count(b"!") == len(qual):
                qual = None      # all-'!' counts as no quality
            out.append(Record(name, lines[k + 1].upper(), qual))
    else:
        for chunk in blob.split(b">")[1:]:
            head, _, body = chunk.partition(b"\n")
            out.append(Record(head.split()[0].decode(),
                              body.replace(b"\n", b"").upper(), None))
    return out


@dataclass
class Ovl:
    q: object            # name (PAF/SAM) or 0-based id (MHAP)
    t: object
    q_begin: int = 0
    q_end: int = 0
    q_length: int = 0
    t_begin: int = 0
    t_end: int = 0
    t_length: int = 0
    strand: bool = False
    cigar: str = ""
    valid: bool = True
    length: int = 0
    error: float = 1.0
    q_id: int = -1
    t_id: int = -1


def _span_stats(o: Ovl) -> None:
    qs, ts = o.q_end - o.q_begin, o.t_end - o.t_begin
    o.length = max(qs, ts)
    o.error = 1 - min(qs, ts) / o.length if o.length else 1.0


def _cigar_runs(cigar: str):
    return [(int(n), op) for n, op in _CIGAR.findall(cigar)]


def read_overlaps(path: str) -> List[Ovl]:
    out: List[Ovl] = []
    with open(path) as fh:
        text = fh.read()
    if path.endswith(".paf"):
        for line in text.splitlines():
            if not line:
                continue
            f = line.split("\t")
            o = Ovl(f[0], f[5], int(f[2]), int(f[3]), int(f[1]), int(f[7]),
                    int(f[8]), int(f[6]), f[4] == "-")
            _span_stats(o)
            out.append(o)
    elif path.endswith(".mhap"):
        for line in text.splitlines():
            if not line:
                continue
            f = line.split()
            o = Ovl(int(f[0]) - 1, int(f[1]) - 1, int(f[5]), int(f[6]),
                    int(f[7]), int(f[9]), int(f[10]), int(f[11]),
                    bool(int(f[4]) ^ int(f[8])))
            _span_stats(o)
            out.append(o)
    elif path.endswith(".sam"):
        for line in text.splitlines():
            if not line or line.startswith("@"):
                continue
            f = line.split("\t")
            flag = int(f[1])
            o = Ovl(f[0], f[2], t_begin=int(f[3]) - 1,
                    strand=bool(flag & 0x10), cigar=f[5],
                    valid=not flag & 0x4)
            runs = _cigar_runs(o.cigar)
            if not runs:
                o.valid = False
                out.append(o)
                continue
            q_aln = sum(n for n, op in runs if op in "M=XI")
            t_aln = sum(n for n, op in runs if op in "M=XDN")
            clip = sum(n for n, op in runs if op in "SH")
            o.q_begin = runs[0][0] if runs[0][1] in "SH" else 0
            o.q_end = o.q_begin + q_aln
            o.q_length = clip + q_aln
            if o.strand:
                o.q_begin, o.q_end = o.q_length - o.q_end, \
                    o.q_length - o.q_begin
            o.t_end = o.t_begin + t_aln
            o.length = max(q_aln, t_aln)
            o.error = 1 - min(q_aln, t_aln) / o.length if o.length else 1.0
            out.append(o)
    else:
        raise InputRejected(f"unknown overlap format: {path}")
    return out


def breaking_points(runs: Sequence[Tuple[int, str]], t_begin: int,
                    t_end: int, q_start: int, w: int) -> Dict[int, tuple]:
    """Window index -> (first matched t, its q, last matched t + 1, its
    q + 1) along an alignment given as (length, op) runs."""
    out: Dict[int, list] = {}
    q, t = q_start, t_begin
    for n, op in runs:
        if op in "M=X":
            m = min(n, max(t_end - t, 0))   # never walk past t_end
            k = 0
            while k < m:
                win = (t + k) // w
                stop = min(m, (win + 1) * w - t)
                entry = out.get(win)
                if entry is None:
                    out[win] = [t + k, q + k, t + stop, q + stop]
                else:
                    entry[2], entry[3] = t + stop, q + stop
                k = stop
            q += n
            t += n
        elif op == "I":
            q += n
        elif op in "DN":
            t += n
        elif op in "SH":
            pass
    return {k: tuple(v) for k, v in out.items()}


def ops_runs(ops: np.ndarray) -> List[Tuple[int, str]]:
    """Alignment ops (0 M, 1 I, 2 D) as (length, op) runs."""
    if len(ops) == 0:
        return []
    edges = np.flatnonzero(np.diff(ops)) + 1
    starts = np.concatenate([[0], edges])
    ends = np.concatenate([edges, [len(ops)]])
    return [(int(e - s), "MID"[int(ops[s])]) for s, e in zip(starts, ends)]


@dataclass
class Layer:
    begin: int
    end: int
    data: bytes
    quality: Optional[bytes]


@dataclass
class WindowRef:
    target: int
    rank: int
    backbone: bytes
    backbone_quality: Optional[bytes]
    tgs: bool
    layers: List[Layer] = field(default_factory=list)
    consensus: bytes = b""
    polished: bool = False


@dataclass
class JobRef:
    """What the reference works out for one job."""
    target_names: List[str]
    target_lengths: List[int]
    coverages: List[int]
    n_sequences: int
    windows: Dict[int, WindowRef]      # global window index -> window


def _options(options: Sequence[str]) -> Dict[str, float]:
    keys = {"-w": "w", "-q": "q", "-e": "e", "-m": "m", "-x": "x",
            "-g": "g"}
    out = {"w": 500, "q": 10.0, "e": 0.3, "m": 5, "x": -4, "g": -8}
    for k in range(0, len(options) - 1, 2):
        if options[k] in keys:
            out[keys[options[k]]] = float(options[k + 1])
    for k in ("w", "m", "x", "g"):
        out[k] = int(out[k])
    return out


def reference_job(reads_path: str, overlaps_path: str, targets_path: str,
                  fragment: bool, options: Sequence[str],
                  sample: Sequence[int], **kw) -> JobRef:
    """The reference of one job for the windows ``sample`` (global window
    indices, in target order); ``kw`` as :func:`reference_jobs`."""
    return reference_jobs([(reads_path, overlaps_path, targets_path,
                            fragment, sample)], options, **kw)[0]


def reference_jobs(jobs: Sequence[tuple], options: Sequence[str],
                   device="cpu", vote_dtype=torch.float64,
                   score_bits: int = 32) -> List[JobRef]:
    """The references of several jobs, each ``(reads, overlaps, targets,
    fragment, sample)``, with their alignments in one batch a step.
    ``score_bits`` and ``vote_dtype`` below 32 bits and float64 give the
    controls: saturated DP scores, lower-precision vote sums."""
    opt = _options(options)
    sat = _saturation(score_bits)
    preps = [_prepare(*job, opt) for job in jobs]
    pairs = [p for prep in preps for p in prep.pairs]
    aligned = iter(nw.align_batch(pairs, 0, -1, -1, device=device,
                                  sat=sat))
    for prep in preps:
        _add_layers(prep, [next(aligned) for _ in prep.pairs], opt)
    consensus([w for prep in preps for w in prep.windows.values()], opt,
              device, vote_dtype, sat)
    return [JobRef([t.name for t in prep.targets],
                   [len(t.data) for t in prep.targets], prep.coverages,
                   len(prep.seqs), prep.windows) for prep in preps]


@dataclass
class _Prep:
    targets: List[Record]
    seqs: List[Record]
    coverages: List[int]
    windows: Dict[int, WindowRef]
    by_target: Dict[int, Dict[int, int]]
    touching: List[Ovl]
    pending: List[Ovl]
    pairs: List[tuple]


def _prepare(reads_path, overlaps_path, targets_path, fragment, sample,
             opt) -> _Prep:
    """Parse, resolve and filter; the sampled windows; the overlaps that
    touch them and the alignments they still need."""
    w = opt["w"]
    targets = read_sequences(targets_path)
    if not targets:
        raise InputRejected("empty target sequences set")
    seqs: List[Record] = list(targets)
    name_to_id: Dict[str, int] = {}
    id_to_id: Dict[int, int] = {}
    for i, s in enumerate(targets):
        name_to_id[s.name + "t"] = i
        id_to_id[i << 1 | 1] = i
    reads = targets if reads_path == targets_path else \
        read_sequences(reads_path)
    total = 0
    for k, s in enumerate(reads):
        total += len(s.data)
        tid = name_to_id.get(s.name + "t")
        if tid is not None:
            if len(s.data) != len(seqs[tid].data):
                raise InputRejected(f"duplicate {s.name} with unequal data")
            name_to_id[s.name + "q"] = tid
            id_to_id[k << 1] = tid
        else:
            name_to_id[s.name + "q"] = len(seqs)
            id_to_id[k << 1] = len(seqs)
            seqs.append(s)
    tgs = total / len(reads) > 1000

    # Overlaps: resolve, then filter each run of one query's overlaps.
    kept: List[Ovl] = []
    group: List[Ovl] = []

    def flush():
        good = [o for o in group if o.error <= opt["e"] and o.q_id != o.t_id]
        if good and not fragment:
            best = good[0]
            for o in good[1:]:
                if o.length >= best.length:
                    best = o
            good = [best]
        kept.extend(good)
        group.clear()

    for o in read_overlaps(overlaps_path):
        if not o.valid:
            continue
        if isinstance(o.q, str):
            q_id = name_to_id.get(o.q + "q")
        else:
            q_id = id_to_id.get(o.q << 1)
        if q_id is None:
            continue
        if o.q_length != len(seqs[q_id].data):
            raise InputRejected(f"unequal lengths for {seqs[q_id].name}")
        if isinstance(o.t, str):
            t_id = name_to_id.get(o.t + "t")
        else:
            t_id = id_to_id.get(o.t << 1 | 1)
        if t_id is None:
            continue
        if o.t_length and o.t_length != len(seqs[t_id].data):
            raise InputRejected(f"unequal lengths for {seqs[t_id].name}")
        o.t_length = len(seqs[t_id].data)
        o.q_id, o.t_id = q_id, t_id
        if group and group[-1].q_id != q_id:
            flush()
        group.append(o)
    flush()
    if not kept:
        raise InputRejected("empty overlap set")

    coverages = [0] * len(targets)
    for o in kept:
        coverages[o.t_id] += 1

    # The sampled windows, by target and rank.
    first = np.concatenate([[0], np.cumsum([-(-len(t.data) // w)
                                            for t in targets])])
    windows: Dict[int, WindowRef] = {}
    by_target: Dict[int, Dict[int, int]] = {}
    for g in sorted(set(int(x) for x in sample)):
        tid = int(np.searchsorted(first, g, side="right") - 1)
        rank = g - int(first[tid])
        tgt = targets[tid]
        lo, hi = rank * w, min((rank + 1) * w, len(tgt.data))
        windows[g] = WindowRef(tid, rank, tgt.data[lo:hi],
                               tgt.quality[lo:hi] if tgt.quality else None,
                               tgs)
        by_target.setdefault(tid, {})[rank] = g

    # Breaking points of the overlaps that touch a sampled window.
    touching = []
    for o in kept:
        ranks = by_target.get(o.t_id)
        if not ranks:
            continue
        if any(r * w < o.t_end and o.t_begin < (r + 1) * w for r in ranks):
            touching.append(o)
    pending = [o for o in touching if not o.cigar]
    pairs = []
    for o in pending:
        q, t = _operands(o, seqs)
        pairs.append((encode(q), encode(t)))
    return _Prep(targets, seqs, coverages, windows, by_target, touching,
                 pending, pairs)


def _add_layers(prep: _Prep, aligned, opt) -> None:
    """Breaking points of the touching overlaps, and the layers they give
    the sampled windows, with the 2%-span and mean-quality filters."""
    w = opt["w"]
    seqs, windows, by_target = prep.seqs, prep.windows, prep.by_target
    runs_of = {id(o): ops_runs(ops) for o, ops in zip(prep.pending, aligned)}
    min_span = 0.02 * w
    for o in prep.touching:
        runs = runs_of.get(id(o)) or _cigar_runs(o.cigar)
        q_start = o.q_begin if not o.strand else o.q_length - o.q_end
        bps = breaking_points(runs, o.t_begin, o.t_end, q_start, w)
        s = seqs[o.q_id]
        data = revcomp(s.data) if o.strand else s.data
        qual = (s.quality[::-1] if o.strand else s.quality) \
            if s.quality is not None else None
        for rank, g in by_target[o.t_id].items():
            bp = bps.get(rank)
            if bp is None:
                continue
            ft, fq, lt1, lq1 = bp
            n_b = lq1 - fq
            if n_b < min_span:
                continue
            if qual is not None and n_b > 0:
                avg = (np.frombuffer(qual[fq:lq1], np.uint8).astype(np.int64)
                       - 33).sum() / n_b
                if avg < opt["q"]:
                    continue
            win = windows[g]
            begin, end = ft - rank * w, lt1 - rank * w - 1
            if begin < 0 or begin >= end or end > len(win.backbone):
                raise InputRejected("layer begin and end positions are "
                                     "invalid")
            win.layers.append(Layer(begin, end, data[fq:lq1],
                                    qual[fq:lq1] if qual is not None
                                    else None))



def _operands(o: Ovl, seqs: List[Record]) -> Tuple[bytes, bytes]:
    s = seqs[o.q_id]
    if o.strand:
        q = revcomp(s.data)[o.q_length - o.q_end:o.q_length - o.q_begin]
    else:
        q = s.data[o.q_begin:o.q_end]
    return q, seqs[o.t_id].data[o.t_begin:o.t_end]


# ------------------------------------------------------------ consensus

def _saturation(bits: int):
    """The (lo, hi) of a signed ``bits``-bit score, None for 32 bits."""
    return None if bits >= 32 else (-(1 << (bits - 1)), (1 << (bits - 1)) - 1)


def consensus(windows: List[WindowRef], opt, device, vote_dtype,
              sat=None) -> None:
    active = []
    for win in windows:
        if len(win.layers) < 2:
            win.consensus, win.polished = win.backbone, False
        else:
            active.append(win)
    if not active:
        return
    layers, spans, anchors = [], [], []
    for win in active:
        order = np.argsort(np.asarray([L.begin for L in win.layers]),
                           kind="stable")
        lay, sp = [], []
        for k in order:
            L = win.layers[k]
            wts = (np.frombuffer(L.quality, np.uint8).astype(np.float32) - 33
                   if L.quality is not None
                   else np.ones(len(L.data), np.float32))
            lay.append((encode(L.data), wts))
            sp.append((L.begin, L.end))
        layers.append(lay)
        spans.append(sp)
        bw = (np.frombuffer(win.backbone_quality, np.uint8).astype(np.float32)
              - 33 if win.backbone_quality is not None
              else np.zeros(len(win.backbone), np.float32))
        anchors.append((encode(win.backbone), bw))
    # Insertion-vote scales: 0.2 in each of the 3 refinement rounds, 0.6
    # in the final one.
    scales = [0.2, 0.2, 0.2, 0.6]
    results = None
    for scale in scales:
        jobs = []
        for wi in range(len(active)):
            jobs.extend(_build_jobs(wi, anchors[wi][0], layers[wi],
                                    spans[wi]))
        ops = nw.align_batch([(j.q, j.t) for j in jobs], opt["m"], opt["x"],
                             opt["g"], device=device, sat=sat)
        for j, o in zip(jobs, ops):
            j.ops = o
        results = _merge_round(anchors, jobs, scale, vote_dtype)
        new_anchors, new_spans = [], []
        for wi, (cons, _cov, map_b, map_e) in enumerate(results):
            new_anchors.append((cons, np.zeros(len(cons), np.float32)))
            new_spans.append([
                (int(map_b[b]) if b < len(map_b) else 0,
                 int(map_e[e]) if e < len(map_e) else len(cons) - 1)
                for b, e in spans[wi]])
        anchors, spans = new_anchors, new_spans
    for win, (cons, cov, _b, _e) in zip(active, results):
        data = _DEC[cons].tobytes()
        if win.tgs:
            avg = len(win.layers) // 2
            keep = np.flatnonzero(cov[:len(cons)] >= avg)
            if len(keep) and keep[0] < keep[-1]:
                data = data[keep[0]:keep[-1] + 1]
        win.consensus, win.polished = data, True


class _Job:
    __slots__ = ("win", "q", "w", "w_read", "t", "t_off", "ops")

    def __init__(self, win, q, w, t, t_off):
        self.win, self.q, self.w, self.t, self.t_off = win, q, w, t, t_off
        self.w_read = float(w.astype(np.float64).mean()) if len(w) else 0.0
        self.ops = None


def _build_jobs(wi, bb, lst, sp):
    L = len(bb)
    offset = L // 100
    jobs = []
    for (codes, wts), (begin, end) in zip(lst, sp):
        begin = max(0, min(begin, L - 1))
        end = max(begin, min(end, L - 1))
        if begin < offset and end > L - offset:
            jobs.append(_Job(wi, codes, wts, bb, 0))
        else:
            jobs.append(_Job(wi, codes, wts, bb[begin:end + 1], begin))
    return jobs


class _Acc:
    """A flat vote accumulator in ``dtype``. In float64 the adds go in at
    once; in a lower precision every add is rounded to ``dtype``, one job
    after another (a job adds at most once to each entry)."""

    def __init__(self, n: int, dtype):
        self.dtype = dtype
        self.t = np.zeros(n)

    def add(self, idx: np.ndarray, vals: np.ndarray, jid=None) -> None:
        idx = np.asarray(idx, np.int64)
        vals = np.asarray(vals, np.float64)
        if not len(idx):
            return
        if self.dtype == torch.float64:
            np.add.at(self.t, idx, vals)
            return
        if jid is None:
            self.t[idx] = _round_array(self.t[idx] + vals, self.dtype)
            return
        bounds = np.flatnonzero(np.diff(jid)) + 1
        for part in np.split(np.arange(len(idx)), bounds):
            i = idx[part]
            self.t[i] = _round_array(self.t[i] + vals[part], self.dtype)

    def values(self) -> np.ndarray:
        return self.t


def _merge_round(anchors, jobs, scale, dtype):
    n_win = len(anchors)
    Ls = np.array([len(bb) for bb, _ in anchors], np.int64)
    col_off = np.concatenate([[0], np.cumsum(Ls)])
    gap_off = np.concatenate([[0], np.cumsum(Ls + 1)])
    total_c, total_g = int(col_off[-1]), int(gap_off[-1])
    base_w = _Acc(total_c * ALPHABET, dtype)
    base_c = np.zeros(total_c * ALPHABET, np.int64)
    del_w = _Acc(total_c, dtype)
    direct_w = _Acc(total_g, dtype)
    ins1_w = _Acc(total_g * ALPHABET, dtype)
    ins1_c = np.zeros(total_g * ALPHABET, np.int64)
    ins1_stop = _Acc(total_g, dtype)
    piles: Dict[int, _Pileup] = {}

    bb_flat = np.concatenate([bb for bb, _ in anchors]).astype(np.int64)
    bbw_flat = np.concatenate([w for _, w in anchors]).astype(np.float64)
    base_w.add(np.arange(total_c) * ALPHABET + bb_flat, bbw_flat + EPS)
    np.add.at(base_c, np.arange(total_c) * ALPHABET + bb_flat, 1)
    for wi, (_bb, bw) in enumerate(anchors):
        bw = bw.astype(np.float64)
        cross = (np.concatenate([[bw[0]], bw]) +
                 np.concatenate([bw, [bw[-1]]])) * 0.5
        direct_w.add(np.arange(gap_off[wi], gap_off[wi + 1]), cross + EPS)
    if jobs:
        _scatter(jobs, col_off, gap_off, base_w, base_c, del_w, direct_w,
                 ins1_w, ins1_c, ins1_stop, piles, dtype)

    bw2 = base_w.values().reshape(total_c, ALPHABET)
    best_code = np.argmax(bw2, axis=1)
    ar = np.arange(total_c)
    best_w = bw2[ar, best_code]
    kept_flat = del_w.values() <= best_w
    cov_flat = base_c.reshape(total_c, ALPHABET)[ar, best_code]
    i1 = ins1_w.values().reshape(total_g, ALPHABET)
    if dtype == torch.float64:
        g_tot = i1.sum(axis=1)
    else:
        g_tot = np.zeros(total_g)
        for b in range(ALPHABET):
            g_tot = _round_array(g_tot + i1[:, b], dtype)
    g_arg = np.argmax(i1, axis=1)
    direct = direct_w.values()
    stop = ins1_stop.values()
    emit1 = g_tot > direct * scale
    ic2 = ins1_c.reshape(total_g, ALPHABET)
    keys = np.array(sorted(piles), np.int64)
    bounds = np.searchsorted(keys, gap_off)

    results = []
    for wi in range(n_win):
        c0, c1 = int(col_off[wi]), int(col_off[wi + 1])
        g0, g1 = int(gap_off[wi]), int(gap_off[wi + 1])
        L = c1 - c0
        kept = kept_flat[c0:c1]
        codes = best_code[c0:c1]
        cov = cov_flat[c0:c1]
        events = []
        for g in np.flatnonzero(emit1[g0:g1]):
            gg = g0 + int(g)
            if gg in piles:
                continue
            events.append((int(g), np.array([g_arg[gg]], np.uint8),
                           np.array([ic2[gg, g_arg[gg]]], np.int64)))
        for gg in keys[bounds[wi]:bounds[wi + 1]]:
            gg = int(gg)
            seq, cnt = piles[gg].consensus(float(direct[gg]) * scale,
                                           i1[gg], ic2[gg], float(stop[gg]),
                                           dtype)
            if len(seq):
                events.append((gg - g0, seq, cnt))
        events.sort(key=lambda e: e[0])
        ins_len_at = np.zeros(L + 1, np.int64)
        parts, covs = [], []
        last = 0
        for g, seq, cnt in events:
            ins_len_at[g] = len(seq)
            sel = kept[last:g]
            parts += [codes[last:g][sel], seq]
            covs += [cov[last:g][sel], cnt]
            last = g
        sel = kept[last:]
        parts.append(codes[last:][sel])
        covs.append(cov[last:][sel])
        cons = np.concatenate(parts).astype(np.uint8)
        coverage = np.concatenate(covs).astype(np.int32)
        kept_excl = np.cumsum(kept) - kept
        new_col = kept_excl + np.cumsum(ins_len_at)[:L]
        kept_idx = np.flatnonzero(kept)
        ar_l = np.arange(L)
        if len(kept_idx) == 0:
            map_b = np.zeros(L, np.int64)
            map_e = np.zeros(L, np.int64)
        else:
            nb = np.searchsorted(kept_idx, ar_l, side="left")
            map_b = new_col[kept_idx[np.minimum(nb, len(kept_idx) - 1)]]
            ne = np.searchsorted(kept_idx, ar_l, side="right") - 1
            map_e = new_col[kept_idx[np.maximum(ne, 0)]]
        np.clip(map_b, 0, max(len(cons) - 1, 0), out=map_b)
        np.clip(map_e, 0, max(len(cons) - 1, 0), out=map_e)
        results.append((cons, coverage, map_b, map_e))
    return results


def _round_array(a: np.ndarray, dtype) -> np.ndarray:
    return torch.from_numpy(np.asarray(a, np.float64)).to(dtype).double() \
        .numpy()


def _scatter(jobs, col_off, gap_off, base_w, base_c, del_w, direct_w,
             ins1_w, ins1_c, ins1_stop, piles, dtype) -> None:
    DIAG, UP, LEFT = nw.DIAG, nw.UP, nw.LEFT
    lens = np.array([len(j.ops) for j in jobs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    o = np.concatenate([j.ops for j in jobs])
    q_flat = np.concatenate([j.q for j in jobs]).astype(np.int64)
    w_flat = np.concatenate([j.w for j in jobs]).astype(np.float64)
    q_lens = np.array([len(j.q) for j in jobs], np.int64)
    q_offs = np.concatenate([[0], np.cumsum(q_lens)[:-1]])
    jid = np.repeat(np.arange(len(jobs)), lens)
    w_read = np.repeat(np.array([j.w_read for j in jobs]), lens)
    wins = np.array([j.win for j in jobs], np.int64)
    t_offs = np.array([j.t_off for j in jobs], np.int64)
    t_base = np.repeat(col_off[wins] + t_offs, lens)
    g_base = np.repeat(gap_off[wins] + t_offs, lens)
    cq = o != LEFT
    ct = o != UP
    pre_q = np.cumsum(cq) - cq
    pre_t = np.cumsum(ct) - ct
    qpos = pre_q - np.repeat(pre_q[starts], lens)
    tpos = pre_t - np.repeat(pre_t[starts], lens)
    gq = np.minimum(q_offs[jid] + qpos, q_offs[jid] + q_lens[jid] - 1)
    gcol = t_base + tpos
    ggap = g_base + tpos

    m = o == DIAG
    base_w.add(gcol[m] * ALPHABET + q_flat[gq[m]], w_flat[gq[m]], jid[m])
    np.add.at(base_c, gcol[m] * ALPHABET + q_flat[gq[m]], 1)
    d = o == LEFT
    del_w.add(gcol[d], w_read[d], jid[d])
    t_idx = np.flatnonzero(ct)
    if len(t_idx) > 1:
        wq = np.where(m, w_flat[gq], w_read)
        same = jid[t_idx[1:]] == jid[t_idx[:-1]]
        adj = (np.diff(t_idx) == 1) & same
        direct_w.add(ggap[t_idx[1:]][adj],
                     0.5 * (wq[t_idx[:-1]][adj] + wq[t_idx[1:]][adj]),
                     jid[t_idx[1:]][adj])
    i_mask = o == UP
    if not i_mask.any():
        return
    flat = np.flatnonzero(i_mask)
    brk = (np.diff(flat) > 1) | (jid[flat[1:]] != jid[flat[:-1]])
    run_s = flat[np.concatenate([[True], brk])]
    run_e = flat[np.concatenate([brk, [True]])]
    one = (run_e - run_s) == 0
    s1 = run_s[one]
    g1 = ggap[s1]
    b1 = q_flat[gq[s1]]
    w1 = w_flat[gq[s1]]
    ins1_w.add(g1 * ALPHABET + b1, w1, jid[s1])
    np.add.at(ins1_c, g1 * ALPHABET + b1, 1)
    ins1_stop.add(g1, w1, jid[s1])
    for s, e in zip(run_s[~one], run_e[~one]):
        g = int(ggap[s])
        qs, qe = int(gq[s]), int(gq[e])
        pile = piles.get(g)
        if pile is None:
            pile = piles[g] = _Pileup(dtype)
        pile.add(q_flat[qs:qe + 1], w_flat[qs:qe + 1])


class _Pileup:
    """Left-justified pileup of the multi-base insertions at one gap;
    columns vote while the reads still extending outweigh those that
    stopped."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.col_w: List[np.ndarray] = []
        self.col_c: List[np.ndarray] = []
        self.len_w: Dict[int, float] = {}

    def _r(self, x):
        return x if self.dtype == torch.float64 else _round_array(
            x, self.dtype)

    def add(self, seg, w) -> None:
        for k in range(len(seg)):
            if k == len(self.col_w):
                self.col_w.append(np.zeros(ALPHABET))
                self.col_c.append(np.zeros(ALPHABET, np.int64))
            self.col_w[k][seg[k]] = self._r(self.col_w[k][seg[k]] + w[k])
            self.col_c[k][seg[k]] += 1
        n = len(seg)
        self.len_w[n] = float(self._r(self.len_w.get(n, 0.0) +
                                      float(w.astype(np.float64).mean())))

    def consensus(self, direct, extra0_w, extra0_c, extra_stop1, dtype):
        out, cnt = [], []
        stopped = float(direct)
        for k in range(len(self.col_w)):
            cw, cc = self.col_w[k], self.col_c[k]
            if k == 0:
                cw = self._r(cw + extra0_w)
                cc = cc + extra0_c
            if float(self._r(cw.sum())) <= stopped:
                break
            b = int(np.argmax(cw))
            out.append(b)
            cnt.append(int(cc[b]))
            stopped = float(self._r(stopped + self.len_w.get(k + 1, 0.0)))
            if k == 0:
                stopped = float(self._r(stopped + extra_stop1))
        return np.asarray(out, np.uint8), np.asarray(cnt, np.int32)
