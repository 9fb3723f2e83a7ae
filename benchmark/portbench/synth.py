"""Synthetic polishing jobs made from a seed with numpy.

A frozen copy of the port's generator (``racon_tpu_torch/utils/synth.py``),
widened where the benchmark's configurations need it:

- the layout of a job (its reads' lengths, log-normal and clipped, their
  contigs and positions) is drawn from the traffic's own ``length_seed``
  and the job's index, so every seed polishes the same sizes; the seed
  draws the sequences, the errors, the qualities and the strands;
- errors split between substitutions, insertions and deletions by the
  configuration's ``mix``;
- SAM CIGARs are composed from the generator's own edit maps (read ->
  truth -> draft), so set-up runs no aligner;
- all-vs-all overlaps (MHAP) for partial reads: a pair overlaps where
  their truth intervals intersect, each pair once, in a direction drawn
  from the seed.

Every job writes ``targets.fasta``, ``reads.fast{a,q}`` and the overlaps
file into its directory and returns a :class:`Job` with the truth of
every sequence the polisher may output.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

_BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in (("A", "T"), ("C", "G")):
    _COMP[ord(_a)], _COMP[ord(_b)] = ord(_b), ord(_a)
_COMP_TABLE = _COMP.tobytes()

# CIGAR op codes of the composed alignment, in SAM's letters.
_NONE, _M, _I, _D = 0, 1, 2, 3
_CIGAR_LETTERS = np.array(["", "M", "I", "D"])


def revcomp(data: bytes) -> bytes:
    return data.translate(_COMP_TABLE)[::-1]


@dataclass
class Job:
    """One polishing job's files and what the benchmark knows of it."""
    directory: str
    reads: str
    overlaps: str
    targets: str
    fragment_correction: bool
    # Output record name (before the port's tags) -> truth bytes.
    truth: Dict[str, bytes] = field(default_factory=dict)
    target_bases: int = 0
    n_windows: int = 0

    def argv(self, threads: int, options: List[str],
             device: str = "cuda") -> List[str]:
        """The command line a user writes for this job."""
        argv = [self.reads, self.overlaps, self.targets, *options,
                "-t", str(threads), "--device", device]
        return (["-f"] + argv) if self.fragment_correction else argv


def mutate(rng, seq: np.ndarray, rate: float, mix: Dict[str, float]):
    """Noisy copy of ``seq`` (ASCII uint8). Each truth base is deleted,
    substituted or followed by one inserted base with probabilities
    ``rate * mix[...]``. Returns ``(copy, slot, count)``: ``slot[i]`` is
    the copy index where truth base i's slot starts (``slot[n]`` =
    len(copy)) and ``count[i]`` in {0, 1, 2} the bases the slot holds
    (0 deleted, 2 with an insertion after the base)."""
    n = len(seq)
    p_del = rate * mix["del"]
    p_sub = rate * mix["sub"]
    p_ins = rate * mix["ins"]
    r = rng.random(n)
    dele = r < p_del
    sub = (r >= p_del) & (r < p_del + p_sub)
    ins = (r >= p_del + p_sub) & (r < p_del + p_sub + p_ins)
    # A substitution draws one of the three other bases.
    shift = rng.integers(1, 4, n).astype(np.uint8)
    code = np.searchsorted(_BASES, seq)
    base = np.where(sub, _BASES[(code + shift) % 4], seq)
    count = np.where(dele, 0, np.where(ins, 2, 1)).astype(np.int64)
    starts = np.cumsum(count) - count
    out = np.zeros(int(count.sum()), np.uint8)
    keep = ~dele
    out[starts[keep]] = base[keep]
    out[starts[ins] + 1] = _BASES[rng.integers(0, 4, int(ins.sum()))]
    return out, np.concatenate([starts, [len(out)]]), count


def compose_cigars(read_count: np.ndarray, draft_count: np.ndarray,
                   offsets: np.ndarray) -> List[str]:
    """CIGARs of reads against the draft over the same truth slots, from
    the copies' slot counts (``mutate``'s ``count``; read r holds slots
    ``offsets[r]:offsets[r + 1]`` of both): a truth base both keep is M,
    one only the read keeps I, one only the draft keeps D; inserted bases
    after the same truth base pair up as M."""
    r_base, d_base = read_count > 0, draft_count > 0
    r_ins, d_ins = read_count == 2, draft_count == 2

    def column(r, d):
        # M = 1 where both, I = 2 where the read alone, D = 3 where the
        # draft alone, 0 where neither.
        return (r & d) * np.uint8(_M) + (r & ~d) * np.uint8(_I) + \
            (~r & d) * np.uint8(_D)

    ops = np.empty(2 * len(read_count), np.uint8)
    ops[0::2] = column(r_base, d_base)
    ops[1::2] = column(r_ins, d_ins)
    rid = np.repeat(np.arange(len(offsets) - 1, dtype=np.int32),
                    2 * np.diff(offsets))
    keep = ops != _NONE
    ops, rid = ops[keep], rid[keep]
    if len(ops) == 0:
        return [""] * (len(offsets) - 1)
    change = np.empty(len(ops), bool)
    change[0] = True
    change[1:] = (ops[1:] != ops[:-1]) | (rid[1:] != rid[:-1])
    starts = np.flatnonzero(change)
    lens = np.diff(starts, append=len(ops))
    tokens = [""] * (2 * len(starts))
    tokens[0::2] = map(str, lens.tolist())
    tokens[1::2] = _CIGAR_LETTERS[ops[starts]].tolist()
    bounds = 2 * np.searchsorted(rid[starts], np.arange(len(offsets)))
    return ["".join(tokens[a:b]) for a, b in zip(bounds[:-1].tolist(),
                                                bounds[1:].tolist())]


def compose_cigar(read_count: np.ndarray, draft_count: np.ndarray) -> str:
    """:func:`compose_cigars` of one read."""
    return compose_cigars(read_count, draft_count,
                          np.array([0, len(read_count)]))[0]


def _segments(starts: np.ndarray, ends: np.ndarray):
    """Indices of every range [starts[r], ends[r]) concatenated, and each
    range's offset in them."""
    lens = ends - starts
    off = np.concatenate([[0], np.cumsum(lens)])
    idx = np.arange(off[-1]) - np.repeat(off[:-1] - starts, lens)
    return idx, off


def read_lengths(traffic: dict, total_bp: int) -> np.ndarray:
    """The traffic's fixed multiset of read lengths: log-normal with the
    given N50 and sigma (N50 = exp(mu + sigma^2)), clipped, drawn from
    the traffic's own ``length_seed`` until they cover ``total_bp``."""
    spec = traffic["read_length"]
    sigma = float(spec["sigma"])
    mu = np.log(float(spec["n50"])) - sigma ** 2
    rng = np.random.default_rng(int(spec["length_seed"]))
    out: List[int] = []
    have = 0
    while have < total_bp:
        n = int(np.clip(rng.lognormal(mu, sigma), spec["min"], spec["max"]))
        out.append(n)
        have += n
    return np.asarray(out, dtype=np.int64)


def _quality(rng, n: int, reads: dict) -> bytes:
    lo, hi = reads["phred"]
    return (rng.integers(33 + lo, 33 + hi, n).astype(np.uint8).tobytes())


def _place(rng, lengths: np.ndarray, span: int):
    """Read starts spread past both ends of a ``span``-long truth, so
    coverage stays even up to the ends; reads are cut at the ends."""
    s = rng.integers(-lengths // 2, span - lengths // 2)
    e = np.minimum(s + lengths, span)
    return np.maximum(s, 0), e


def _write_reads(path: str, reads: List[tuple], fastq: bool) -> None:
    with open(path, "wb") as fh:
        for name, raw, qual in reads:
            if fastq:
                fh.write(b"@%s\n%s\n+\n%s\n" % (name.encode(), raw, qual))
            else:
                fh.write(b">%s\n%s\n" % (name.encode(), raw))


def _write_fasta(path: str, records: List[tuple]) -> None:
    with open(path, "wb") as fh:
        for name, data in records:
            fh.write(b">%s\n%s\n" % (name.encode(), data))


def _windows(lengths, window: int) -> int:
    return int(sum(-(-int(n) // window) for n in lengths))


def make_job(directory: str, config: dict, traffic: dict, seed: int,
             index: int) -> Job:
    """Write job ``index`` of a run with ``seed`` under ``directory``."""
    rng = np.random.default_rng([seed, index])
    layout = np.random.default_rng(
        [int(traffic["read_length"]["length_seed"]), index])
    os.makedirs(directory, exist_ok=True)
    if traffic["mode"] == "contigs":
        return _contig_job(directory, config, traffic, rng, layout)
    if traffic["mode"] == "ava":
        return _ava_job(directory, config, traffic, rng, layout)
    raise ValueError(f"unknown traffic mode {traffic['mode']!r}")


def _contig_job(directory, config, traffic, rng, layout) -> Job:
    rcfg = config["reads"]
    window = int(config["window_length"])
    sizes = [int(n) for n in traffic["contig_bp"]]
    fastq = bool(rcfg["fastq"])
    fmt = traffic["overlaps"]
    if fmt not in ("paf", "sam"):
        raise ValueError(f"contig traffic takes paf or sam, not {fmt!r}")
    job = Job(directory, os.path.join(directory, "reads.fastq" if fastq
                                      else "reads.fasta"),
              os.path.join(directory, f"overlaps.{fmt}"),
              os.path.join(directory, "targets.fasta"), False)
    truth = [_BASES[rng.integers(0, 4, n)] for n in sizes]
    drafts = [mutate(rng, t, config["draft"]["error"], config["draft"]["mix"])
              for t in truth]
    lengths = read_lengths(traffic, int(rcfg["coverage"]) * sum(sizes))
    lengths = lengths[layout.permutation(len(lengths))]
    n = len(lengths)
    # Reads fall on contigs in proportion to their lengths.
    contig = layout.choice(len(sizes), size=n,
                           p=np.asarray(sizes, float) / sum(sizes))
    s, e = np.zeros(n, np.int64), np.zeros(n, np.int64)
    for c, size in enumerate(sizes):
        on = contig == c
        s[on], e[on] = _place(layout, lengths[on], size)
    # Every read's truth segment, all mutated at once.
    first = np.concatenate([[0], np.cumsum(sizes)])
    idx, off = _segments(s + first[contig], e + first[contig])
    data, slot, count = mutate(rng, np.concatenate(truth)[idx],
                               rcfg["error"], rcfg["mix"])
    rc = rng.random(n) < rcfg["reverse_share"]
    lo, hi = rcfg["phred"]
    qual = rng.integers(33 + lo, 33 + hi, len(data)).astype(np.uint8)
    data_b, qual_b = data.tobytes(), qual.tobytes()
    cuts = slot[off].tolist()
    if fmt == "sam":
        dcount = np.concatenate([d[2] for d in drafts])
        cigars = compose_cigars(count, dcount[idx], off)
    reads, lines = [], []
    for k in range(n):
        c = int(contig[k])
        raw, q = data_b[cuts[k]:cuts[k + 1]], qual_b[cuts[k]:cuts[k + 1]]
        name = f"read{k}"
        reads.append((name, revcomp(raw), q[::-1]) if rc[k] else
                     (name, raw, q))
        d, dslot, _dcount = drafts[c]
        t0, t1 = int(dslot[s[k]]), int(dslot[e[k]])
        if fmt == "paf":
            a, b = min(len(raw), t1 - t0), max(len(raw), t1 - t0)
            lines.append(f"{name}\t{len(raw)}\t0\t{len(raw)}\t"
                         f"{'-' if rc[k] else '+'}\tctg{c}\t{len(d)}\t{t0}"
                         f"\t{t1}\t{a}\t{b}\t60\n")
        else:
            lines.append(f"{name}\t{16 if rc[k] else 0}\tctg{c}\t{t0 + 1}"
                         f"\t60\t{cigars[k]}\t*\t0\t0\t{raw.decode()}\t"
                         f"{q.decode()}\n")
    _write_reads(job.reads, reads, fastq)
    _write_fasta(job.targets, [(f"ctg{c}", d[0].tobytes())
                               for c, d in enumerate(drafts)])
    with open(job.overlaps, "w") as fh:
        if fmt == "sam":
            fh.write("@HD\tVN:1.6\n")
            for c, d in enumerate(drafts):
                fh.write(f"@SQ\tSN:ctg{c}\tLN:{len(d[0])}\n")
        fh.writelines(lines)
    job.truth = {f"ctg{c}": t.tobytes() for c, t in enumerate(truth)}
    job.target_bases = sum(len(d[0]) for d in drafts)
    job.n_windows = _windows([len(d[0]) for d in drafts], window)
    return job


def _ava_job(directory, config, traffic, rng, layout) -> Job:
    rcfg = config["reads"]
    window = int(config["window_length"])
    span = int(traffic["region_bp"])
    fastq = bool(rcfg["fastq"])
    job = Job(directory, os.path.join(directory, "reads.fastq" if fastq
                                      else "reads.fasta"),
              os.path.join(directory, "overlaps.mhap"),
              os.path.join(directory, "reads.fastq" if fastq
                           else "reads.fasta"), True)
    region = _BASES[rng.integers(0, 4, span)]
    lengths = read_lengths(traffic, int(rcfg["coverage"]) * span)
    lengths = lengths[layout.permutation(len(lengths))]
    starts, ends = _place(layout, lengths, span)
    reads, info = [], []
    for k, (s, e) in enumerate(zip(starts, ends)):
        s, e = int(s), int(e)
        data, slot, _count = mutate(rng, region[s:e], rcfg["error"],
                                    rcfg["mix"])
        rc = bool(rng.random() < rcfg["reverse_share"])
        raw = data.tobytes()
        qual = _quality(rng, len(raw), rcfg)
        name = f"read{k}"
        stored, stored_q = (revcomp(raw), qual[::-1]) if rc else (raw, qual)
        reads.append((name, stored, stored_q))
        info.append((s, e, slot, rc, len(raw)))
        truth = region[s:e].tobytes()
        # The corrected read keeps the read's strand; kF tags it "r".
        job.truth[name + "r"] = revcomp(truth) if rc else truth
    _write_reads(job.reads, reads, fastq)

    def coords(r, x, y):
        """Forward-strand coordinates in read r of truth [x, y)."""
        s, _e, slot, rc, n = info[r]
        b, e = int(slot[x - s]), int(slot[y - s])
        return (n - e, n - b) if rc else (b, e)

    min_ovl = int(traffic["min_overlap_bp"])
    order = np.argsort(starts, kind="stable")
    lines = []
    for ii, a in enumerate(order):
        for b in order[ii + 1:]:
            if starts[b] >= ends[a] - min_ovl + 1:
                break  # sorted by start: no later read overlaps a enough
            x, y = int(max(starts[a], starts[b])), int(min(ends[a], ends[b]))
            if y - x < min_ovl:
                continue
            q, t = (a, b) if rng.random() < 0.5 else (b, a)
            qb, qe = coords(q, x, y)
            tb, te = coords(t, x, y)
            strand = int(info[q][3] != info[t][3])
            lines.append((int(q), int(t), qb, qe, tb, te, strand))
    lines.sort()
    with open(job.overlaps, "w") as fh:
        for q, t, qb, qe, tb, te, strand in lines:
            # MHAP: 1-based ids in file order, error, minmers, then each
            # read's strand bit, begin, end and length.
            err = 1 - min(qe - qb, te - tb) / max(qe - qb, te - tb)
            fh.write(f"{q + 1} {t + 1} {err:.4f} {max(qe - qb, 1) // 10} "
                     f"0 {qb} {qe} {info[q][4]} {strand} {tb} {te} "
                     f"{info[t][4]}\n")
    job.target_bases = sum(x[4] for x in info)
    job.n_windows = _windows([x[4] for x in info], window)
    return job
