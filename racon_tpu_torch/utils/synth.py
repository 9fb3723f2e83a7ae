"""Synthetic polishing inputs made from a seed with numpy.

A truth genome of one or more contigs; a draft assembly that is a noisy
copy of each contig; reads that are noisy copies of truth segments (half
of them reverse-complemented); overlaps of each read to its draft contig
as PAF (approximate coordinates, aligned later by the polisher) or SAM
(with CIGARs from the native aligner); optionally an all-vs-all PAF of
full-length reads for fragment correction (``-f``). Used by the tests and
by ``chip_smoke.py``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from racon_tpu_torch.ops.encode import reverse_complement

_BASES = np.frombuffer(b"ACGT", np.uint8)


def mutate(rng, seq: np.ndarray, rate: float):
    """Noisy copy of ``seq`` (ASCII uint8) with substitutions, insertions
    and deletions at ``rate / 3`` each. Returns (copy, pos) where
    ``pos[i]`` is the copy index where truth base i's slot starts
    (``pos[len(seq)]`` = len(copy))."""
    n = len(seq)
    r = rng.random(n)
    dele = r < rate / 3
    sub = (r >= rate / 3) & (r < 2 * rate / 3)
    ins = (r >= 2 * rate / 3) & (r < rate)
    counts = np.where(dele, 0, np.where(ins, 2, 1))
    base = np.where(sub, _BASES[rng.integers(0, 4, n)], seq)
    starts = np.cumsum(counts) - counts
    out = np.zeros(int(counts.sum()), np.uint8)
    keep = ~dele
    out[starts[keep]] = base[keep]
    out[starts[ins] + 1] = _BASES[rng.integers(0, 4, int(ins.sum()))]
    return out, np.concatenate([starts, [len(out)]])


def edit_distance(a: bytes, b: bytes) -> int:
    """Exact edit distance (native banded aligner, unit costs)."""
    from racon_tpu_torch.native.aligner import NativeAligner
    ops = NativeAligner().align(a, b)
    qa = np.frombuffer(a, np.uint8)
    ta = np.frombuffer(b, np.uint8)
    gaps = int((ops != 0).sum())
    d = ops == 0
    qi = np.cumsum(ops != 2) - 1
    tj = np.cumsum(ops != 1) - 1
    return gaps + int((qa[qi[d]] != ta[tj[d]]).sum())


def write_dataset(out_dir: str, *, seed: int = 0, n_contigs: int = 1,
                  contig_len: int = 6000, read_len: Optional[int] = None,
                  coverage: int = 60, draft_err: float = 0.05,
                  read_err: float = 0.08, fastq: bool = True,
                  overlaps: str = "paf", ava: bool = False) -> Dict:
    """Write draft.fasta, reads.fast{a,q}, the overlaps file and
    truth.fasta into ``out_dir``. ``read_len=None`` makes full-length
    reads (each a noisy copy of a whole contig). ``overlaps``: "paf" or
    "sam"; ``ava`` adds ava.paf (all-vs-all, full-length reads only).
    Returns the paths, the truth contigs and the draft contigs."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    truth = [_BASES[rng.integers(0, 4, contig_len)] for _ in range(n_contigs)]
    drafts, dpos = [], []
    for t in truth:
        d, p = mutate(rng, t, draft_err)
        drafts.append(d)
        dpos.append(p)
    rlen = contig_len if read_len is None else read_len
    n_reads = max(2, coverage * contig_len // rlen)
    reads: List[tuple] = []           # (name, data, qual, contig, t0, t1, rc)
    for c in range(n_contigs):
        for k in range(n_reads):
            if read_len is None:
                s, e = 0, contig_len
            else:
                # Starts spread past both contig ends (reads overhanging
                # an end are cut), so coverage stays even up to the ends.
                s = int(rng.integers(-rlen // 2, contig_len - rlen // 2))
                e = min(s + rlen, contig_len)
                s = max(s, 0)
            data, _ = mutate(rng, truth[c][s:e], read_err)
            rc = bool(rng.random() < 0.5)
            raw = data.tobytes()
            if rc:
                raw = reverse_complement(raw)
            qual = (rng.integers(33 + 15, 33 + 36, len(raw))
                    .astype(np.uint8).tobytes())
            reads.append((f"read{c}_{k}", raw, qual, c,
                          int(dpos[c][s]), int(dpos[c][e]), rc))

    paths = {"draft": os.path.join(out_dir, "draft.fasta"),
             "truth": os.path.join(out_dir, "truth.fasta"),
             "reads": os.path.join(out_dir,
                                   "reads.fastq" if fastq else "reads.fasta")}
    with open(paths["draft"], "wb") as fh:
        for c, d in enumerate(drafts):
            fh.write(b">ctg%d\n" % c + d.tobytes() + b"\n")
    with open(paths["truth"], "wb") as fh:
        for c, t in enumerate(truth):
            fh.write(b">ctg%d\n" % c + t.tobytes() + b"\n")
    with open(paths["reads"], "wb") as fh:
        for name, raw, qual, *_ in reads:
            if fastq:
                fh.write(b"@" + name.encode() + b"\n" + raw + b"\n+\n" +
                         qual + b"\n")
            else:
                fh.write(b">" + name.encode() + b"\n" + raw + b"\n")

    if overlaps == "paf":
        paths["overlaps"] = os.path.join(out_dir, "overlaps.paf")
        with open(paths["overlaps"], "w") as fh:
            for name, raw, _q, c, t0, t1, rc in reads:
                tl = len(drafts[c])
                m, al = min(len(raw), t1 - t0), max(len(raw), t1 - t0)
                fh.write(f"{name}\t{len(raw)}\t0\t{len(raw)}\t"
                         f"{'-' if rc else '+'}\tctg{c}\t{tl}\t{t0}\t{t1}"
                         f"\t{m}\t{al}\t60\n")
    elif overlaps == "sam":
        from racon_tpu_torch.native.aligner import NativeAligner
        aligner = NativeAligner()
        paths["overlaps"] = os.path.join(out_dir, "overlaps.sam")
        with open(paths["overlaps"], "w") as fh:
            for name, raw, _q, c, t0, t1, rc in reads:
                q = reverse_complement(raw) if rc else raw
                cigar = aligner.cigar(q, drafts[c][t0:t1].tobytes())
                fh.write(f"{name}\t{16 if rc else 0}\tctg{c}\t{t0 + 1}\t60"
                         f"\t{cigar.decode()}\t*\t0\t0\t*\t*\n")
    else:
        raise ValueError(f"unknown overlap format {overlaps!r}")

    if ava:
        if read_len is not None:
            raise ValueError("all-vs-all overlaps need full-length reads")
        paths["ava"] = os.path.join(out_dir, "ava.paf")
        with open(paths["ava"], "w") as fh:
            for qn, qr, _a, qc, _b, _c, qrc in reads:
                for tn, tr, _d, tc, _e, _f, trc in reads:
                    if qn == tn or qc != tc:
                        continue
                    m, al = min(len(qr), len(tr)), max(len(qr), len(tr))
                    fh.write(f"{qn}\t{len(qr)}\t0\t{len(qr)}\t"
                             f"{'-' if qrc != trc else '+'}\t{tn}\t{len(tr)}"
                             f"\t0\t{len(tr)}\t{m}\t{al}\t60\n")
    return {"paths": paths, "truth": [t.tobytes() for t in truth],
            "drafts": [d.tobytes() for d in drafts]}
