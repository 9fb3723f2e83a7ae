"""The frozen generator: the same seed makes the same job, every seed the
same read lengths, and the composed SAM CIGARs are alignments."""

import filecmp
import os
import re

import numpy as np

from conftest import tiny_mix
from portbench import spec, synth
from reference import nw
from reference.polish import encode


def _files(job):
    return [job.reads, job.overlaps, job.targets]


def test_a_seed_repeats_exactly(tmp_path):
    for name, config in (("contig-250kbp", "ecoli-k12-ont-r9"),
                         ("chroms-1-3-6", "yeast-s288c-pacbio-clr"),
                         ("ava-50kb", "ecoli-k12-ont-r9")):
        cfg, mix = tiny_mix(config, name)
        a = synth.make_job(str(tmp_path / name / "a"), cfg, mix,
                           2 ** 31 + 11, 0)
        b = synth.make_job(str(tmp_path / name / "b"), cfg, mix,
                           2 ** 31 + 11, 0)
        c = synth.make_job(str(tmp_path / name / "c"), cfg, mix, 5, 0)
        assert all(filecmp.cmp(x, y, shallow=False)
                   for x, y in zip(_files(a), _files(b)))
        assert a.truth == b.truth and a.target_bases == b.target_bases
        assert not filecmp.cmp(a.reads, c.reads, shallow=False)


def test_every_seed_draws_the_same_read_lengths():
    cell = spec.load_cell("ecoli_ont.polish")
    a = synth.read_lengths(cell.traffic, 10 ** 6)
    b = synth.read_lengths(cell.traffic, 10 ** 6)
    assert np.array_equal(a, b)
    n50 = np.sort(a)[::-1][np.searchsorted(np.cumsum(np.sort(a)[::-1]),
                                           a.sum() / 2)]
    assert 8000 < n50 < 12000 and a.min() >= 1000 and a.max() <= 40000


def _cigar_cost(cigar, read, draft):
    q = t = cost = 0
    for n, op in re.findall(r"(\d+)([MID])", cigar):
        n = int(n)
        if op == "M":
            cost += sum(read[q + k] != draft[t + k] for k in range(n))
            q, t = q + n, t + n
        elif op == "I":
            q, cost = q + n, cost + n
        else:
            t, cost = t + n, cost + n
    return q, t, cost


def _mutations(truth, copy, slot, count):
    kept = count > 0
    subs = int((copy[slot[:-1][kept]] != truth[kept]).sum())
    return subs + int((count != 1).sum())


def test_composed_cigar_is_an_alignment_of_read_to_draft():
    rng = np.random.default_rng(3)
    mix = {"sub": 0.15, "ins": 0.5, "del": 0.35}
    for _ in range(20):
        truth = synth._BASES[rng.integers(0, 4, 300)]
        read, rslot, rcount = synth.mutate(rng, truth, 0.13, mix)
        draft, dslot, dcount = synth.mutate(rng, truth, 0.03, mix)
        cigar = synth.compose_cigar(rcount, dcount)
        q, t, cost = _cigar_cost(cigar, read, draft)
        assert (q, t) == (len(read), len(draft))
        # No cheaper than the optimal alignment, no dearer than the two
        # copies' mutations together.
        ops = nw.align_batch([(encode(read.tobytes()),
                               encode(draft.tobytes()))], 0, -1,
                             -1)[0]
        qi = np.cumsum(ops != nw.LEFT) - 1
        ti = np.cumsum(ops != nw.UP) - 1
        d = ops == nw.DIAG
        best = int((ops != nw.DIAG).sum() +
                   (read[qi[d]] != draft[ti[d]]).sum())
        assert best <= cost <= (_mutations(truth, read, rslot, rcount) +
                                _mutations(truth, draft, dslot, dcount))


def test_ava_overlaps_pair_intersecting_reads(tmp_path):
    cfg, mix = tiny_mix("ecoli-k12-ont-r9", "ava-50kb")
    job = synth.make_job(str(tmp_path), cfg, mix, 9, 0)
    lengths = {}
    with open(job.reads, "rb") as fh:
        lines = fh.read().split(b"\n")
    for k in range(0, len(lines) - 3, 4):
        lengths[k // 4] = len(lines[k + 1])
    with open(job.overlaps) as fh:
        rows = [line.split() for line in fh]
    assert rows
    pairs = set()
    for r in rows:
        a, b = int(r[0]) - 1, int(r[1]) - 1
        assert a != b and (b, a) not in pairs
        pairs.add((a, b))
        assert int(r[7]) == lengths[a] and int(r[11]) == lengths[b]
        assert 0 <= int(r[5]) < int(r[6]) <= lengths[a]
        assert 0 <= int(r[9]) < int(r[10]) <= lengths[b]
    assert job.fragment_correction and job.reads == job.targets
    assert set(job.truth) == {f"read{k}r" for k in lengths}
    assert os.path.getsize(job.overlaps) > 0
