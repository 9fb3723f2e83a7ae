"""The overlap layer's step readers (``card_route_s_per_mbp``,
``host_align_s_per_mbp``, ``bp_walk_s_per_mbp``) on a hand-built traced
run: each sums its counter over the window's jobs, divides by the Mbp of
their targets, counts a job without the key as 0, and gives None where
no job has it (a program that does not record the step)."""

import pytest

from portbench import jobs, spec

READERS = {"card_route_s_per_mbp": "ovl_card_s",
           "host_align_s_per_mbp": "ovl_host_align_s",
           "bp_walk_s_per_mbp": "ovl_walk_s"}


class Run:
    """What the readers see of run.py's TracedRun."""

    def __init__(self, registries, target_bases):
        self.jobs = []
        for reg, bases in zip(registries, target_bases):
            j = jobs.JobRun(0, 0, b"", "", 0.0, 1.0)
            j.registry = reg
            j.target_bases = bases
            self.jobs.append(j)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_sums_over_jobs_per_mbp(name):
    key = READERS[name]
    read = spec.metric_reader(name).read
    run = Run([{key: 3.0, "align_phase_seconds": 9.0}, {key: 1.5}],
              [250_000, 500_000])
    assert read(run) == pytest.approx(4.5 / 0.75)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_counts_a_job_without_the_step_as_zero(name):
    key = READERS[name]
    read = spec.metric_reader(name).read
    run = Run([{"ingest_wait_s": 1.0}, {key: 2.0}], [1_000_000, 1_000_000])
    assert read(run) == pytest.approx(1.0)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_gives_none_where_no_job_has_the_key(name):
    read = spec.metric_reader(name).read
    others = {k: 1.0 for k in READERS.values() if k != READERS[name]}
    assert read(Run([others, {}], [250_000, 250_000])) is None
    assert read(Run([], [])) is None


def test_each_reader_is_declared_for_its_cells():
    bench = spec.load_benchmark()
    metrics = {m["name"]: m for m in bench["per_layer"]}
    both = ["ecoli_ont.polish", "ecoli_ont.correct_ava"]
    assert metrics["card_route_s_per_mbp"]["workloads"] == both
    assert metrics["host_align_s_per_mbp"]["workloads"] == both
    assert metrics["bp_walk_s_per_mbp"]["workloads"] == \
        ["ecoli_ont.polish", "yeast_clr.polish_sam", "ecoli_ont.correct_ava"]
    for name in READERS:
        m = metrics[name]
        assert (m["unit"], m["better"], m["source"], m["layer"],
                m["moves"]) == ("s/Mbp", "lower", "program_counter",
                                "overlap alignment", "polished_kbp_per_s")
