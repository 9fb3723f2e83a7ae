"""The metric arithmetic on hand-made records: the rate over whole cycles
of jobs, QV with its +1, the idle share and its labels from a synthetic
timeline, and the K1 and K3 counts against hand counts with padded lanes
left out."""

import math

import pytest

from portbench import accuracy, jobs, peaks, profile, spec


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_no_cycle_starts_after_the_window_and_the_rate_is_whole_jobs():
    clock = Clock()
    cost = {0: 10.0, 1: 4.0, 2: 7.0}          # unequal distinct jobs

    def run_one(i, k):
        t0 = clock.t
        clock.t += cost[k]
        r = jobs.JobRun(k, 0 if i != 1 else 1, b"", "", t0, clock.t)
        r.target_bases = 1_000_000
        return r

    runs = jobs.run_window(run_one, 3, 25.0, clock)
    # Cycles start at 0 and 21 s; none at 42 s, past the 25 s asked, and
    # each distinct job runs twice.
    assert [r.t0 - 100.0 for r in runs] == [0.0, 10.0, 14.0, 21.0, 31.0,
                                            35.0]
    assert [r.input_index for r in runs] == [0, 1, 2, 0, 1, 2]
    # Job 1 failed: 5 Mbp completed over the 42 s window.
    assert jobs.kbp_per_s(runs) == pytest.approx(5000.0 / 42.0)


def test_qv_keeps_an_error_free_output_finite():
    assert accuracy.qv(0, 1_000_000) == pytest.approx(60.0)
    assert accuracy.qv(9, 1_000_000) == pytest.approx(50.0)
    assert math.isfinite(accuracy.qv(0, 10))


def test_edit_distance_helper_matches_a_plain_dp():
    ed = accuracy.EditDistance(spec.ROOT)

    def plain(a, b):
        prev = list(range(len(b) + 1))
        for i in range(1, len(a) + 1):
            cur = [i] + [0] * len(b)
            for j in range(1, len(b) + 1):
                cur[j] = min(prev[j - 1] + (a[i - 1] != b[j - 1]),
                             prev[j] + 1, cur[j - 1] + 1)
            prev = cur
        return prev[-1]

    cases = [(b"", b"ACGT"), (b"ACGT", b"ACGT"), (b"ACGTACGT", b"AGTTACG"),
             (b"A" * 300, b"C" * 10 + b"A" * 250)]
    for a, b in cases:
        assert ed(a, b) == plain(a, b)
    assert accuracy.job_errors(ed, [("x", b"ACGA")], {"x": b"ACGT"}) == (1, 4)


def test_idle_share_and_gap_labels_from_a_synthetic_timeline():
    tr = profile.DeviceTrace(10.0, [("k1", 1.0, 2.0), ("copy", 1.5, 3.0),
                                    ("k3", 6.0, 7.0)])
    assert tr.busy_s() == pytest.approx(3.0)
    assert tr.gaps() == [(0.0, 1.0), (3.0, 6.0), (7.0, 10.0)]
    read = spec.metric_reader("device_idle_pct").read

    class Run:
        trace = tr
    assert read(Run) == pytest.approx(70.0)
    spans = [{"kind": "phase", "name": "windows", "s": 2.5, "e": 6.5},
             {"kind": "chunk", "name": "chunk3", "s": 4.0, "e": 5.0}]
    b = profile.breakdown(tr, spans)
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"no port span": 4.0, "chunk:chunk3": 3.0})
    assert b["device_ops"][0][0] == "copy"


def test_k1_count_takes_real_lanes_and_rows_only():
    k1 = spec.kernel_counts()["band_fwd"]
    launch = {"args": [{"shape": [4, 896]}, {"shape": [640, 4]},
                       {"shape": [4]}, {"shape": [4],
                                        "values": [500, 1, 0, 300]}],
              "kwargs": {"W": 256, "nxt_k": 4}}  # two padding lanes
    ops, nbytes = k1.count(launch)
    cells = (500 + 300) * 256
    assert ops == cells * 50
    assert nbytes == ((256 + 500) + 500 + 8 + 500 * 256 * 4 + 4 * 256 +
                      (256 + 300) + 300 + 8 + 300 * 256 * 4 + 4 * 256)


def test_k3_count_takes_the_rows_each_lane_has_in_the_tile():
    k3 = spec.kernel_counts()["band_tile_fwd"]
    launch = {"args": [{"shape": [3, 3584]}, {"shape": [2048, 3]},
                       {"shape": [3]}, {"shape": [3],
                                        "values": [5000, 9000, 1]}, 4096],
              "kwargs": {"W": 1536, "nxt_k": 2}}
    ops, nbytes = k3.count(launch)
    rows = [5000 - 4096, 2048]
    assert ops == sum(rows) * 1536 * 40
    assert nbytes == sum((1536 + r) + r + 8 + 24 * 1536 + r * 1536 * 2
                         for r in rows)


def test_roofline_is_least_time_over_device_time():
    from portbench.reading import roofline_pct

    class Run:
        launches = {"band_fwd": [{"args": [{}, {}, {}, {"values": [100]}],
                                  "kwargs": {"W": 128}}]}
        counts = spec.kernel_counts()
        trace = profile.DeviceTrace(1.0, [("band_fwd_kernel<2,2>", 0.0,
                                           1e-3)])
    ops, nbytes = Run.counts["band_fwd"].count(Run.launches["band_fwd"][0])
    want = 100 * peaks.bound_s(ops, nbytes) / 1e-3
    assert roofline_pct(Run, "band_fwd") == pytest.approx(want)
    Run.launches = {"band_fwd": []}
    assert roofline_pct(Run, "band_fwd") is None
