"""Helpers the per-layer metric readers share (``metrics/*.py``).

A reader gets the traced run's record (``TracedRun`` in run.py): the
window's jobs (``JobRun`` with ``phases()``, ``registry``,
``host_clock``, ``target_bases``, ``n_windows``), the device trace, the
K1 and K3 launches and the kernel counts. It returns a number, or None
when the run has nothing to read, and the metric is then left out.
"""

from __future__ import annotations

from typing import Optional

from portbench import peaks


def target_mbp(run) -> float:
    return sum(j.target_bases for j in run.jobs) / 1e6


def phase_s(run, phase: str) -> Optional[float]:
    vals = [j.phases().get(phase) for j in run.jobs]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals)


def per_mbp(run, seconds: Optional[float]) -> Optional[float]:
    mbp = target_mbp(run)
    if seconds is None or mbp <= 0:
        return None
    return seconds / mbp


def roofline_pct(run, kernel: str) -> Optional[float]:
    """100 x (summed least time of every launch) / (summed device time of
    the kernel's symbol), or None where the kernel did not run."""
    launches = run.launches.get(kernel) or []
    counts = run.counts[kernel]
    device_s = run.trace.kernel_seconds(counts.SYMBOL)
    if not launches or device_s <= 0:
        return None
    least = sum(peaks.bound_s(*counts.count(launch)) for launch in launches)
    return 100.0 * least / device_s
