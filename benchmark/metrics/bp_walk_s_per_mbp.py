"""Seconds of the breaking-point walk over every overlap (the port's
``ovl_walk_s`` counter; the whole CIGAR walk where overlaps come with
CIGARs), summed over the window's jobs, per Mbp of targets; None where
no job recorded it."""

from portbench.reading import per_mbp


def read(run):
    vals = [j.registry.get("ovl_walk_s") for j in run.jobs]
    if all(v is None for v in vals):
        return None
    return per_mbp(run, sum(v for v in vals if v is not None))
