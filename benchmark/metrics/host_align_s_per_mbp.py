"""Seconds of the host aligner on the overlaps the card's routes do not
take, with their operand preparation (the port's ``ovl_host_align_s``
counter), summed over the window's jobs, per Mbp of targets; None where
no job recorded it."""

from portbench.reading import per_mbp


def read(run):
    vals = [j.registry.get("ovl_host_align_s") for j in run.jobs]
    if all(v is None for v in vals):
        return None
    return per_mbp(run, sum(v for v in vals if v is not None))
