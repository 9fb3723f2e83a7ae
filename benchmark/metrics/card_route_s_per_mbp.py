"""Seconds of the card's overlap route (the port's ``ovl_card_s``
counter: ``device_breaking_points`` from its prep through its collect),
summed over the window's jobs, per Mbp of targets; None where no job
recorded it."""

from portbench.reading import per_mbp


def read(run):
    vals = [j.registry.get("ovl_card_s") for j in run.jobs]
    if all(v is None for v in vals):
        return None
    return per_mbp(run, sum(v for v in vals if v is not None))
