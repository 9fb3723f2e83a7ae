"""Seconds the polisher waited on the ingest plane (the port's
``ingest_wait_s`` counter, summed over the window's jobs) per Mbp of
targets."""

from portbench.reading import per_mbp


def read(run):
    vals = [j.registry.get("ingest_wait_s") for j in run.jobs]
    if not vals or any(v is None for v in vals):
        return None
    return per_mbp(run, sum(vals))
