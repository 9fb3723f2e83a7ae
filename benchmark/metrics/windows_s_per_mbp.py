"""The logger's "transformed data into windows" seconds, summed over the
window's jobs, per Mbp of targets."""

from portbench.reading import per_mbp, phase_s


def read(run):
    return per_mbp(run, phase_s(run, "transformed data into windows"))
