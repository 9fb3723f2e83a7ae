"""The logger's "aligned overlaps" seconds, summed over the window's
jobs, per Mbp of targets (it includes the reverse-complement
transmute before the alignment)."""

from portbench.reading import per_mbp, phase_s


def read(run):
    return per_mbp(run, phase_s(run, "aligned overlaps"))
