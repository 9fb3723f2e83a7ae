"""Windows polished per second of the logger's "generated consensus"
phase, both summed over the window's jobs."""

from portbench.reading import phase_s


def read(run):
    seconds = phase_s(run, "generated consensus")
    if not seconds:
        return None
    return sum(j.n_windows for j in run.jobs) / seconds
