"""The share of the window in which no kernel, copy or memset ran on the
card: 100 x (1 - union of the profiler's device intervals / window)."""


def read(run):
    if run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
