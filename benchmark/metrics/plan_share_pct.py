"""The host clock's ``plan`` part (``device_poa.ChunkPlan`` and
``packed_bufs``) as a share of the "generated consensus" seconds, both
summed over the window's jobs."""

from portbench.reading import phase_s


def read(run):
    seconds = phase_s(run, "generated consensus")
    plan = sum(j.host_clock.get("plan", 0.0) for j in run.jobs)
    if not seconds or plan <= 0:
        return None
    return 100.0 * plan / seconds
