"""K3 (``racon_band_tile_fwd``): its launches' least time over its device
time in the profiler's trace (counts/band_tile_fwd.py,
portbench/peaks.py)."""

from portbench.reading import roofline_pct


def read(run):
    return roofline_pct(run, "band_tile_fwd")
