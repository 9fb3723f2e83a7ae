"""K1, ``racon_band_fwd`` (csrc/band_fwd.cu): the banded forward of the
consensus rounds and of the untiled overlap groups.

Counted from each launch's real lanes (a padding lane has lq <= 1): a
lane needs lq rows of W band cells. Each input byte is read once (the
lane's W + lq target bytes, lq query bytes, its klo and lq) and each
output byte written once (its rows of cells, + the u8 predecessor plane
at walk depth k >= 2, + the u16 one at k = 4, and its W-slot hlast row).
Integer operations per cell, counted from the kernel's row body: 30 at
k = 1, 40 at k = 2, 50 at k = 4.
"""

SYMBOL = "band_fwd_kernel"
# kernels.fw_dirs_band(tband, qT, klo, lq, *, ..., W, nxt_k)
LAUNCH = "fw_dirs_band"
OPS_PER_CELL = {1: 30, 2: 40, 4: 50}


def planes(k: int) -> int:
    return 1 + (k >= 2) + 2 * (k >= 4)


def count(launch: dict):
    """(int32 operations, bytes) of one launch."""
    W, k = launch["kwargs"]["W"], launch["kwargs"].get("nxt_k", 2)
    ops = nbytes = 0
    for lq in launch["args"][3]["values"]:
        if lq <= 1:
            continue
        cells = lq * W
        ops += cells * OPS_PER_CELL[k]
        nbytes += (W + lq) + lq + 8 + cells * planes(k) + 4 * W
    return ops, nbytes
