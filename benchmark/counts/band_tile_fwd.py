"""K3, ``racon_band_tile_fwd`` (csrc/band_fwd.cu): one T-row tile of the
tiled overlap forward, with an explicit DP frontier.

Counted from each launch's real lanes (lq > 1) that still have rows in
the tile: rows = min(lq - i0, T). Each input byte is read once (the
lane's W + rows target bytes, rows query bytes, klo and lq, and the
frontier it reads: prev, uc and hlast, 3 x 4 W bytes) and each output
byte written once (rows of cells, + the u8 predecessor plane at k >= 2,
+ the u16 one at k = 4, and the frontier it writes, 3 x 4 W bytes). The
tile runs K1's row body: 40 integer operations a cell at k = 2, 50 at
k = 4.
"""

SYMBOL = "band_tile_kernel"
# kernels.fw_dirs_band_tile(tband, qT, klo, lq, i0, prev, uc, hlast, *,
#                           ..., W, nxt_k, out)
LAUNCH = "fw_dirs_band_tile"
OPS_PER_CELL = {2: 40, 4: 50}


def count(launch: dict):
    """(int32 operations, bytes) of one launch."""
    args, kw = launch["args"], launch["kwargs"]
    W, k = kw["W"], kw["nxt_k"]
    T, i0 = args[1]["shape"][0], args[4]
    planes = 1 + (k >= 2) + 2 * (k >= 4)
    ops = nbytes = 0
    for lq in args[3]["values"]:
        rows = min(lq - i0, T)
        if lq <= 1 or rows <= 0:
            continue
        cells = rows * W
        ops += cells * OPS_PER_CELL[k]
        nbytes += (W + rows) + rows + 8 + 12 * W + cells * planes + 12 * W
    return ops, nbytes
