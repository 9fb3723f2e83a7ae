"""A Python model of T1's windowed walk (csrc/nw_traceback.cu), step for
step: its windows (``kernels.TB_WINDOW``, placed by
``kernels.traceback_band``), the exit rule and the prefetch, with the
plane read only through the windows. It gives the kernel's outputs and
its refill counts (windows entered and misses a lane), so the CPU tests
hold the window logic against the plain traceback, and the card tests
and chip numbers can be held against its counts.
"""

import numpy as np

from racon_tpu_torch.ops import kernels
from racon_tpu_torch.ops.cigar import DIAG, LEFT, UP
from racon_tpu_torch.ops.flat import PAD_OP

# Why a window's walk stopped (the kernel's Exit).
FULL, EDGE, TOP, MISS = range(4)


class _Window:
    """A window anchored at (i0, j0): rows i0 .. i0 - nr + 1, each a band
    of C bytes of the flat plane from column ``lo[r]`` (bytes outside
    the plane are -1, which no step may read)."""

    def __init__(self, flat, b, B, Lt, i0, j0, base_mod):
        R, C, _ = kernels.TB_WINDOW
        self.i0 = i0
        self.nr = min(R, i0)
        starts = [((i0 - 1 - r) * B + b) * Lt for r in range(self.nr)]
        lo = kernels.traceback_band(j0, [base_mod + g for g in starts])
        self.lo = lo
        self.rows = []
        for g, c0 in zip(starts, lo):
            e = np.arange(g + c0, g + c0 + C)
            ok = (e >= 0) & (e < flat.size)
            self.rows.append(np.where(ok, flat[np.clip(e, 0, flat.size - 1)],
                                      -1))


def windowed_traceback(dirs, lq, lt, L, base_mod=0):
    """(ops u8 [B, L], n i32 [B], refills i32 [B, 2]) of the windowed
    walk over dirs u8 [Lq, B, Lt] (numpy or CPU tensors); ``base_mod`` is
    the plane's address modulo 32, which places the bands."""
    dirs = np.asarray(dirs)
    lq, lt = np.asarray(lq), np.asarray(lt)
    Lq, B, Lt = dirs.shape
    flat = dirs.reshape(-1).astype(np.int64)
    R, C, _ = kernels.TB_WINDOW
    ops = np.full((B, L), PAD_OP, np.uint8)
    n_out = np.zeros(B, np.int32)
    refills = np.zeros((B, 2), np.int32)
    for b in range(B):
        i = int(min(max(lq[b], 0), Lq))
        j = int(min(max(lt[b], 0), Lt))
        steps = []
        n = n_win = n_miss = 0
        cur = pf = None
        enter = True
        while len(steps) < L and i > 0 and j > 0:
            if enter:
                if (pf is not None and i == pf.i0 and
                        0 <= j - 1 - pf.lo[0] < C):
                    cur = pf
                else:
                    cur = _Window(flat, b, B, Lt, i, j, base_mod)
                n_win += 1
                pf = None
                if cur.nr == R and i - R >= 1 and j - R >= 1:
                    pf = _Window(flat, b, B, Lt, i - R, j - R, base_mod)
            r = cur.i0 - i
            cap = min(kernels.TB_RING, L - len(steps))
            k = 0
            while True:
                if k == cap:
                    why = FULL
                    break
                if i == 0 or j == 0:
                    why = EDGE
                    break
                if r == cur.nr:
                    why = TOP
                    break
                c = j - 1 - cur.lo[r]
                if not 0 <= c < C:
                    why = MISS
                    break
                d = int(cur.rows[r][c])
                assert d >= 0, "the walk read outside the plane"
                steps.append(d)
                k += 1
                n += d != PAD_OP
                if d in (DIAG, UP):
                    i -= 1
                    r += 1
                if d in (DIAG, LEFT):
                    j -= 1
            n_miss += why == MISS
            enter = why != FULL
        if len(steps) < L and (i == 0) != (j == 0):
            k = min(i + j, L - len(steps))
            steps.extend([LEFT if i == 0 else UP] * k)
            n += k
        row = np.asarray(steps, np.uint8)[::-1]
        ops[b, L - len(row):] = row
        n_out[b] = n
        refills[b] = (n_win, n_miss)
    return ops, n_out, refills
