"""Global alignment in plain PyTorch: Needleman-Wunsch with a linear gap,
int32 scores and ties broken DIAG > UP > LEFT at every cell.

One row of the DP matrix per step, every lane of the batch at once, in
band coordinates: lane b's row i holds columns j = i + klo[b] + c for c
in [0, BW). The left-gap chain of a row is a prefix maximum
(H[j] = g*j + max_{k<=j}(V[k] - g*k)), so a row is a handful of tensor
operations. Directions are kept for each lane's own rows only (lanes
sorted by query length, so a row's live lanes are a prefix), and the
traceback walks every lane back from (lq, lt) at once.

A band is accepted by the escape bound: any path that leaves the band
[min(0, d) - w, max(0, d) + w] (d = lt - lq) needs at least
|d| + 2(w + 1) gaps and has at most min(lq, lt) matches, so a banded
score at or above ``max(m, 0) * min(lq, lt) + g * (|d| + 2w + 2)`` is
the optimum. Lanes that fail it run again with a band their score
already certifies. A band that covers the whole matrix is exact.

Ops: 0 = DIAG (consumes query and target), 1 = UP (query only),
2 = LEFT (target only).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

DIAG, UP, LEFT = 0, 1, 2
NEG = -(1 << 29)
_PAD_Q, _PAD_T = 254, 255


def _band(lq: np.ndarray, lt: np.ndarray, w: np.ndarray):
    d = lt - lq
    klo = np.maximum(np.minimum(0, d) - w, -lq)
    khi = np.minimum(np.maximum(0, d) + w, lt)
    return klo, khi


def _forward(qs, ts, klo, BW, match, mismatch, gap, device, sat=None):
    """Banded forward over lanes sorted by query length (descending).
    Returns (dirs_flat u8, row_off i64[Lq+1], scores i64[B]). ``sat``
    (lo, hi) saturates every score as an integer type of that range
    would."""
    lo_s, hi_s = sat if sat else (NEG, -NEG)
    B = len(qs)
    lq = np.array([len(q) for q in qs], np.int64)
    lt = np.array([len(t) for t in ts], np.int64)
    Lq = int(lq.max())
    # q as [Lq, B] rows; tb[b, s] = t_b[klo_b + s - 1] so that row i's
    # target bases are the slice tb[:, i:i + BW].
    qm = np.full((Lq + 1, B), _PAD_Q, np.uint8)
    width = Lq + BW + 1
    tb = np.full((B, width), _PAD_T, np.uint8)
    for b in range(B):
        qm[1:lq[b] + 1, b] = qs[b]
        s0 = -int(klo[b]) + 1            # s where t index 0 lands
        lo, hi = max(s0, 0), min(s0 + lt[b], width)
        if hi > lo:
            tb[b, lo:hi] = ts[b][lo - s0:hi - s0]
    qd = torch.from_numpy(qm).to(device)
    tbd = torch.from_numpy(tb).to(device)
    klo_d = torch.from_numpy(klo.astype(np.int64)).to(device)
    cc = torch.arange(BW, dtype=torch.int64, device=device)
    gc = gap * cc                                     # g * c
    # Live lanes at row i: those with lq >= i, a prefix of the batch.
    live = np.searchsorted(-lq, -np.arange(Lq + 1), side="right")
    row_off = np.concatenate([[0], np.cumsum(live * BW)])
    dirs = torch.empty(int(row_off[-1]), dtype=torch.uint8, device=device)
    # Row 0: H[0][j] = j * g for 0 <= j <= lt (later columns never feed
    # back into earlier ones, so j > lt needs no mask). H keeps one more
    # column, always NEG: the up neighbour of the band's last cell.
    H = torch.full((B, BW + 1), NEG, dtype=torch.int64, device=device)
    j0 = klo_d[:, None] + cc[None, :]
    H[:, :BW] = torch.where(j0 >= 0, (j0 * gap).clamp(min=lo_s), NEG)
    dirs[:B * BW] = LEFT
    scores = torch.full((B,), NEG, dtype=torch.int64, device=device)
    end_c = torch.from_numpy((lt - lq - klo).astype(np.int64)).to(device)
    ends = {}
    for b in range(B):
        ends.setdefault(int(lq[b]), []).append(b)
    # Rows past this one have no cell at j <= 0 in any lane's band.
    mask_rows = int(max(-klo.min(), 0))
    for i in range(1, Lq + 1):
        n = int(live[i])
        prev = H[:n]
        sub = torch.where(tbd[:n, i:i + BW] == qd[i, :n, None], match,
                          mismatch)
        diag = prev[:, :BW] + sub
        up = prev[:, 1:] + gap
        if sat:
            diag, up = diag.clamp(lo_s, hi_s), up.clamp(lo_s, hi_s)
        V = torch.maximum(diag, up)
        if i <= mask_rows:
            j = (klo_d[:n, None] + i) + cc[None, :]
            V = torch.where(j > 0, V, torch.where(j == 0, max(i * gap, lo_s),
                                                  NEG))
        Hn = torch.cummax(V - gc, dim=1).values + gc
        if sat:
            # The left chain only adds gaps, so the low end is the one
            # to saturate; below the band's edge stays unreachable.
            Hn = torch.where(Hn > NEG // 2, Hn.clamp(min=lo_s), Hn)
        # DIAG where the diagonal gives H, else UP where the row above
        # does, else LEFT.
        out = dirs[int(row_off[i]):int(row_off[i + 1])].view(n, BW)
        torch.mul(Hn != diag, 2 - (Hn == up).to(torch.uint8), out=out)
        H[:n, :BW] = Hn
        done = ends.get(i)
        if done:
            idx = torch.tensor(done, device=device)
            scores[idx] = H[idx, end_c[idx]]
    return dirs, row_off, scores


def _traceback(dirs, row_off, klo, lq, lt, BW) -> List[np.ndarray]:
    """Every lane walked back from (lq, lt) at once, on the host; ops in
    start-to-end order, one uint8 array a lane."""
    dirs = dirs.cpu().numpy()
    B = len(lq)
    steps = int((lq + lt).max())
    i, j = lq.astype(np.int64).copy(), lt.astype(np.int64).copy()
    base = np.arange(B, dtype=np.int64) * BW - klo
    out = np.full((B, steps), 3, np.uint8)
    active = np.ones(B, bool)
    for s in range(steps - 1, -1, -1):
        d = dirs[row_off[i] + base + j - i]
        d[i == 0] = LEFT
        d[(j == 0) & (i > 0)] = UP
        d[~active] = 3
        out[:, s] = d
        i -= (d == DIAG) | (d == UP)
        j -= (d == DIAG) | (d == LEFT)
        active = (i > 0) | (j > 0)
        if not active.any():
            break
    return [row[row != 3] for row in out]


def align_batch(pairs: Sequence[Tuple[np.ndarray, np.ndarray]], match: int,
                mismatch: int, gap: int, device="cpu",
                sat=None) -> List[np.ndarray]:
    """Optimal global alignments of (query codes, target codes) pairs, in
    a certified band. ``sat`` (lo, hi) computes the scores in a narrower
    integer type with saturating adds (the control of a lower precision),
    and takes the first band uncertified."""
    B = len(pairs)
    if B == 0:
        return []
    lq = np.array([len(q) for q, _ in pairs], np.int64)
    lt = np.array([len(t) for _, t in pairs], np.int64)
    w = np.maximum(128, np.abs(lt - lq) + 64)
    out: List[np.ndarray] = [None] * B  # type: ignore[list-item]
    todo = np.arange(B)
    mmax = max(match, 0) * np.minimum(lq, lt)
    while len(todo):
        order = todo[np.argsort(-lq[todo], kind="stable")]
        klo, khi = _band(lq[order], lt[order], w[order])
        BW = int((khi - klo + 1).max())
        qs = [pairs[b][0] for b in order]
        ts = [pairs[b][1] for b in order]
        dirs, row_off, scores = _forward(qs, ts, klo, BW, match, mismatch,
                                         gap, device, sat)
        sc = scores.cpu().numpy().astype(np.int64)
        whole = (klo <= -lq[order]) & (khi >= lt[order])
        escape = mmax[order] + gap * (np.abs(lt[order] - lq[order]) +
                                      2 * w[order] + 2)
        ok = whole | (sc >= escape) | bool(sat)
        ops = _traceback(dirs, row_off, klo, lq[order], lt[order], BW)
        del dirs
        for k, b in enumerate(order):
            if ok[k]:
                out[b] = ops[k]
        retry = order[~ok]
        # The banded score is a lower bound of the optimum, so a band it
        # already certifies is accepted on the next pass.
        need = (sc[~ok] - mmax[retry]) // gap - np.abs(lt[retry] -
                                                       lq[retry]) - 2
        w[retry] = np.maximum(2 * w[retry], need // 2 + 1)
        todo = retry
    return out
