"""Column-walk traceback: per-anchor-position vote channels in one pass.

Port of the JAX package's ``ops/colwalk.py::col_walk``. The forward
kernels pack, per DP cell, ``dir | consumer_dir << 2 | up_run << 4``;
in forward order a global alignment's ops partition into blocks
``[UP run at gap j][DIAG/LEFT consuming column j]``, so one packed-byte
read per anchor position undoes a whole block. The walk runs over the
anchor positions p = LA+1 .. 0 and each lane is active while
j = p - t_off lies in [0, lt]; emissions are keyed by anchor position.

With the ``nxt`` plane one read undoes two positions, with ``nxt2`` as
well four (``chain_len``). The walk is a chain of dependent gathers —
an XLA scan in the reference, one Python loop over all lanes here. This
loop is the plain version of the CUDA walk csrc/col_walk.cu (wrapper
ops/kernels.py::col_walk_kernel, both layouts), which the overlap
aligner and the consensus engine run on the card; the loop runs only
for CPU tensors and in the tests.

``up_run`` saturates at U_SAT; a saturated read (or a leading insertion
longer than K_INS) raises the lane's ``sat`` flag and its window takes
the redo route.
"""

from __future__ import annotations

import torch

from racon_tpu_torch.ops.cigar import DIAG, LEFT
from racon_tpu_torch.ops.flat import PAD_OP, U_SAT

UNROLL = 4


def chain_len(LA: int, k: int) -> int:
    """Dependent-gather count of the walk at anchor padding LA and depth
    k (1, 2 or 4): ceil((LA + 2) / k)."""
    if k not in (1, 2, 4):
        raise ValueError("[racon_tpu_torch::colwalk] walk depth must be 1/2/4")
    return -(-(int(LA) + 2) // int(k))


def col_walk(cells, lq, lt, klo, t_off, *, LA: int, layout: str,
             nxt=None, nxt2=None, tile_klo=None, tile_len: int = 0,
             emit=torch.int16):
    """Walk packed cells over the anchor-position grid.

    Args:
      cells: uint8 packed cells, layout "band" [Lq, B, W] or "flat"
        [Lq, B, Lt].
      lq, lt, t_off: int32[B]; klo: int32[B] band origin (None for flat,
        ignored when ``tile_klo`` is given).
      nxt, nxt2: the k=2 / k=4 predecessor planes of the band forward.
      tile_klo: int32[n_tiles, B] per-tile band origins of the tiled
        overlap forward: stored row r maps to target columns through the
        origin of tile ``r // tile_len``.
      emit: dtype of the channels — int16 (consensus) or int32 (tiled
        overlaps, whose query indices outgrow int16).

    Returns dict of ``emit`` [B, LA+2] arrays ``ins_len``, ``qstart``,
    ``op_c``, ``qi_c`` and ``sat`` bool[B] (see the JAX package's
    docstring for their meaning).
    """
    if layout not in ("band", "flat"):
        raise ValueError(f"[racon_tpu_torch::colwalk] bad layout {layout!r}")
    if nxt2 is not None and nxt is None:
        raise ValueError("[racon_tpu_torch::colwalk] nxt2 requires nxt")
    if tile_klo is not None and tile_len <= 0:
        raise ValueError("[racon_tpu_torch::colwalk] tile_klo needs tile_len")
    Lq, B, W = cells.shape
    dev = cells.device
    i64 = torch.int64
    c1 = cells.reshape(-1)
    n1 = None if nxt is None else nxt.reshape(-1)
    n2 = None if nxt2 is None else nxt2.view(torch.int16).reshape(-1)
    lt = lt.to(i64)
    t_off = t_off.to(i64)
    kl = None if klo is None else klo.to(i64)
    tk = None if tile_klo is None else tile_klo.to(i64).reshape(-1)
    lane = torch.arange(B, dtype=i64, device=dev)
    lane_off = lane * W
    i = lq.to(i64)
    sat = torch.zeros(B, dtype=torch.bool, device=dev)

    def cell_idx(i, jc):
        r = torch.clamp(i - 1, min=0)
        if layout == "flat":
            col = torch.clamp(jc - 1, min=0)
        else:
            if tk is not None:
                tl = torch.clamp(torch.div(r, tile_len, rounding_mode="floor"),
                                 0, tile_klo.shape[0] - 1)
                kl_r = torch.take(tk, tl * B + lane)
            else:
                kl_r = kl
            col = torch.clamp(jc - i - kl_r, 0, W - 1)
        return r * (B * W) + lane_off + col

    T = (LA + 1 + UNROLL) // UNROLL
    out = torch.empty((B, UNROLL * T, 4), dtype=emit, device=dev)

    def undo(i, sat, p, u_raw, cdir_raw):
        j = p - t_off
        active = (j >= 0) & (j <= lt)
        jc = torch.minimum(torch.clamp(j, min=0), lt)
        readable = active & (i >= 1) & (jc >= 1)
        u = torch.where(readable, u_raw, 0)
        cdir = torch.where(readable, cdir_raw, LEFT)
        is_j0 = active & (j == 0)
        sat = sat | (readable & (u == U_SAT)) | (is_j0 & (i > U_SAT - 1))
        u_eff = torch.where(is_j0, i, u)
        top = i - u_eff
        cons = torch.where(top <= 0, LEFT, cdir)
        cons = torch.where(is_j0, PAD_OP, cons)
        qi = top - (cons == DIAG).to(i64)
        out[:, p] = torch.stack([u_eff, top, cons, qi], dim=-1).to(emit)
        i_next = torch.where(active, torch.where(is_j0, 0, qi), i)
        return i_next, sat

    def index(i, p):
        j = p - t_off
        return j, cell_idx(i, torch.minimum(torch.clamp(j, min=0), lt))

    for t in reversed(range(T)):
        p0 = UNROLL * t
        if n1 is None:
            for k in reversed(range(UNROLL)):
                _, idx = index(i, p0 + k)
                pv = torch.take(c1, idx).to(i64)
                i, sat = undo(i, sat, p0 + k, pv >> 4, (pv >> 2) & 3)
        elif n2 is None:
            for k in (UNROLL - 1, UNROLL - 3):
                p_hi = p0 + k
                j, idx = index(i, p_hi)
                pv = torch.take(c1, idx).to(i64)
                nv = torch.take(n1, idx).to(i64)
                active_hi = (j >= 0) & (j <= lt)
                i, sat = undo(i, sat, p_hi, pv >> 4, (pv >> 2) & 3)
                u_lo = torch.where(active_hi, nv >> 2, pv >> 4)
                c_lo = torch.where(active_hi, nv & 3, (pv >> 2) & 3)
                i, sat = undo(i, sat, p_hi - 1, u_lo, c_lo)
        else:
            p_hi = p0 + UNROLL - 1
            j, idx = index(i, p_hi)
            pv = torch.take(c1, idx).to(i64)
            nv = torch.take(n1, idx).to(i64)
            n2v = torch.take(n2, idx).to(i64) & 0xFFFF
            hops_u = torch.stack([pv >> 4, nv >> 2, (n2v >> 2) & 0xF,
                                  (n2v >> 10) & 0xF])
            hops_c = torch.stack([(pv >> 2) & 3, nv & 3, n2v & 3,
                                  (n2v >> 8) & 3])
            # First active position of the quad (entry edge): the clipped
            # gather read cell (i, lt), which position a would fetch.
            a = torch.clamp(j - lt, 0, 3)
            for m in range(4):
                hop = torch.clamp(m - a, 0, 3)[None]
                u_m = hops_u.gather(0, hop)[0]
                c_m = hops_c.gather(0, hop)[0]
                i, sat = undo(i, sat, p_hi - m, u_m, c_m)

    ch = out[:, :LA + 2]
    return {"ins_len": ch[..., 0], "qstart": ch[..., 1],
            "op_c": ch[..., 2], "qi_c": ch[..., 3], "sat": sat}
