"""Banded NW forward in per-lane diagonal coordinates — the plain PyTorch
version.

Counterpart of the JAX package's ``ops/pallas/band_kernel.py``
(``fw_dirs_band_xla`` and the Pallas ``_kernel``); the CUDA kernel that
replaces the latter is ``csrc/band_fwd.cu`` (wrapper in ops/kernels.py).

Band column x of row i is target column

    j = i + klo_b + x,      klo_b = min(0, lt_b - lq_b) - wl_b,
    wl_b = (W - 1 - |lt_b - lq_b|) // 2

so the diag neighbour of (i, x) is (i-1, x), the up neighbour (i-1, x+1)
and the left-gap chain a prefix max along x. The caller pre-shifts each
lane's target: ``tband[b, y] = anchor_b[klo_b + y]`` for y in
[0, W + Lq), fill 7 outside the slice.

Outputs (layout [Lq, B, W], the "band" walk layout):

- cells u8: ``dir | consumer_dir << 2 | up_run << 4`` (up_run saturates
  at U_SAT);
- nxt u8 (k >= 2): the predecessor's ``up_run << 2 | consumer_dir``;
- nxt2 u16 (k = 4): hops 2 (low byte) and 3 (high byte);
- hlast i32[B, W]: the scores of row lq_b, for the escape certificate.
"""

from __future__ import annotations

import torch

from racon_tpu_torch.ops.cigar import DIAG, UP, LEFT
from racon_tpu_torch.ops.flat import NEG, U_SAT


def uc_boundary(nxt_k: int = 2) -> int:
    """Packed row-0 / out-of-band frontier fill for a ``nxt_k``-deep
    predecessor plane: every 6-bit hop field and the base (U, C) pair
    decode as (up_run 0, consumer LEFT)."""
    v = LEFT
    for _ in range(max(int(nxt_k) - 1, 1)):
        v = (v << 6) | LEFT
    return v


def band_geometry(lq: torch.Tensor, lt: torch.Tensor, W: int):
    """Per-lane (klo, wl) for a W-slot band (int32 vectors)."""
    delta = lt - lq
    wl = torch.div(W - 1 - delta.abs(), 2, rounding_mode="floor")
    klo = torch.clamp(delta, max=0) - wl
    return klo.to(torch.int32), wl.to(torch.int32)


def band_targets(flat: torch.Tensor, base: torch.Tensor, klo: torch.Tensor,
                 lt: torch.Tensor, PW: int, origin: int = 0) -> torch.Tensor:
    """Pre-shifted target windows u8[B, PW]: ``tband[b, y] =
    flat[base_b + klo_b + origin + y]`` where ``klo_b + origin + y`` lies
    in [0, lt_b), else 7 (a code no query base equals)."""
    rel = (klo.long()[:, None] + origin +
           torch.arange(PW, device=flat.device)[None, :])
    okb = (rel >= 0) & (rel < lt.long()[:, None])
    idx = torch.clamp(base.long()[:, None] + rel, 0, flat.numel() - 1)
    return torch.where(okb, flat[idx], 7).to(torch.uint8)


def fw_dirs_band_plain(tband: torch.Tensor, qT: torch.Tensor,
                       klo: torch.Tensor, lq: torch.Tensor, *, match: int,
                       mismatch: int, gap: int, W: int, nxt_k: int = 2):
    """Row loop over [B, W] int32 tensors. Returns ``(cells, nxt, nxt2,
    hlast)``; ``nxt`` is None at k=1, ``nxt2`` None below k=4."""
    B = tband.shape[0]
    Lq = qT.shape[0]
    dev = tband.device
    k = int(nxt_k)
    P = row0_scores(klo, W, gap)
    U = torch.zeros((B, W), dtype=torch.int32, device=dev)
    C = torch.full((B, W), LEFT, dtype=torch.int32, device=dev)
    N = C.clone()
    planes = _planes(Lq, B, W, k, dev)
    P, hl, *_ = _band_rows(tband, qT, klo, lq, 0, P, P.clone(), U, C, N,
                           N.clone(), N.clone(), planes, match=match,
                           mismatch=mismatch, gap=gap, W=W, k=k)
    return planes + (hl,)


def row0_scores(klo: torch.Tensor, W: int, gap: int) -> torch.Tensor:
    """Row 0 of the band: ``j * gap`` at target column j >= 0, NEG before
    it (int32[B, W]); also the initial hlast."""
    xr = torch.arange(W, dtype=torch.int32, device=klo.device)[None, :]
    j0 = klo.to(torch.int32)[:, None] + xr
    return torch.where(j0 >= 0, j0 * gap, NEG).to(torch.int32)


def fw_dirs_band_tile_plain(tband: torch.Tensor, qT: torch.Tensor,
                            klo: torch.Tensor, lq: torch.Tensor, i0: int,
                            prev: torch.Tensor, uc: torch.Tensor,
                            hlast: torch.Tensor, *, match: int,
                            mismatch: int, gap: int, W: int,
                            nxt_k: int = 2, out=None):
    """One T-row query tile of the banded forward with an explicit DP
    frontier — the plain version of the JAX package's
    ``fw_dirs_band_xla_tile`` (Pallas ``_kernel_tile``).

    Args:
      tband: u8[B, W+T], this tile's pre-shifted targets:
        ``tband[b, y] = target_b[klo_b + i0 + y]`` (fill 7).
      qT: u8[T, B], this tile's query rows.
      klo, lq: int32[B]; this tile's band origin and the query lengths.
      i0: 0-based global row origin; rows i0+1 .. i0+T are computed.
      prev, uc, hlast: int32[B, W] frontier after row i0: scores, packed
        ``N3 << 18 | N2 << 12 | N << 6 | U << 2 | C`` metadata (the hop-2/3
        fields at k=4 only) and the running capture of row lq_b.
      nxt_k: 2 or 4.
      out: optional ``(cells, nxt, nxt2)`` stitched planes [Lq, B, W]; the
        tile writes rows [i0, i0+T) of them (``nxt2`` None below k=4).

    Returns ``(cells, nxt, nxt2, hlast, prev, uc)``: the tile's [T, B, W]
    planes (views into ``out`` when given) and the frontier after row
    i0+T in the same band coordinates. With the row-0 frontier
    (:func:`row0_scores`, :func:`uc_boundary`) and i0 = 0 a single tile
    equals :func:`fw_dirs_band_plain`.
    """
    k = int(nxt_k)
    if k not in (2, 4):
        raise ValueError("[racon_tpu_torch::band] tile depth must be 2 or 4")
    B = tband.shape[0]
    T = qT.shape[0]
    uc = uc.to(torch.int32)
    if out is None:
        planes = _planes(T, B, W, k, tband.device)
    else:
        planes = tuple(None if p is None else p[i0:i0 + T] for p in out)
    P, hl, U, C, N, N2, N3 = _band_rows(
        tband, qT, klo, lq, i0, prev.to(torch.int32), hlast.to(torch.int32),
        (uc >> 2) & 0xF, uc & 3, (uc >> 6) & 0x3F, (uc >> 12) & 0x3F,
        (uc >> 18) & 0x3F, planes, match=match, mismatch=mismatch, gap=gap,
        W=W, k=k)
    ucout = (N << 6) + (U << 2) + C
    if k >= 4:
        ucout = ucout + (N3 << 18) + (N2 << 12)
    return planes + (hl, P, ucout)


def _planes(rows: int, B: int, W: int, k: int, dev):
    cells = torch.empty((rows, B, W), dtype=torch.uint8, device=dev)
    nxt = (torch.empty((rows, B, W), dtype=torch.uint8, device=dev)
           if k >= 2 else None)
    nxt2 = (torch.empty((rows, B, W), dtype=torch.uint16, device=dev)
            if k >= 4 else None)
    return cells, nxt, nxt2


def _band_rows(tband, qT, klo, lq, i0, P, hl, U, C, N, N2, N3, planes, *,
               match, mismatch, gap, W, k):
    """The row recurrence over local rows 1..T (global i0+1 .. i0+T),
    writing the planes; returns the frontier (P, hl, U, C, N, N2, N3)."""
    cells, nxt, nxt2 = planes
    B = tband.shape[0]
    dev = tband.device
    i32 = torch.int32
    xr = torch.arange(W, dtype=i32, device=dev)[None, :]
    t32 = tband.to(i32)
    q32 = qT.to(i32)
    j0 = klo.to(i32)[:, None] + xr
    lqc = lq.to(i32)[:, None]
    n2w = None if nxt2 is None else nxt2.view(torch.int16)
    negcol = torch.full((B, 1), NEG, dtype=i32, device=dev)
    leftcol = torch.full((B, 1), LEFT, dtype=i32, device=dev)
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)

    def shift_up(A, fill):
        return torch.cat([A[:, 1:], fill], dim=1)

    def shift_left(A):
        return torch.cat([leftcol, A[:, :-1]], dim=1)

    for rl in range(1, qT.shape[0] + 1):
        i = i0 + rl
        tw = t32[:, rl - 1:rl - 1 + W]
        jcol = i + j0
        sub = torch.where(tw == q32[rl - 1][:, None], match, mismatch)
        sub = torch.where(jcol >= 1, sub, NEG).to(i32)
        diag = P + sub                       # >= 2*NEG = -2^31, no wrap
        up = shift_up(P, negcol) + gap
        tmp = torch.maximum(diag, up)
        tmp = torch.where(jcol == 0, i * gap, tmp).to(i32)
        tmp = torch.clamp(tmp, min=NEG)
        jg = jcol * gap
        f = torch.clamp(torch.cummax(tmp - jg, dim=1).values, min=NEG)
        h = torch.where(jcol >= 0, f + jg, NEG).to(i32)
        d = torch.where(h == diag, DIAG,
                        torch.where(h == up, UP, LEFT)).to(i32)
        isup = d == UP
        Un = torch.where(isup, torch.clamp(shift_up(U, zcol) + 1,
                                           max=U_SAT), 0)
        Cn = torch.where(isup, shift_up(C, leftcol), d)
        ucnow = (Un << 2) + Cn
        # k-step predecessor metadata: UP inherits hop m from the cell
        # above, DIAG takes the previous row's same-slot hop m-1, LEFT
        # this row's just-computed hop m-1 at slot x-1.
        Nn = torch.where(isup, shift_up(N, leftcol),
                         torch.where(d == DIAG, (U << 2) + C,
                                     shift_left(ucnow)))
        cells[rl - 1] = (d + (Cn << 2) + (Un << 4)).to(torch.uint8)
        if k >= 2:
            nxt[rl - 1] = Nn.to(torch.uint8)
        if k >= 4:
            N2n = torch.where(isup, shift_up(N2, leftcol),
                              torch.where(d == DIAG, N, shift_left(Nn)))
            N3n = torch.where(isup, shift_up(N3, leftcol),
                              torch.where(d == DIAG, N2, shift_left(N2n)))
            n2w[rl - 1] = ((N3n << 8) + N2n).to(torch.int16)
            N2, N3 = N2n, N3n
        hl = torch.where(lqc == i, h, hl)
        P, U, C, N = h, Un, Cn, Nn
    return P, hl, U, C, N, N2, N3
