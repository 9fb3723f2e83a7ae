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


def fw_dirs_band_plain(tband: torch.Tensor, qT: torch.Tensor,
                       klo: torch.Tensor, lq: torch.Tensor, *, match: int,
                       mismatch: int, gap: int, W: int, nxt_k: int = 2):
    """Row loop over [B, W] int32 tensors. Returns ``(cells, nxt, nxt2,
    hlast)``; ``nxt`` is None at k=1, ``nxt2`` None below k=4."""
    B = tband.shape[0]
    Lq = qT.shape[0]
    dev = tband.device
    i32 = torch.int32
    xr = torch.arange(W, dtype=i32, device=dev)[None, :]
    t32 = tband.to(i32)
    q32 = qT.to(i32)
    klo = klo.to(i32)[:, None]
    lqc = lq.to(i32)[:, None]
    j0 = klo + xr
    P = torch.where(j0 >= 0, j0 * gap, NEG).to(i32)
    hl = P.clone()
    U = torch.zeros((B, W), dtype=i32, device=dev)
    C = torch.full((B, W), LEFT, dtype=i32, device=dev)
    N = torch.full((B, W), LEFT, dtype=i32, device=dev)
    N2 = N.clone()
    N3 = N.clone()
    k = int(nxt_k)
    cells = torch.empty((Lq, B, W), dtype=torch.uint8, device=dev)
    nxt = (torch.empty((Lq, B, W), dtype=torch.uint8, device=dev)
           if k >= 2 else None)
    nxt2 = (torch.empty((Lq, B, W), dtype=torch.int16, device=dev)
            if k >= 4 else None)
    negcol = torch.full((B, 1), NEG, dtype=i32, device=dev)
    leftcol = torch.full((B, 1), LEFT, dtype=i32, device=dev)
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)

    def shift_up(A, fill):
        return torch.cat([A[:, 1:], fill], dim=1)

    def shift_left(A):
        return torch.cat([leftcol, A[:, :-1]], dim=1)

    for i in range(1, Lq + 1):
        tw = t32[:, i - 1:i - 1 + W]
        jcol = i + j0
        sub = torch.where(tw == q32[i - 1][:, None], match, mismatch)
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
        cells[i - 1] = (d + (Cn << 2) + (Un << 4)).to(torch.uint8)
        if k >= 2:
            nxt[i - 1] = Nn.to(torch.uint8)
        if k >= 4:
            N2n = torch.where(isup, shift_up(N2, leftcol),
                              torch.where(d == DIAG, N, shift_left(Nn)))
            N3n = torch.where(isup, shift_up(N3, leftcol),
                              torch.where(d == DIAG, N2, shift_left(N2n)))
            nxt2[i - 1] = ((N3n << 8) + N2n).to(torch.int16)
            N2, N3 = N2n, N3n
        hl = torch.where(lqc == i, h, hl)
        P, U, C, N = h, Un, Cn, Nn
    if nxt2 is not None:
        nxt2 = nxt2.view(torch.uint16)
    return cells, nxt, nxt2, hl
