"""Full-width batched NW forward in absolute target coordinates — the
plain PyTorch version.

Counterpart of the JAX package's ``ops/flat.py::fw_dirs_xla`` and of its
Pallas kernel ``ops/pallas/flat_kernel.py::_kernel``; the CUDA kernel
that replaces the latter is ``csrc/flat_fwd.cu`` (wrapper in
ops/kernels.py). Lane j-1 of every row is target column j, so the
substitution input is static per lane and the traceback (which starts at
(lq, lt) and moves down-left) never visits the garbage cells beyond a
job's true lt.

The output cell byte packs ``dir | consumer_dir << 2 | up_run << 4``
(ops/colwalk.py reads it); ``up_run`` saturates at ``U_SAT``.
"""

from __future__ import annotations

import torch

from racon_tpu_torch.ops.cigar import DIAG, UP, LEFT

PAD_OP = 3
NEG = -(2 ** 30)
# UP-run saturation in the packed cell byte; equals device_merge.K_INS + 1
# so a saturated counter marks runs longer than the K_INS pileup slots the
# device merge keeps (such lanes take the redo route).
U_SAT = 11


def fw_dirs_flat_plain(tbuf: torch.Tensor, qT: torch.Tensor, *, match: int,
                       mismatch: int, gap: int) -> torch.Tensor:
    """Packed cells uint8[Lq, B, Lt] via a row loop.

    tbuf: uint8[B, Lt] targets (any filler beyond each job's lt).
    qT:   uint8[Lq, B] queries (transposed).
    """
    B, Lt = tbuf.shape
    Lq = qT.shape[0]
    dev = tbuf.device
    jr = torch.arange(Lt, dtype=torch.int32, device=dev)[None, :]
    jg = (jr + 1) * gap
    t32 = tbuf.to(torch.int32)
    q32 = qT.to(torch.int32)
    P = jg.expand(B, Lt).clone()
    U = torch.zeros((B, Lt), dtype=torch.int32, device=dev)
    C = torch.full((B, Lt), LEFT, dtype=torch.int32, device=dev)
    bnd = torch.where(jr == 0, 0, NEG).to(torch.int32)
    dirs = torch.empty((Lq, B, Lt), dtype=torch.uint8, device=dev)
    for i in range(1, Lq + 1):
        sub = torch.where(t32 == q32[i - 1][:, None], match, mismatch)
        Pshift = torch.cat(
            [torch.full((B, 1), (i - 1) * gap, dtype=torch.int32,
                        device=dev), P[:, :-1]], dim=1)
        diag = Pshift + sub
        up = P + gap
        tmp = torch.maximum(diag, up)
        # Left-gap chain with the H[i][0] = i*gap boundary folded in: its
        # one-left-move path to column 1 is (i+1)*gap, injected at lane 0.
        f = torch.maximum(tmp, bnd + (i + 1) * gap) - jg
        h = torch.cummax(f, dim=1).values + jg
        d = torch.where(h == diag, DIAG, torch.where(h == up, UP, LEFT))
        isup = d == UP
        U = torch.where(isup, torch.clamp(U + 1, max=U_SAT), 0)
        C = torch.where(isup, C, d)
        dirs[i - 1] = (d + (C << 2) + (U << 4)).to(torch.uint8)
        P = h
    return dirs
