"""Batched Needleman-Wunsch alignment with traceback — port of the JAX
package's ``ops/align.py``.

The library's batched aligner: it stands in for the reference's two
alignment engines (edlib's global alignment with path, for overlap
CIGARs, and spoa's layer alignment inside a window) wherever a caller
wants whole op strings rather than the column walk's vote channels.
``PoaEngine._align`` (ops/poa.py) runs it on the engine's device.

Two steps, each a CUDA kernel on a GPU tensor (wrappers in
ops/kernels.py) and a plain PyTorch version here for CPU tensors:

- the forward ``nw_dirs`` (csrc/nw_fwd.cu, K4; plain ``nw_dirs_plain``):
  direction codes DIAG/UP/LEFT of every DP cell, u8 [Lq, B, Lt] — row i-1,
  lane b, column j-1 holds cell (i, j), the layout of the reference's
  Pallas forward;
- the traceback ``nw_traceback`` (csrc/nw_traceback.cu, T1; plain
  ``traceback_plain``): one walk a lane from (lq, lt) back to (0, 0).

Scores are int32. H[0, j] = j*gap, H[i, 0] = i*gap; ties prefer DIAG,
then UP, then LEFT. The substitution ``q == t ? match : mismatch`` runs
over the whole padded grid, as in the reference, so padded cells agree
between the kernel and its plain version too.

Op encoding (ops/cigar.py): 0 = DIAG (M), 1 = UP (I), 2 = LEFT (D);
``PAD_OP`` = 3 fills an op row in front of its path.
"""

from __future__ import annotations

import torch

from racon_tpu_torch.ops.cigar import DIAG, UP, LEFT
from racon_tpu_torch.ops.flat import PAD_OP


def nw_dirs_plain(q: torch.Tensor, t: torch.Tensor, *, match: int,
                  mismatch: int, gap: int) -> torch.Tensor:
    """Direction codes u8 [Lq, B, Lt] of q u8 [B, Lq] against t u8 [B, Lt]
    (a row loop; the left-gap chain of a row is a cummax of H - j*gap)."""
    B, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    jg = torch.arange(1, Lt + 1, dtype=torch.int32, device=dev)[None, :] * gap
    t32 = t.to(torch.int32)
    q32 = q.to(torch.int32)
    prev = jg.expand(B, Lt).clone()                   # H[0, 1..Lt]
    dirs = torch.empty((Lq, B, Lt), dtype=torch.uint8, device=dev)
    for i in range(1, Lq + 1):
        sub = torch.where(t32 == q32[:, i - 1:i], match, mismatch)
        pshift = torch.cat([torch.full((B, 1), (i - 1) * gap,
                                       dtype=torch.int32, device=dev),
                            prev[:, :-1]], dim=1)
        diag = pshift + sub
        up = prev + gap
        f = torch.maximum(diag, up) - jg
        h = torch.clamp(torch.cummax(f, dim=1).values, min=i * gap) + jg
        d = torch.where(h == diag, DIAG, torch.where(h == up, UP, LEFT))
        dirs[i - 1] = d.to(torch.uint8)
        prev = h
    return dirs


def traceback_plain(dirs: torch.Tensor, lq: torch.Tensor, lt: torch.Tensor,
                    L: int) -> torch.Tensor:
    """Walk every lane from (lq, lt) back to (0, 0) over ``dirs`` u8
    [Lq, B, Lt]: the reference's ``_traceback_flat`` on the [Lq, B, Lt]
    layout, one op a lane a step. Returns rev ops u8 [B, L]: paths in
    end-to-start order, front-aligned, padded with PAD_OP. Starting points
    past the plane are clamped onto it (the CUDA kernel does the same)."""
    Lq, B, Lt = dirs.shape
    dev = dirs.device
    i64 = torch.int64
    d1 = dirs.reshape(-1)
    i = torch.clamp(lq.to(i64), 0, Lq)
    j = torch.clamp(lt.to(i64), 0, Lt)
    b_off = torch.arange(B, dtype=i64, device=dev) * Lt
    rev = torch.empty((B, L), dtype=torch.uint8, device=dev)
    for s in range(L):
        done = (i == 0) & (j == 0)
        idx = (torch.clamp(i - 1, min=0) * (B * Lt) + b_off +
               torch.clamp(j - 1, min=0))
        dv = torch.take(d1, idx).to(i64)
        d = torch.where(done, PAD_OP,
                        torch.where(i == 0, LEFT,
                                    torch.where(j == 0, UP, dv)))
        rev[:, s] = d.to(torch.uint8)
        i = i - ((d == DIAG) | (d == UP)).to(i64)
        j = j - ((d == DIAG) | (d == LEFT)).to(i64)
    return rev


def nw_align_batch(q: torch.Tensor, t: torch.Tensor, lq: torch.Tensor,
                   lt: torch.Tensor, *, match: int, mismatch: int, gap: int):
    """Batched global alignment with traceback.

    Args:
      q: uint8[B, Lq] query codes, zero-padded.
      t: uint8[B, Lt] target codes, zero-padded.
      lq, lt: int32[B] true lengths.
    Returns:
      ops uint8[B, Lq+Lt], each row's path right-aligned behind PAD_OP
      (``ops[b, Lq+Lt-n[b]:]`` is the path, start to end), and n int32[B].

    K4 and T1 on CUDA tensors, their plain versions on CPU tensors.
    """
    # kernels imports this module's plain versions.
    from racon_tpu_torch.ops import kernels
    Lq, Lt = q.shape[1], t.shape[1]
    dirs = kernels.nw_dirs(q, t, match=match, mismatch=mismatch, gap=gap)
    return kernels.nw_traceback(dirs, lq, lt, Lq + Lt)


# The reference's entry that picks its Pallas forward on a TPU; on the
# card there is one route (K4 and T1), so it is the same function.
nw_align_auto = nw_align_batch


def nw_scores(q: torch.Tensor, t: torch.Tensor, lq: torch.Tensor,
              lt: torch.Tensor, *, match: int, mismatch: int,
              gap: int) -> torch.Tensor:
    """Batched NW final scores only, int32[B] (PyTorch ops: the reference
    runs it in XLA, no Pallas kernel, and no main path calls it)."""
    B, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    jg = torch.arange(Lt + 1, dtype=torch.int32, device=dev)[None, :] * gap
    t32 = t.to(torch.int32)
    q32 = q.to(torch.int32)
    lq = lq.to(torch.int32)
    prev = jg.expand(B, Lt + 1).clone()
    for i in range(1, Lq + 1):
        sub = torch.where(t32 == q32[:, i - 1:i], match, mismatch)
        tmp = torch.maximum(prev[:, :-1] + sub, prev[:, 1:] + gap)
        f = torch.cat([torch.full((B, 1), i * gap, dtype=torch.int32,
                                  device=dev), tmp], dim=1) - jg
        h = torch.cummax(f, dim=1).values + jg
        # Past a lane's query length its row stops evolving, so the score
        # is read from the final row at column lt.
        prev = torch.where((i <= lq)[:, None], h, prev)
    return torch.gather(prev, 1, lt.to(torch.int64)[:, None])[:, 0]
