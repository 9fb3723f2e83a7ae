"""Alignment-op encoding shared by the port's aligners (numpy-only).

Op encoding (the forward kernels' direction codes and the native C++
aligner in racon_tpu_torch/native/nw.cpp):
  0 = DIAG  (consumes query+target -> CIGAR 'M')
  1 = UP    (consumes query only   -> CIGAR 'I')
  2 = LEFT  (consumes target only  -> CIGAR 'D')
"""

from __future__ import annotations

import numpy as np

DIAG, UP, LEFT = 0, 1, 2

_OP_TO_CIGAR = np.frombuffer(b"MID", dtype=np.uint8)


def ops_to_cigar(ops: np.ndarray) -> bytes:
    """Run-length encode an op array (0/1/2) into CIGAR bytes (M/I/D)."""
    ops = np.asarray(ops, dtype=np.uint8)
    if ops.size == 0:
        return b""
    edges = np.flatnonzero(np.diff(ops)) + 1
    starts = np.concatenate([[0], edges])
    ends = np.concatenate([edges, [ops.size]])
    out = []
    for s, e in zip(starts, ends):
        out.append(str(e - s).encode())
        out.append(_OP_TO_CIGAR[ops[s]:ops[s] + 1].tobytes())
    return b"".join(out)
