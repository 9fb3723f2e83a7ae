"""Alignment-op encoding shared by the port's aligners (numpy-only), and
the numpy NW oracle the tests hold the aligners against.

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


def nw_oracle(q, t, match: int, mismatch: int, gap: int):
    """Reference numpy NW (row loop) -> (score, ops uint8[n]). Test oracle;
    semantics identical to the batched aligner (ops/align.py): boundaries
    H[0, j] = j*gap, H[i, 0] = i*gap, ties DIAG > UP > LEFT."""
    qa = np.frombuffer(q, dtype=np.uint8) if isinstance(q, (bytes, bytearray)) \
        else np.asarray(q, dtype=np.uint8)
    ta = np.frombuffer(t, dtype=np.uint8) if isinstance(t, (bytes, bytearray)) \
        else np.asarray(t, dtype=np.uint8)
    lq, lt = len(qa), len(ta)
    H = np.zeros((lq + 1, lt + 1), dtype=np.int64)
    H[0, :] = np.arange(lt + 1) * gap
    H[:, 0] = np.arange(lq + 1) * gap
    D = np.zeros((lq, lt), dtype=np.uint8)
    for i in range(1, lq + 1):
        sub = np.where(ta == qa[i - 1], match, mismatch)
        diag = H[i - 1, :-1] + sub
        up = H[i - 1, 1:] + gap
        tmp = np.maximum(diag, up)
        row = np.empty(lt + 1, dtype=np.int64)
        row[0] = i * gap
        for j in range(1, lt + 1):
            row[j] = max(tmp[j - 1], row[j - 1] + gap)
        H[i] = row
        D[i - 1] = np.where(row[1:] == diag, DIAG,
                            np.where(row[1:] == up, UP, LEFT))
    ops = []
    i, j = lq, lt
    while i > 0 or j > 0:
        d = LEFT if i == 0 else (UP if j == 0 else int(D[i - 1, j - 1]))
        ops.append(d)
        if d != LEFT:
            i -= 1
        if d != UP:
            j -= 1
    return int(H[lq, lt]), np.asarray(ops[::-1], dtype=np.uint8)
