"""ctypes bindings for the native banded-NW aligner (edlib replacement).

The reference calls ``edlibAlign`` once per overlap under a thread pool
(reference: src/polisher.cpp:351-364, src/overlap.cpp:198-213). Here the
native aligner exposes a *batched* entry point over flat buffers so the
Python side makes one FFI call per batch, and the same op encoding as the
JAX device kernel (racon_tpu/ops/align.py) so either backend can serve any
alignment job.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np

from racon_tpu_torch.native.build import shared_library_path
from racon_tpu_torch.ops.cigar import ops_to_cigar
from racon_tpu_torch.ops.encode import encode_bases

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(shared_library_path())
        lib.racon_nw_align.restype = ctypes.c_int32
        lib.racon_nw_align.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.racon_nw_align_batch.restype = ctypes.c_int32
        lib.racon_nw_align_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    return _lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeAligner:
    """Host-side global aligner with adaptive banding.

    match/mismatch/gap default to edit-distance-equivalent scoring
    (maximizing m=0, x=-1, g=-1 yields a minimum-edit-distance alignment),
    which is what edlib computes for the reference's breaking-point
    alignments (src/overlap.cpp:198-200).
    """

    def __init__(self, match: int = 0, mismatch: int = -1, gap: int = -1,
                 band: int = 0, threads: int = 1):
        self.match, self.mismatch, self.gap = match, mismatch, gap
        self.band = band
        # Batch records fan out over OS threads (reference -t semantics,
        # src/polisher.cpp:341-364); 1 = serial, <=0 = all hardware cores.
        self.threads = threads
        _load()

    def align(self, q: bytes, t: bytes) -> np.ndarray:
        """Align raw sequence bytes; returns ops uint8[n] (0=M,1=I,2=D)."""
        qa = np.ascontiguousarray(encode_bases(q))
        ta = np.ascontiguousarray(encode_bases(t))
        return self.align_codes(qa, ta)

    def align_codes(self, qa: np.ndarray, ta: np.ndarray) -> np.ndarray:
        lib = _load()
        out = np.empty(len(qa) + len(ta), dtype=np.uint8)
        score = ctypes.c_int32(0)
        n = lib.racon_nw_align(
            _u8ptr(qa), len(qa), _u8ptr(ta), len(ta),
            self.match, self.mismatch, self.gap, self.band,
            _u8ptr(out), ctypes.byref(score))
        if n < 0:
            raise RuntimeError(
                "[racon_tpu_torch::native] error: alignment failed "
                f"(lq={len(qa)}, lt={len(ta)})")
        return out[:n]

    def align_batch(self, pairs: Sequence[Tuple[np.ndarray, np.ndarray]]
                    ) -> List[np.ndarray]:
        """One FFI call for a whole batch of (q_codes, t_codes) pairs."""
        lib = _load()
        n = len(pairs)
        if n == 0:
            return []
        q_len = np.array([len(p[0]) for p in pairs], dtype=np.int32)
        t_len = np.array([len(p[1]) for p in pairs], dtype=np.int32)
        q_off = np.concatenate([[0], np.cumsum(q_len[:-1], dtype=np.int64)])
        t_off = np.concatenate([[0], np.cumsum(t_len[:-1], dtype=np.int64)])
        q_flat = np.concatenate([np.asarray(p[0], dtype=np.uint8)
                                 for p in pairs]) if q_len.sum() else \
            np.empty(0, np.uint8)
        t_flat = np.concatenate([np.asarray(p[1], dtype=np.uint8)
                                 for p in pairs]) if t_len.sum() else \
            np.empty(0, np.uint8)
        cap = (q_len + t_len).astype(np.int64)
        ops_off = np.concatenate([[0], np.cumsum(cap[:-1])])
        ops_out = np.empty(int(cap.sum()), dtype=np.uint8)
        ops_len = np.empty(n, dtype=np.int32)
        rc = lib.racon_nw_align_batch(
            _u8ptr(q_flat), q_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            q_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            _u8ptr(t_flat), t_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            t_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, self.match, self.mismatch, self.gap, self.band, self.threads,
            _u8ptr(ops_out), ops_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ops_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if rc != 0:
            raise RuntimeError(
                f"[racon_tpu_torch::native] error: batch alignment failed at "
                f"record {rc - 1}")
        return [ops_out[ops_off[i]:ops_off[i] + ops_len[i]].copy()
                for i in range(n)]

    def cigar(self, q: bytes, t: bytes) -> bytes:
        """CIGAR bytes for Overlap.find_breaking_points's aligner hook."""
        return ops_to_cigar(self.align(q, t))
