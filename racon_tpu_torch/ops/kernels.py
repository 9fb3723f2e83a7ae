"""The port's CUDA kernels: build, binding and wrappers.

Two hand-written Hopper kernels replace the JAX package's Pallas
forwards on the consensus path:

- ``band_fwd`` (csrc/band_fwd.cu) — racon_tpu/ops/pallas/band_kernel.py
  ``_kernel``; plain version ops/band.py::fw_dirs_band_plain;
- ``flat_fwd`` (csrc/flat_fwd.cu) — racon_tpu/ops/pallas/flat_kernel.py
  ``_kernel``; plain version ops/flat.py::fw_dirs_flat_plain.

The sources compile on first use with ``nvcc`` (one process per source,
started together, then one link) into a shared library with a plain C
interface in the port's build directory, keyed by a hash of the sources
and flags; ctypes loads it. Nothing is built or imported at module
import time.

Each wrapper sends a CPU tensor to the plain version and a CUDA tensor
to its kernel (or raises: there is no fallback). ``LAUNCHES`` counts
kernel launches per wrapper and is touched nowhere else.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import torch

from racon_tpu_torch.native.build import (build_dir, content_tag,
                                          run_build)
from racon_tpu_torch.ops.band import fw_dirs_band_plain
from racon_tpu_torch.ops.flat import fw_dirs_flat_plain

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
SOURCES = ("band_fwd.cu", "flat_fwd.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

LAUNCHES = {"band_fwd": 0, "flat_fwd": 0}

_LOCK = threading.Lock()
_LIB = None


class KernelError(RuntimeError):
    pass


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build() -> str:
    """Compile the kernels (if the hashed library is missing); returns
    the library path."""
    srcs = [os.path.join(_CSRC, s) for s in SOURCES]
    tag = content_tag(srcs, NVCC_FLAGS)
    out = build_dir()
    lib = os.path.join(out, f"libracon_kernels.{tag}.so")
    if os.path.isfile(lib):
        return lib
    nvcc = _nvcc()
    pid = os.getpid()
    objs = [os.path.join(out, f"{os.path.splitext(s)[0]}.{tag}.{pid}.o")
            for s in SOURCES]
    run_build([[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
               for src, obj in zip(srcs, objs)])
    tmp = f"{lib}.{pid}.tmp"
    run_build([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                "-shared", *objs, "-o", tmp]])
    os.replace(tmp, lib)
    for o in objs:
        os.unlink(o)
    return lib


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.racon_band_fwd.restype = ci
            lib.racon_band_fwd.argtypes = [vp] * 8 + [ci] * 7 + [vp]
            lib.racon_flat_fwd.restype = ci
            lib.racon_flat_fwd.argtypes = [vp] * 3 + [ci] * 6 + [vp]
            _LIB = lib
    return _LIB


def _check(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if t.device != dev:
        raise KernelError(f"[racon_tpu_torch::kernels] {name} on {t.device}, "
                          f"expected {dev}")
    if t.dtype != dtype:
        raise KernelError(f"[racon_tpu_torch::kernels] {name} dtype "
                          f"{t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise KernelError(f"[racon_tpu_torch::kernels] {name} shape "
                          f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise KernelError(f"[racon_tpu_torch::kernels] {name} must be "
                          "contiguous")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def fw_dirs_band(tband: torch.Tensor, qT: torch.Tensor, klo: torch.Tensor,
                 lq: torch.Tensor, *, match: int, mismatch: int, gap: int,
                 W: int, nxt_k: int = 2):
    """Banded forward: ``(cells u8[Lq,B,W], nxt u8 | None, nxt2 u16 |
    None, hlast i32[B,W])`` (see ops/band.py for the contract).

    tband u8[B, W+Lq], qT u8[Lq, B], klo/lq i32[B]."""
    if tband.device.type == "cpu":
        return fw_dirs_band_plain(tband, qT, klo, lq, match=match,
                                  mismatch=mismatch, gap=gap, W=W,
                                  nxt_k=nxt_k)
    if tband.device.type != "cuda":
        raise KernelError("[racon_tpu_torch::kernels] band_fwd needs a "
                          "CPU or CUDA tensor")
    B = tband.shape[0]
    Lq = qT.shape[0]
    dev = tband.device
    _check(tband, "tband", torch.uint8, (B, W + Lq), dev)
    _check(qT, "qT", torch.uint8, (Lq, B), dev)
    _check(klo, "klo", torch.int32, (B,), dev)
    _check(lq, "lq", torch.int32, (B,), dev)
    if (W // 4 if W % 4 == 0 else W) > 1024:
        raise KernelError(f"[racon_tpu_torch::kernels] band width {W} "
                          "exceeds the kernel's 1024-thread block")
    k = int(nxt_k)
    cells = torch.empty((Lq, B, W), dtype=torch.uint8, device=dev)
    nxt = (torch.empty((Lq, B, W), dtype=torch.uint8, device=dev)
           if k >= 2 else None)
    nxt2 = (torch.empty((Lq, B, W), dtype=torch.uint16, device=dev)
            if k >= 4 else None)
    hlast = torch.empty((B, W), dtype=torch.int32, device=dev)
    rc = _lib().racon_band_fwd(
        tband.data_ptr(), qT.data_ptr(), klo.data_ptr(), lq.data_ptr(),
        cells.data_ptr(), nxt.data_ptr() if nxt is not None else None,
        nxt2.data_ptr() if nxt2 is not None else None, hlast.data_ptr(),
        B, Lq, W, match, mismatch, gap, k, _stream(dev))
    if rc != 0:
        raise KernelError(f"[racon_tpu_torch::kernels] band_fwd launch "
                          f"failed (cudaError {rc})")
    LAUNCHES["band_fwd"] += 1
    return cells, nxt, nxt2, hlast


def fw_dirs_flat(tbuf: torch.Tensor, qT: torch.Tensor, *, match: int,
                 mismatch: int, gap: int) -> torch.Tensor:
    """Full-width forward: packed cells u8[Lq, B, Lt] from tbuf u8[B, Lt]
    and qT u8[Lq, B]."""
    if tbuf.device.type == "cpu":
        return fw_dirs_flat_plain(tbuf, qT, match=match, mismatch=mismatch,
                                  gap=gap)
    if tbuf.device.type != "cuda":
        raise KernelError("[racon_tpu_torch::kernels] flat_fwd needs a "
                          "CPU or CUDA tensor")
    B, Lt = tbuf.shape
    Lq = qT.shape[0]
    dev = tbuf.device
    _check(tbuf, "tbuf", torch.uint8, (B, Lt), dev)
    _check(qT, "qT", torch.uint8, (Lq, B), dev)
    if (Lt // 4 if Lt % 4 == 0 else Lt) > 1024:
        raise KernelError(f"[racon_tpu_torch::kernels] target width {Lt} "
                          "exceeds the kernel's 1024-thread block")
    cells = torch.empty((Lq, B, Lt), dtype=torch.uint8, device=dev)
    rc = _lib().racon_flat_fwd(tbuf.data_ptr(), qT.data_ptr(),
                               cells.data_ptr(), B, Lq, Lt, match, mismatch,
                               gap, _stream(dev))
    if rc != 0:
        raise KernelError(f"[racon_tpu_torch::kernels] flat_fwd launch "
                          f"failed (cudaError {rc})")
    LAUNCHES["flat_fwd"] += 1
    return cells
