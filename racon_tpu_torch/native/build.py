"""Build the native pieces of the port into its git-ignored build directory.

Two kinds of shared library are compiled on first use, each keyed by a
hash of its sources and flags so an edit triggers a rebuild and a stale
binary is never loaded:

- the host aligner (``nw.cpp``, ``g++``) — overlap breaking points for
  PAF/MHAP inputs and the host consensus path;
- the CUDA kernels (``csrc/*.cu``, ``nvcc``; see ops/kernels.py).

Everything lands under ``<checkout>/build/racon_tpu_torch/``, never next
to the sources. Libraries are written to a temporary name and renamed
into place, so concurrent processes building the same hash never load a
half-written file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "nw.cpp")
_CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
              "-funroll-loops", "-Wall", "-Wextra", "-pthread"]


class NativeBuildError(RuntimeError):
    pass


def build_dir() -> str:
    """The port's build directory (created on demand)."""
    d = os.path.join(os.path.dirname(_PKG), "build", "racon_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return d


def content_tag(paths: Sequence[str], flags: Sequence[str]) -> str:
    """16-hex-digit hash of source contents plus build flags."""
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def run_build(cmds: List[List[str]]) -> None:
    """Run compiler commands concurrently; raise with the first failure's
    output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errs = []
    for c, p in zip(cmds, procs):
        out, err = p.communicate()
        if p.returncode != 0:
            errs.append(f"$ {' '.join(c)}\n{out}{err}")
    if errs:
        raise NativeBuildError(
            "[racon_tpu_torch::native] error: build failed\n" +
            "\n".join(errs))


def shared_library_path() -> str:
    """Path to the compiled host aligner, building it if missing."""
    tag = content_tag([_SRC], _CXX_FLAGS)
    lib = os.path.join(build_dir(), f"libracon_nw.{tag}.so")
    if not os.path.isfile(lib):
        tmp = f"{lib}.{os.getpid()}.tmp"
        run_build([[os.environ.get("CXX", "g++"), *_CXX_FLAGS, _SRC,
                    "-o", tmp]])
        os.replace(tmp, lib)
    return lib
