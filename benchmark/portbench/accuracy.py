"""Polished accuracy against the generator's truth, on the benchmark's
own aligner: ``native/edit_distance.cpp``, built with g++ into
``build/benchmark/`` under a hash of its source and flags."""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
from typing import Dict, Iterable, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "native", "edit_distance.cpp")
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def build_dir(root: str) -> str:
    d = os.path.join(root, "build", "benchmark")
    os.makedirs(d, exist_ok=True)
    return d


def library(root: str) -> str:
    """Path of the helper library under ``root``/build/benchmark, built
    on first use (written to a temporary name and renamed into place)."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(_FLAGS).encode())
    lib = os.path.join(build_dir(root),
                       f"libportbench_ed.{h.hexdigest()[:16]}.so")
    if not os.path.isfile(lib):
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run([os.environ.get("CXX", "g++"), *_FLAGS, _SRC, "-o",
                        tmp], check=True, capture_output=True)
        os.replace(tmp, lib)
    return lib


class EditDistance:
    def __init__(self, root: str):
        self._lib = ctypes.CDLL(library(root))
        fn = self._lib.portbench_edit_distance
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
                       ctypes.c_int64]
        self._fn = fn

    def __call__(self, a: bytes, b: bytes) -> int:
        return int(self._fn(a, len(a), b, len(b)))


def qv(errors: int, bases: int) -> float:
    """Phred accuracy -10 log10((E + 1) / N); the +1 keeps an error-free
    output finite."""
    return -10.0 * math.log10((errors + 1) / bases)


def job_errors(ed: EditDistance, records: Iterable[Tuple[str, bytes]],
               truth: Dict[str, bytes]) -> Tuple[int, int]:
    """(summed edit distance, truth bases) of one job's output records
    against their truths."""
    errors = bases = 0
    for name, data in records:
        t = truth[name]
        errors += ed(data, t)
        bases += len(t)
    return errors, bases
