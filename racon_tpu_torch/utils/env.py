"""The port's environment gates — the only three it honours.

Both keep the JAX package's names and meanings, so one variable set in a
test steers the reference and the port alike:

- ``RACON_TPU_NO_BAND`` (flag): disable the banded forward; every round
  runs the full-width forward.
- ``RACON_TPU_WALK_K`` (1, 2 or 4; default 4): cap on the column walk's
  depth (ops/budget.py::walk_k_for).
- ``RACON_TPU_OVL_TILED`` ("0" turns it off): the tiled route of the
  device overlap aligner (ops/ovl_align.py); with it off, overlaps too
  long for the untiled route take the host aligner.
"""

from __future__ import annotations

import os

NO_BAND = "RACON_TPU_NO_BAND"
WALK_K = "RACON_TPU_WALK_K"
OVL_TILED = "RACON_TPU_OVL_TILED"
_KNOWN = (NO_BAND, WALK_K, OVL_TILED)


def read(name: str) -> str:
    """Raw read of a declared gate ('' when unset)."""
    if name not in _KNOWN:
        raise KeyError(f"[racon_tpu_torch::env] undeclared env gate {name!r}")
    return os.environ.get(name, "")


def band_disabled() -> bool:
    return read(NO_BAND) not in ("", "0", "false")


def ovl_tiled() -> bool:
    return read(OVL_TILED) != "0"
