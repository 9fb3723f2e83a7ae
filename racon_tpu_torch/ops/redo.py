"""On-device wide-band redo: second pass for flagged windows.

Port of the JAX package's ``ops/redo.py``. Windows whose consensus
outgrew the chunk's padded anchor width, whose banded optimum failed the
escape certificate, or whose walk saturated an up-run counter come back
from collect_chunk as ``None``. They re-run on the device first, through
the same ChunkPlan / dispatch_chunk / collect_chunk machinery with two
budgets widened:

* anchor slack — ``la_grow`` quadruples (4 * LA_GROW growth slots);
* band width — the plan's band doubles, clamped to the LA - 128 ceiling;
  past the clamp the redo runs full width (band_w = 0), which cannot fail
  the escape certificate.

Windows still flagged after the wide pass (saturated up-runs, or growth
past even the widened slack) go back to the caller for the host path.
The reference's default (``RACON_TPU_REDO=1``) is the port's only mode.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def _widen(plan) -> None:
    """Widen a redo ChunkPlan's band in place: 2x the first-pass width,
    full width past the LA - 128 ceiling."""
    if plan.band_w:
        w2 = 2 * plan.band_w
        plan.band_w = w2 if w2 + 128 <= plan.LA else 0


def device_redo(windows: List, *, match: int, mismatch: int, gap: int,
                ins_scale, rounds: int, device, jobs_cap: int = 2048,
                stats: Optional[dict] = None
                ) -> Tuple[List[Tuple[object, bytes, np.ndarray]], List]:
    """Re-run flagged windows through a wide-band device pass. Returns
    ``(resolved, remaining)``: (window, codes bytes, coverage) triples to
    apply, and the windows that must take the host path."""
    from racon_tpu_torch.ops.device_poa import (ChunkPlan, LA_GROW,
                                                MAX_DIR_ELEMS, collect_chunk,
                                                dispatch_chunk)
    resolved: List[Tuple[object, bytes, np.ndarray]] = []
    remaining: List = []
    groups: List[List] = []
    cur: List = []
    jobs = 0
    for w in windows:
        if cur and jobs + w.n_layers > jobs_cap:
            groups.append(cur)
            cur, jobs = [], 0
        cur.append(w)
        jobs += w.n_layers
    if cur:
        groups.append(cur)

    for ws in groups:
        plan = ChunkPlan(ws, la_grow=4 * LA_GROW)
        _widen(plan)
        cols = plan.band_w if plan.band_w else plan.LA
        if plan.B * plan.Lq * cols > MAX_DIR_ELEMS:
            remaining.extend(ws)
            continue
        packed = dispatch_chunk(plan, match=match, mismatch=mismatch,
                                gap=gap, ins_scale=ins_scale, rounds=rounds,
                                device=device, stats=stats)
        codes, covs = collect_chunk(plan, packed, stats=stats)
        for w, c, cv in zip(ws, codes, covs):
            if c is None:
                remaining.append(w)
            else:
                resolved.append((w, c, cv))
    return resolved, remaining
