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
past even the widened slack), and the windows of a redo chunk whose
transfer or dispatch exhausted its retries, go back to the caller for
the host path; the latter are degraded windows, and ``on_exhausted``
accounts them (PoaEngine._note_degraded: the stderr line and
``res_degraded_windows``, or the re-raise of an exhaustion that must end
the run).
The reference's default (``RACON_TPU_REDO=1``) is the port's only mode.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np


def _widen(plan) -> None:
    """Widen a redo ChunkPlan's band in place: 2x the first-pass width,
    full width past the LA - 128 ceiling."""
    if plan.band_w:
        w2 = 2 * plan.band_w
        plan.band_w = w2 if w2 + 128 <= plan.LA else 0


def device_redo(windows: List, *, match: int, mismatch: int, gap: int,
                ins_scale, rounds: int, device, jobs_cap: int = 2048,
                stats: Optional[dict] = None,
                on_exhausted: Optional[Callable] = None
                ) -> Tuple[List[Tuple[object, bytes, np.ndarray]], List]:
    """Re-run flagged windows through a wide-band device pass. Returns
    ``(resolved, remaining)``: (window, codes bytes, coverage) triples to
    apply, and the windows that must take the host path."""
    from racon_tpu_torch.obs.trace import get_tracer
    from racon_tpu_torch.ops.device_poa import (ChunkPlan, LA_GROW,
                                                MAX_DIR_ELEMS, collect_chunk,
                                                dispatch_chunk)
    from racon_tpu_torch.resilience.retry import RetryExhausted
    tracer = get_tracer()
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

    for k, ws in enumerate(groups):
        plan = ChunkPlan(ws, la_grow=4 * LA_GROW)
        _widen(plan)
        cols = plan.band_w if plan.band_w else plan.LA
        if plan.B * plan.Lq * cols > MAX_DIR_ELEMS:
            remaining.extend(ws)
            continue
        try:
            with tracer.span("chunk", f"redo{k}", windows=len(ws),
                             lanes=plan.B, jobs=plan.n_jobs):
                packed = dispatch_chunk(
                    plan, match=match, mismatch=mismatch, gap=gap,
                    ins_scale=ins_scale, rounds=rounds, device=device,
                    stats=stats)
                codes, covs = collect_chunk(plan, packed, stats=stats)
        except RetryExhausted as exc:
            if on_exhausted is not None:
                on_exhausted(ws, exc)
            remaining.extend(ws)
            continue
        for w, c, cv in zip(ws, codes, covs):
            if c is None:
                remaining.append(w)
            else:
                resolved.append((w, c, cv))
    return resolved, remaining
