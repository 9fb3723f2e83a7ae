"""Run-level shape buckets for read-length diversity (port of the JAX
package's ``ava/planner.py``).

An ava run presents one overlap geometry to the device per distinct
padded read length, and an assembly-scale read set has millions of
lengths. The planner quantizes lengths to a bucket quantum (tied to the
window length), sweeps the targets in input order coalescing runs of
same-bucket reads, and keys each bucket by its padded length plus the
tile tier ``ops/budget.tile_plan`` picks for a same-length overlap. If
the buckets exceed ``RACON_TPU_AVA_COMPILE_BUDGET`` the quantum doubles
and the sweep repeats, so the plan always ends with ``n_buckets <=
budget``.

In the JAX package each geometry is an XLA compile. On CUDA the kernels
are built once, so the budget here bounds the distinct geometries a run
presents to them (``compile_keys``); the plan and its ``ava_*`` gauges
are the JAX package's numbers on the same offsets. The ledger worker
publishes the plan at join time from the ledger's offsets, with no
file I/O.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

from racon_tpu_torch.ops import budget as _budget
from racon_tpu_torch.utils import env

ENV_AVA_COMPILE_BUDGET = env.AVA_COMPILE_BUDGET
_AVA_COMPILE_BUDGET_DEFAULT = 8


def ava_compile_budget() -> int:
    """The most shape buckets the planner may plan (default 8). An
    invalid or non-positive value is an error."""
    raw = env.read(ENV_AVA_COMPILE_BUDGET).strip()
    if not raw:
        return _AVA_COMPILE_BUDGET_DEFAULT
    try:
        n = int(raw)
    except ValueError:
        n = -1
    if n < 1:
        raise ValueError(
            f"[racon_tpu_torch::budget] {ENV_AVA_COMPILE_BUDGET}={raw!r} "
            "invalid — expected a positive bucket count")
    return n


def ava_bucket_quantum(window_length: int) -> int:
    """The starting bucket granularity: a power of two near
    ``window_length / 8`` (64 for 500-base windows), at least 16."""
    w = max(1, int(window_length))
    return 1 << max(4, (w // 8).bit_length())


class BucketPlan(NamedTuple):
    """One plan: ``buckets`` maps padded length to read count
    (ascending); ``n_runs`` counts the input-order runs the sweep
    coalesced; ``compile_keys`` are the distinct (tier W, tier T,
    capacity) geometries the budget bounds; ``pad_frac`` is the padding
    the quantization costs."""
    n_targets: int
    quantum: int
    buckets: Tuple[Tuple[int, int], ...]
    n_runs: int
    compile_keys: Tuple[Tuple[int, int, int], ...]
    pad_frac: float
    budget: int

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)


def _tier_key(cap: int) -> Tuple[int, int]:
    """(W, T) of the tile tier a same-length overlap of ``cap`` bases
    lands on, or (0, 0) for the untiled or host class."""
    plan = _budget.tile_plan(cap, cap)
    if plan is None:
        return (0, 0)
    return (plan.W, plan.T)


def plan_buckets(lengths: Sequence[int], *, window_length: int = 500,
                 budget: Optional[int] = None) -> BucketPlan:
    """Plan shape buckets for per-target ``lengths`` in input order,
    doubling the quantum until ``n_buckets <= budget``."""
    if not lengths:
        raise ValueError(
            "[racon_tpu_torch::ava] plan_buckets needs at least one "
            "target")
    if budget is None:
        budget = ava_compile_budget()
    budget = max(1, int(budget))
    quantum = ava_bucket_quantum(window_length)
    total_len = sum(max(1, int(ln)) for ln in lengths)
    while True:
        counts = {}
        n_runs = 0
        prev_cap = None
        padded_total = 0
        for ln in lengths:
            ln = max(1, int(ln))
            cap = -(-ln // quantum) * quantum
            padded_total += cap
            counts[cap] = counts.get(cap, 0) + 1
            if cap != prev_cap:
                n_runs += 1
                prev_cap = cap
        if len(counts) <= budget:
            break
        quantum *= 2
    buckets = tuple(sorted(counts.items()))
    keys = tuple(sorted({_tier_key(cap) + (cap,) for cap, _ in buckets}))
    pad_frac = round(1.0 - total_len / padded_total, 4) \
        if padded_total else 0.0
    return BucketPlan(n_targets=len(lengths), quantum=quantum,
                      buckets=buckets, n_runs=n_runs,
                      compile_keys=keys, pad_frac=pad_frac,
                      budget=budget)


def lengths_from_offsets(offsets: Sequence[int]) -> List[int]:
    """Per-target byte sizes from the ledger's published offsets: the
    planner's input before any parse. Byte extents overstate base counts
    by the header overhead; bucketing is scale-free."""
    from racon_tpu_torch.ava.partition import weights_from_offsets
    return weights_from_offsets(offsets)
