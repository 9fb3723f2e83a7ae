"""Length-weighted shard bounds for all-vs-all target sets (port of the
JAX package's ``ava/partition.py``).

The work ledger's count partition (distributed/ledger.py::_partition)
balances shards by target count, right for kC polishing where contigs
are few and alike. Under ``-f`` every read is a target, and read lengths
span orders of magnitude, so equal-count shards can differ tenfold in
work. The ledger publishes per-target byte offsets
(io/parsers.py::scan_sequence_index) in its meta.json; this module turns
them into per-target weights and cuts contiguous bounds at equal-weight
points.

- Bounds stay contiguous and ascending over ``[0, n_targets]``, so every
  invariant downstream of the count partition (manifest-as-prefix
  resume, split carving, the merge's tiling check) holds.
- Every shard keeps at least one target.
- Target ``i`` weighs the byte distance to the next record's offset; the
  last record weighs the mean. Weights come only from the published
  offsets, so any worker recomputing them gets the same bounds.
- Bounds change which worker polishes a target, never the merge order.

``RACON_TPU_AVA_WEIGHTED=0`` keeps the count partition.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import List, Optional, Sequence

from racon_tpu_torch.utils import env

ENV_AVA_WEIGHTED = env.AVA_WEIGHTED


def weighted_enabled() -> bool:
    return env.read(ENV_AVA_WEIGHTED).strip().lower() not in (
        "0", "false", "no", "off")


def weights_from_offsets(offsets: Sequence[int]) -> List[int]:
    """Per-target byte weights from record start offsets: the gap to the
    next record's offset, the mean gap for the last record, at least 1
    each."""
    n = len(offsets)
    if n == 0:
        return []
    if n == 1:
        return [1]
    weights = [max(1, int(offsets[i + 1]) - int(offsets[i]))
               for i in range(n - 1)]
    weights.append(max(1, round(sum(weights) / len(weights))))
    return weights


def weighted_partition(n_targets: int, n_shards: int,
                       weights: Sequence[int]) -> List[int]:
    """Contiguous bounds cutting ``weights`` into ``n_shards`` runs of
    near-equal weight: cut ``k`` lands where the weight prefix first
    reaches ``k / n_shards`` of the total, clamped so this shard and
    every later one keep at least one target."""
    if len(weights) != n_targets:
        raise ValueError(
            f"[racon_tpu_torch::ava] weighted_partition got "
            f"{len(weights)} weights for {n_targets} targets")
    prefix = [0]
    for w in weights:
        prefix.append(prefix[-1] + max(1, int(w)))
    total = prefix[-1]
    bounds = [0]
    for k in range(1, n_shards):
        cut = bisect_left(prefix, total * k / n_shards)
        cut = max(cut, bounds[-1] + 1)
        cut = min(cut, n_targets - (n_shards - k))
        bounds.append(cut)
    bounds.append(n_targets)
    return bounds


def weighted_bounds(n_targets: int, n_shards: int,
                    offsets: Sequence[int]) -> Optional[List[int]]:
    """The bounds ``WorkLedger.open`` publishes when it holds per-target
    offsets, or None to keep the count partition (gate off, offsets
    inconsistent with the count, or one shard)."""
    if n_shards <= 1 or len(offsets) != n_targets:
        return None
    if not weighted_enabled():
        return None
    return weighted_partition(n_targets, n_shards,
                              weights_from_offsets(offsets))
