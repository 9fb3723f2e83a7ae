"""Assembly-scale all-vs-all (ava) pieces the service core needs (port
of part of the JAX package's ``ava/`` package).

Racon's second mode (``-f``, fragment correction) makes every read a
target: millions of short targets a run instead of the kC regime's tens
of contigs. The JAX package's ava pieces, all ported:

- :mod:`racon_tpu_torch.ava.partition` — length-weighted shard bounds
  over the work ledger's published offsets;
- :mod:`racon_tpu_torch.ava.planner` — run-level shape buckets against
  ``RACON_TPU_AVA_COMPILE_BUDGET``, published by each ledger worker;
- :mod:`racon_tpu_torch.ava.emit` — the streaming record spool a daemon
  job's result stream uses, so millions of emitted records never
  materialize as millions of live Python objects;
- :func:`seg_targets_for` below — how many committed targets amortize
  into one run-length record of the v2 checkpoint manifest
  (resilience/checkpoint.py).
"""

from __future__ import annotations

from racon_tpu_torch.utils import env

#: Targets per v2 manifest segment when the env leaves it to us: large
#: enough that a 10M-target run writes ~40k manifest records instead
#: of 10M, small enough that a crash recomputes at most one segment.
DEFAULT_SEG_TARGETS = 256

ENV_AVA_SEG = env.AVA_SEG


def seg_targets_for(fragment_correction: bool) -> int:
    """Checkpoint-manifest segment size for a run: ``0`` keeps the v1
    one-record-per-target manifest. Unset defaults to segmented for
    ava runs (every read is a target — per-target manifest records are
    exactly what cannot survive that scale) and v1 for kC polishing;
    an explicit ``RACON_TPU_AVA_SEG`` value wins in either mode."""
    raw = env.read(ENV_AVA_SEG).strip()
    if raw:
        try:
            return max(0, int(raw))
        except ValueError:
            return 0
    return DEFAULT_SEG_TARGETS if fragment_correction else 0


from racon_tpu_torch.ava.emit import (RecordSpool,  # noqa: E402
                                      iter_fasta_records)
from racon_tpu_torch.ava.partition import (weighted_bounds,  # noqa: E402
                                           weights_from_offsets)
from racon_tpu_torch.ava.planner import (BucketPlan,  # noqa: E402
                                         plan_buckets)

__all__ = ["DEFAULT_SEG_TARGETS", "ENV_AVA_SEG", "seg_targets_for",
           "RecordSpool", "iter_fasta_records", "weighted_bounds",
           "weights_from_offsets", "BucketPlan", "plan_buckets"]
