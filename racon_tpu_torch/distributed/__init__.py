"""Preemption-tolerant sharded execution (port of the JAX package's
``distributed/``).

Polishing is embarrassingly parallel over contigs, so scaling out is a
work-distribution problem, not a communication one:

- ``ledger.py`` — the contig work ledger: partitions the targets into
  shards, hands them to workers under time-bounded leases, and lets
  survivors steal shards whose lease expired;
- ``worker.py`` — the worker loop: claim, polish through the service
  core's loop (server/engine.py::polish_job) into a per-shard checkpoint
  store on the card, complete; then the merge that assembles the shard
  stores in target order, byte-identical to the serial CLI;
- ``autoscaler.py`` — the elastic supervisor: spawns, retires and
  replaces worker processes; it builds no polisher and touches no GPU.

Everything lives in one directory every worker can reach; there is no
coordinator and no network protocol — an evicted worker is a lease that
stops being renewed. The files are the JAX package's, so either
package's workers can finish a ledger the other started.
"""

from racon_tpu_torch.distributed.ledger import (Claim, LeaseLost,
                                                LedgerError, WorkLedger)

__all__ = ["Claim", "LeaseLost", "LedgerError", "WorkLedger"]
