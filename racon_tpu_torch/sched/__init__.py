"""Convergence-aware refinement scheduling — port of the JAX package's
``sched/`` (the device engine's default chunk loop).

The fixed-round engine (ops/device_poa.py) runs every window through all
``refine_rounds + 1`` rounds; on real polishing data most windows reach a
fixed point by round 2 and the later rounds replay them unchanged. The
scheduler

  (a) detects per-window fixed points on the device (M2's detect);
  (b) freezes converged and flagged windows at once: M2's sched mode
      also assembles the same sums at the final round's insertion scale,
      so a frozen window's output is the fixed engine's (sched/rounds.py);
  (c) repacks the surviving lanes into smaller batches between rounds
      (sched/repack.py) and skips the rest of a chunk once every window
      froze;
  (d) counts rounds, freezes and repacks (sched/telemetry.py), which the
      polisher prints on stderr.

``RACON_TPU_SCHED=0`` runs the fixed-round engine instead.
"""

from racon_tpu_torch.sched.repack import RepackPlan
from racon_tpu_torch.sched.scheduler import ConvergenceScheduler
from racon_tpu_torch.sched.telemetry import SchedTelemetry
from racon_tpu_torch.utils.env import sched_enabled

__all__ = ["ConvergenceScheduler", "RepackPlan", "SchedTelemetry",
           "sched_enabled"]
