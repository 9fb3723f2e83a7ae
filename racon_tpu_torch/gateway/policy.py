"""Fleet sizing from service signals (port of the JAX package's
``gateway/policy.py``).

The supervisor's stock policy sizes the fleet from one number: open
ledger work (pending shards and an unfinished merge). That suits a batch
run, not a service: by the time shards pile up, jobs have already waited
in the daemon's admission queue. :func:`service_target` wraps the stock
``decide()`` clamp with the service's own signals:

- ``serve_queue_depth_peak`` — jobs stacked on the admission semaphore
  (queue pressure: the gateway should provision ahead);
- the ``serve_queue_wait_s`` histogram — when its p95 reaches
  :data:`SLOW_WAIT_S`, tenants feel the backlog;
- the fleet's windows/s (the worker metric shards under the run's
  ledger) — a fleet already draining faster than the open work needs no
  boost, which keeps the pressure signals from oscillating the fleet.

The chosen target lands in the ``gate_fleet_target`` gauge, so the
OpenMetrics surface and the flight recorder show every sizing decision.
"""

from __future__ import annotations

from typing import Optional

from racon_tpu_torch.gateway.dispatch import ENV_QUEUE_PRESSURE
from racon_tpu_torch.obs.metrics import (HIST_BUCKETS, hist_quantile,
                                         registry, set_gate_fleet_target)
from racon_tpu_torch.utils import env

#: p95 admission-queue wait (seconds) from which the service counts as
#: backlogged and the fleet target gets a pressure boost.
SLOW_WAIT_S = 0.25


def fleet_windows_per_sec(ledger_dir: str) -> float:
    """Summed windows/s across the run's worker metric shards — the
    fleet's current drain rate. 0.0 when no shard is readable yet (the
    fleet is still spawning), so the damper never blocks the first
    scale-up."""
    from racon_tpu_torch.obs import fleet as _fleet
    try:
        shards = _fleet.load_worker_shards(
            _fleet.obs_dir_for(ledger_dir))
    except Exception:
        return 0.0
    total = 0.0
    for sh in shards:
        last = sh["records"][-1]
        wall = float(last.get("wall_s", 0.0))
        windows = last.get("metrics", {}).get("poa_windows_total", 0)
        if wall > 0 and windows:
            total += windows / wall
    return round(total, 3)


def service_target(open_work: Optional[int], policy,
                   reg=None, ledger_dir: Optional[str] = None) -> int:
    """Target worker count for one supervisor tick, from service signals
    over the stock open-work clamp: the supervisor's ``target_fn`` when
    the gateway runs a fleet job."""
    from racon_tpu_torch.distributed.autoscaler import decide
    base = decide(open_work, policy)
    reg = reg if reg is not None else registry()
    boost = 0
    pressure = max(1, int(env.read(ENV_QUEUE_PRESSURE)))
    depth = int(reg.get("serve_queue_depth_peak", 0) or 0)
    if depth >= pressure:
        boost += 1
    hist = reg.get("serve_queue_wait_s", None)
    if isinstance(hist, dict) and hist.get("count"):
        p95 = hist_quantile(hist, 0.95,
                            HIST_BUCKETS["serve_queue_wait_s"])
        if p95 >= SLOW_WAIT_S:
            boost += 1
    if boost and ledger_dir is not None and open_work is not None:
        rate = fleet_windows_per_sec(ledger_dir)
        if rate >= float(max(1, open_work)):
            boost = 0  # already draining faster than work is arriving
    target = max(policy.min_workers,
                 min(policy.max_workers, base + boost))
    set_gate_fleet_target(target)
    return target
