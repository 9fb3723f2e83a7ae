"""The gateway between the daemon and a fleet (port of the JAX package's
``gateway/``):

- ``ha.py`` — the nonce-fenced lease over a daemon state dir, so exactly
  one daemon journals there and a standby can adopt a dead primary's
  in-flight jobs;
- ``dispatch.py`` — the routing decision (in-process batcher or
  autoscaled ledger fleet) and the job→ledger adapter
  (``run_fleet_job``);
- ``policy.py`` — the fleet's size from service signals (queue depth,
  queue-wait p95, the fleet's drain rate).
"""

from racon_tpu_torch.gateway.dispatch import (FleetDispatchError,
                                              FleetPaths, RouteDecision,
                                              decide_route, fleet_enabled,
                                              fleet_paths, run_fleet_job)
from racon_tpu_torch.gateway.ha import GatewayLease, GatewayLeaseLost

__all__ = ["FleetDispatchError", "FleetPaths", "GatewayLease",
           "GatewayLeaseLost", "RouteDecision", "decide_route",
           "fleet_enabled", "fleet_paths", "run_fleet_job"]
