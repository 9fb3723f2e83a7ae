"""The gateway between the daemon and a fleet (port of part of the JAX
package's ``gateway/``):

- ``ha.py`` — the nonce-fenced lease over a daemon state dir, so exactly
  one daemon journals there and a standby can adopt a dead primary's
  in-flight jobs;
- ``dispatch.py`` — the routing decision (every job routes to the
  in-process batcher).

The fleet route, its routing policy and the service autoscaling policy
are still to be ported; the ledger fleet they route to is
(distributed/).
"""

from racon_tpu_torch.gateway.dispatch import (FleetDispatchError,
                                              RouteDecision, decide_route,
                                              fleet_enabled, require_local)
from racon_tpu_torch.gateway.ha import GatewayLease, GatewayLeaseLost

__all__ = ["FleetDispatchError", "GatewayLease", "GatewayLeaseLost",
           "RouteDecision", "decide_route", "fleet_enabled",
           "require_local"]
