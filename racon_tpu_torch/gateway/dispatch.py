"""The gateway's routing decision (the local half of the JAX package's
``gateway/dispatch.py``).

Each job the daemon admits is routed, after the Tier-1 cache probe
(``PolishServer._run_job``), either to the resident in-process batcher
or to an autoscaled ledger fleet. ``RACON_TPU_GATE_FLEET`` arms the
fleet route (default off); ``gate/route`` is the decision's fault site.

The ledger fleet exists in the port (distributed/: the work ledger,
its workers and the autoscaler, driven by ``cli.py --ledger-dir``); the
gateway's route to it (``run_fleet_job``: one WorkLedger a job
fingerprint, autoscaled workers, the merged FASTA re-committed into the
job's store) and the policy that picks it (the size and queue-pressure
thresholds) are still to be ported. Until then :func:`require_local`
refuses an armed fleet gate, the daemon exits 1 at start with its
message, and every job it admits routes local, reason
``fleet-disabled``: it never serves locally a job the operator meant for
the fleet.
"""

from __future__ import annotations

from typing import NamedTuple

from racon_tpu_torch.resilience.faults import maybe_fault
from racon_tpu_torch.utils import env

ENV_GATE_FLEET = env.GATE_FLEET


class FleetDispatchError(RuntimeError):
    """A job the fleet route should run cannot run: the port's gateway
    has no route to the ledger fleet yet."""


class RouteDecision(NamedTuple):
    route: str          # "fleet" | "local"
    reason: str         # human-readable policy clause that fired
    n_targets: int
    queue_depth: int
    target_bytes: int = 0  # ava size signal (0 for count-routed jobs)


def fleet_enabled() -> bool:
    return env.read(ENV_GATE_FLEET).strip().lower() \
        not in ("", "0", "false", "off")


def require_local() -> None:
    """Raise :class:`FleetDispatchError` when the fleet gate is armed:
    the port's distributed slice (the ledger fleet) runs through the
    CLI, but the gateway's route to it (``run_fleet_job``) is not ported
    yet."""
    if fleet_enabled():
        raise FleetDispatchError(
            f"[racon_tpu_torch::gate] {ENV_GATE_FLEET} is armed, but the "
            "fleet route (gateway/dispatch.run_fleet_job) is not ported "
            "yet; the port's distributed slice (distributed/: ledger, "
            "worker, autoscaler) runs only through the CLI's "
            "--ledger-dir. Unset it to serve every job in-process")


def decide_route(queue_depth: int = 0) -> RouteDecision:
    """The route of one admitted job. The daemon runs only with the
    fleet gate off (:func:`require_local`), so every job routes local,
    reason ``fleet-disabled``. ``gate/route`` fires before the decision
    is read."""
    maybe_fault("gate/route")
    return RouteDecision("local", "fleet-disabled", 0, queue_depth)
