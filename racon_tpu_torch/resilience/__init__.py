"""Resilience: transfer and dispatch retry with backoff, fault injection
and the fail-slow watchdog — port of the JAX package's ``resilience/``
(its checkpoint store is not ported yet).

- :mod:`racon_tpu_torch.resilience.retry` — bounded exponential backoff
  around every h2d/d2h/dispatch choke point, degrading a chunk to the
  host consensus path when the budget is exhausted (``RACON_TPU_RETRY``);
- :mod:`racon_tpu_torch.resilience.faults` — the deterministic, env-gated
  fault injector that proves those paths (``RACON_TPU_FAULTS``);
- :mod:`racon_tpu_torch.resilience.watchdog` — monotonic-clock deadlines
  around the same choke points for a wedged call that never raises
  (``RACON_TPU_DEADLINE_*``, ``RACON_TPU_WATCHDOG_TERMINAL``).
"""

from racon_tpu_torch.resilience.faults import (ENV_FAULTS, FaultInjector,
                                               FaultSpecError,
                                               InjectedFault, maybe_fault)
from racon_tpu_torch.resilience.retry import (ENV_RETRY, RetryExhausted,
                                              RetryPolicy,
                                              call as with_retry,
                                              default_policy)
from racon_tpu_torch.resilience.watchdog import (EXIT_SELF_EVICT,
                                                 DispatchTimeout,
                                                 WatchdogTerminal, guard,
                                                 is_terminal)

__all__ = [
    "ENV_FAULTS", "FaultInjector", "FaultSpecError", "InjectedFault",
    "maybe_fault",
    "ENV_RETRY", "RetryExhausted", "RetryPolicy", "with_retry",
    "default_policy",
    "EXIT_SELF_EVICT", "DispatchTimeout", "WatchdogTerminal", "guard",
    "is_terminal",
]
