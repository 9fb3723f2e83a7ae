"""Bounded retry with exponential backoff around the chunk transfers and
dispatches — port of the JAX package's ``resilience/retry.py``.

Every h2d/d2h/dispatch choke point of the device engine
(ops/device_poa.py, sched/scheduler.py) runs through :func:`call`, which

- re-attempts **transient** failures up to ``RetryPolicy.attempts``
  tries, with exponential backoff and deterministic jitter;
- propagates everything else on the first occurrence — a retry loop must
  never mask a logic error, and must never hide a kernel;
- raises :class:`RetryExhausted` when the budget runs out, which the
  engine catches to polish the chunk's windows on the host path instead
  (PoaEngine._degrade, and the streaming pipeline's h2d, compute and
  walk stages) — but only where that hides no kernel
  (:attr:`RetryExhausted.degradable`).

Transient, in this package: :class:`InjectedFault` (the test harness),
``ConnectionError``, ``TimeoutError`` (so the watchdog's
``DispatchTimeout``), ``OSError``, and ``torch.OutOfMemoryError`` (the
caching allocator could not serve a chunk; a later attempt may find the
memory freed). This differs from the reference, which also retries
every ``JaxRuntimeError``: there a device or transfer failure through the
runtime is transient by construction. On CUDA it is not. Kernel faults
are asynchronous — they surface at the next sync (the adaptive test's
``.item()``, the flag pull, the d2h), not at the launch — and a sticky
error (illegal address, launch failure, device assert) poisons the
context, so every retry and every later chunk fails the same way; a
degrade on a kernel's error would be a fallback that hides the kernel.
So ``KernelError`` (ops/kernels.py), ``torch.AcceleratorError`` and
every other ``RuntimeError`` propagate on the first try and end the run.

For the same reason an exhausted site degrades its chunk to the host
path only when the last failure was injected (an ``InjectedFault``, or a
deadline breach while the body slept in an injected ``hang``/``stall``)
or the site is an upload (``h2d/*``: no kernel has run on the chunk
yet). A real breach or out-of-memory at a site that launches kernels or
waits on them (``dispatch/*``, ``sched/flags``, ``d2h/chunk``) is a slow
or starved kernel: the RetryExhausted propagates and the run exits 1,
where the reference would polish the chunk on the host.

The backoff schedule is a pure function of (policy, site, attempt): the
jitter comes from a seeded hash, not the wall clock, and is the
reference's, so both packages sleep the same schedule.

Every retried attempt increments ``res_retry_total`` /
``res_retry_site_*`` and emits a ``retry`` trace span
(pipeline/metrics.py::record_retry); exhaustion increments
``res_retry_exhausted``.
"""

from __future__ import annotations

import hashlib
import time
from typing import Callable, Optional, Tuple

from racon_tpu_torch.utils import env

ENV_RETRY = env.RETRY


class RetryExhausted(RuntimeError):
    """A retry-wrapped call site failed ``attempts`` times in a row.

    ``__cause__`` chains the last underlying error (``last``); ``site``
    names the choke point. The consensus engine takes it as the signal
    to degrade the chunk to the host path when :attr:`degradable`, and
    lets it end the run otherwise.
    """

    def __init__(self, site: str, attempts: int, last: BaseException):
        super().__init__(
            f"[racon_tpu_torch::resilience] {site} failed after {attempts} "
            f"attempt(s): {last!r}")
        self.site = site
        self.attempts = attempts
        self.last = last

    @property
    def degradable(self) -> bool:
        """Whether the chunk may polish on the host path instead: the last
        failure was injected, or the site is an upload (module
        docstring)."""
        return bool(getattr(self.last, "injected", False)) or \
            self.site.startswith("h2d/")


def _transient_classes() -> Tuple[type, ...]:
    """The exception classes worth retrying (module docstring)."""
    import torch
    from racon_tpu_torch.resilience.faults import InjectedFault
    return (InjectedFault, ConnectionError, TimeoutError, OSError,
            torch.OutOfMemoryError)


_TRANSIENT: Optional[Tuple[type, ...]] = None


def is_transient(exc: BaseException) -> bool:
    global _TRANSIENT
    if _TRANSIENT is None:
        _TRANSIENT = _transient_classes()
    return isinstance(exc, _TRANSIENT)


class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter.

    ``attempts`` is the TOTAL try budget (attempts=1 means no retries).
    The delay before retry ``k`` (k = 1 for the first retry) is::

        min(base * multiplier**(k-1), max_delay) * (1 + jitter * u)

    where ``u`` in [-1, 1) comes from sha256(seed, site, k).
    """

    __slots__ = ("attempts", "base", "multiplier", "max_delay", "jitter",
                 "seed")

    def __init__(self, attempts: int = 4, base: float = 0.05,
                 multiplier: float = 2.0, max_delay: float = 2.0,
                 jitter: float = 0.1, seed: int = 0):
        if attempts < 1:
            raise ValueError(
                f"[racon_tpu_torch::resilience] invalid attempts {attempts}")
        self.attempts = int(attempts)
        self.base = float(base)
        self.multiplier = float(multiplier)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.seed = int(seed)

    def retryable(self, exc: BaseException) -> bool:
        return is_transient(exc)

    def delay(self, attempt: int, site: str = "") -> float:
        """Backoff before retry ``attempt`` (1-based), in seconds."""
        d = min(self.base * self.multiplier ** (attempt - 1),
                self.max_delay)
        if self.jitter:
            h = hashlib.sha256(
                f"{self.seed}:{site}:{attempt}".encode()).digest()
            u = int.from_bytes(h[:8], "big") / 2 ** 63 - 1.0  # [-1, 1)
            d *= 1.0 + self.jitter * u
        return max(d, 0.0)

    def schedule(self, site: str = "") -> Tuple[float, ...]:
        """The whole delay sequence (attempts-1 entries)."""
        return tuple(self.delay(k, site)
                     for k in range(1, self.attempts))


_DEFAULT: Optional[RetryPolicy] = None


def default_policy() -> RetryPolicy:
    """The process default, from ``RACON_TPU_RETRY`` as a comma list of
    key=value pairs (attempts/base/multiplier/max_delay/jitter/seed), e.g.
    ``RACON_TPU_RETRY=attempts=6,base=0.2``. ``attempts=1`` turns retrying
    off and keeps the degradation path."""
    global _DEFAULT
    if _DEFAULT is None:
        kw = {}
        spec = env.read(ENV_RETRY)
        for part in filter(None, (p.strip() for p in spec.split(","))):
            try:
                key, val = part.split("=", 1)
                kw[key] = int(val) if key in ("attempts", "seed") \
                    else float(val)
            except ValueError as exc:
                raise ValueError(
                    f"[racon_tpu_torch::resilience] invalid {ENV_RETRY} "
                    f"clause {part!r}") from exc
        _DEFAULT = RetryPolicy(**kw)
    return _DEFAULT


def configure(policy: Optional[RetryPolicy]) -> None:
    """Install (or with None, drop back to the env-derived) process
    default policy."""
    global _DEFAULT
    _DEFAULT = policy


def call(site: str, fn: Callable, *args,
         policy: Optional[RetryPolicy] = None,
         deadline_s: Optional[float] = None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under the retry policy, with the fault
    injector's hook for ``site`` armed before every try.

    The injection point sits INSIDE the retried body, so
    ``h2d/chunk:0,1`` exercises the real recovery: tries 1 and 2 raise,
    try 3 (call index 2 at that site) succeeds. An injected raise fires
    before ``fn``, so a retried attempt launches nothing twice.

    Every attempt runs under the watchdog (resilience/watchdog.py):
    ``deadline_s=None`` resolves the site's class default, callers with
    the chunk's geometry pass a derived deadline, and <= 0 turns the
    guard off. A breach raises DispatchTimeout — transient, so it lands
    in this loop; past the terminal breach budget it raises
    WatchdogTerminal, which is not transient and propagates. The fault
    hook sits inside the guarded body, so an injected ``hang`` is bounded
    by the same deadline as an organic one, and an attempt whose caller
    gave up during the hang returns without running ``fn``.
    """
    from racon_tpu_torch.pipeline.metrics import (record_retry,
                                                  record_retry_exhausted)
    from racon_tpu_torch.resilience.faults import maybe_fault
    from racon_tpu_torch.resilience.watchdog import (abandoned, guard,
                                                     site_deadline)

    if deadline_s is None:
        deadline_s = site_deadline(site)

    def _attempt():
        maybe_fault(site)
        if abandoned():
            return None         # the caller has moved on: launch nothing
        return fn(*args, **kwargs)

    pol = policy if policy is not None else default_policy()
    attempt = 0
    while True:
        try:
            if deadline_s and deadline_s > 0:
                return guard(site, deadline_s, _attempt)
            return _attempt()
        except BaseException as exc:  # noqa: BLE001 — filtered below
            if not pol.retryable(exc):
                raise
            attempt += 1
            if attempt >= pol.attempts:
                record_retry_exhausted(site, attempt)
                raise RetryExhausted(site, attempt, exc) from exc
            d = pol.delay(attempt, site)
            record_retry(site, attempt, d, type(exc).__name__,
                         getattr(exc, "injected", False))
            if d > 0:
                time.sleep(d)
