"""Deterministic, env-gated fault injection — port of the JAX package's
``resilience/faults.py``.

The retry, degradation and stall-recovery paths are only credible if they
can be exercised where real transfer faults never happen (the CPU tests,
and a clean card). ``RACON_TPU_FAULTS=<spec>`` arms the
:func:`maybe_fault` hooks that retry.call() places inside every retried
attempt, raising synthetic :class:`InjectedFault` errors (or sleeping, or
killing the process) at chosen per-site call indices.

Spec grammar (clauses joined by ``;``)::

    spec    := clause (';' clause)*
    clause  := site ':' selector ['!' action]
             | 'seed=' int
             | 'skew=' float               # lease-clock skew, seconds
    selector:= index (',' index)*          # explicit call indices
             | 'p=' float                  # per-call probability
    action  := 'raise'                     # default: InjectedFault
             | 'kill'                      # hard exit 137, no cleanup
             | 'term' | 'int'              # signal self (SIGTERM/SIGINT)
             | 'torn'                      # tear the write in progress
             | 'hang' ['=' float]          # sleep past the armed watchdog
                                           #   deadline (or S seconds)
             | 'stall' ['=' float]         # sleep S seconds, then proceed

Examples::

    RACON_TPU_FAULTS='h2d/chunk:0,1,2'          # first 3 chunk uploads fail
    RACON_TPU_FAULTS='d2h/chunk:p=0.05;seed=7'  # 5% of pulls, seeded
    RACON_TPU_FAULTS='dispatch/chunk:1!hang=2'  # 2nd dispatch wedges 2 s
    RACON_TPU_FAULTS='pipe/pack:0!hang=3'       # the pack stage wedges

The port's sites (:data:`SITES`): the chunk transfers and dispatches
``h2d/chunk``, ``dispatch/chunk``, ``dispatch/walk``, ``d2h/chunk``, the
scheduler's ``sched/flags`` and ``h2d/repack``, the ingest plane's
``io/read`` (once a line on the streaming readers, once a record on the
mmap readers) and ``io/inflate`` (once a gzip block or member handed to
the inflate pool, or a feed of the stream inflate), and the pipeline
stages' ``pipe/<stage>``. Arming any ``io/*`` site turns the ingest
prefetch threads off (io/ingest.prefetch_ok), so that explicit call
indices stay deterministic. Call indices are 0-based and advance once an
*attempt* at that site (each retry consults the injector again), so
``site:0,1`` checks a genuine two-failure recovery.

``kill`` goes through :func:`hard_exit` (``os._exit``, no cleanup), so
in-process tests can intercept the death; ``torn`` tears a write at a
site that supports tearing (:func:`maybe_torn`) and degrades to ``raise``
elsewhere (the port has no tear-capable site yet); ``skew=S`` is parsed
and kept (:func:`clock_skew`) for the distributed ledger.

Determinism: explicit-index decisions are pure functions of the per-site
call counter; probability decisions hash ``(seed, site, index)`` with the
JAX package's hash, so the same spec and seed fault the same call indices
in both packages. Counters are process-wide and thread-safe. Every fired
fault is recorded (``res_fault_*`` counters and a ``fault`` trace span)
via pipeline/metrics.py::record_fault.

When the variable is unset the hook is a single None check.
"""

from __future__ import annotations

import hashlib
import os
import signal
import threading
import time
from typing import Dict, List, Optional, Tuple

from racon_tpu_torch.utils import env

ENV_FAULTS = env.FAULTS

_ACTIONS = ("raise", "kill", "term", "int", "torn", "hang", "stall")

#: The sites this package consults (keep alphabetical); later slices add
#: theirs.
SITES = (
    "d2h/chunk",
    "dispatch/chunk", "dispatch/walk",
    "h2d/chunk", "h2d/repack",
    "io/inflate", "io/read",
    "sched/flags",
)

#: Dynamic site families: the concrete site is prefix + a runtime name
#: (the pipeline's stage names, pipe/<stage>).
SITE_PREFIXES = ("pipe/",)

#: Fallback sleep for ``stall`` with no explicit duration, seconds.
ENV_STALL_S = env.FAULT_STALL_S
_STALL_DEFAULT_S = 1.0
#: Fallback sleep for ``hang`` when no watchdog deadline is armed on the
#: current thread and no explicit duration was given, seconds.
ENV_HANG_S = env.FAULT_HANG_S
_HANG_DEFAULT_S = 30.0


def hard_exit(code: int) -> None:
    """Simulated hard crash: no atexit, no flushes. A seam so in-process
    tests can intercept the death; a real fault does ``os._exit``."""
    os._exit(code)


class InjectedFault(RuntimeError):
    """A synthetic transfer/dispatch failure raised by the injector.

    ``injected`` marks the error so retry accounting can tell synthetic
    from organic failures.
    """

    injected = True

    def __init__(self, site: str, index: int):
        super().__init__(
            f"[racon_tpu_torch::faults] injected fault at {site} call "
            f"{index}")
        self.site = site
        self.index = index


class FaultSpecError(ValueError):
    pass


class _SiteRule:
    __slots__ = ("indices", "prob", "action", "duration")

    def __init__(self, indices: Optional[frozenset], prob: float,
                 action: str, duration: Optional[float] = None):
        self.indices = indices   # frozenset of call indices, or None
        self.prob = prob         # used when indices is None
        self.action = action
        self.duration = duration  # hang=S / stall=S sleep, seconds


def _parse(spec: str) -> Tuple[Dict[str, _SiteRule], int, float]:
    rules: Dict[str, _SiteRule] = {}
    seed = 0
    skew = 0.0
    for clause in filter(None, (c.strip() for c in spec.split(";"))):
        if clause.startswith("seed="):
            try:
                seed = int(clause[5:])
            except ValueError:
                raise FaultSpecError(
                    f"[racon_tpu_torch::faults] bad seed clause {clause!r}")
            continue
        if clause.startswith("skew="):
            try:
                skew = float(clause[5:])
            except ValueError:
                raise FaultSpecError(
                    f"[racon_tpu_torch::faults] bad skew clause {clause!r}")
            continue
        if ":" not in clause:
            raise FaultSpecError(
                f"[racon_tpu_torch::faults] clause {clause!r} is not "
                "'site:selector' or 'seed=N'")
        site, sel = clause.split(":", 1)
        action = "raise"
        duration: Optional[float] = None
        if "!" in sel:
            sel, action = sel.split("!", 1)
            if "=" in action:
                # hang=S / stall=S: an explicit sleep, seconds.
                action, dur_txt = action.split("=", 1)
                if action not in ("hang", "stall"):
                    raise FaultSpecError(
                        f"[racon_tpu_torch::faults] action {action!r} "
                        f"takes no '=' argument in clause {clause!r}")
                try:
                    duration = float(dur_txt)
                    if duration < 0:
                        raise ValueError
                except ValueError:
                    raise FaultSpecError(
                        f"[racon_tpu_torch::faults] bad duration "
                        f"{dur_txt!r} in clause {clause!r}")
            if action not in _ACTIONS:
                raise FaultSpecError(
                    f"[racon_tpu_torch::faults] unknown action {action!r} "
                    f"(expected one of {', '.join(_ACTIONS)})")
        site = site.strip()
        if not site:
            raise FaultSpecError(
                f"[racon_tpu_torch::faults] empty site in clause "
                f"{clause!r}")
        try:
            if sel.startswith("p="):
                prob = float(sel[2:])
                if not 0.0 <= prob <= 1.0:
                    raise ValueError
                rules[site] = _SiteRule(None, prob, action, duration)
            else:
                idx = frozenset(int(p) for p in sel.split(","))
                if any(i < 0 for i in idx):
                    raise ValueError
                rules[site] = _SiteRule(idx, 0.0, action, duration)
        except ValueError:
            raise FaultSpecError(
                f"[racon_tpu_torch::faults] bad selector {sel!r} in clause "
                f"{clause!r}")
    return rules, seed, skew


class FaultInjector:
    """Parsed fault plan + per-site call counters."""

    def __init__(self, spec: str, seed: Optional[int] = None):
        self._rules, parsed_seed, self.skew = _parse(spec)
        self.seed = parsed_seed if seed is None else int(seed)
        self.spec = spec
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}   # guarded-by: _lock
        self.fired: List[Tuple[str, int, str]] = []  # guarded-by: _lock

    def sites(self) -> Tuple[str, ...]:
        return tuple(sorted(self._rules))

    def _decide(self, site: str, index: int) -> Optional[str]:
        rule = self._rules.get(site)
        if rule is None:
            return None
        if rule.indices is not None:
            return rule.action if index in rule.indices else None
        h = hashlib.sha256(
            f"{self.seed}:{site}:{index}".encode()).digest()
        u = int.from_bytes(h[:8], "big") / 2 ** 64
        return rule.action if u < rule.prob else None

    def check(self, site: str, torn_ok: bool = False) -> bool:
        """Advance ``site``'s call counter; fire if the plan says so.

        ``torn_ok``: the caller is a write site that supports torn writes
        — a ``torn`` action returns True (the caller tears its write and
        hard-exits) instead of raising. Returns False when nothing fired.
        """
        with self._lock:
            index = self._counts.get(site, 0)
            self._counts[site] = index + 1
            action = self._decide(site, index)
            if action is not None:
                self.fired.append((site, index, action))
                duration = self._rules[site].duration
        if action is None:
            return False
        from racon_tpu_torch.pipeline.metrics import record_fault
        record_fault(site, index, action)
        if action in ("hang", "stall"):
            self._sleep(action, duration)
            return False
        if action == "torn" and torn_ok:
            return True
        if action in ("raise", "torn"):
            # A torn rule at a site with no write to tear degrades to a
            # plain synthetic failure.
            raise InjectedFault(site, index)
        if action == "kill":
            hard_exit(137)
        os.kill(os.getpid(), signal.SIGTERM if action == "term"
                else signal.SIGINT)
        return False

    @staticmethod
    def _sleep(action: str, duration: Optional[float]) -> None:
        """Fail-slow actions: block, then PROCEED normally.

        ``stall`` sleeps a bounded time (explicit ``=S`` or
        RACON_TPU_FAULT_STALL_S, default 1 s): a transient slowdown that
        must not trip anything by itself. ``hang`` sleeps past whatever
        watchdog deadline is armed on the current thread (2x the ambient
        deadline), or an explicit ``=S``, or RACON_TPU_FAULT_HANG_S
        (default 30 s) when unguarded — e.g. at a pipeline stage, where
        test. Returning (rather than sleeping forever) lets abandoned
        guard threads end, so tests leak no busy threads. A guarded body
        is marked first, so a breach of the sleep counts as injected."""
        from racon_tpu_torch.resilience.watchdog import (ambient_deadline,
                                                         note_injected_sleep)
        note_injected_sleep()
        if action == "stall":
            if duration is None:
                duration = float(env.read(ENV_STALL_S) or _STALL_DEFAULT_S)
            time.sleep(duration)
            return
        if duration is None:
            armed = ambient_deadline()
            duration = 2.0 * armed if armed > 0 else \
                float(env.read(ENV_HANG_S) or _HANG_DEFAULT_S)
        time.sleep(duration)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


_INJECTOR: Optional[FaultInjector] = None
_ARMED = False


def configure(spec: Optional[str], seed: Optional[int] = None) -> \
        Optional[FaultInjector]:
    """Install a fault plan programmatically (tests), or clear it with
    ``spec=None``. Returns the installed injector."""
    global _INJECTOR, _ARMED
    _INJECTOR = FaultInjector(spec, seed) if spec else None
    _ARMED = True
    return _INJECTOR


def get_injector() -> Optional[FaultInjector]:
    """The active injector, armed lazily from ``RACON_TPU_FAULTS``."""
    global _INJECTOR, _ARMED
    if not _ARMED:
        spec = env.read(ENV_FAULTS)
        _INJECTOR = FaultInjector(spec) if spec else None
        _ARMED = True
    return _INJECTOR


def maybe_fault(site: str) -> None:
    """The hook retry.call() runs before every attempt. Near-free when no
    fault plan is configured."""
    inj = get_injector()
    if inj is not None:
        inj.check(site)


def maybe_torn(site: str) -> bool:
    """The hook a tear-capable write site runs before its append: True
    when a ``torn`` rule fires there (the caller then writes a partial
    record, makes it durable and calls :func:`hard_exit`). Other actions
    behave as in :func:`maybe_fault`."""
    inj = get_injector()
    return inj.check(site, torn_ok=True) if inj is not None else False


def clock_skew() -> float:
    """Seconds a lease clock shifts by (``skew=S``); 0.0 when unarmed."""
    inj = get_injector()
    return inj.skew if inj is not None else 0.0
