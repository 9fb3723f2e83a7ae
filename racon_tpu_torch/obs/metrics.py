"""The port's one metrics registry, in the JAX package's location (its
``obs/metrics.py``).

A process-wide store of named numbers and JSON-ready values under the
JAX package's registry keys. Every module of the port writes here: the
streaming pipeline's, ingest plane's, transfers' and fault plane's
recorders (pipeline/metrics.py, which re-exports :func:`registry` and
:func:`reset` from this module, so both names reach the same object)
and the service core's below — the checkpoint store (``res_ckpt_*``),
the result cache (``cache_*``), the daemon and its batcher (``serve_*``),
the gateway's routing (``gate_*``), the ledger fleet (``dist_*``), the
ava planner (``ava_*``), and the polish loop's window and phase totals
(``poa_windows_total``, ``phase_seconds_*``) that the fleet aggregator
(obs/fleet.py) divides into per-worker rates. Every update takes the
registry's lock; a multi-key read-modify-write goes through
:meth:`Registry.apply`, under the lock once. Keys starting with ``_``
are internal and left out of snapshots. Mutations of the process
registry also land in the flight recorder's ring (obs/flightrec.py).

Fixed-bucket histograms (:data:`HIST_BUCKETS`, :func:`record_hist`,
:func:`hist_quantile`) and the fleet merge kinds (:func:`merge_kind`,
:func:`merge_values`) are the JAX package's, so the OpenMetrics render
(obs/export.py) types each key, and the fleet model folds it, as the
reference does.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from racon_tpu_torch.obs import flightrec as _flightrec
from racon_tpu_torch.obs import trace as _trace


class Registry:
    """Named counters and gauges, safe to update from any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._v: Dict[str, object] = {}   # guarded-by: _lock

    def _flight(self, key: str, value) -> None:
        if self is _REGISTRY:
            _flightrec.note_metric(key, value)

    def inc(self, key: str, v=1) -> None:
        with self._lock:
            self._v[key] = self._v.get(key, 0) + v
        self._flight(key, v)

    def max(self, key: str, v) -> None:
        with self._lock:
            self._v[key] = max(self._v.get(key, v), v)
        self._flight(key, v)

    def set(self, key: str, v) -> None:
        with self._lock:
            self._v[key] = v
        self._flight(key, v)

    def apply(self, fn) -> None:
        """Run ``fn(values_dict)`` under the lock: the one mutation point
        for updates that read and write several keys together."""
        with self._lock:
            fn(self._v)

    def get(self, key: str, default=None):
        with self._lock:
            return self._v.get(key, default)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {k: v for k, v in self._v.items()
                    if not k.startswith("_")}

    def reset(self) -> None:
        with self._lock:
            self._v.clear()


_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY


def reset() -> None:
    _REGISTRY.reset()


# ------------------------------------------------------------ histograms

#: Fixed-bucket histograms: family -> ascending upper bucket bounds
#: (seconds, ``le``; one implicit +Inf bucket at the end).
HIST_BUCKETS = {
    "dispatch_round_s": (0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                         0.5, 1.0, 2.5, 5.0, 10.0),
    "h2d_transfer_s": (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                       0.1, 0.25, 0.5, 1.0, 2.5),
    "serve_job_latency_s": (0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                            5.0, 10.0, 25.0, 60.0, 120.0),
    "serve_queue_wait_s": (0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                           1.0, 2.5, 5.0, 10.0, 30.0),
    "walk_hidden_s": (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                      0.1, 0.25, 0.5, 1.0, 2.5),
}


def record_hist(name: str, value: float,
                reg: Optional[Registry] = None) -> None:
    """One observation into the histogram ``name``: the registry value is
    ``{"buckets": [c0, ..., cN, overflow], "sum": s, "count": n}`` with
    per-bucket (not cumulative) counts."""
    reg = reg if reg is not None else _REGISTRY
    bounds = HIST_BUCKETS[name]
    value = float(value)

    def _mutate(v):
        h = v.get(name)
        if h is None:
            h = v[name] = {"buckets": [0] * (len(bounds) + 1),
                           "sum": 0.0, "count": 0}
        idx = len(bounds)
        for i, bound in enumerate(bounds):
            if value <= bound:
                idx = i
                break
        h["buckets"][idx] += 1
        h["sum"] = round(h["sum"] + value, 6)
        h["count"] += 1

    reg.apply(_mutate)
    if reg is _REGISTRY:
        _flightrec.note_metric(name, round(value, 6))


def hist_quantile(hist: Dict, q: float, bounds) -> float:
    """The q-quantile (0..1) of a histogram dict, interpolated linearly in
    its bucket; the overflow bucket clamps to the last bound; 0.0 when
    empty."""
    count = int(hist.get("count", 0))
    if count <= 0:
        return 0.0
    target = q * count
    seen = 0
    lo = 0.0
    for i, c in enumerate(hist["buckets"]):
        hi = float(bounds[i]) if i < len(bounds) else float(bounds[-1])
        if c and seen + c >= target:
            frac = (target - seen) / c
            return round(lo + (hi - lo) * min(max(frac, 0.0), 1.0), 6)
        seen += c
        lo = hi
    return round(float(bounds[-1]), 6)


# ------------------------------------------------------------- checkpoint

def record_ckpt(event: str, tid: int, nbytes: int,
                reg: Optional[Registry] = None) -> None:
    """One checkpoint event (resilience/checkpoint.py): ``commit``,
    ``skip`` (a resumed run re-emitted a committed contig), ``seal``,
    ``compaction`` or ``resume`` (``tid`` = contigs committed)."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc(f"res_ckpt_{event}s" if event != "resume" else
            "res_ckpt_resumes")
    if event == "commit":
        reg.inc("res_ckpt_bytes", int(nbytes))
    _trace.get_tracer().point("checkpoint", event, tid=int(tid),
                              bytes=int(nbytes))


# ---------------------------------------------------------- serve plane

def record_serve_job(event: str, job: str, tenant: str,
                     trace_id: str = "-", parent_id: int = 0,
                     reg: Optional[Registry] = None) -> int:
    """One daemon job event (``submitted``, ``completed``, ``failed``,
    ``cancelled``, ``resumed``): the counter ``serve_jobs_<event>`` and a
    ``serve`` span; returns the span id."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc(f"serve_jobs_{event}")
    return _trace.get_tracer().point("serve", event, job=str(job),
                                     tenant=str(tenant),
                                     trace_id=str(trace_id),
                                     parent_id=int(parent_id))


def record_serve_batch(n_windows: int, capacity: int, jobs, tenants,
                       wait_s: float, round_s: float = 0.0,
                       trace_ids=(), parent_ids=(),
                       reg: Optional[Registry] = None) -> None:
    """One cross-request batch dispatch (server/batch.py): windows
    carried, its jobs and tenants, the staging wait its items paid and
    its round's wall (``dispatch_round_s``). ``serve_batch_occupancy`` =
    windows a dispatch over the capacity, derived in the same pass."""
    reg = reg if reg is not None else _REGISTRY
    cap = max(int(capacity), 1)

    def _mutate(v):
        v["serve_batches"] = v.get("serve_batches", 0) + 1
        v["serve_batch_windows"] = \
            v.get("serve_batch_windows", 0) + int(n_windows)
        v["serve_tenant_wait_s"] = \
            v.get("serve_tenant_wait_s", 0.0) + float(wait_s)
        v["serve_batch_occupancy"] = round(
            v["serve_batch_windows"] / (v["serve_batches"] * cap), 4)
        v["serve_rate_wall_s"] = round(time.time(), 3)

    reg.apply(_mutate)
    if round_s > 0:
        record_hist("dispatch_round_s", float(round_s), reg)
    tid = ",".join(sorted({str(t) for t in trace_ids if t})) or "-"
    pid = int(next(iter(parent_ids), 0))
    _trace.get_tracer().point("serve", "batch",
                              job=",".join(str(j) for j in jobs),
                              tenant=",".join(str(t) for t in tenants),
                              windows=int(n_windows), capacity=cap,
                              wait_s=round(float(wait_s), 6),
                              trace_id=tid, parent_id=pid)


def set_serve_active(n: int, reg: Optional[Registry] = None) -> None:
    """The daemon's in-flight job gauge."""
    reg = reg if reg is not None else _REGISTRY
    reg.set("serve_active_jobs", int(n))


def set_serve_rate(jobs_per_min: float,
                   reg: Optional[Registry] = None) -> None:
    """The daemon's completion rate (jobs a minute of uptime) and its
    freshness stamp ``serve_rate_wall_s``."""
    reg = reg if reg is not None else _REGISTRY

    def _mutate(v):
        v["serve_jobs_per_min"] = round(float(jobs_per_min), 4)
        v["serve_rate_wall_s"] = round(time.time(), 3)

    reg.apply(_mutate)


# ------------------------------------------------------------ gate plane

#: Gateway events -> their counters; record_gate refuses any other.
_GATE_EVENT_KEYS = {
    "route_fleet": "gate_routed_fleet",
    "route_local": "gate_routed_local",
    "adopt": "gate_adoptions",
    "fleet_run": "gate_fleet_runs",
}


def record_gate(event: str, job: str, tenant: str,
                trace_id: str = "-", parent_id: int = 0,
                reg: Optional[Registry] = None,
                wall_s: Optional[float] = None, **attrs) -> int:
    """One gateway event (gateway/): a counter and a ``gate`` span;
    returns the span id."""
    reg = reg if reg is not None else _REGISTRY
    try:
        key = _GATE_EVENT_KEYS[event]
    except KeyError:
        raise ValueError(f"[racon_tpu_torch::metrics] unknown gate event "
                         f"{event!r}") from None
    reg.inc(key)
    if wall_s is not None:
        reg.inc("gate_fleet_wall_s", float(wall_s))
        attrs["wall_s"] = round(float(wall_s), 6)
    return _trace.get_tracer().point("gate", event, job=str(job),
                                     tenant=str(tenant),
                                     trace_id=str(trace_id),
                                     parent_id=int(parent_id), **attrs)


def set_gate_fleet_target(n: int, reg: Optional[Registry] = None) -> None:
    """The gateway's fleet sizing gauge: the worker target the service
    policy (gateway/policy.py) chose on its latest supervisor tick."""
    reg = reg if reg is not None else _REGISTRY
    reg.set("gate_fleet_target", int(n))


# ----------------------------------------------------------- result cache

_CACHE_OUTCOME_KEYS = {
    "hit": "cache_hits_total",
    "miss": "cache_misses_total",
    "store": "cache_stores_total",
    "evict": "cache_evictions_total",
    "verify_fail": "cache_verify_fail_total",
}


def record_cache(tier: str, outcome: str, n: int = 1, nbytes: int = 0,
                 reg: Optional[Registry] = None) -> None:
    """Result-cache events (cache/): ``tier`` ``job`` (the CAS) or
    ``window`` (the batcher's memo); ``outcome`` ``hit``, ``miss``,
    ``store``, ``evict`` or ``verify_fail``; ``n`` events at once;
    ``nbytes`` stored. ``cache_hit_ratio`` is derived in the same pass."""
    reg = reg if reg is not None else _REGISTRY
    key = _CACHE_OUTCOME_KEYS.get(outcome)
    if key is None:
        raise ValueError(f"[racon_tpu_torch::metrics] unknown cache "
                         f"outcome {outcome!r}")

    def _mutate(v):
        v[key] = v.get(key, 0) + int(n)
        if nbytes:
            v["cache_bytes"] = v.get("cache_bytes", 0) + int(nbytes)
        seen = v.get("cache_hits_total", 0) + \
            v.get("cache_misses_total", 0)
        if seen:
            v["cache_hit_ratio"] = round(
                v.get("cache_hits_total", 0) / seen, 4)

    reg.apply(_mutate)
    _trace.get_tracer().point("cache", outcome, tier=str(tier),
                              outcome=str(outcome), n=int(n),
                              bytes=int(nbytes))


# ------------------------------------------------------- distributed work

def record_dist(event: str, shard, worker, value: float = 1,
                reg: Optional[Registry] = None, **attrs) -> None:
    """One work-ledger event (distributed/): the counter ``dist_<event>``
    (``claims``, ``shards_stolen``, ``leases_expired``,
    ``lease_renewals``, ``leases_lost``, ``contigs_polished``,
    ``contigs_repolished``, ``contigs_resumed``, ``shards_completed``,
    ``steal_latency_s``, ``recovery_wall_s``, ``merges``, ...) grows by
    ``value`` under the registry's lock, and a ``dist`` span carries the
    shard (-1 for run-level events) and the worker."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc(f"dist_{event}", value)
    _trace.get_tracer().point("dist", event, shard=int(shard),
                              worker=str(worker), **attrs)


def set_dist(key: str, value: object,
             reg: Optional[Registry] = None) -> None:
    """A fleet-shape gauge: ``dist_workers``, ``dist_shards``,
    ``dist_n_targets``."""
    reg = reg if reg is not None else _REGISTRY
    reg.set(f"dist_{key}", value)


# -------------------------------------------------------------- ava plane

def record_ava_plan(plan, reg: Optional[Registry] = None) -> None:
    """The ava shape-bucket plan (ava/planner.py) as gauges: targets,
    buckets, the quantum the budget loop settled on, the budget and the
    padding it cost. Every worker computes the same plan from the
    ledger's published offsets, so the fleet merge takes the last."""
    reg = reg if reg is not None else _REGISTRY
    reg.set("ava_targets", int(plan.n_targets))
    reg.set("ava_buckets", int(plan.n_buckets))
    reg.set("ava_quantum", int(plan.quantum))
    reg.set("ava_compile_budget", int(plan.budget))
    reg.set("ava_pad_frac", round(float(plan.pad_frac), 4))


# -------------------------------------------------- phases and windows

def _phase_slug(msg: str) -> str:
    """Registry-key slug of a logger phase message:
    ``"[racon_tpu_torch::Polisher::initialize] loaded sequences"`` ->
    ``"initialize_loaded_sequences"``."""
    msg = msg.strip()
    if msg.startswith("[") and "]" in msg:
        head, _, rest = msg.partition("]")
        msg = head[1:].rsplit("::", 1)[-1] + " " + rest
    out = []
    for ch in msg.lower():
        out.append(ch if ch.isalnum() else "_")
    slug = "_".join(filter(None, "".join(out).split("_")))
    return slug[:64] or "unnamed"


def record_phase_seconds(msg: str, seconds: float,
                         reg: Optional[Registry] = None) -> None:
    """One finished logger phase (utils/logger.py) as
    ``phase_seconds_<slug>`` plus the ``phase_seconds_total`` roll-up:
    the per-worker phase split of the fleet model."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc(f"phase_seconds_{_phase_slug(msg)}", float(seconds))
    reg.inc("phase_seconds_total", float(seconds))


def record_windows(n: int, reg: Optional[Registry] = None) -> None:
    """``n`` polished windows (ops/poa.py, the streaming pipeline):
    ``poa_windows_total``, cumulative across chunks, contigs and shards,
    which the fleet model divides by a worker's wall seconds."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("poa_windows_total", int(n))


# ------------------------------------------------------------ merge kinds

MERGE_SUM = "sum"
MERGE_MAX = "max"
MERGE_LAST = "last"
MERGE_HIST = "hist"

#: Keys whose fleet merge is ``last`` (point-in-time gauges), as in the
#: JAX package.
_MERGE_LAST_KEYS = frozenset({
    "dist_workers", "dist_shards", "dist_n_targets",
    "ovl_device_fraction", "walk_chain_len",
    "pipe_overlap_efficiency",
    "jax_cache_enabled", "jax_cache_entries_start",
    "jax_cache_entries_added",
    "sched_rounds", "sched_windows", "sched_chunks",
    "sched_rounds_hist", "sched_survivor_frac",
    "sched_rounds_saved_frac", "sched_repack_overhead_s",
    "sched_dispatches_saved",
    "fleet_target_workers",
    "ingest_fraction_of_wall", "ingest_enabled",
    "walk_async_enabled", "walk_hidden_fraction",
    "serve_active_jobs", "serve_batch_occupancy", "serve_jobs_per_min",
    "serve_rate_wall_s",
    "cache_hit_ratio",
    "gate_fleet_target", "gate_fleet_jobs_per_min",
    "gate_compile_skip_s",
    "ava_targets", "ava_buckets", "ava_quantum", "ava_compile_budget",
    "ava_pad_frac", "ava_reads_per_sec", "ava_peak_rss_mb",
    "ava_manifest_bytes_per_target",
})


def merge_kind(key: str) -> str:
    """The fleet merge kind of a registry key: ``hist`` for the
    histogram families, ``last`` for gauges, ``max`` for ``*_peak``,
    else ``sum``."""
    if key in HIST_BUCKETS:
        return MERGE_HIST
    if key in _MERGE_LAST_KEYS:
        return MERGE_LAST
    if key.endswith("_peak"):
        return MERGE_MAX
    return MERGE_SUM


def merge_values(key: str, values) -> object:
    """Fold per-worker values of ``key`` by its merge kind (the fleet
    model, obs/fleet.py). Histogram dicts fold bucket by bucket; other
    non-numeric values (the scheduler's round histogram) take the last;
    None values are skipped, and all-None folds to None."""
    vals = [v for v in values if v is not None]
    if not vals:
        return None
    kind = merge_kind(key)
    if kind == MERGE_HIST:
        n = len(HIST_BUCKETS[key]) + 1
        out = {"buckets": [0] * n, "sum": 0.0, "count": 0}
        for v in vals:
            if not isinstance(v, dict):
                continue
            for i, c in enumerate(v.get("buckets", ())[:n]):
                out["buckets"][i] += int(c)
            out["sum"] = round(out["sum"] + float(v.get("sum", 0.0)), 6)
            out["count"] += int(v.get("count", 0))
        return out
    numeric = all(isinstance(v, (int, float)) and
                  not isinstance(v, bool) for v in vals)
    if not numeric or kind == MERGE_LAST:
        return vals[-1]
    if kind == MERGE_MAX:
        return max(vals)
    total = sum(vals)
    return round(total, 6) if isinstance(total, float) else total
