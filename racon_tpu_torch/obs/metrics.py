"""The port's one metrics registry and every recorder over it — port of
the JAX package's ``obs/metrics.py``, in its sections and order, under
its registry keys.

Every module of the port writes here: the transfer choke points
(ops/device_poa.py, sched/scheduler.py, parallel/dispatch.py), the
engine's dispatches and adaptive exit (``device_dispatches``,
``walk_chain_len``, ``adaptive_*``), the fault plane (``res_*``), the
ledger fleet (``dist_*``), the overlap aligner (``ovl_*``,
``align_phase_seconds``), the wide-band redo (``redo_*``), the ingest
plane (``ingest_*``), the streaming pipeline (``pipe_*``, ``walk_*``),
the daemon and its batcher (``serve_*``), the gateway (``gate_*``), the
ava planner (``ava_*``), the result cache (``cache_*``), the convergence
scheduler's telemetry (``sched_*``, :func:`publish_sched`) and the polish
loop's window and phase totals (``poa_windows_total``,
``phase_seconds_*``). The ``*_extras`` functions give each family as a
JSON-ready dict; :func:`sched_summary_line` formats the polisher's
stderr "scheduler" line from the registry. Every update takes the
registry's lock; a multi-key read-modify-write goes through
:meth:`MetricsRegistry.apply`, under the lock once. Keys starting with
``_`` are internal and left out of snapshots. Mutations of the process
registry also land in the flight recorder's ring (obs/flightrec.py).

Counter conventions:

- ``h2d_bytes`` / ``h2d_s`` / ``h2d_transfers`` — bytes shipped to the
  card, seconds of the copy's enqueue (the copy is asynchronous, so a
  lower bound on the transfer), and the count; each also lands in the
  ``h2d_transfer_s`` histogram;
- ``d2h_bytes`` / ``d2h_s`` / ``d2h_transfers`` — pulls from the card;
  a pull waits for the compute that produces it, so ``d2h_s`` is "time
  blocked pulling results";
- ``sched_flag_pulls`` / ``sched_flag_pull_s`` — the scheduler's
  per-round flag pulls, a sync point kept out of the bandwidth keys;
- ``device_dispatches`` — chunk, round, repack, pack and walk launches
  of the consensus engine (one a retry-wrapped dispatch call);
- ``ovl_card_s`` / ``ovl_host_align_s`` / ``ovl_walk_s`` — the align
  phase's wall seconds by step (:data:`OVL_STEP_KEYS`), and
  ``ovl_tail_lanes`` — tiled lanes whose group ran a tile past their
  rows (:func:`record_ovl`): keys the JAX package does not have.

The JAX package's three compile-cache gauges (``jax_cache_enabled``,
``jax_cache_entries_start``, ``jax_cache_entries_added``) have no
meaning without JAX: the port records none of them, and they have no row
in :data:`METRIC_SPECS` and no merge kind here.

No device syncs anywhere: every value rides on host data the path
already had in hand.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from racon_tpu_torch.obs import flightrec as _flightrec
from racon_tpu_torch.obs import trace as _trace


class MetricsRegistry:
    """Flat name -> value store: numeric counters plus JSON-ready
    structured values (lists, dicts), safe to update from any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._v: Dict[str, object] = {}   # guarded-by: _lock

    def _flight(self, key: str, value) -> None:
        if self is _REGISTRY:
            _flightrec.note_metric(key, value)

    def inc(self, key: str, value: float = 1) -> None:
        with self._lock:
            self._v[key] = self._v.get(key, 0) + value
        self._flight(key, value)

    def set(self, key: str, value: object) -> None:
        with self._lock:
            self._v[key] = value
        self._flight(key, value)

    def max(self, key: str, value: float) -> None:
        """Keep the running maximum (gauge peaks, e.g. queue depth)."""
        with self._lock:
            cur = self._v.get(key)
            if cur is None or value > cur:
                self._v[key] = value
        self._flight(key, value)

    def apply(self, fn) -> None:
        """Run ``fn(values_dict)`` under the lock: the one mutation point
        for updates that read and write several keys together."""
        with self._lock:
            fn(self._v)

    def get(self, key: str, default: object = 0) -> object:
        with self._lock:
            return self._v.get(key, default)

    def reset(self) -> None:
        with self._lock:
            self._v.clear()

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {k: v for k, v in self._v.items()
                    if not k.startswith("_")}


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def reset() -> None:
    _REGISTRY.reset()


def _extras(reg: MetricsRegistry, keep) -> Dict[str, object]:
    """The snapshot's keys that ``keep`` accepts, sorted, floats rounded
    to 4 places: the JSON shape of every ``*_extras`` below."""
    return {k: round(v, 4) if isinstance(v, float) else v
            for k, v in sorted(reg.snapshot().items()) if keep(k)}


# ------------------------------------------------------------ histograms

#: Fixed-bucket histograms: family -> ascending upper bucket bounds
#: (seconds, ``le``; one implicit +Inf bucket at the end). merge_kind()
#: answers ``hist`` for exactly these keys, and the OpenMetrics render
#: gives each a ``_bucket``/``_sum``/``_count`` family.
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
                reg: Optional[MetricsRegistry] = None) -> None:
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


def hist_percentiles(name: str, reg: Optional[MetricsRegistry] = None
                     ) -> Dict[str, float]:
    """``{name_p50, name_p95, name_p99}`` from the recorded buckets;
    empty when the family has no observations."""
    reg = reg if reg is not None else _REGISTRY
    h = reg.get(name, None)
    if not isinstance(h, dict) or not h.get("count"):
        return {}
    bounds = HIST_BUCKETS[name]
    return {f"{name}_p{p}": hist_quantile(h, p / 100.0, bounds)
            for p in (50, 95, 99)}


# ------------------------------------------------------------- transfers

def record_h2d(nbytes: int, seconds: float,
               reg: Optional[MetricsRegistry] = None,
               name: str = "h2d") -> None:
    """One host-to-device transfer: its counters, the ``h2d_transfer_s``
    histogram and a ``transfer`` point."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("h2d_bytes", int(nbytes))
    reg.inc("h2d_s", float(seconds))
    reg.inc("h2d_transfers")
    record_hist("h2d_transfer_s", float(seconds), reg)
    _trace.get_tracer().point("transfer", name, dur_s=float(seconds),
                              bytes=int(nbytes), dir="h2d")


def record_d2h(nbytes: int, seconds: float,
               reg: Optional[MetricsRegistry] = None,
               name: str = "d2h") -> None:
    """One device-to-host pull; ``seconds`` includes the wait for the
    compute that produces it."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("d2h_bytes", int(nbytes))
    reg.inc("d2h_s", float(seconds))
    reg.inc("d2h_transfers")
    _trace.get_tracer().point("transfer", name, dur_s=float(seconds),
                              bytes=int(nbytes), dir="d2h")


def record_flag_pull(nbytes: int, seconds: float,
                     reg: Optional[MetricsRegistry] = None) -> None:
    """The scheduler's flag pull: a sync point, so it stays out of the
    d2h keys."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("sched_flag_pulls")
    reg.inc("sched_flag_pull_s", float(seconds))


def transfer_extras(reg: Optional[MetricsRegistry] = None
                    ) -> Dict[str, object]:
    """The transfer counters with the derived ``*_mb_per_s``, the flag
    pulls and ``device_dispatches``."""
    reg = reg if reg is not None else _REGISTRY
    out: Dict[str, object] = {}
    for d in ("h2d", "d2h"):
        b = int(reg.get(f"{d}_bytes", 0))
        s = float(reg.get(f"{d}_s", 0.0))
        n = int(reg.get(f"{d}_transfers", 0))
        if not n:
            continue
        out[f"{d}_bytes"] = b
        out[f"{d}_s"] = round(s, 4)
        out[f"{d}_transfers"] = n
        if s > 0:
            out[f"{d}_mb_per_s"] = round(b / s / 1e6, 3)
    n = int(reg.get("sched_flag_pulls", 0))
    if n:
        out["sched_flag_pulls"] = n
        out["sched_flag_pull_s"] = round(
            float(reg.get("sched_flag_pull_s", 0.0)), 4)
    n = int(reg.get("device_dispatches", 0))
    if n:
        out["device_dispatches"] = n
    return out


# ----------------------------------------------------------- resilience

def _site_key(site: str) -> str:
    """Counter-key slug of a site name ("h2d/chunk" -> "h2d_chunk")."""
    return site.replace("/", "_").replace(".", "_")


def record_retry(site: str, attempt: int, delay_s: float, error: str,
                 injected: bool,
                 reg: Optional[MetricsRegistry] = None) -> None:
    """One retried attempt at a retry-wrapped site (resilience/retry.py),
    traced as a ``retry`` point."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("res_retry_total")
    reg.inc(f"res_retry_site_{_site_key(site)}")
    reg.inc("res_retry_backoff_s", float(delay_s))
    _trace.get_tracer().point("retry", site, attempt=int(attempt),
                              error=error, injected=int(bool(injected)))


def record_retry_exhausted(site: str, attempts: int,
                           reg: Optional[MetricsRegistry] = None) -> None:
    """A retry loop gave up; the caller degrades or ends the run."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("res_retry_exhausted")
    _trace.get_tracer().point("retry", f"{site}/exhausted",
                              attempt=int(attempts), error="exhausted",
                              injected=0)


def record_fault(site: str, index: int, action: str,
                 reg: Optional[MetricsRegistry] = None) -> None:
    """One injected fault (resilience/faults.py)."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("res_fault_injected_total")
    reg.inc(f"res_fault_site_{_site_key(site)}")
    _trace.get_tracer().point("fault", site, index=int(index),
                              action=action)


def record_watchdog_breach(site: str, deadline_s: float, waited_s: float,
                           terminal: bool = False,
                           reg: Optional[MetricsRegistry] = None) -> None:
    """One deadline breach (resilience/watchdog.py), traced as a
    ``watchdog`` point; a terminal one also counts
    ``res_watchdog_terminal_total``."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("res_watchdog_breach_total")
    reg.inc(f"res_watchdog_site_{_site_key(site)}")
    if terminal:
        reg.inc("res_watchdog_terminal_total")
    _flightrec.note_breach(site, deadline_s, waited_s, terminal)
    _trace.get_tracer().point("watchdog", site, dur_s=float(waited_s),
                              deadline_s=float(deadline_s),
                              waited_s=round(float(waited_s), 6),
                              terminal=int(bool(terminal)))


def record_stall(window_s: float, n_stages: int,
                 reg: Optional[MetricsRegistry] = None) -> None:
    """One stall-detector firing (no stage progressed for a whole
    window), traced as a ``stall`` point."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("pipe_stall_events")
    _trace.get_tracer().point("stall", "pipeline", window_s=float(window_s),
                              stages=int(n_stages))


def record_degraded(n_windows: int,
                    reg: Optional[MetricsRegistry] = None) -> None:
    """A chunk exhausted its retries (or the pipeline stalled) and its
    windows were polished on the host path."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("res_degraded_chunks")
    reg.inc("res_degraded_windows", int(n_windows))


def record_ckpt(event: str, tid: int, nbytes: int,
                reg: Optional[MetricsRegistry] = None) -> None:
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


def resilience_extras(reg: Optional[MetricsRegistry] = None
                      ) -> Dict[str, object]:
    """The ``res_*`` keys; empty when nothing resilience-related
    happened."""
    reg = reg if reg is not None else _REGISTRY
    return _extras(reg, lambda k: k.startswith("res_"))


# ------------------------------------------------------- distributed work

def record_dist(event: str, shard, worker, value: float = 1,
                reg: Optional[MetricsRegistry] = None, **attrs) -> None:
    """One work-ledger event (distributed/): the counter ``dist_<event>``
    (``claims``, ``shards_stolen``, ``leases_expired``,
    ``lease_renewals``, ``leases_lost``, ``contigs_polished``,
    ``contigs_repolished``, ``contigs_resumed``, ``shards_completed``,
    ``steal_latency_s``, ``recovery_wall_s``, ``merges``, ...) grows by
    ``value``, and a ``dist`` point carries the shard (-1 for run-level
    events) and the worker."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc(f"dist_{event}", value)
    _trace.get_tracer().point("dist", event, shard=int(shard),
                              worker=str(worker), **attrs)


def set_dist(key: str, value: object,
             reg: Optional[MetricsRegistry] = None) -> None:
    """A fleet-shape gauge: ``dist_workers``, ``dist_shards``,
    ``dist_n_targets``."""
    reg = reg if reg is not None else _REGISTRY
    reg.set(f"dist_{key}", value)


def dist_extras(reg: Optional[MetricsRegistry] = None
                ) -> Dict[str, object]:
    """The ``dist_*`` keys; empty when no ledger ran."""
    reg = reg if reg is not None else _REGISTRY
    return _extras(reg, lambda k: k.startswith("dist_"))


# ------------------------------------------- overlap-alignment counters

def record_ovl(device_jobs: int, native_jobs: int, tiles: int,
               tail_lanes: int = 0,
               reg: Optional[MetricsRegistry] = None) -> None:
    """One device_breaking_points call (ops/ovl_align.py): overlaps the
    card aligned and certified, overlaps sent to the native aligner (no
    route admits them, or uncertified), and tile launches of the tiled
    route. ``ovl_device_fraction``, the running device share, is derived
    in the same pass. ``tail_lanes``, the port's own ``ovl_tail_lanes``:
    tiled lanes whose launch group ran at least one tile past their last
    row, written on every call beside the other three."""
    reg = reg if reg is not None else _REGISTRY

    def _mutate(v):
        v["ovl_device_jobs"] = v.get("ovl_device_jobs", 0) + int(device_jobs)
        v["ovl_native_jobs"] = v.get("ovl_native_jobs", 0) + int(native_jobs)
        v["ovl_tiles_exec"] = v.get("ovl_tiles_exec", 0) + int(tiles)
        v["ovl_tail_lanes"] = v.get("ovl_tail_lanes", 0) + int(tail_lanes)
        total = v["ovl_device_jobs"] + v["ovl_native_jobs"]
        if total > 0:
            v["ovl_device_fraction"] = round(
                v["ovl_device_jobs"] / total, 4)

    reg.apply(_mutate)


def record_align_phase(seconds: float,
                       reg: Optional[MetricsRegistry] = None) -> None:
    """Wall seconds of one polisher align phase (the card's route, the
    native aligner and the breaking-point walk; models/polisher.py phase
    5), summed over contigs."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("align_phase_seconds", float(seconds))


#: The align phase's timed steps (models/polisher.py phase 5), the port's
#: own keys: the card's route (ops/ovl_align.device_breaking_points, its
#: prep through its collect), the host aligner with its operand
#: preparation, and the breaking-point walk.
OVL_STEP_KEYS = ("ovl_card_s", "ovl_host_align_s", "ovl_walk_s")


def record_ovl_step(key: str, seconds: float,
                    reg: Optional[MetricsRegistry] = None) -> None:
    """Wall seconds of one align-phase step of one job, ``key`` one of
    :data:`OVL_STEP_KEYS`; always on, like ``ingest_wait_s``."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc(key, float(seconds))


def ovl_extras(reg: Optional[MetricsRegistry] = None
               ) -> Dict[str, object]:
    """The ``ovl_*`` keys (the step seconds among them) and
    ``align_phase_seconds``; empty when no overlap alignment ran."""
    reg = reg if reg is not None else _REGISTRY
    return _extras(reg, lambda k: k.startswith("ovl_") or
                   k == "align_phase_seconds")


# --------------------------------------------------- wide-band redo

def record_redo(device_windows: int, host_windows: int,
                reg: Optional[MetricsRegistry] = None) -> None:
    """One wide-band redo pass (ops/redo.py): flagged windows the device
    pass resolved, and windows still unresolved after it that take the
    host path."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("redo_passes")
    reg.inc("redo_device_windows", int(device_windows))
    reg.inc("redo_host_windows", int(host_windows))


def redo_extras(reg: Optional[MetricsRegistry] = None
                ) -> Dict[str, object]:
    """The ``redo_*`` keys and the ``walk_chain_len`` gauge (set at every
    chunk dispatch, so it reports when no redo ran too)."""
    reg = reg if reg is not None else _REGISTRY
    return _extras(reg, lambda k: k.startswith("redo_") or
                   k == "walk_chain_len")


# ------------------------------------------------------- ingest plane

def record_ingest_inflate(mode: str, bytes_in: int, bytes_out: int,
                          seconds: float, blocks: int,
                          reg: Optional[MetricsRegistry] = None) -> None:
    """One gzip source's inflate totals (io/inflate.py, once when the
    source finishes): its plan (``bgzf``, ``members`` or ``stream``),
    compressed bytes in, bytes out, the workers' summed inflate seconds
    and blocks; one ``ingest`` point ``inflate/<mode>``."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("ingest_bytes_in", int(bytes_in))
    reg.inc("ingest_bytes_out", int(bytes_out))
    reg.inc("ingest_inflate_s", float(seconds))
    reg.inc("ingest_blocks", int(blocks))
    _trace.get_tracer().point("ingest", f"inflate/{mode}",
                              dur_s=float(seconds), mode=mode,
                              bytes=int(bytes_out), blocks=int(blocks))


def record_ingest_parse(mode: str, seconds: float, records: int,
                        raw_bytes: int,
                        reg: Optional[MetricsRegistry] = None) -> None:
    """One file's parse totals: the reader plan (``serial`` or
    ``prefetch``), seconds turning bytes into records, records and raw
    bytes; one ``ingest`` point ``parse/<mode>``."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("ingest_parse_s", float(seconds))
    reg.inc("ingest_records", int(records))
    reg.inc("ingest_raw_bytes", int(raw_bytes))
    _trace.get_tracer().point("ingest", f"parse/{mode}",
                              dur_s=float(seconds), mode=mode,
                              bytes=int(raw_bytes), records=int(records))


def record_ingest_wait(seconds: float,
                       reg: Optional[MetricsRegistry] = None) -> None:
    """Seconds a consumer was blocked on ingest (all of a serial parse):
    the only ingest term on the run's critical path under prefetch."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("ingest_wait_s", float(seconds))


def set_ingest_fraction(wall_s: float,
                        reg: Optional[MetricsRegistry] = None) -> None:
    """``ingest_fraction_of_wall`` = ingest wait / the run's wall (the
    CLI, at the end of a run)."""
    reg = reg if reg is not None else _REGISTRY
    if wall_s > 0:
        wait = float(reg.get("ingest_wait_s", 0.0))
        reg.set("ingest_fraction_of_wall", round(wait / wall_s, 4))


def ingest_extras(reg: Optional[MetricsRegistry] = None
                  ) -> Dict[str, object]:
    """The ``ingest_*`` keys, plus ``ingest_mb_per_sec`` (raw MB over
    inflate and parse seconds) and ``ingest_seconds``; empty when no
    ingest was recorded."""
    reg = reg if reg is not None else _REGISTRY
    out = _extras(reg, lambda k: k.startswith("ingest_"))
    if not out:
        return out
    raw = float(reg.get("ingest_raw_bytes", 0.0)) or float(
        reg.get("ingest_bytes_out", 0.0))
    busy = float(reg.get("ingest_inflate_s", 0.0)) + float(
        reg.get("ingest_parse_s", 0.0))
    if raw > 0 and busy > 0:
        out["ingest_mb_per_sec"] = round(raw / busy / 1e6, 2)
    out["ingest_seconds"] = round(busy, 4)
    return out


# ------------------------------------------------------ pipeline gauges

def record_stage(name: str, busy_s: float, stall_in_s: float,
                 stall_out_s: float, items: int,
                 reg: Optional[MetricsRegistry] = None) -> None:
    """One pipeline stage's totals, when its thread exits: seconds in its
    work function, blocked on its input queue, blocked on its output
    queue, and items handled."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc(f"pipe_stage_{name}_busy_s", float(busy_s))
    reg.inc(f"pipe_stage_{name}_stall_in_s", float(stall_in_s))
    reg.inc(f"pipe_stage_{name}_stall_out_s", float(stall_out_s))
    reg.inc(f"pipe_stage_{name}_items", int(items))


def record_queue(name: str, peak: int, put_wait_s: float,
                 get_wait_s: float,
                 reg: Optional[MetricsRegistry] = None) -> None:
    """One bounded queue's gauges (the peak is a max across runs)."""
    reg = reg if reg is not None else _REGISTRY
    reg.max(f"pipe_queue_{name}_peak", int(peak))
    reg.inc(f"pipe_queue_{name}_put_wait_s", float(put_wait_s))
    reg.inc(f"pipe_queue_{name}_get_wait_s", float(get_wait_s))


def record_pipeline_wall(seconds: float,
                         reg: Optional[MetricsRegistry] = None) -> None:
    """One stream_consensus call's wall seconds."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("pipe_runs")
    reg.inc("pipe_wall_s", float(seconds))


def pipeline_extras(reg: Optional[MetricsRegistry] = None
                    ) -> Dict[str, object]:
    """The ``pipe_*`` keys plus ``pipe_overlap_efficiency`` = the compute
    stage's busy seconds / the pipeline's wall; empty when no pipeline
    ran."""
    reg = reg if reg is not None else _REGISTRY
    if not int(reg.get("pipe_runs", 0)):
        return {}
    out = _extras(reg, lambda k: k.startswith("pipe_"))
    wall = float(reg.get("pipe_wall_s", 0.0))
    busy = float(reg.get("pipe_stage_compute_busy_s", 0.0))
    if wall > 0:
        out["pipe_overlap_efficiency"] = round(busy / wall, 4)
    return out


# -------------------------------------------- decoupled-walk telemetry

def record_walk(walk_s: float, overlap_s: float, dispatches: int,
                fused_chunks: int, queue_peak: int, enabled: bool,
                reg: Optional[MetricsRegistry] = None) -> None:
    """One stream_consensus call's decoupled walk: seconds in walk
    dispatches, the part of them during which another chunk's forward was
    in flight (also one ``walk_hidden_s`` observation when it walked),
    decoupled dispatches, fused chunks, the walk queue's peak, whether it
    was on; ``walk_hidden_fraction`` = overlap / walk seconds."""
    reg = reg if reg is not None else _REGISTRY
    reg.set("walk_async_enabled", int(bool(enabled)))
    reg.inc("walk_seconds", float(walk_s))
    reg.inc("walk_overlap_s", float(overlap_s))
    reg.inc("walk_dispatches", int(dispatches))
    reg.inc("walk_fused_chunks", int(fused_chunks))
    reg.max("walk_queue_peak", int(queue_peak))
    if dispatches:
        record_hist("walk_hidden_s", float(overlap_s), reg)
    total = float(reg.get("walk_seconds", 0.0))
    if total > 0:
        reg.set("walk_hidden_fraction",
                round(float(reg.get("walk_overlap_s", 0.0)) / total, 4))


def walk_extras(reg: Optional[MetricsRegistry] = None
                ) -> Dict[str, object]:
    """The ``walk_*`` keys; empty when record_walk never ran."""
    reg = reg if reg is not None else _REGISTRY
    if reg.get("walk_async_enabled", None) is None:
        return {}
    return _extras(reg, lambda k: k.startswith("walk_"))


# ---------------------------------------------------------- serve plane

def record_serve_job(event: str, job: str, tenant: str,
                     trace_id: str = "-", parent_id: int = 0,
                     reg: Optional[MetricsRegistry] = None) -> int:
    """One daemon job event (``submitted``, ``completed``, ``failed``,
    ``cancelled``, ``resumed``): the counter ``serve_jobs_<event>`` and a
    ``serve`` point; returns the point's id."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc(f"serve_jobs_{event}")
    return _trace.get_tracer().point("serve", event, job=str(job),
                                     tenant=str(tenant),
                                     trace_id=str(trace_id),
                                     parent_id=int(parent_id))


def record_serve_batch(n_windows: int, capacity: int, jobs, tenants,
                       wait_s: float, round_s: float = 0.0,
                       trace_ids=(), parent_ids=(),
                       reg: Optional[MetricsRegistry] = None) -> None:
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


def set_serve_active(n: int,
                     reg: Optional[MetricsRegistry] = None) -> None:
    """The daemon's in-flight job gauge."""
    reg = reg if reg is not None else _REGISTRY
    reg.set("serve_active_jobs", int(n))


def set_serve_rate(jobs_per_min: float,
                   reg: Optional[MetricsRegistry] = None) -> None:
    """The daemon's completion rate (jobs a minute of uptime) and its
    freshness stamp ``serve_rate_wall_s``."""
    reg = reg if reg is not None else _REGISTRY

    def _mutate(v):
        v["serve_jobs_per_min"] = round(float(jobs_per_min), 4)
        v["serve_rate_wall_s"] = round(time.time(), 3)

    reg.apply(_mutate)


def serve_extras(reg: Optional[MetricsRegistry] = None
                 ) -> Dict[str, object]:
    """The ``serve_*`` keys; empty when no daemon or batcher ran."""
    reg = reg if reg is not None else _REGISTRY
    return _extras(reg, lambda k: k.startswith("serve_"))


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
                reg: Optional[MetricsRegistry] = None,
                wall_s: Optional[float] = None, **attrs) -> int:
    """One gateway event (gateway/): a counter and a ``gate`` point
    (``fleet_run``'s ``wall_s`` also sums into ``gate_fleet_wall_s``);
    returns the point's id."""
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


def set_gate_fleet_target(n: int,
                          reg: Optional[MetricsRegistry] = None) -> None:
    """The gateway's fleet sizing gauge: the worker target the service
    policy (gateway/policy.py) chose on its latest supervisor tick."""
    reg = reg if reg is not None else _REGISTRY
    reg.set("gate_fleet_target", int(n))


def set_gate_rate(jobs_per_min: float,
                  compile_skip_s: Optional[float] = None,
                  reg: Optional[MetricsRegistry] = None) -> None:
    """The gateway's throughput gauges: fleet-route jobs a minute and,
    when measured, the seconds a new worker skipped on a warm start."""
    reg = reg if reg is not None else _REGISTRY
    reg.set("gate_fleet_jobs_per_min", round(float(jobs_per_min), 4))
    if compile_skip_s is not None:
        reg.set("gate_compile_skip_s", round(float(compile_skip_s), 4))


def gate_extras(reg: Optional[MetricsRegistry] = None
                ) -> Dict[str, object]:
    """The ``gate_*`` keys; empty when no gateway ran."""
    reg = reg if reg is not None else _REGISTRY
    return _extras(reg, lambda k: k.startswith("gate_"))


# ------------------------------------------------------------ ava plane

def record_ava_plan(plan, reg: Optional[MetricsRegistry] = None) -> None:
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


def set_ava_bench(reads_per_sec: float, peak_rss_mb: float,
                  manifest_bytes_per_target: float,
                  reg: Optional[MetricsRegistry] = None) -> None:
    """The ava bench gauges: corrected reads a wall second, the run's
    peak resident set and manifest bytes a committed target."""
    reg = reg if reg is not None else _REGISTRY
    reg.set("ava_reads_per_sec", round(float(reads_per_sec), 4))
    reg.set("ava_peak_rss_mb", round(float(peak_rss_mb), 4))
    reg.set("ava_manifest_bytes_per_target",
            round(float(manifest_bytes_per_target), 4))


def ava_extras(reg: Optional[MetricsRegistry] = None
               ) -> Dict[str, object]:
    """The ``ava_*`` keys; empty when no ava planning ran."""
    reg = reg if reg is not None else _REGISTRY
    return _extras(reg, lambda k: k.startswith("ava_"))


# --------------------------------------------------- result cache plane

_CACHE_OUTCOME_KEYS = {
    "hit": "cache_hits_total",
    "miss": "cache_misses_total",
    "store": "cache_stores_total",
    "evict": "cache_evictions_total",
    "verify_fail": "cache_verify_fail_total",
}


def record_cache(tier: str, outcome: str, n: int = 1, nbytes: int = 0,
                 reg: Optional[MetricsRegistry] = None) -> None:
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


def result_cache_extras(reg: Optional[MetricsRegistry] = None
                        ) -> Dict[str, object]:
    """The ``cache_*`` keys; empty when nothing probed the result
    cache."""
    reg = reg if reg is not None else _REGISTRY
    return _extras(reg, lambda k: k.startswith("cache_"))


# ------------------------------------------------------- sched telemetry

#: The scheduler telemetry's registry keys.
SCHED_KEYS = ("sched_rounds", "sched_windows", "sched_chunks",
              "sched_rounds_hist", "sched_survivor_frac",
              "sched_rounds_saved_frac", "sched_repack_overhead_s",
              "sched_dispatches_saved")


def publish_sched(telem, reg: Optional[MetricsRegistry] = None) -> None:
    """A SchedTelemetry's counters under the ``sched_*`` keys: the one
    place their shape is defined."""
    reg = reg if reg is not None else _REGISTRY
    reg.set("sched_rounds", telem.rounds)
    reg.set("sched_windows", telem.windows)
    reg.set("sched_chunks", telem.chunks)
    reg.set("sched_rounds_hist",
            {str(k): v for k, v in sorted(telem.hist.items())})
    reg.set("sched_survivor_frac",
            [round(f, 4) for f in telem.survivor_frac()])
    reg.set("sched_rounds_saved_frac", round(telem.rounds_saved_frac(), 4))
    reg.set("sched_repack_overhead_s", round(telem.repack_s, 4))
    reg.set("sched_dispatches_saved", telem.dispatches_saved)


def sched_extras(reg: Optional[MetricsRegistry] = None
                 ) -> Dict[str, object]:
    """The ``sched_*`` telemetry keys (None where unpublished)."""
    reg = reg if reg is not None else _REGISTRY
    return {k: reg.get(k) for k in SCHED_KEYS}


# ------------------------------------------------- fleet merge semantics

#: Merge kinds for the fleet model (obs/fleet.py): ``sum`` for counters,
#: ``max`` for peak gauges, ``last`` for point-in-time gauges and
#: per-run snapshots (the latest worker snapshot wins), ``hist`` for the
#: fixed-bucket histograms (per-bucket sum).
MERGE_SUM = "sum"
MERGE_MAX = "max"
MERGE_LAST = "last"
MERGE_HIST = "hist"

#: Keys whose fleet merge is ``last``. ``sched_flag_pulls`` and
#: ``sched_flag_pull_s`` are counters despite their prefix, so they sum.
_MERGE_LAST_KEYS = frozenset({
    "dist_workers", "dist_shards", "dist_n_targets",
    "ovl_device_fraction", "walk_chain_len",
    "pipe_overlap_efficiency",
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


#: The declared metric contract: one row a registry key family,
#: ``(pattern, merge kind, doc token)``; ``*`` in a pattern matches one
#: runtime-named segment (site slug, stage name, phase slug). The JAX
#: package's rows less its three ``jax_cache_*`` rows, plus the port's
#: :data:`OVL_STEP_KEYS` and ``ovl_tail_lanes``.
METRIC_SPECS = (
    ("adaptive_early_exits", MERGE_SUM, "adaptive_early_exits"),
    ("adaptive_rounds_executed", MERGE_SUM, "adaptive_rounds_executed"),
    ("adaptive_rounds_scheduled", MERGE_SUM, "adaptive_rounds_scheduled"),
    ("align_phase_seconds", MERGE_SUM, "align_phase_seconds"),
    ("ava_buckets", MERGE_LAST, "ava_buckets"),
    ("ava_compile_budget", MERGE_LAST, "ava_compile_budget"),
    ("ava_manifest_bytes_per_target", MERGE_LAST,
     "ava_manifest_bytes_per_target"),
    ("ava_pad_frac", MERGE_LAST, "ava_pad_frac"),
    ("ava_peak_rss_mb", MERGE_LAST, "ava_peak_rss_mb"),
    ("ava_quantum", MERGE_LAST, "ava_quantum"),
    ("ava_reads_per_sec", MERGE_LAST, "ava_reads_per_sec"),
    ("ava_targets", MERGE_LAST, "ava_targets"),
    ("cache_bytes", MERGE_SUM, "cache_bytes"),
    ("cache_evictions_total", MERGE_SUM, "cache_evictions_total"),
    ("cache_hit_ratio", MERGE_LAST, "cache_hit_ratio"),
    ("cache_hits_total", MERGE_SUM, "cache_hits_total"),
    ("cache_misses_total", MERGE_SUM, "cache_misses_total"),
    ("cache_stores_total", MERGE_SUM, "cache_stores_total"),
    ("cache_verify_fail_total", MERGE_SUM, "cache_verify_fail_total"),
    ("d2h_bytes", MERGE_SUM, "d2h_bytes"),
    ("d2h_s", MERGE_SUM, "d2h_s"),
    ("d2h_transfers", MERGE_SUM, "d2h_transfers"),
    ("device_dispatches", MERGE_SUM, "device_dispatches"),
    ("dist_n_targets", MERGE_LAST, "dist_n_targets"),
    ("dist_shards", MERGE_LAST, "dist_shards"),
    ("dist_workers", MERGE_LAST, "dist_workers"),
    ("dist_*", MERGE_SUM, "dist_claims"),
    ("dispatch_round_s", MERGE_HIST, "dispatch_round_s"),
    ("fleet_target_workers", MERGE_LAST, "fleet_target_workers"),
    ("flight_dump_write_s", MERGE_SUM, "flight_dump_write_s"),
    ("flight_dumps_total", MERGE_SUM, "flight_dumps_total"),
    ("gate_compile_skip_s", MERGE_LAST, "gate_compile_skip_s"),
    ("gate_fleet_jobs_per_min", MERGE_LAST, "gate_fleet_jobs_per_min"),
    ("gate_fleet_target", MERGE_LAST, "gate_fleet_target"),
    ("gate_*", MERGE_SUM, "gate_routed_fleet"),
    ("h2d_bytes", MERGE_SUM, "h2d_bytes"),
    ("h2d_s", MERGE_SUM, "h2d_s"),
    ("h2d_transfer_s", MERGE_HIST, "h2d_transfer_s"),
    ("h2d_transfers", MERGE_SUM, "h2d_transfers"),
    ("ingest_blocks", MERGE_SUM, "ingest_blocks"),
    ("ingest_bytes_in", MERGE_SUM, "ingest_bytes_in"),
    ("ingest_bytes_out", MERGE_SUM, "ingest_bytes_out"),
    ("ingest_enabled", MERGE_LAST, "ingest_enabled"),
    ("ingest_fraction_of_wall", MERGE_LAST, "ingest_fraction_of_wall"),
    ("ingest_inflate_s", MERGE_SUM, "ingest_inflate_s"),
    ("ingest_parse_s", MERGE_SUM, "ingest_parse_s"),
    ("ingest_raw_bytes", MERGE_SUM, "ingest_raw_bytes"),
    ("ingest_records", MERGE_SUM, "ingest_records"),
    ("ingest_wait_s", MERGE_SUM, "ingest_wait_s"),
    ("ovl_card_s", MERGE_SUM, "ovl_card_s"),
    ("ovl_device_fraction", MERGE_LAST, "ovl_device_fraction"),
    ("ovl_device_jobs", MERGE_SUM, "ovl_device_jobs"),
    ("ovl_host_align_s", MERGE_SUM, "ovl_host_align_s"),
    ("ovl_native_jobs", MERGE_SUM, "ovl_native_jobs"),
    ("ovl_tail_lanes", MERGE_SUM, "ovl_tail_lanes"),
    ("ovl_tiles_exec", MERGE_SUM, "ovl_tiles_exec"),
    ("ovl_walk_s", MERGE_SUM, "ovl_walk_s"),
    ("phase_seconds_*", MERGE_SUM, "phase_seconds_"),
    ("pipe_overlap_efficiency", MERGE_LAST, "pipe_overlap_efficiency"),
    ("pipe_queue_*_get_wait_s", MERGE_SUM, "pipe_queue_"),
    ("pipe_queue_*_peak", MERGE_MAX, "pipe_queue_"),
    ("pipe_queue_*_put_wait_s", MERGE_SUM, "pipe_queue_"),
    ("pipe_runs", MERGE_SUM, "pipe_runs"),
    ("pipe_stage_*_busy_s", MERGE_SUM, "pipe_stage_"),
    ("pipe_stage_*_items", MERGE_SUM, "pipe_stage_"),
    ("pipe_stage_*_stall_in_s", MERGE_SUM, "pipe_stage_"),
    ("pipe_stage_*_stall_out_s", MERGE_SUM, "pipe_stage_"),
    ("pipe_stall_events", MERGE_SUM, "pipe_stall_events"),
    ("pipe_wall_s", MERGE_SUM, "pipe_wall_s"),
    ("poa_windows_total", MERGE_SUM, "poa_windows_total"),
    ("redo_device_windows", MERGE_SUM, "redo_device_windows"),
    ("redo_host_windows", MERGE_SUM, "redo_host_windows"),
    ("redo_passes", MERGE_SUM, "redo_passes"),
    ("res_ckpt_*", MERGE_SUM, "res_ckpt_commits"),
    ("res_degraded_chunks", MERGE_SUM, "res_degraded_chunks"),
    ("res_degraded_windows", MERGE_SUM, "res_degraded_windows"),
    ("res_fault_injected_total", MERGE_SUM, "res_fault_injected_total"),
    ("res_fault_site_*", MERGE_SUM, "res_fault_site_"),
    ("res_retry_backoff_s", MERGE_SUM, "res_retry_backoff_s"),
    ("res_retry_exhausted", MERGE_SUM, "res_retry_exhausted"),
    ("res_retry_site_*", MERGE_SUM, "res_retry_site_"),
    ("res_retry_total", MERGE_SUM, "res_retry_total"),
    ("res_watchdog_breach_total", MERGE_SUM, "res_watchdog_breach_total"),
    ("res_watchdog_site_*", MERGE_SUM, "res_watchdog_site_"),
    ("res_watchdog_terminal_total", MERGE_SUM,
     "res_watchdog_terminal_total"),
    ("sched_dispatches_saved", MERGE_LAST, "sched_"),
    ("sched_flag_pull_s", MERGE_SUM, "sched_flag_pull_s"),
    ("sched_flag_pulls", MERGE_SUM, "sched_flag_pulls"),
    ("sched_repack_overhead_s", MERGE_LAST, "sched_"),
    ("sched_rounds", MERGE_LAST, "sched_"),
    ("sched_rounds_hist", MERGE_LAST, "sched_"),
    ("sched_rounds_saved_frac", MERGE_LAST, "sched_"),
    ("sched_survivor_frac", MERGE_LAST, "sched_"),
    ("sched_chunks", MERGE_LAST, "sched_"),
    ("sched_windows", MERGE_LAST, "sched_"),
    ("serve_active_jobs", MERGE_LAST, "serve_active_jobs"),
    ("serve_batch_occupancy", MERGE_LAST, "serve_batch_occupancy"),
    ("serve_batch_windows", MERGE_SUM, "serve_batch_windows"),
    ("serve_batches", MERGE_SUM, "serve_batches"),
    ("serve_job_latency_s", MERGE_HIST, "serve_job_latency_s"),
    ("serve_jobs_per_min", MERGE_LAST, "serve_jobs_per_min"),
    ("serve_jobs_*", MERGE_SUM, "serve_jobs_"),
    ("serve_queue_depth_peak", MERGE_MAX, "serve_queue_depth_peak"),
    ("serve_queue_wait_s", MERGE_HIST, "serve_queue_wait_s"),
    ("serve_rate_wall_s", MERGE_LAST, "serve_rate_wall_s"),
    ("serve_tenant_wait_s", MERGE_SUM, "serve_tenant_wait_s"),
    ("walk_async_enabled", MERGE_LAST, "walk_async_enabled"),
    ("walk_chain_len", MERGE_LAST, "walk_chain_len"),
    ("walk_dispatches", MERGE_SUM, "walk_dispatches"),
    ("walk_fused_chunks", MERGE_SUM, "walk_fused_chunks"),
    ("walk_hidden_fraction", MERGE_LAST, "walk_hidden_fraction"),
    ("walk_hidden_s", MERGE_HIST, "walk_hidden_s"),
    ("walk_overlap_s", MERGE_SUM, "walk_overlap_s"),
    ("walk_queue_peak", MERGE_MAX, "walk_queue_peak"),
    ("walk_seconds", MERGE_SUM, "walk_seconds"),
)


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
                         reg: Optional[MetricsRegistry] = None) -> None:
    """One finished logger phase (utils/logger.py) as
    ``phase_seconds_<slug>`` plus the ``phase_seconds_total`` roll-up:
    the per-worker phase split of the fleet model."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc(f"phase_seconds_{_phase_slug(msg)}", float(seconds))
    reg.inc("phase_seconds_total", float(seconds))


def record_windows(n: int, reg: Optional[MetricsRegistry] = None) -> None:
    """``n`` polished windows (ops/poa.py, the streaming pipeline):
    ``poa_windows_total``, cumulative across chunks, contigs and shards,
    which the fleet model divides by a worker's wall seconds."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("poa_windows_total", int(n))


def sched_summary_line(reg: Optional[MetricsRegistry] = None) -> str:
    """The polisher's one-line stderr scheduler summary, formatted from
    the registry's ``sched_*`` keys."""
    reg = reg if reg is not None else _REGISTRY
    hist = reg.get("sched_rounds_hist", {}) or {}
    hist_s = " ".join(f"r{k}:{v}" for k, v in
                      sorted(hist.items(), key=lambda kv: int(kv[0])))
    saved = float(reg.get("sched_rounds_saved_frac", 0.0))
    repack = float(reg.get("sched_repack_overhead_s", 0.0))
    return (f"windows={reg.get('sched_windows', 0)} "
            f"chunks={reg.get('sched_chunks', 0)} "
            f"frozen[{hist_s}] "
            f"rounds_saved={saved:.0%} "
            f"repack={repack:.3f}s")
