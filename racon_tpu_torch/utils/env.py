"""The port's environment gates.

Each keeps the JAX package's name and meaning, so one variable set in a
test steers the reference and the port alike:

- ``RACON_TPU_NO_BAND`` (flag): disable the banded forward; every round
  runs the full-width forward.
- ``RACON_TPU_WALK_K`` (1, 2 or 4; default 4): cap on the column walk's
  depth (ops/budget.py::walk_k_for).
- ``RACON_TPU_OVL_TILED`` ("0" turns it off): the tiled route of the
  device overlap aligner (ops/ovl_align.py); with it off, overlaps too
  long for the untiled route take the host aligner.
- ``RACON_TPU_SCHED`` ("0" or "false" turns it off): the convergence
  scheduler (sched/), the device engine's default chunk loop; with it
  off, chunks run the fixed-round engine in a depth-2 pipeline.
- ``RACON_TPU_ADAPTIVE`` ("0" or "false" turns it off): the adaptive
  exit of the fixed-round engine's middle rounds and of the scheduler's
  fused tail; with it off, every scheduled round runs.
- ``RACON_TPU_REDO`` ("0" or "false" turns it off): the wide-band device
  redo of flagged windows (ops/redo.py); with it off, every flagged
  window takes the host path.
- ``RACON_TPU_PIPELINE`` (default off; "0" or "false" forces it off over
  the CLI's ``--pipeline-depth``): the streaming pipeline (pipeline/).
- ``RACON_TPU_PIPELINE_DEPTH`` (default 2): chunks in flight a queue of
  the pipeline.
- ``RACON_TPU_WALK_ASYNC`` ("0" or "false" turns it off): the decoupled
  final-round walk of the pipeline's fixed-round path.
- ``RACON_TPU_WALK_QUEUE`` (default: the pipeline depth): chunks whose
  final-round planes may wait for the walk stage; 0 turns the decoupled
  walk off (ops/budget.py::walk_queue_env).
- ``RACON_TPU_STALL_S`` (default 300; 0 turns it off): seconds without
  progress after which the pipeline's stall detector fails the run.
- ``RACON_TPU_INGEST`` ("0" or "false" turns it off): the ingest plane
  (io/ingest.py: prefetch threads, mmap readers, parallel inflate).
- ``RACON_TPU_INGEST_WORKERS`` (default: cores, 2 to 8): the parallel
  inflate's threads (io/inflate.py).

The fault plane's gates (resilience/, obs/trace.py, ops/budget.py), with
the JAX package's defaults and error texts:

- ``RACON_TPU_FAULTS`` (spec): the fault injector's plan
  (resilience/faults.py); ``RACON_TPU_FAULT_STALL_S`` (default 1) and
  ``RACON_TPU_FAULT_HANG_S`` (default 30): the sleeps of its ``stall``
  and unguarded ``hang`` actions.
- ``RACON_TPU_RETRY`` (``key=value,...``): the retry policy
  (resilience/retry.py; default 4 attempts, 0.05 s base, x2, 2 s cap,
  10% jitter).
- ``RACON_TPU_DEADLINE_{H2D,D2H,DISPATCH}`` (defaults 60, 300, 300 s;
  <= 0 turns a class off), ``RACON_TPU_DEADLINE_MBPS`` (0.25),
  ``RACON_TPU_DEADLINE_CELLS_PER_S`` (2e6) and
  ``RACON_TPU_DEADLINE_SCALE`` (1): the watchdog's deadlines
  (ops/budget.py).
- ``RACON_TPU_WATCHDOG_TERMINAL`` (default 0 = never): the breach count
  at which a breach becomes terminal (resilience/watchdog.py).
- ``RACON_TPU_TIMING`` (flag): the fixed engine's per-round timing path
  and the overlap aligner's timing lines, on stderr.
- ``RACON_TPU_TRACE`` (path): the JSONL tracer (obs/trace.py);
  ``RACON_TPU_TRACE_XPROF`` (flag): each span also an NVTX range.

The service core's gates (server/, cache/, ava/, gateway/, obs/), with
the JAX package's defaults (:data:`_DEFAULTS`; :func:`read` returns the
default when the variable is unset):

- ``RACON_TPU_SERVE_BATCH`` (256): the cross-request batch's capacity in
  windows a dispatch; ``RACON_TPU_SERVE_BATCH_WAIT_S`` (0.05): the
  longest a partial batch waits for more work; ``RACON_TPU_SERVE_QUEUE``
  (64): the admission queue's depth in work items;
  ``RACON_TPU_SERVE_MAX_JOBS`` (4): jobs running at once;
  ``RACON_TPU_SERVE_GRACE_S`` (30): the SIGTERM drain's grace seconds;
  ``RACON_TPU_SERVE_SPOOL_MB`` (unset = 8 MiB, 0 = never): a job's
  in-memory result bytes before its stream spills to a file.
- ``RACON_TPU_CACHE`` ("0" or "false" turns both tiers off; the daemon
  arms it by default, the CLI with ``--cache-dir``),
  ``RACON_TPU_CACHE_DIR`` (the daemon's cache root, default
  ``<state-dir>/cache``), ``RACON_TPU_CACHE_MAX_MB`` (256: the job CAS's
  byte bound), ``RACON_TPU_CACHE_WINDOWS`` ("0" or "false" turns the
  window memo off).
- ``RACON_TPU_GATE_FLEET`` (0): the gateway's fleet route
  (gateway/dispatch.py); ``RACON_TPU_GATE_FLEET_MIN_TARGETS`` (32): the
  target count from which a job routes to the fleet;
  ``RACON_TPU_GATE_FLEET_MIN_BYTES`` (8388608): the targets file's size
  from which a ``-f`` job does; ``RACON_TPU_GATE_QUEUE_PRESSURE`` (8):
  the admission-queue depth from which any job does;
  ``RACON_TPU_GATE_WORKERS`` (2): the most workers a fleet job's
  supervisor runs; ``RACON_TPU_GATE_LEASE_S`` (10) and
  ``RACON_TPU_GATE_STANDBY_POLL_S`` (0.2): the state-dir lease's term
  and a standby's poll.
- ``RACON_TPU_AVA_COMPACT`` (unset = every 64 sealed segments, 0 = never):
  the v2 checkpoint manifest's compaction; ``RACON_TPU_AVA_SEG`` (unset:
  256 targets a segment for ``-f`` runs, v1 manifests otherwise).
- ``RACON_TPU_FLIGHT_EVENTS`` (unset = 256, 0 = off): the flight
  recorder's ring; ``RACON_TPU_OBS_DIR`` (path): where it dumps, and
  the serial CLI's opt-in to a fleet metric shard (obs/fleet.py) in
  that directory — the JAX package's two uses.

The ledger fleet's gates (distributed/, obs/fleet.py, ava/, cli.py),
with the JAX package's defaults:

- ``RACON_TPU_DIST_SHARDS`` (unset = 2 x ``--workers``): the shard count
  the first worker publishes; ``RACON_TPU_DIST_POLL`` (unset = lease/10
  within [0.05, 1] s): a worker's claim poll; ``RACON_TPU_DIST_AVOID``
  (comma list): shard names a worker claims last (the autoscaler seeds
  it when it replaces a self-evicted worker).
- ``RACON_TPU_SPLIT`` (1; "0", "false", "no" or "off" turns it off):
  dynamic shard splitting; ``RACON_TPU_SPLIT_AFTER_S`` (unset = max(5,
  lease) s): how long a shard is held before it may split;
  ``RACON_TPU_SPLIT_DEPTH`` (unset = 1): split generations allowed.
- ``RACON_TPU_AUTOSCALE_MIN`` (1), ``_MAX`` (``--workers``),
  ``_INTERVAL_S`` (0.5, floor 0.05), ``_MAX_SPAWNS`` (max(8, 4 x MAX)),
  ``_DEADLINE_S`` (0 = none) and ``_FAULT_PLAN`` (a JSON list of
  ``RACON_TPU_FAULTS`` specs, one a spawn ordinal): the supervisor's
  policy (distributed/autoscaler.py).
- ``RACON_TPU_OBS_FLUSH_S`` (unset = 5; 0 = every call): a worker's
  metric-shard cadence; ``RACON_TPU_STRAGGLER_FRAC`` (unset = 0.5, in
  (0, 1]): the fraction of the fleet's median windows a second below
  which a worker is flagged a straggler.
- ``RACON_TPU_TRACE_CTX`` (``<trace_id>:<parent_id>``): a trace context
  handed to this process (obs/trace.py::adopt_trace_context).
- ``RACON_TPU_METRICS_PORT`` (port): the CLI's OpenMetrics pull endpoint
  with ``/healthz``; a ledger member answers ``/healthz`` with the
  fleet's view (obs/export.py::fleet_health).
- ``RACON_TPU_AVA_WEIGHTED`` (1; "0", "false", "no" or "off" turns it
  off): length-weighted shard bounds for ``-f`` ledgers
  (ava/partition.py).
- ``RACON_TPU_AVA_COMPILE_BUDGET`` (unset = 8; a positive int): the most
  shape buckets the ava planner may plan (ava/planner.py). In the JAX
  package each bucket is an XLA compile. On CUDA nothing compiles per
  shape — the kernels are built once, with nvcc — so here the budget
  bounds the number of distinct overlap geometries a run presents to
  the kernels (the plan's ``compile_keys``), not a compile count; the
  plan and its ``ava_*`` gauges are the JAX package's numbers.
"""

from __future__ import annotations

import os

NO_BAND = "RACON_TPU_NO_BAND"
WALK_K = "RACON_TPU_WALK_K"
OVL_TILED = "RACON_TPU_OVL_TILED"
SCHED = "RACON_TPU_SCHED"
ADAPTIVE = "RACON_TPU_ADAPTIVE"
REDO = "RACON_TPU_REDO"
PIPELINE = "RACON_TPU_PIPELINE"
PIPELINE_DEPTH = "RACON_TPU_PIPELINE_DEPTH"
WALK_ASYNC = "RACON_TPU_WALK_ASYNC"
WALK_QUEUE = "RACON_TPU_WALK_QUEUE"
STALL_S = "RACON_TPU_STALL_S"
INGEST = "RACON_TPU_INGEST"
INGEST_WORKERS = "RACON_TPU_INGEST_WORKERS"
FAULTS = "RACON_TPU_FAULTS"
FAULT_STALL_S = "RACON_TPU_FAULT_STALL_S"
FAULT_HANG_S = "RACON_TPU_FAULT_HANG_S"
RETRY = "RACON_TPU_RETRY"
DEADLINE_H2D = "RACON_TPU_DEADLINE_H2D"
DEADLINE_D2H = "RACON_TPU_DEADLINE_D2H"
DEADLINE_DISPATCH = "RACON_TPU_DEADLINE_DISPATCH"
DEADLINE_MBPS = "RACON_TPU_DEADLINE_MBPS"
DEADLINE_CELLS_PER_S = "RACON_TPU_DEADLINE_CELLS_PER_S"
DEADLINE_SCALE = "RACON_TPU_DEADLINE_SCALE"
WATCHDOG_TERMINAL = "RACON_TPU_WATCHDOG_TERMINAL"
TIMING = "RACON_TPU_TIMING"
TRACE = "RACON_TPU_TRACE"
TRACE_XPROF = "RACON_TPU_TRACE_XPROF"
SERVE_BATCH = "RACON_TPU_SERVE_BATCH"
SERVE_BATCH_WAIT_S = "RACON_TPU_SERVE_BATCH_WAIT_S"
SERVE_QUEUE = "RACON_TPU_SERVE_QUEUE"
SERVE_MAX_JOBS = "RACON_TPU_SERVE_MAX_JOBS"
SERVE_GRACE_S = "RACON_TPU_SERVE_GRACE_S"
SERVE_SPOOL_MB = "RACON_TPU_SERVE_SPOOL_MB"
CACHE = "RACON_TPU_CACHE"
CACHE_DIR = "RACON_TPU_CACHE_DIR"
CACHE_MAX_MB = "RACON_TPU_CACHE_MAX_MB"
CACHE_WINDOWS = "RACON_TPU_CACHE_WINDOWS"
GATE_FLEET = "RACON_TPU_GATE_FLEET"
GATE_FLEET_MIN_TARGETS = "RACON_TPU_GATE_FLEET_MIN_TARGETS"
GATE_FLEET_MIN_BYTES = "RACON_TPU_GATE_FLEET_MIN_BYTES"
GATE_QUEUE_PRESSURE = "RACON_TPU_GATE_QUEUE_PRESSURE"
GATE_WORKERS = "RACON_TPU_GATE_WORKERS"
GATE_LEASE_S = "RACON_TPU_GATE_LEASE_S"
GATE_STANDBY_POLL_S = "RACON_TPU_GATE_STANDBY_POLL_S"
AVA_COMPACT = "RACON_TPU_AVA_COMPACT"
AVA_SEG = "RACON_TPU_AVA_SEG"
FLIGHT_EVENTS = "RACON_TPU_FLIGHT_EVENTS"
OBS_DIR = "RACON_TPU_OBS_DIR"
DIST_SHARDS = "RACON_TPU_DIST_SHARDS"
DIST_POLL = "RACON_TPU_DIST_POLL"
DIST_AVOID = "RACON_TPU_DIST_AVOID"
SPLIT = "RACON_TPU_SPLIT"
SPLIT_AFTER_S = "RACON_TPU_SPLIT_AFTER_S"
SPLIT_DEPTH = "RACON_TPU_SPLIT_DEPTH"
AUTOSCALE_MIN = "RACON_TPU_AUTOSCALE_MIN"
AUTOSCALE_MAX = "RACON_TPU_AUTOSCALE_MAX"
AUTOSCALE_INTERVAL_S = "RACON_TPU_AUTOSCALE_INTERVAL_S"
AUTOSCALE_MAX_SPAWNS = "RACON_TPU_AUTOSCALE_MAX_SPAWNS"
AUTOSCALE_DEADLINE_S = "RACON_TPU_AUTOSCALE_DEADLINE_S"
AUTOSCALE_FAULT_PLAN = "RACON_TPU_AUTOSCALE_FAULT_PLAN"
OBS_FLUSH_S = "RACON_TPU_OBS_FLUSH_S"
STRAGGLER_FRAC = "RACON_TPU_STRAGGLER_FRAC"
TRACE_CTX = "RACON_TPU_TRACE_CTX"
METRICS_PORT = "RACON_TPU_METRICS_PORT"
AVA_WEIGHTED = "RACON_TPU_AVA_WEIGHTED"
AVA_COMPILE_BUDGET = "RACON_TPU_AVA_COMPILE_BUDGET"
#: Gates whose unset value is not "" (the JAX package's defaults).
_DEFAULTS = {SERVE_BATCH: "256", SERVE_BATCH_WAIT_S: "0.05",
             SERVE_QUEUE: "64", SERVE_MAX_JOBS: "4", SERVE_GRACE_S: "30",
             CACHE_MAX_MB: "256", GATE_FLEET: "0",
             GATE_FLEET_MIN_TARGETS: "32", GATE_FLEET_MIN_BYTES: "8388608",
             GATE_QUEUE_PRESSURE: "8", GATE_WORKERS: "2",
             GATE_LEASE_S: "10", GATE_STANDBY_POLL_S: "0.2", SPLIT: "1",
             AVA_WEIGHTED: "1"}
_KNOWN = (NO_BAND, WALK_K, OVL_TILED, SCHED, ADAPTIVE, REDO, PIPELINE,
          PIPELINE_DEPTH, WALK_ASYNC, WALK_QUEUE, STALL_S, INGEST,
          INGEST_WORKERS, FAULTS, FAULT_STALL_S, FAULT_HANG_S, RETRY,
          DEADLINE_H2D, DEADLINE_D2H, DEADLINE_DISPATCH, DEADLINE_MBPS,
          DEADLINE_CELLS_PER_S, DEADLINE_SCALE, WATCHDOG_TERMINAL, TIMING,
          TRACE, TRACE_XPROF, SERVE_BATCH, SERVE_BATCH_WAIT_S, SERVE_QUEUE,
          SERVE_MAX_JOBS, SERVE_GRACE_S, SERVE_SPOOL_MB, CACHE, CACHE_DIR,
          CACHE_MAX_MB, CACHE_WINDOWS, GATE_FLEET, GATE_FLEET_MIN_TARGETS,
          GATE_FLEET_MIN_BYTES, GATE_QUEUE_PRESSURE, GATE_WORKERS,
          GATE_LEASE_S, GATE_STANDBY_POLL_S, AVA_COMPACT, AVA_SEG,
          FLIGHT_EVENTS, OBS_DIR, DIST_SHARDS, DIST_POLL, DIST_AVOID,
          SPLIT, SPLIT_AFTER_S, SPLIT_DEPTH, AUTOSCALE_MIN, AUTOSCALE_MAX, AUTOSCALE_INTERVAL_S,
          AUTOSCALE_MAX_SPAWNS, AUTOSCALE_DEADLINE_S, AUTOSCALE_FAULT_PLAN,
          OBS_FLUSH_S, STRAGGLER_FRAC, TRACE_CTX, METRICS_PORT,
          AVA_WEIGHTED, AVA_COMPILE_BUDGET)


def read(name: str) -> str:
    """Raw read of a declared gate (its default when unset: '' for most,
    :data:`_DEFAULTS` for the rest)."""
    if name not in _KNOWN:
        raise KeyError(f"[racon_tpu_torch::env] undeclared env gate {name!r}")
    return os.environ.get(name, _DEFAULTS.get(name, ""))


def band_disabled() -> bool:
    return read(NO_BAND) not in ("", "0", "false")


def ovl_tiled() -> bool:
    return read(OVL_TILED) != "0"


def sched_enabled() -> bool:
    return read(SCHED) not in ("0", "false")


def adaptive_enabled() -> bool:
    return read(ADAPTIVE) not in ("0", "false")


def redo_enabled() -> bool:
    return read(REDO) not in ("0", "false")


def timing_enabled() -> bool:
    """``RACON_TPU_TIMING``: per-round timing lines on stderr."""
    return read(TIMING) not in ("", "0")
