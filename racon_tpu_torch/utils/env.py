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
_KNOWN = (NO_BAND, WALK_K, OVL_TILED, SCHED, ADAPTIVE, REDO, PIPELINE,
          PIPELINE_DEPTH, WALK_ASYNC, WALK_QUEUE, STALL_S, INGEST,
          INGEST_WORKERS, FAULTS, FAULT_STALL_S, FAULT_HANG_S, RETRY,
          DEADLINE_H2D, DEADLINE_D2H, DEADLINE_DISPATCH, DEADLINE_MBPS,
          DEADLINE_CELLS_PER_S, DEADLINE_SCALE, WATCHDOG_TERMINAL, TIMING,
          TRACE, TRACE_XPROF)


def read(name: str) -> str:
    """Raw read of a declared gate ('' when unset)."""
    if name not in _KNOWN:
        raise KeyError(f"[racon_tpu_torch::env] undeclared env gate {name!r}")
    return os.environ.get(name, "")


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
