"""The streaming pipeline's and the ingest plane's counters.

A process-wide registry of named numbers under the JAX package's
registry keys (its ``obs/metrics.py``): what its ``record_stage``,
``record_queue``, ``record_pipeline_wall``, ``record_walk``,
``record_stall``, ``record_ingest_parse``, ``record_ingest_wait`` and
``record_ingest_inflate`` store. Every update takes the registry's lock,
since the pipeline's stage threads, the ingest prefetch threads and the
inflate workers all write here. ``reset()`` clears it (tests, and a caller
that reads one run's numbers).

- ``pipe_stage_<name>_{busy_s,stall_in_s,stall_out_s,items}``: a stage's
  seconds in its work function, blocked on its input queue, blocked on its
  output queue, and items handled;
- ``pipe_queue_<name>_{peak,put_wait_s,get_wait_s}``: a queue's peak depth
  and the seconds its producers and consumers were blocked;
- ``pipe_runs``, ``pipe_wall_s``: stream_consensus calls and their wall;
  ``pipe_stall_events``: stall-detector firings;
- ``walk_*``: the decoupled walk (seconds in walk dispatches, the part of
  them during which another chunk's forward was in flight, decoupled
  dispatches, fused chunks, the walk queue's peak, whether it was on);
- ``ingest_*``: parse seconds, records and bytes, the consumer's blocked
  seconds, and the inflate plane's bytes, seconds and blocks.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class Registry:
    """Named counters and gauges, safe to update from any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._v: Dict[str, float] = {}

    def inc(self, key: str, v=1) -> None:
        with self._lock:
            self._v[key] = self._v.get(key, 0) + v

    def max(self, key: str, v) -> None:
        with self._lock:
            self._v[key] = max(self._v.get(key, v), v)

    def set(self, key: str, v) -> None:
        with self._lock:
            self._v[key] = v

    def get(self, key: str, default=None):
        with self._lock:
            return self._v.get(key, default)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._v)

    def reset(self) -> None:
        with self._lock:
            self._v.clear()


_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY


def reset() -> None:
    _REGISTRY.reset()


def record_stage(name: str, busy_s: float, stall_in_s: float,
                 stall_out_s: float, items: int,
                 reg: Optional[Registry] = None) -> None:
    """One pipeline stage's totals, when its thread exits."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc(f"pipe_stage_{name}_busy_s", float(busy_s))
    reg.inc(f"pipe_stage_{name}_stall_in_s", float(stall_in_s))
    reg.inc(f"pipe_stage_{name}_stall_out_s", float(stall_out_s))
    reg.inc(f"pipe_stage_{name}_items", int(items))


def record_queue(name: str, peak: int, put_wait_s: float, get_wait_s: float,
                 reg: Optional[Registry] = None) -> None:
    """One bounded queue's gauges (the peak is a max across runs)."""
    reg = reg if reg is not None else _REGISTRY
    reg.max(f"pipe_queue_{name}_peak", int(peak))
    reg.inc(f"pipe_queue_{name}_put_wait_s", float(put_wait_s))
    reg.inc(f"pipe_queue_{name}_get_wait_s", float(get_wait_s))


def record_pipeline_wall(seconds: float,
                         reg: Optional[Registry] = None) -> None:
    """One stream_consensus call's wall seconds."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("pipe_runs")
    reg.inc("pipe_wall_s", float(seconds))


def record_stall(reg: Optional[Registry] = None) -> None:
    """One stall-detector firing."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("pipe_stall_events")


def record_walk(walk_s: float, overlap_s: float, dispatches: int,
                fused_chunks: int, queue_peak: int, enabled: bool,
                reg: Optional[Registry] = None) -> None:
    """One stream_consensus call's decoupled-walk numbers; sets
    ``walk_hidden_fraction`` = overlap / walk seconds over the run."""
    reg = reg if reg is not None else _REGISTRY
    reg.set("walk_async_enabled", int(bool(enabled)))
    reg.inc("walk_seconds", float(walk_s))
    reg.inc("walk_overlap_s", float(overlap_s))
    reg.inc("walk_dispatches", int(dispatches))
    reg.inc("walk_fused_chunks", int(fused_chunks))
    reg.max("walk_queue_peak", int(queue_peak))
    total = float(reg.get("walk_seconds", 0.0))
    if total > 0:
        reg.set("walk_hidden_fraction",
                float(reg.get("walk_overlap_s", 0.0)) / total)


def record_ingest_parse(mode: str, seconds: float, records: int,
                        raw_bytes: int, reg: Optional[Registry] = None
                        ) -> None:
    """One file's parse totals (``mode``: ``serial`` or ``prefetch``)."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("ingest_parse_s", float(seconds))
    reg.inc("ingest_records", int(records))
    reg.inc("ingest_raw_bytes", int(raw_bytes))
    reg.inc(f"ingest_parse_{mode}_files")


def record_ingest_wait(seconds: float,
                       reg: Optional[Registry] = None) -> None:
    """Seconds a consumer was blocked on ingest (all of a serial parse)."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("ingest_wait_s", float(seconds))


def record_ingest_inflate(mode: str, bytes_in: int, bytes_out: int,
                          seconds: float, blocks: int,
                          reg: Optional[Registry] = None) -> None:
    """One gzip source's inflate totals (``mode``: bgzf, members or
    stream); ``seconds`` sums the workers' inflate time."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("ingest_bytes_in", int(bytes_in))
    reg.inc("ingest_bytes_out", int(bytes_out))
    reg.inc("ingest_inflate_s", float(seconds))
    reg.inc("ingest_blocks", int(blocks))
    reg.inc(f"ingest_inflate_{mode}_sources")
