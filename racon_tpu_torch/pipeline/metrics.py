"""The port's counters: the streaming pipeline's, the ingest plane's,
the transfers' and the fault plane's.

Recorders over the port's one registry (obs/metrics.py, whose
:func:`registry` and :func:`reset` this module re-exports), under the
JAX package's registry keys: what its ``record_stage``,
``record_queue``, ``record_pipeline_wall``, ``record_walk``,
``record_stall``, ``record_ingest_parse``, ``record_ingest_wait``,
``record_ingest_inflate``, ``record_h2d``, ``record_d2h``,
``record_flag_pull``, ``record_retry``, ``record_retry_exhausted``,
``record_fault``, ``record_watchdog_breach`` and ``record_degraded``
store, with the same trace points (obs/trace.py). Every update takes the
registry's lock, since the pipeline's stage threads, the ingest prefetch
threads, the inflate workers and the watchdog's guard threads all write
here. ``reset()`` clears it (tests, and a caller that reads one run's
numbers).

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
  seconds, and the inflate plane's bytes, seconds and blocks;
- ``h2d_*``, ``d2h_*``: the chunk transfers' bytes, seconds (the h2d's
  enqueue; the d2h's wait for the chunk, compute included) and count;
  ``sched_flag_pull*``: the scheduler's flag pulls;
- ``res_*``: retries (total, a site, backoff seconds), exhausted retry
  loops, injected faults (total, a site), watchdog breaches (total, a
  site, terminal) and degraded chunks and windows
  (:func:`resilience_extras`).
"""

from __future__ import annotations

from typing import Dict, Optional

from racon_tpu_torch.obs import trace as _trace
# The one registry (obs/metrics.py): these recorders write to the same
# object the service core's do.
from racon_tpu_torch.obs.metrics import Registry, registry, reset
from racon_tpu_torch.obs.metrics import _REGISTRY


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


def record_stall(window_s: float, n_stages: int,
                 reg: Optional[Registry] = None) -> None:
    """One stall-detector firing (no stage progressed for a whole
    window), traced as a ``stall`` span."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("pipe_stall_events")
    _trace.get_tracer().point("stall", "pipeline", window_s=float(window_s),
                              stages=int(n_stages))


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


# ------------------------------------------------------------- transfers

def record_h2d(nbytes: int, seconds: float, reg: Optional[Registry] = None,
               name: str = "h2d") -> None:
    """One host-to-device transfer (traced as a ``transfer`` span)."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("h2d_bytes", int(nbytes))
    reg.inc("h2d_s", float(seconds))
    reg.inc("h2d_transfers")
    _trace.get_tracer().point("transfer", name, dur_s=float(seconds),
                              bytes=int(nbytes), dir="h2d")


def record_d2h(nbytes: int, seconds: float, reg: Optional[Registry] = None,
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
                     reg: Optional[Registry] = None) -> None:
    """The scheduler's flag pull: a sync point, so it stays out of the
    d2h keys."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("sched_flag_pulls")
    reg.inc("sched_flag_pull_s", float(seconds))


# ----------------------------------------------------------- resilience

def _site_key(site: str) -> str:
    """Counter-key slug of a site name ("h2d/chunk" -> "h2d_chunk")."""
    return site.replace("/", "_").replace(".", "_")


def record_retry(site: str, attempt: int, delay_s: float, error: str,
                 injected: bool, reg: Optional[Registry] = None) -> None:
    """One retried attempt at a retry-wrapped site (resilience/retry.py),
    traced as a ``retry`` span."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("res_retry_total")
    reg.inc(f"res_retry_site_{_site_key(site)}")
    reg.inc("res_retry_backoff_s", float(delay_s))
    _trace.get_tracer().point("retry", site, attempt=int(attempt),
                              error=error, injected=int(bool(injected)))


def record_retry_exhausted(site: str, attempts: int,
                           reg: Optional[Registry] = None) -> None:
    """A retry loop gave up; the caller degrades or ends the run."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("res_retry_exhausted")
    _trace.get_tracer().point("retry", f"{site}/exhausted",
                              attempt=int(attempts), error="exhausted",
                              injected=0)


def record_fault(site: str, index: int, action: str,
                 reg: Optional[Registry] = None) -> None:
    """One injected fault (resilience/faults.py)."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("res_fault_injected_total")
    reg.inc(f"res_fault_site_{_site_key(site)}")
    _trace.get_tracer().point("fault", site, index=int(index),
                              action=action)


def record_watchdog_breach(site: str, deadline_s: float, waited_s: float,
                           terminal: bool = False,
                           reg: Optional[Registry] = None) -> None:
    """One deadline breach (resilience/watchdog.py), traced as a
    ``watchdog`` span; a terminal one also counts
    ``res_watchdog_terminal_total``."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("res_watchdog_breach_total")
    reg.inc(f"res_watchdog_site_{_site_key(site)}")
    if terminal:
        reg.inc("res_watchdog_terminal_total")
    from racon_tpu_torch.obs.flightrec import note_breach
    note_breach(site, deadline_s, waited_s, terminal)
    _trace.get_tracer().point("watchdog", site, dur_s=float(waited_s),
                              deadline_s=float(deadline_s),
                              waited_s=round(float(waited_s), 6),
                              terminal=int(bool(terminal)))


def record_degraded(n_windows: int, reg: Optional[Registry] = None) -> None:
    """A chunk exhausted its retries (or the pipeline stalled) and its
    windows were polished on the host path."""
    reg = reg if reg is not None else _REGISTRY
    reg.inc("res_degraded_chunks")
    reg.inc("res_degraded_windows", int(n_windows))


def resilience_extras(reg: Optional[Registry] = None) -> Dict[str, object]:
    """The registry's ``res_*`` keys as a JSON-ready dict; empty when
    nothing resilience-related happened."""
    reg = reg if reg is not None else _REGISTRY
    out: Dict[str, object] = {}
    for k, v in sorted(reg.snapshot().items()):
        if k.startswith("res_"):
            out[k] = round(v, 4) if isinstance(v, float) else v
    return out
