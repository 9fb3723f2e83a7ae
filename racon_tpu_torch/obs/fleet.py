"""Fleet observability plane: worker metric shards and their aggregate
(port of the JAX package's ``obs/fleet.py``; same files, same records,
same model).

The writer half:

- :class:`WorkerMetricsWriter` — every ledger worker (and the serial CLI
  under ``RACON_TPU_OBS_DIR``) snapshots its registry into
  ``obs/worker_<id>.metrics.jsonl``: a history of snapshots, the whole
  file republished atomically at each flush, so a reader never sees a
  torn shard however the worker dies. The CLI's SIGTERM teardown calls
  :func:`flush_final`, so an evicted worker leaves a final snapshot; a
  hard kill leaves the last periodic one. The ``obs/snapshot`` fault
  site drills the hazard the atomic publish removes: a ``torn`` rule
  writes a truncated file at the final path and hard-exits, and the
  reader must still recover every record before the tear.

The reader half:

- :func:`aggregate` — merges every worker shard, the ledger's
  ``events.jsonl`` and the autoscaler's heartbeat into one fleet model:
  each worker's last snapshot, windows a second and phase seconds;
  fleet-wide values folded by each key's merge kind
  (obs/metrics.py::merge_values); a per-shard lease timeline with renew
  runs compressed; straggler flags under ``RACON_TPU_STRAGGLER_FRAC``.
  Shards of different run fingerprints refuse to merge
  (:class:`FleetObsError`).
- :func:`assemble_job_timeline` — one job's spans across every process's
  trace file, on one wall clock.

The model feeds obs/export.py (``render_fleet``, ``fleet_health``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from racon_tpu_torch.obs.metrics import Registry, merge_values
from racon_tpu_torch.obs.metrics import registry as _default_registry
from racon_tpu_torch.resilience.faults import hard_exit, maybe_torn
from racon_tpu_torch.utils import env
from racon_tpu_torch.utils.atomicio import (atomic_write_bytes, fsync_dir,
                                            load_jsonl_prefix)

SNAPSHOT_SCHEMA = 1
OBS_SUBDIR = "obs"
SHARD_SUFFIX = ".metrics.jsonl"
#: The autoscaler's per-tick heartbeat (distributed/autoscaler.py),
#: written atomically beside the worker shards.
SUPERVISOR_NAME = "autoscaler.json"

#: The serial CLI's opt-in: a directory to write the same metric shard a
#: fleet worker writes (a one-shard directory aggregates as a one-worker
#: fleet).
ENV_OBS_DIR = env.OBS_DIR
#: Seconds between periodic flushes (default 5; 0 flushes at every
#: :func:`maybe_flush`).
ENV_FLUSH_S = env.OBS_FLUSH_S
DEFAULT_FLUSH_S = 5.0
#: A worker whose windows a second sit below this fraction of the
#: fleet's median (over workers that polished at all) is a straggler.
ENV_STRAGGLER_FRAC = env.STRAGGLER_FRAC
DEFAULT_STRAGGLER_FRAC = 0.5


class FleetObsError(ValueError):
    """Unusable fleet state: no worker shard where some were expected,
    or shards of different run fingerprints (merging them would make up
    a fleet that never ran)."""


def straggler_frac() -> float:
    raw = env.read(ENV_STRAGGLER_FRAC).strip()
    if not raw:
        return DEFAULT_STRAGGLER_FRAC
    try:
        v = float(raw)
    except ValueError:
        raise FleetObsError(
            f"[racon_tpu_torch::fleet] invalid {ENV_STRAGGLER_FRAC}="
            f"{raw!r} (expected a fraction in (0, 1])")
    if not 0.0 < v <= 1.0:
        raise FleetObsError(
            f"[racon_tpu_torch::fleet] invalid {ENV_STRAGGLER_FRAC}={v} "
            "(expected a fraction in (0, 1])")
    return v


def _slug(worker_id: str) -> str:
    """Filesystem-safe shard name component of a worker id."""
    out = "".join(ch if ch.isalnum() or ch in "._-" else "_"
                  for ch in str(worker_id))
    return out[:80] or "worker"


def shard_path(directory: str, worker_id: str) -> str:
    return os.path.join(directory, f"worker_{_slug(worker_id)}"
                        f"{SHARD_SUFFIX}")


def flush_interval() -> float:
    raw = env.read(ENV_FLUSH_S)
    if raw:
        try:
            return max(0.0, float(raw))
        except ValueError:
            pass
    return DEFAULT_FLUSH_S


class WorkerMetricsWriter:
    """Periodic, atomically published registry snapshots of one worker.

    The shard is a JSONL history: one record a flush, ``seq`` strictly
    increasing, each carrying the whole registry snapshot, the worker's
    identity (``worker_id``, ``run_fp``) and its clocks. Each flush
    rewrites the file through atomic_write_bytes, so the published file
    is always a complete history and readers take its last record.
    """

    def __init__(self, directory: str, worker_id: str, run_fp: str,
                 reg: Optional[Registry] = None,
                 interval_s: Optional[float] = None):
        os.makedirs(directory, exist_ok=True)
        fsync_dir(os.path.dirname(os.path.abspath(directory)))
        self.directory = directory
        self.worker_id = str(worker_id)
        self.run_fp = str(run_fp)
        self.path = shard_path(directory, worker_id)
        self.interval_s = (flush_interval() if interval_s is None
                           else max(0.0, float(interval_s)))
        self._reg = reg if reg is not None else _default_registry()
        self._lock = threading.Lock()
        self._records: List[Dict] = []   # guarded-by: _lock
        self._t0 = time.perf_counter()
        self._last_flush = -1.0
        self._final = False              # guarded-by: _lock

    def maybe_flush(self) -> bool:
        """Flush when the interval has passed (always at interval 0 and
        on the first call); True when a snapshot was published."""
        now = time.perf_counter()
        if self._last_flush >= 0.0 and \
                now - self._last_flush < self.interval_s:
            return False
        self.flush()
        return True

    def flush(self, final: bool = False) -> None:
        """Snapshot the registry and republish the shard. ``final`` marks
        the exit snapshot (a clean exit or the SIGTERM teardown); the
        writer is inert after it, so late teardown paths may call it."""
        with self._lock:
            if self._final:
                return
            self._final = bool(final)
            rec = {
                "schema": SNAPSHOT_SCHEMA,
                "seq": len(self._records),
                "worker_id": self.worker_id,
                "run_fp": self.run_fp,
                "unix_time": round(time.time(), 3),
                "wall_s": round(time.perf_counter() - self._t0, 3),
                "final": bool(final),
                "metrics": self._reg.snapshot(),
            }
            self._records.append(rec)
            data = b"".join(
                json.dumps(r, sort_keys=True,
                           separators=(",", ":")).encode() + b"\n"
                for r in self._records)
            if maybe_torn("obs/snapshot"):
                # The drill: write a truncated shard straight to the
                # final path (the atomic publish cannot tear), make it
                # durable and die without cleanup.
                torn = data[:max(1, len(data) - 17)]
                with open(self.path, "wb") as fh:
                    fh.write(torn)
                    fh.flush()
                    os.fsync(fh.fileno())
                hard_exit(137)
            atomic_write_bytes(self.path, data)
            self._last_flush = time.perf_counter()


# One writer a process, installed by the CLI or the worker at join time,
# so library code and teardown paths can flush without plumbing.
_WRITER: Optional[WorkerMetricsWriter] = None


def install_writer(directory: str, worker_id: str, run_fp: str,
                   reg: Optional[Registry] = None,
                   interval_s: Optional[float] = None
                   ) -> WorkerMetricsWriter:
    """Install the process's metrics writer and flush it at once, so a
    worker evicted before its first contig still shows in the fleet."""
    global _WRITER
    _WRITER = WorkerMetricsWriter(directory, worker_id, run_fp,
                                  reg=reg, interval_s=interval_s)
    _WRITER.flush()
    return _WRITER


def get_writer() -> Optional[WorkerMetricsWriter]:
    return _WRITER


def maybe_flush() -> None:
    """The periodic flush of hot paths; a no-op without a writer."""
    if _WRITER is not None:
        _WRITER.maybe_flush()


def flush_final(reason: str = "teardown") -> None:
    """The final snapshot of every exit path (clean return, SIGTERM
    teardown, self-eviction); idempotent, a no-op without a writer. It
    also dumps the flight recorder (obs/flightrec.py) beside the
    shards."""
    if _WRITER is not None:
        _WRITER.flush(final=True)
        from racon_tpu_torch.obs import flightrec
        flightrec.dump(_WRITER.directory, reason=reason)


# ----------------------------------------------------------- aggregation

def obs_dir_for(root: str) -> str:
    """The shard directory of ``root``: its ``obs/`` subdirectory when
    there is one (a ledger), else ``root`` itself (a bare
    ``RACON_TPU_OBS_DIR``)."""
    sub = os.path.join(root, OBS_SUBDIR)
    return sub if os.path.isdir(sub) else root


def load_worker_shards(obs_dir: str) -> List[Dict]:
    """Every ``worker_*.metrics.jsonl`` under ``obs_dir``, read
    tolerantly: a torn tail drops only the torn record. Returns ``[{path,
    records, clean}, ...]`` sorted by file name; a shard with no
    readable record is skipped."""
    shards = []
    try:
        names = sorted(os.listdir(obs_dir))
    except OSError:
        return shards
    for name in names:
        if not (name.startswith("worker_") and
                name.endswith(SHARD_SUFFIX)):
            continue
        path = os.path.join(obs_dir, name)
        records, clean = load_jsonl_prefix(path)
        records = [r for r in records
                   if r.get("schema") == SNAPSHOT_SCHEMA and
                   isinstance(r.get("metrics"), dict) and
                   "worker_id" in r and "run_fp" in r]
        if records:
            shards.append({"path": path, "records": records,
                           "clean": clean})
    return shards


def _compress_timeline(events: List[Dict]) -> Dict[str, List[Dict]]:
    """Ledger events grouped by shard name into timelines, each run of
    consecutive renews by one worker folded into one ``{"ev": "renew",
    "n": count, ...}`` entry."""
    timeline: Dict[str, List[Dict]] = {}
    for rec in events:
        name = rec.get("name")
        ev = rec.get("ev")
        if not isinstance(name, str) or ev not in ("claim", "renew",
                                                   "steal", "complete",
                                                   "release", "split"):
            continue
        lane = timeline.setdefault(name, [])
        if ev == "renew" and lane and lane[-1]["ev"] == "renew" and \
                lane[-1].get("worker") == rec.get("worker"):
            lane[-1]["n"] += 1
            lane[-1]["t_last"] = rec.get("t")
            continue
        entry = {"ev": ev, "worker": rec.get("worker"),
                 "t": rec.get("t")}
        if ev == "renew":
            entry["n"] = 1
            entry["t_last"] = rec.get("t")
        if ev == "steal":
            entry["victim"] = rec.get("victim")
            entry["expired_for_s"] = rec.get("expired_for_s")
        if ev == "split":
            entry["child"] = rec.get("child")
        if "epoch" in rec:
            entry["epoch"] = rec.get("epoch")
        lane.append(entry)
    return timeline


def load_supervisor(root: str) -> Optional[Dict]:
    """The autoscaler's heartbeat (``obs/autoscaler.json``), or None when
    no supervisor attached to this ledger; an unreadable heartbeat reads
    as absent."""
    path = os.path.join(obs_dir_for(root), SUPERVISOR_NAME)
    try:
        with open(path, "rb") as fh:
            rec = json.loads(fh.read())
    except (OSError, ValueError):
        return None
    return rec if isinstance(rec, dict) else None


def aggregate(root: str) -> Dict:
    """Merge every worker shard under ``root`` (and the ledger's
    ``events.jsonl`` when there is one) into the fleet model::

        {"run_fp", "n_workers",
         "workers": {wid: {"seq", "wall_s", "final", "clean",
                           "unix_time", "windows_per_sec",
                           "phase_seconds", "metrics", "straggler"}},
         "fleet": {key: merged value}, "timeline": {shard: [events]},
         "lineage": {child: parent}, "steals", "splits", "spawns",
         "retires", "supervisor", "stragglers"}

    Raises :class:`FleetObsError` when no shard is readable or the
    shards carry different run fingerprints."""
    obs_dir = obs_dir_for(root)
    shards = load_worker_shards(obs_dir)
    if not shards:
        raise FleetObsError(
            f"[racon_tpu_torch::fleet] no worker metric shards under "
            f"{obs_dir!r} — was the fleet run with fleet obs enabled "
            "(ledger workers write them automatically; serial runs "
            f"need {ENV_OBS_DIR})?")
    fps = sorted({sh["records"][-1]["run_fp"] for sh in shards})
    if len(fps) > 1:
        raise FleetObsError(
            f"[racon_tpu_torch::fleet] refusing to merge shards from "
            f"different runs: {obs_dir!r} holds run_fp "
            f"{', '.join(fp[:12] for fp in fps)} — stale shards from "
            "a previous run share this directory; clear it or point "
            "at a fresh one")
    workers: Dict[str, Dict] = {}
    for sh in shards:
        last = sh["records"][-1]
        wid = str(last["worker_id"])
        metrics = last["metrics"]
        wall = float(last.get("wall_s", 0.0))
        windows = metrics.get("poa_windows_total", 0)
        phase = {k[len("phase_seconds_"):]: v
                 for k, v in metrics.items()
                 if k.startswith("phase_seconds_") and
                 k != "phase_seconds_total"}
        workers[wid] = {
            "seq": last.get("seq"),
            "wall_s": wall,
            "final": bool(last.get("final")),
            "clean": bool(sh["clean"]),
            "unix_time": last.get("unix_time"),
            "windows_per_sec": (round(windows / wall, 3)
                                if wall > 0 and windows else 0.0),
            "phase_seconds": phase,
            "metrics": metrics,
        }
    # Stragglers need at least two workers that polished windows.
    rates = sorted(w["windows_per_sec"] for w in workers.values()
                   if w["windows_per_sec"] > 0)
    stragglers: List[str] = []
    if len(rates) >= 2:
        mid = len(rates) // 2
        median = rates[mid] if len(rates) % 2 else \
            (rates[mid - 1] + rates[mid]) / 2.0
        cutoff = straggler_frac() * median
        for wid in sorted(workers):
            w = workers[wid]
            w["straggler"] = bool(0 < w["windows_per_sec"] < cutoff)
            if w["straggler"]:
                stragglers.append(wid)
    else:
        for w in workers.values():
            w["straggler"] = False
    keys = sorted({k for w in workers.values() for k in w["metrics"]})
    order = sorted(workers)
    fleet = {}
    for key in keys:
        merged = merge_values(
            key, [workers[w]["metrics"].get(key) for w in order])
        if merged is not None:
            fleet[key] = merged
    events_path = os.path.join(root, "events.jsonl")
    events: List[Dict] = []
    if os.path.exists(events_path):
        events, _ = load_jsonl_prefix(events_path)
    timeline = _compress_timeline(events)
    steals = sum(1 for rec in events if rec.get("ev") == "steal")
    splits = sum(1 for rec in events if rec.get("ev") == "split")
    spawns = sum(1 for rec in events if rec.get("ev") == "spawn")
    retires = sum(1 for rec in events if rec.get("ev") == "retire")
    lineage = {rec["child"]: rec["name"] for rec in events
               if rec.get("ev") == "split" and
               isinstance(rec.get("child"), str) and
               isinstance(rec.get("name"), str)}
    # The supervisor polishes nothing and has no shard: its decision
    # counters and target gauge ride its heartbeat into the fold.
    supervisor = load_supervisor(root)
    if supervisor is not None:
        for key, val in sorted(
                (supervisor.get("metrics") or {}).items()):
            if isinstance(val, (int, float)) and \
                    not isinstance(val, bool):
                fleet[key] = val
    return {
        "run_fp": fps[0],
        "n_workers": len(workers),
        "workers": workers,
        "fleet": fleet,
        "timeline": timeline,
        "lineage": lineage,
        "steals": steals,
        "splits": splits,
        "spawns": spawns,
        "retires": retires,
        "supervisor": supervisor,
        "stragglers": stragglers,
    }


# ----------------------------------------------------- per-job timelines

def _span_matches_trace(span: Dict, trace_id: str) -> bool:
    """Batch spans carry comma-joined trace ids (one dispatch serves
    several jobs); a span belongs to the job when its id is listed."""
    tid = span.get("trace_id")
    if not isinstance(tid, str):
        return False
    return trace_id in tid.split(",")


def assemble_job_timeline(root: str, trace_id: str) -> Dict:
    """One job's causal timeline from every span file under ``root`` (its
    ``obs/`` subdirectory for a ledger, and any nested ``obs/``): each
    process writes its own ``RACON_TPU_TRACE`` JSONL, and every span
    carrying the job's ``trace_id`` is placed on one wall clock by its
    trace's ``begin`` record. ``.part`` files count too: a hard-killed
    worker never finished its trace.

    Returns ``{"trace_id", "n_processes", "n_spans", "sources": {file:
    span count}, "spans": [...]}``, spans sorted by absolute start
    (each gains ``t_abs`` and ``src``). Raises :class:`FleetObsError`
    when no span carries the id, or the matched spans carry different
    ``run_fp`` stamps."""
    obs_dir = obs_dir_for(root)
    dirs = [obs_dir]
    for dirpath, _dirnames, _files in os.walk(root):
        if os.path.basename(dirpath) == OBS_SUBDIR and \
                os.path.abspath(dirpath) != os.path.abspath(obs_dir):
            dirs.append(dirpath)
    spans: List[Dict] = []
    sources: Dict[str, int] = {}
    fps = set()
    for d in dirs:
        try:
            names = sorted(os.listdir(d))
        except OSError:
            names = []
        for name in names:
            if name.endswith(SHARD_SUFFIX) or not (
                    name.endswith(".jsonl") or
                    name.endswith(".jsonl.part")):
                continue
            path = os.path.join(d, name)
            src = name if d == obs_dir else \
                os.path.relpath(path, root)
            records, _ = load_jsonl_prefix(path)
            if not records or records[0].get("ev") != "begin":
                continue
            begin = float(records[0].get("unix_time", 0.0))
            n = 0
            for rec in records[1:]:
                if rec.get("ev") != "span" or \
                        not _span_matches_trace(rec, trace_id):
                    continue
                span = dict(rec)
                span["t_abs"] = round(
                    begin + float(rec.get("t0", 0.0)), 6)
                span["src"] = src
                spans.append(span)
                n += 1
                fp = rec.get("run_fp")
                if isinstance(fp, str):
                    fps.add(fp)
            if n:
                sources[src] = n
    if not spans:
        raise FleetObsError(
            f"[racon_tpu_torch::fleet] no span under {obs_dir!r} carries "
            f"trace_id {trace_id!r} — was the job run with tracing on "
            f"and the trace context handed to every process?")
    if len(fps) > 1:
        raise FleetObsError(
            f"[racon_tpu_torch::fleet] refusing to assemble a timeline "
            f"from mixed runs: trace_id {trace_id!r} matched spans "
            f"stamped run_fp {', '.join(sorted(fp[:12] for fp in fps))} "
            "— stale traces from a previous run share this directory")
    spans.sort(key=lambda s: (s["t_abs"], s["src"], s.get("id", 0)))
    return {
        "trace_id": trace_id,
        "n_processes": len(sources),
        "n_spans": len(spans),
        "sources": sources,
        "spans": spans,
    }
