"""Per-process crash flight recorder: a bounded in-memory ring of the
last N telemetry events — span records (fed by obs/trace.py), metric
mutations (fed by obs/metrics.py), and watchdog breaches — dumped to
``<obs-dir>/flight_<pid>.json`` when the process tears down abnormally
(the daemon's SIGTERM drain, server/daemon.py). Port of the JAX
package's ``obs/flightrec.py``; same format.

The dump is JSON Lines despite the ``.json`` suffix — one header line,
one line per ring event, one final metrics-registry snapshot line — so
a dump torn mid-write (power loss, SIGKILL racing the flush) still
loads as a valid prefix via
:func:`racon_tpu_torch.utils.atomicio.load_jsonl_prefix`. The ``obs/flight``
fault site injects exactly that tear in tests and the resilience
drills.

The ring is always armed (capacity ``RACON_TPU_FLIGHT_EVENTS``,
default 256; 0 disables) because the events it needs most are the ones
nobody planned to capture; appends are O(1) deque pushes under a
dedicated lock, and nothing is written to disk until :func:`dump`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from racon_tpu_torch.utils import env
from racon_tpu_torch.utils.atomicio import (atomic_write_bytes,
                                            load_jsonl_prefix)

SCHEMA_VERSION = 1

ENV_FLIGHT_EVENTS = env.FLIGHT_EVENTS
DEFAULT_EVENTS = 256

#: Dump filename prefix; one dump per pid so fleet workers never race.
FILE_PREFIX = "flight_"


class FlightRecorder:
    """Bounded event ring. ``capacity == 0`` records nothing (the
    disabled recorder still answers every call, so feed points need no
    gating)."""

    def __init__(self, capacity: int = DEFAULT_EVENTS):
        self.capacity = max(int(capacity), 0)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity or 1)

    def note(self, rec: Dict) -> None:
        if not self.capacity:
            return
        with self._lock:
            self._ring.append(rec)

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._ring) if self.capacity else []


_RECORDER: Optional[FlightRecorder] = None
_LOCK = threading.Lock()


def recorder() -> FlightRecorder:
    """The process flight recorder; sized from the environment on first
    use."""
    global _RECORDER
    if _RECORDER is None:
        with _LOCK:
            if _RECORDER is None:
                raw = env.read(ENV_FLIGHT_EVENTS)
                try:
                    cap = int(raw) if raw else DEFAULT_EVENTS
                except ValueError:
                    cap = DEFAULT_EVENTS
                _RECORDER = FlightRecorder(cap)
    return _RECORDER


def reset() -> None:
    """Drop the process recorder (tests re-arm with a fresh ring)."""
    global _RECORDER
    with _LOCK:
        _RECORDER = None


# ---------------------------------------------------------- feed points

def note_span(rec: Dict) -> None:
    """Called by obs/trace.py for every span record written."""
    recorder().note(rec)


def note_metric(key: str, value) -> None:
    """Called by obs/metrics.py for global-registry mutations."""
    r = recorder()
    if not r.capacity:
        return
    r.note({"ev": "metric", "k": key, "v": value,
            "wall": round(time.time(), 3)})


def note_breach(site: str, deadline_s: float, waited_s: float,
                terminal: bool) -> None:
    """Breaches land in the ring even when tracing is off."""
    recorder().note({"ev": "breach", "site": site,
                     "deadline_s": round(float(deadline_s), 6),
                     "waited_s": round(float(waited_s), 6),
                     "terminal": int(bool(terminal)),
                     "wall": round(time.time(), 3)})


# ----------------------------------------------------------- dump/load

def flight_path(directory: str, pid: Optional[int] = None) -> str:
    return os.path.join(directory,
                        f"{FILE_PREFIX}{pid or os.getpid()}.json")


def list_flights(directory: str) -> List[str]:
    """Every flight dump under ``directory``, sorted by name."""
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return sorted(os.path.join(directory, n) for n in names
                  if n.startswith(FILE_PREFIX) and n.endswith(".json"))


def dump(directory: Optional[str] = None, reason: str = "teardown") -> str:
    """Write the ring to ``<directory>/flight_<pid>.json`` atomically;
    returns the path ("" when no directory is resolvable — flight
    recording is strictly best-effort and never takes down a teardown
    path). ``directory=None`` falls back to ``RACON_TPU_OBS_DIR``."""
    if directory is None:
        directory = env.read(env.OBS_DIR)
    if not directory:
        return ""
    # Imported here, not at module top: metrics feeds this module, and
    # faults -> metrics would otherwise close an import cycle.
    from racon_tpu_torch.obs import metrics as _metrics
    from racon_tpu_torch.resilience import faults as _faults

    t0 = time.perf_counter()
    events = recorder().events()
    header = {"ev": "flight", "schema": SCHEMA_VERSION,
              "pid": os.getpid(), "reason": str(reason),
              "unix_time": round(time.time(), 3),
              "events": len(events)}
    lines = [json.dumps(header, separators=(",", ":"))]
    lines.extend(json.dumps(e, separators=(",", ":")) for e in events)
    lines.append(json.dumps(
        {"ev": "metrics", **_metrics.registry().snapshot()},
        separators=(",", ":"), default=str))
    data = ("\n".join(lines) + "\n").encode("utf-8")
    path = flight_path(directory)
    try:
        os.makedirs(directory, exist_ok=True)
        if _faults.maybe_torn("obs/flight"):
            torn = data[: max(1, len(data) - 17)]
            with open(path, "wb") as fh:  # lint: atomic-ok (torn-write drill)
                fh.write(torn)
                fh.flush()
                os.fsync(fh.fileno())
            _faults.hard_exit(137)
        atomic_write_bytes(path, data)
    except OSError:
        return ""
    dt = time.perf_counter() - t0
    _metrics.registry().inc("flight_dump_write_s", round(dt, 6))
    _metrics.registry().inc("flight_dumps_total")
    return path


def load_flight(path: str) -> Dict:
    """Parse a dump (torn-tolerant): the longest clean JSONL prefix,
    split into header / ring events / trailing metrics snapshot.
    Raises ValueError when even the header line is unusable."""
    records, clean = load_jsonl_prefix(path)
    if not records or records[0].get("ev") != "flight" or \
            records[0].get("schema") != SCHEMA_VERSION:
        raise ValueError(f"[racon_tpu_torch::flightrec] not a flight dump: "
                         f"{path}")
    header = records[0]
    metrics = None
    body = records[1:]
    if body and body[-1].get("ev") == "metrics":
        metrics = body.pop()
    return {"header": header, "events": body, "metrics": metrics,
            "clean": clean}
