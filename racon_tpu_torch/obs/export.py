"""OpenMetrics text render of the port's metrics registry — the
single-process half of the JAX package's ``obs/export.py``.

- every metric is ``racon_tpu_<key>`` (the JAX package's prefix, so one
  scrape config reads both), preceded by stable ``# HELP`` / ``# TYPE``
  lines;
- the merge kind (obs/metrics.py::merge_kind) decides the type: ``sum``
  keys are counters (samples get the ``_total`` suffix), ``max``/``last``
  keys gauges, the histogram families histograms;
- the output is byte-stable: keys sorted, numbers formatted through one
  path, no timestamps; it ends with ``# EOF``.

Non-numeric registry values have no OpenMetrics form and are skipped.
Entry points: :func:`render_registry` (one process's registry: the
daemon's and the CLI's metrics endpoints), :func:`render_fleet` (the
fleet model of obs/fleet.py::aggregate), :func:`fleet_health` (the
``/healthz`` view of a ledger member), :func:`serve_metrics` (the CLI's
``RACON_TPU_METRICS_PORT`` pull endpoint) and
:func:`validate_openmetrics` (the tests' structural check).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from racon_tpu_torch.obs.metrics import (HIST_BUCKETS, MERGE_HIST,
                                         MERGE_SUM, merge_kind)
from racon_tpu_torch.utils import env

ENV_METRICS_PORT = env.METRICS_PORT

PREFIX = "racon_tpu_"
CONTENT_TYPE = ("application/openmetrics-text; version=1.0.0; "
                "charset=utf-8")


def _sanitize(key: str) -> str:
    """Map a registry key into the OpenMetrics name charset
    ``[a-zA-Z0-9_]`` (leading digits get an underscore)."""
    out = "".join(ch if ch.isalnum() or ch == "_" else "_"
                  for ch in key)
    if out and out[0].isdigit():
        out = "_" + out
    return out or "unnamed"


def _fmt(value) -> str:
    """One deterministic number path — byte-stability depends on it."""
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int):
        return str(value)
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _labels(pairs: List[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in pairs)
    return "{" + body + "}"


def _numeric(value) -> bool:
    # bool is an int subclass; _fmt renders it 1/0.
    return isinstance(value, (int, float))


class _Family:
    """One metric family: TYPE/HELP header + sorted samples."""

    __slots__ = ("name", "mtype", "help", "samples")

    def __init__(self, name: str, mtype: str, help_text: str):
        self.name = name
        self.mtype = mtype
        self.help = help_text
        self.samples: List[Tuple[str, str]] = []

    def add(self, labels: List[Tuple[str, str]], value) -> None:
        suffix = "_total" if self.mtype == "counter" else ""
        self.samples.append(
            (f"{self.name}{suffix}{_labels(labels)}", _fmt(value)))

    def add_hist(self, labels: List[Tuple[str, str]], hist: Dict,
                 bounds) -> None:
        """One histogram series: cumulative ``_bucket`` samples in
        declared ``le`` order (ending at ``+Inf``), then ``_sum`` and
        ``_count``. Appended in order — render() keeps histogram
        samples unsorted because ``le`` values sort numerically, not
        lexically."""
        buckets = list(hist.get("buckets", ()))
        buckets += [0] * (len(bounds) + 1 - len(buckets))
        cum = 0
        for i, bound in enumerate(bounds):
            cum += int(buckets[i])
            self.samples.append((
                f"{self.name}_bucket"
                f"{_labels(labels + [('le', _fmt(float(bound)))])}",
                _fmt(cum)))
        cum += int(buckets[len(bounds)])
        self.samples.append((
            f"{self.name}_bucket{_labels(labels + [('le', '+Inf')])}",
            _fmt(cum)))
        self.samples.append((f"{self.name}_sum{_labels(labels)}",
                             _fmt(float(hist.get('sum', 0.0)))))
        self.samples.append((f"{self.name}_count{_labels(labels)}",
                             _fmt(int(hist.get('count', 0)))))

    def render(self, out: List[str]) -> None:
        out.append(f"# HELP {self.name} {self.help}")
        out.append(f"# TYPE {self.name} {self.mtype}")
        samples = self.samples if self.mtype == "histogram" \
            else sorted(self.samples)
        for sample, value in samples:
            out.append(f"{sample} {value}")


def _family_for_key(key: str) -> _Family:
    kind = merge_kind(key)
    name = PREFIX + _sanitize(key)
    if kind == MERGE_SUM and name.endswith("_total"):
        # The sample suffix is appended by _Family.add; a key that
        # already says _total (poa_windows_total) must not double it.
        name = name[:-len("_total")]
    if kind == MERGE_HIST:
        mtype = "histogram"
    else:
        mtype = "counter" if kind == MERGE_SUM else "gauge"
    return _Family(name, mtype,
                   f"racon_tpu metric {key} (merge={kind})")


def _render(families: List[_Family]) -> str:
    families = sorted(families, key=lambda f: f.name)
    out: List[str] = []
    for fam in families:
        fam.render(out)
    out.append("# EOF")
    return "\n".join(out) + "\n"


def render_registry(snapshot: Dict,
                    labels: Optional[List[Tuple[str, str]]] = None
                    ) -> str:
    """Render one registry snapshot (MetricsRegistry.snapshot()) as
    OpenMetrics text. ``labels`` are attached to every sample (the pull
    endpoint tags ``worker``)."""
    labels = labels or []
    fams: Dict[str, _Family] = {}
    for key in sorted(snapshot):
        value = snapshot[key]
        is_hist = key in HIST_BUCKETS and isinstance(value, dict)
        if not is_hist and not _numeric(value):
            continue
        fam = _family_for_key(key)
        if fam.name in fams:
            fam = fams[fam.name]
        else:
            fams[fam.name] = fam
        if is_hist:
            fam.add_hist(labels, value, HIST_BUCKETS[key])
        else:
            fam.add(labels, value)
    return _render(list(fams.values()))


def render_fleet(model: Dict) -> str:
    """Render a fleet model (obs/fleet.py::aggregate): the fleet-wide
    merged metrics unlabeled, each worker's rate, wall and final flag
    labeled ``worker``, each shard's steals labeled ``shard``."""
    fams: Dict[str, _Family] = {}

    def fam(key_or_fam) -> _Family:
        f = key_or_fam if isinstance(key_or_fam, _Family) \
            else _family_for_key(key_or_fam)
        return fams.setdefault(f.name, f)

    for key in sorted(model.get("fleet", {})):
        value = model["fleet"][key]
        if key in HIST_BUCKETS and isinstance(value, dict):
            fam(key).add_hist([], value, HIST_BUCKETS[key])
        elif _numeric(value):
            fam(key).add([], value)

    n = _Family(PREFIX + "fleet_workers", "gauge",
                "racon_tpu fleet: worker shard count")
    fam(n).add([], model.get("n_workers", 0))
    s = _Family(PREFIX + "fleet_steals", "counter",
                "racon_tpu fleet: lease steals in events.jsonl")
    fam(s).add([], model.get("steals", 0))
    sp = _Family(PREFIX + "fleet_splits", "counter",
                 "racon_tpu fleet: dynamic shard splits in "
                 "events.jsonl")
    fam(sp).add([], model.get("splits", 0))

    per_worker = (
        ("windows_per_sec", "gauge",
         "racon_tpu worker: polished windows per wall second"),
        ("wall_s", "gauge", "racon_tpu worker: wall seconds at last "
                            "snapshot"),
        ("final", "gauge", "racon_tpu worker: 1 when the last snapshot "
                           "was a final (exit/SIGTERM) flush"),
    )
    for field, mtype, help_text in per_worker:
        f = fam(_Family(PREFIX + "worker_" + field, mtype, help_text))
        for wid in sorted(model.get("workers", {})):
            f.add([("worker", wid)],
                  model["workers"][wid].get(field, 0))

    timeline = model.get("timeline", {})
    if timeline:
        f = fam(_Family(PREFIX + "shard_steals", "counter",
                        "racon_tpu fleet: steals per ledger shard"))
        for name in sorted(timeline):
            f.add([("shard", name)],
                  sum(1 for e in timeline[name] if e["ev"] == "steal"))
    return _render(list(fams.values()))


# ---------------------------------------------------------- fleet health

#: A supervisor heartbeat older than this many of its own intervals
#: reads as a dead autoscaler (503 on /healthz).
SUPERVISOR_STALE_FACTOR = 5.0


def fleet_health(ledger_dir: str, base: Optional[Callable] = None,
                 stale_factor: float = SUPERVISOR_STALE_FACTOR) -> Dict:
    """The ``/healthz`` view of a ledger member: the process's own
    watchdog snapshot (``base``) with a ``"fleet"`` section — worker
    counts (from the supervisor's heartbeat when there is one, else from
    the metric shards' final flags), open shards and the heartbeat's
    age. The status turns ``"supervisor-dead"`` (503) when a heartbeat
    exists but is older than ``stale_factor`` of its own interval; a
    fleet that never ran a supervisor is not penalized."""
    import time as _time

    from racon_tpu_torch.obs import fleet as _fleet

    snap: Dict = dict(base()) if base is not None else {"status": "ok"}
    view: Dict = {}
    live = exited = 0
    for sh in _fleet.load_worker_shards(_fleet.obs_dir_for(ledger_dir)):
        if sh["records"][-1].get("final"):
            exited += 1
        else:
            live += 1
    view["workers_live"] = live
    view["workers_exited"] = exited
    try:
        from racon_tpu_torch.distributed.ledger import (LedgerError,
                                                        WorkLedger)
        try:
            led = WorkLedger.attach(ledger_dir)
            view["open_shards"] = len(led.pending_shards())
            view["merge_done"] = led.merge_done()
        except LedgerError:
            view["open_shards"] = None  # meta not yet published
    except Exception:  # pragma: no cover — the probe must never raise
        view["open_shards"] = None
    hb = _fleet.load_supervisor(ledger_dir)
    if hb is not None:
        age = max(0.0, _time.time() - float(hb.get("unix_time", 0.0)))
        interval = max(0.1, float(hb.get("interval_s", 1.0)))
        view["autoscaler"] = {
            "age_s": round(age, 3),
            "interval_s": interval,
            "target_workers": hb.get("target_workers"),
            "live_workers": hb.get("live_workers"),
            "done": bool(hb.get("done")),
        }
        for key in ("workers_live", "workers_evicted",
                    "workers_retired", "workers_done"):
            if key in hb:
                view[key] = hb[key]
        if age > stale_factor * interval and not hb.get("done") and \
                snap.get("status") == "ok":
            # Workers may still finish on their own, but nobody replaces
            # evictions any more: a liveness failure.
            snap["status"] = "supervisor-dead"
    snap["fleet"] = view
    return snap


# ------------------------------------------------------------ validation

def validate_openmetrics(text: str) -> List[str]:
    """Structural OpenMetrics check (the smoke/test gate — promtool is
    not in the image). Verifies: single trailing ``# EOF``; every
    sample parses as ``name[{labels}] value`` with a finite number;
    every sample's family has TYPE and HELP lines *before* it; counter
    samples end in ``_total``; histogram samples end in ``_bucket`` /
    ``_sum`` / ``_count`` and buckets carry an ``le`` label; families
    are not interleaved. Returns a list of problems (empty = valid)."""
    errors: List[str] = []
    lines = text.split("\n")
    if not text.endswith("\n"):
        errors.append("missing trailing newline")
    body = [ln for ln in lines if ln != ""]
    if not body or body[-1] != "# EOF":
        errors.append("missing '# EOF' terminator")
    if text.count("# EOF") != 1:
        errors.append("multiple '# EOF' terminators")
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    seen_families: List[str] = []
    for i, ln in enumerate(body):
        if ln == "# EOF":
            if i != len(body) - 1:
                errors.append("content after '# EOF'")
            break
        if ln.startswith("# TYPE ") or ln.startswith("# HELP "):
            parts = ln.split(" ", 3)
            if len(parts) < 4:
                errors.append(f"malformed meta line: {ln!r}")
                continue
            _, kw, fname, rest = parts
            table = types if kw == "TYPE" else helps
            if fname in table:
                errors.append(f"duplicate # {kw} for {fname}")
            table[fname] = rest
            if kw == "TYPE":
                if rest not in ("counter", "gauge", "histogram",
                                "summary", "info", "unknown"):
                    errors.append(f"bad type {rest!r} for {fname}")
                if seen_families and seen_families[-1] != fname:
                    seen_families.append(fname)
                elif not seen_families:
                    seen_families.append(fname)
            continue
        if ln.startswith("#"):
            errors.append(f"unexpected comment line: {ln!r}")
            continue
        # Sample: name[{labels}] value
        head, _, value = ln.rpartition(" ")
        if not head:
            errors.append(f"malformed sample line: {ln!r}")
            continue
        name = head.split("{", 1)[0]
        if "{" in head and not head.endswith("}"):
            errors.append(f"malformed labels in: {ln!r}")
        fam = name
        if fam not in types:
            # Family resolution: counters sample as <fam>_total,
            # histograms as <fam>_bucket/_sum/_count.
            for suf in ("_total", "_bucket", "_sum", "_count"):
                if name.endswith(suf) and name[:-len(suf)] in types:
                    fam = name[:-len(suf)]
                    break
        if fam not in types:
            errors.append(f"sample {name!r} has no # TYPE line")
            continue
        if fam not in helps:
            errors.append(f"sample {name!r} has no # HELP line")
        if types[fam] == "counter" and not name.endswith("_total"):
            errors.append(
                f"counter sample {name!r} lacks '_total' suffix")
        if types[fam] == "histogram":
            suffix = name[len(fam):]
            if suffix not in ("_bucket", "_sum", "_count"):
                errors.append(f"histogram sample {name!r} lacks "
                              f"'_bucket'/'_sum'/'_count' suffix")
            if suffix == "_bucket" and 'le="' not in head:
                errors.append(f"histogram bucket {name!r} lacks an "
                              f"'le' label")
        try:
            float(value)
        except ValueError:
            errors.append(f"non-numeric value {value!r} in: {ln!r}")
        if seen_families and seen_families[-1] != fam and \
                fam in seen_families:
            errors.append(f"family {fam!r} is interleaved")
    return errors


# ---------------------------------------------------------- pull endpoint

def serve_metrics(port: int, render: Callable[[], str],
                  host: str = "127.0.0.1", health=None, routes=None,
                  name: str = "racon-tpu-metrics"):
    """Start an OpenMetrics pull endpoint on ``host:port`` on a daemon
    thread (named ``name``), serving ``render()`` at every GET path;
    returns the server (``server_address`` holds the bound port;
    ``port=0`` picks one). An error in ``render`` is a 500, never the
    run's end.

    ``health``: a callable returning a dict with a ``"status"`` key; with
    it, ``GET /healthz`` serves the dict as JSON, 200 while the status
    is ``"ok"`` and 503 otherwise, so a plain HTTP probe can evict a
    wedged worker or a fleet whose supervisor died.

    ``routes``: a callable ``(method, path, body)`` answering the paths
    it serves with ``(code, body bytes, content type, headers)`` and
    the rest with None (a GET then gets the health or the metrics, a
    POST a 404); an exception it raises is a 500. The daemon's job API
    rides on it (server/daemon.serve_http)."""
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    def _json(code: int, obj) -> tuple:
        return (code, (json.dumps(obj, sort_keys=True) + "\n").encode(),
                "application/json", ())

    def _health() -> tuple:
        try:
            snap = health()
            return _json(200 if snap.get("status") == "ok" else 503, snap)
        except Exception as exc:  # the probe must not end the run
            return (500, f'{{"status": "error: {exc}"}}\n'.encode(),
                    "application/json", ())

    def _metrics() -> tuple:
        try:
            return 200, render().encode(), CONTENT_TYPE, ()
        except Exception as exc:  # a scrape must not end the run
            return (500, f"render error: {exc}\n".encode(), CONTENT_TYPE,
                    ())

    class Handler(BaseHTTPRequestHandler):
        def _route(self, method: str, body: bytes):
            if routes is None:
                return None
            try:
                return routes(method, self.path.rstrip("/"), body)
            except Exception as exc:  # a handler must not end the run
                return _json(500, {"error": str(exc)})

        def _send(self, reply: tuple) -> None:
            code, body, ctype, headers = reply
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib naming)
            reply = self._route("GET", b"")
            if reply is None:
                reply = _health() if self.path.rstrip("/") == \
                    "/healthz" and health is not None else _metrics()
            self._send(reply)

        def do_POST(self):  # noqa: N802 (stdlib naming)
            length = int(self.headers.get("Content-Length", "0"))
            reply = self._route("POST", self.rfile.read(length))
            self._send(reply or _json(404, {"error": "unknown endpoint"}))

        def log_message(self, *args):  # no per-request stderr
            pass

    server = ThreadingHTTPServer((host, int(port)), Handler)
    thread = threading.Thread(target=server.serve_forever, name=name,
                              daemon=True)
    thread.start()
    return server
