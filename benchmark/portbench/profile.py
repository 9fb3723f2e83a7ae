"""What the traced run records, and its reduction to numbers.

Three sources, all from the benchmark's side:

- ``torch.profiler`` (CPU and CUDA activities) over the whole window:
  every device operation's interval, by name;
- the port's own tracer, through the CLI's ``--trace`` (one file a job):
  the ``phase``, ``chunk`` and ``dispatch`` spans that label the device's
  idle gaps;
- the arguments of the launches the kernel counts (``counts/``) name, by
  wrapping those launch functions of ``racon_tpu_torch.ops.kernels``
  (``LaunchLog``), for the kernels' operation and byte counts.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

# Span kinds that label an idle gap, innermost first.
GAP_KINDS = ("dispatch", "chunk", "phase")
# An int32 tensor argument up to this many elements is kept by value
# (per-lane lengths, band origins); larger ones by shape only.
KEEP_VALUES = 1 << 16


def _arg(a):
    import torch
    if isinstance(a, torch.Tensor):
        keep = a.dtype == torch.int32 and a.numel() <= KEEP_VALUES
        return {"shape": list(a.shape),
                "values": a.detach().clone() if keep else None}
    if isinstance(a, (bool, int, float, str)) or a is None:
        return a
    # Anything else (the output planes a tile writes into) is named, not
    # kept: a reference would hold its memory past the launch.
    return type(a).__name__


class LaunchLog:
    """Records the arguments of every launch of the functions of
    ``racon_tpu_torch.ops.kernels`` that the kernel counts name
    (``counts/<kernel>.py``: ``LAUNCH``): tensors by shape, small int32
    ones by value as a device copy read after the window."""

    def __init__(self, counts: Dict[str, object]):
        self.counts = counts
        self.launches: Dict[str, List[dict]] = {k: [] for k in counts}
        self._orig: Dict[str, object] = {}

    def install(self) -> None:
        from racon_tpu_torch.ops import kernels
        for key, mod in self.counts.items():
            orig = getattr(kernels, mod.LAUNCH)
            self._orig[key] = orig
            setattr(kernels, mod.LAUNCH, self._wrap(key, orig))

    def _wrap(self, key, orig):
        log = self.launches[key]

        def launch(*args, **kwargs):
            log.append({"args": [_arg(a) for a in args],
                        "kwargs": {k: _arg(v) for k, v in kwargs.items()}})
            return orig(*args, **kwargs)

        return launch

    def uninstall(self) -> None:
        from racon_tpu_torch.ops import kernels
        for key, orig in self._orig.items():
            setattr(kernels, self.counts[key].LAUNCH, orig)
        self._orig.clear()

    def host(self) -> Dict[str, List[dict]]:
        """The launches with the kept tensors as host lists."""
        def host_arg(a):
            if isinstance(a, dict) and a.get("values") is not None:
                return dict(a, values=a["values"].cpu().tolist())
            return a

        return {key: [{"args": [host_arg(a) for a in r["args"]],
                       "kwargs": {k: host_arg(v)
                                  for k, v in r["kwargs"].items()}}
                      for r in recs]
                for key, recs in self.launches.items()}


@dataclass
class DeviceTrace:
    """The device's operations inside the window, in seconds from the
    window's start."""
    window_s: float
    ops: List[Tuple[str, float, float]] = field(default_factory=list)

    def busy_s(self) -> float:
        return sum(e - s for s, e in merge_intervals(
            [(s, e) for _n, s, e in self.ops]))

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.ops:
            out[name] = out.get(name, 0.0) + (e - s)
        return out

    def kernel_seconds(self, symbol: str) -> float:
        return sum(e - s for name, s, e in self.ops if symbol in name)

    def gaps(self) -> List[Tuple[float, float]]:
        return idle_gaps([(s, e) for _n, s, e in self.ops], self.window_s)


def merge_intervals(iv: List[Tuple[float, float]]) -> List[Tuple[float,
                                                                  float]]:
    out: List[List[float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_gaps(iv: List[Tuple[float, float]], window_s: float
              ) -> List[Tuple[float, float]]:
    """The intervals of [0, window_s] in which no device operation ran."""
    gaps, t = [], 0.0
    for s, e in merge_intervals(iv):
        if s > t:
            gaps.append((t, min(s, window_s)))
        t = max(t, e)
    if t < window_s:
        gaps.append((t, window_s))
    return [(s, e) for s, e in gaps if e > s]


def device_trace(prof, marker: str, w0: float, w1: float) -> DeviceTrace:
    """The profiler's device operations between ``w0`` and ``w1``
    (perf_counter seconds), aligned by the CPU event ``marker`` that
    opened at ``w0``."""
    events = prof.profiler.kineto_results.events()
    start = None
    for ev in events:
        if ev.name() == marker:
            start = ev.start_ns()
            break
    if start is None:
        raise RuntimeError(f"profiler trace has no {marker!r} event")
    window = w1 - w0
    out = DeviceTrace(window)
    for ev in events:
        if str(ev.device_type()).rsplit(".", 1)[-1] != "CUDA" or \
                ev.name() == marker:
            continue
        s = (ev.start_ns() - start) / 1e9
        e = s + ev.duration_ns() / 1e9
        s, e = max(s, 0.0), min(e, window)
        if e > s:
            out.ops.append((ev.name(), s, e))
    return out


def read_spans(path: str, t0_perf: float, w0: float) -> List[dict]:
    """The port tracer's spans of one job, with start and end in seconds
    from the window's start (``t0_perf``: the tracer's own origin)."""
    spans = []
    try:
        with open(path) as fh:
            lines = fh.read().splitlines()
    except OSError:
        return spans
    for line in lines:
        rec = json.loads(line)
        if rec.get("ev") != "span" or rec.get("kind") not in GAP_KINDS:
            continue
        s = t0_perf + rec["t0"] - w0
        spans.append({"kind": rec["kind"], "name": rec["name"], "s": s,
                      "e": s + rec["dur_s"]})
    return spans


def labels(spans: List[dict], times: np.ndarray) -> List[str]:
    """For each time, the innermost open span (dispatch, then chunk,
    then phase), or "no port span" where none was open (between
    jobs, or a part of a job no span covers)."""
    out = ["no port span"] * len(times)
    done = np.zeros(len(times), bool)
    for kind in GAP_KINDS:
        own = sorted((sp for sp in spans if sp["kind"] == kind),
                     key=lambda sp: sp["s"])
        if not own:
            continue
        starts = np.array([sp["s"] for sp in own])
        ends = np.array([sp["e"] for sp in own])
        idx = np.searchsorted(starts, times, side="right") - 1
        hit = (idx >= 0) & ~done
        hit[hit] &= ends[idx[hit]] > times[hit]
        for k in np.flatnonzero(hit):
            out[k] = f"{kind}:{own[idx[k]]['name']}"
        done |= hit
    return out


def breakdown(trace: DeviceTrace, spans: List[dict], top: int = 10) -> dict:
    """The device operations that took most time, and the idle time
    summed by what the port was doing in each gap."""
    ops = sorted(trace.by_name().items(), key=lambda kv: -kv[1])[:top]
    gaps = trace.gaps()
    mids = np.array([0.5 * (s + e) for s, e in gaps])
    by_label: Dict[str, float] = {}
    for (s, e), name in zip(gaps, labels(spans, mids)):
        by_label[name] = by_label.get(name, 0.0) + (e - s)
    idle = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], v] for n, v in ops],
            "idle_gaps": [[n[:160], v] for n, v in idle]}
