"""Whole jobs through ``racon_tpu_torch.cli.main`` in this process, and
what the check needs of the port's own state.

``Capture`` wraps ``Polisher.polish_records`` from the benchmark's side
(the port is not edited): each call keeps a reference to the polisher's
window list and target bookkeeping, which the polisher drops when it
finishes. When a job has ended, ``summarize`` keeps of them only what the
check reads (the sampled windows, each target's stitched windows), so a
window's jobs do not hold every job's reads alive.
"""

from __future__ import annotations

import contextlib
import io
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

_PHASE = re.compile(
    r"^\[racon_tpu_torch::Polisher::\w+\] ([a-z ]+?) ([0-9.]+) s$", re.M)


@dataclass
class PortState:
    """One polisher's windows and targets, as the port left them."""
    windows: list
    coverages: List[int]
    target_names: List[str]
    target_lengths: List[int]
    n_sequences: int


@dataclass
class JobRun:
    input_index: int
    rc: int
    fasta: bytes
    stderr: str
    t0: float
    t1: float
    port: List["PortSummary"] = field(default_factory=list)
    registry: Dict[str, float] = field(default_factory=dict)
    host_clock: Dict[str, float] = field(default_factory=dict)
    target_bases: int = 0
    n_windows: int = 0

    def phases(self) -> Dict[str, float]:
        """Seconds of each logger phase line of the job."""
        out: Dict[str, float] = {}
        for name, sec in _PHASE.findall(self.stderr):
            out[name] = out.get(name, 0.0) + float(sec)
        return out


class Capture:
    """While installed, every Polisher.polish_records call records the
    polisher's state into ``self.states``."""

    def __init__(self):
        self.states: List[PortState] = []
        self._orig = None

    def install(self) -> None:
        from racon_tpu_torch.models.polisher import Polisher
        orig = self._orig = Polisher.polish_records
        states = self.states

        def polish_records(polisher, *args, **kwargs):
            n_t = polisher._targets_size
            seqs = polisher.sequences
            states.append(PortState(
                polisher.windows, polisher.targets_coverages,
                [seqs[i].name for i in range(n_t)],
                [len(seqs[i].data) for i in range(n_t)], len(seqs)))
            return orig(polisher, *args, **kwargs)

        Polisher.polish_records = polish_records

    def uninstall(self) -> None:
        if self._orig is not None:
            from racon_tpu_torch.models.polisher import Polisher
            Polisher.polish_records = self._orig
            self._orig = None

    def take(self) -> List[PortState]:
        out = list(self.states)
        self.states.clear()
        return out


def _numbers(snapshot: dict) -> Dict[str, float]:
    return {k: float(v) for k, v in snapshot.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


@dataclass
class PortSummary:
    """What the check reads of one polisher's state."""
    target_names: List[str]
    target_lengths: List[int]
    n_sequences: int
    windows: Dict[int, Optional[tuple]]   # sampled window -> port_window
    stitched: Dict[str, tuple]


def summarize(state: PortState, sample: List[int]) -> PortSummary:
    return PortSummary(state.target_names, state.target_lengths,
                       state.n_sequences,
                       {g: port_window(state, g) for g in sample},
                       stitched(state))


def run_job(argv: List[str], input_index: int, capture: Capture,
            sample: List[int], host_clock=None) -> JobRun:
    """One job: ``cli.main(argv)`` with stdout and stderr captured, the
    change in the port's metrics registry over it, the host clock's parts
    when one is running, and the port's state summarized for the
    windows ``sample``."""
    from racon_tpu_torch import cli
    from racon_tpu_torch.obs.metrics import registry
    before = _numbers(registry().snapshot())
    hc_before = dict(host_clock.s) if host_clock is not None else {}
    out_b = io.BytesIO()
    out_t = io.TextIOWrapper(out_b, encoding="utf-8")
    err_t = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out_t), contextlib.redirect_stderr(err_t):
        try:
            rc = cli.main(argv)
        except SystemExit as exc:       # argparse and fatal exits
            rc = exc.code if isinstance(exc.code, int) else 1
        out_t.flush()
    t1 = time.perf_counter()
    after = _numbers(registry().snapshot())
    run = JobRun(input_index, int(rc or 0), out_b.getvalue(),
                 err_t.getvalue(), t0, t1,
                 [summarize(st, sample) for st in capture.take()])
    run.registry = {k: v - before.get(k, 0.0) for k, v in after.items()}
    if host_clock is not None:
        run.host_clock = {k: v - hc_before.get(k, 0.0)
                          for k, v in host_clock.s.items()}
    return run


def run_window(run_one: Callable[[int, int], JobRun], n_inputs: int,
               seconds: float, clock=time.perf_counter) -> List[JobRun]:
    """Whole cycles of the ``n_inputs`` distinct jobs back to back:
    ``run_one(i, k)`` runs job i of the window on input k. No cycle
    starts once ``seconds`` have passed; the window then ends with the
    last cycle's last job, so every distinct job weighs the same in the
    window's rate and accuracy, whatever its cost."""
    runs: List[JobRun] = []
    w0 = clock()
    while not runs or clock() - w0 < seconds:
        for k in range(n_inputs):
            runs.append(run_one(len(runs), k))
    return runs


def kbp_per_s(runs: List[JobRun]) -> float:
    """Target bases of the jobs that completed, over the window from the
    first job's start to the last job's end."""
    bases = sum(r.target_bases for r in runs if r.rc == 0)
    return bases / 1e3 / (runs[-1].t1 - runs[0].t0)


def fasta_records(blob: bytes) -> List[tuple]:
    """(header, data) of every record of a FASTA blob (one line each)."""
    lines = blob.split(b"\n")
    return [(lines[i][1:].decode(), lines[i + 1])
            for i in range(0, len(lines) - 1, 2) if lines[i].startswith(b">")]


def sample_windows(rng, n_windows: int, target_windows: List[int],
                   sample: dict) -> List[int]:
    """Global window indices to compare, drawn from ``rng``: ``clusters``
    runs of ``windows`` consecutive windows inside one target, or every
    window of ``targets`` whole targets."""
    first = [0]
    for n in target_windows:
        first.append(first[-1] + n)
    out: List[int] = []
    if "targets" in sample:
        pick = rng.choice(len(target_windows),
                          size=min(int(sample["targets"]),
                                   len(target_windows)), replace=False)
        for t in sorted(int(x) for x in pick):
            out.extend(range(first[t], first[t + 1]))
        return out
    k = int(sample["windows"])
    for _ in range(int(sample["clusters"])):
        t = int(rng.choice(len(target_windows),
                           p=[n / n_windows for n in target_windows]))
        start = int(rng.integers(0, max(target_windows[t] - k, 0) + 1))
        out.extend(range(first[t] + start,
                         first[t] + min(start + k, target_windows[t])))
    return sorted(set(out))


def port_window(state: PortState, g: int) -> Optional[tuple]:
    """(backbone, layers, consensus, polished) of the port's window g."""
    if g >= len(state.windows):
        return None
    w = state.windows[g]
    layers = [(int(b), int(e), bytes(d), bytes(q) if q is not None else None)
              for b, e, d, q in zip(w.layer_begin, w.layer_end, w.layer_data,
                                    w.layer_quality)]
    return (bytes(w.backbone), layers, w.consensus or b"", bool(w.polished))


def stitched(state: PortState) -> Dict[str, tuple]:
    """Per target name: (data joined from the port's windows, polished
    ratio), in the polisher's own window order."""
    out: Dict[str, tuple] = {}
    parts: Dict[int, list] = {}
    polished: Dict[int, int] = {}
    ranks: Dict[int, int] = {}
    for w in state.windows:
        parts.setdefault(w.id, []).append(w.consensus or b"")
        polished[w.id] = polished.get(w.id, 0) + (1 if w.polished else 0)
        ranks[w.id] = w.rank + 1
    for tid, chunks in parts.items():
        out[state.target_names[tid]] = (b"".join(chunks),
                                        polished[tid] / ranks[tid])
    return out
