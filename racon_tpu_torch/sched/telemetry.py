"""Round telemetry for the convergence scheduler — port of the JAX
package's ``sched/telemetry.py``.

Counters only: every value comes from flags the scheduler already pulls
to the host for control flow, so recording costs no extra device sync.
``as_extras`` and ``summary`` format the counters themselves, under the
reference's ``sched_*`` keys and in its stderr line's format.
"""

from __future__ import annotations

from typing import Dict, List


class SchedTelemetry:
    """Per-run convergence counters.

    ``rounds`` is the engine's total round count R (refine_rounds + 1). A
    window's ``rounds_used`` is the number of rounds it executed before
    freezing: R means it never converged early; smaller values are the
    scheduler's saving. Flagged (redo) windows freeze early too and count
    at their freeze round.
    """

    def __init__(self, rounds: int):
        self.rounds = int(rounds)
        self.windows = 0                  # real windows entering the sched
        self.chunks = 0
        # rounds_used -> windows frozen after exactly that many rounds
        self.hist: Dict[int, int] = {}
        # windows that executed round r (r -> count)
        self._alive: Dict[int, int] = {}
        self.repack_s = 0.0               # host planning + index h2d
        self.dispatches_saved = 0         # round-dispatches early-exited

    # ------------------------------------------------------------ recording

    def record_chunk(self, n_windows: int) -> None:
        self.chunks += 1
        self.windows += int(n_windows)

    def record_round(self, r: int, n_alive: int) -> None:
        """``n_alive`` windows executed refinement round ``r``."""
        self._alive[int(r)] = self._alive.get(int(r), 0) + int(n_alive)

    def record_freeze(self, rounds_used: int, n_windows: int) -> None:
        if n_windows:
            k = int(rounds_used)
            self.hist[k] = self.hist.get(k, 0) + int(n_windows)

    def record_repack(self, seconds: float) -> None:
        self.repack_s += float(seconds)

    def record_skip(self, n_dispatches: int) -> None:
        """A chunk fully converged with ``n_dispatches`` rounds unrun."""
        self.dispatches_saved += int(n_dispatches)

    # ------------------------------------------------------------- reporting

    def survivor_frac(self) -> List[float]:
        """Fraction of windows that executed round r, for r in 0..R-1."""
        if not self.windows:
            return [0.0] * self.rounds
        return [self._alive.get(r, 0) / self.windows
                for r in range(self.rounds)]

    def window_rounds(self) -> int:
        """Window-rounds executed (of ``windows * rounds`` scheduled)."""
        return sum(self._alive.get(r, 0) for r in range(self.rounds))

    def rounds_saved_frac(self) -> float:
        """Fraction of total window-rounds the scheduler skipped."""
        if not self.windows:
            return 0.0
        return 1.0 - self.window_rounds() / (self.windows * self.rounds)

    def as_extras(self) -> Dict[str, object]:
        """JSON-serializable counters (the reference's sched_* keys)."""
        return {
            "sched_rounds": self.rounds,
            "sched_windows": self.windows,
            "sched_chunks": self.chunks,
            "sched_rounds_hist": {str(k): v
                                  for k, v in sorted(self.hist.items())},
            "sched_survivor_frac": [round(f, 4)
                                    for f in self.survivor_frac()],
            "sched_rounds_saved_frac": round(self.rounds_saved_frac(), 4),
            "sched_repack_overhead_s": round(self.repack_s, 4),
            "sched_dispatches_saved": self.dispatches_saved,
        }

    def summary(self) -> str:
        """One line for the polisher's stderr log."""
        ex = self.as_extras()
        hist_s = " ".join(f"r{k}:{v}" for k, v in sorted(
            ex["sched_rounds_hist"].items(), key=lambda kv: int(kv[0])))
        return (f"windows={self.windows} chunks={self.chunks} "
                f"frozen[{hist_s}] "
                f"rounds_saved={ex['sched_rounds_saved_frac']:.0%} "
                f"repack={ex['sched_repack_overhead_s']:.3f}s")
