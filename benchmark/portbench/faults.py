"""Faults planted in the timed path, from the benchmark's side, to show
that the comparison which decides ``correct`` catches them.

Each fault patches the port where the thing it breaks is produced and
names the check that has to catch it:

- ``state_unchanged``: the consensus returns its state unchanged (every
  window keeps its backbone);
- ``half_batch``: half of each window's layers left out of the batch;
- ``base_altered``: a polished base altered where it is produced;
- ``breaking_point_altered``: a breaking point altered where it is
  produced (the host's overlap path: the CPU rehearsal's route).

One card: no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

Patch = Callable[[object, str, object], None]


def _state_unchanged(patch: Patch) -> str:
    from racon_tpu_torch.ops.poa import PoaEngine

    def consensus_windows(self, windows):
        for w in windows:
            w.set_backbone_consensus()
        return 0
    patch(PoaEngine, "consensus_windows", consensus_windows)
    return "consensus_mismatch_pct"


def _half_batch(patch: Patch) -> str:
    from racon_tpu_torch.ops.poa import PoaEngine
    orig = PoaEngine.consensus_windows

    def consensus_windows(self, windows):
        for w in windows:
            for name in ("layer_data", "layer_quality", "layer_begin",
                         "layer_end"):
                setattr(w, name, getattr(w, name)[::2])
        return orig(self, windows)
    patch(PoaEngine, "consensus_windows", consensus_windows)
    return "layers_mismatch"


def _base_altered(patch: Patch) -> str:
    from racon_tpu_torch.models.window import Window
    orig = Window.apply_consensus

    def apply_consensus(self, consensus, coverage, log=None):
        orig(self, consensus, coverage)
        flip = {65: b"C", 67: b"G", 71: b"T", 84: b"A"}
        mid = len(self.consensus) // 2
        self.consensus = (self.consensus[:mid] +
                          flip.get(self.consensus[mid], b"A") +
                          self.consensus[mid + 1:])
    patch(Window, "apply_consensus", apply_consensus)
    return "consensus_mismatch_pct"


def _breaking_point_altered(patch: Patch) -> str:
    from racon_tpu_torch.models.overlap import Overlap
    orig = Overlap.find_breaking_points

    def find_breaking_points(self, sequences, window_length, aligner=None):
        orig(self, sequences, window_length, aligner)
        bp = self.breaking_points
        if bp is not None and len(bp):
            bp[:, 1] = bp[:, 1] + (bp[:, 3] - bp[:, 1] > 20)
    patch(Overlap, "find_breaking_points", find_breaking_points)
    return "layers_mismatch"


FAULTS: Dict[str, Callable[[Patch], str]] = {
    "state_unchanged": _state_unchanged, "half_batch": _half_batch,
    "base_altered": _base_altered,
    "breaking_point_altered": _breaking_point_altered}


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` in place for the block; yields the check that
    has to catch it."""
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)
    try:
        yield FAULTS[name](patch)
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
