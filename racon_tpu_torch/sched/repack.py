"""Host-side survivor repacking between scheduler rounds — port of the
JAX package's ``sched/repack.py``.

After a detecting round the scheduler knows, from the conv/ovf flags it
pulls for control flow anyway, which windows froze. A RepackPlan lays the
survivors out on fresh dense axes — windows renumbered 0..n_surv-1
(padded to the 32 grid, like ChunkPlan), lanes compacted onto the coarse
batch buckets ChunkPlan uses — and gives the index vectors sched_repack
(sched/rounds.py) gathers with on the device. Only these small vectors
cross to the card; anchors, spans and queries stay there.

Lanes keep their ascending order (``np.flatnonzero``), so each window's
jobs stay in job order and the merge kernels' per-window sums add the
same values in the same order after a repack as before it.
"""

from __future__ import annotations

import numpy as np

from racon_tpu_torch.ops.budget import round_up
from racon_tpu_torch.ops.device_poa import _bucket_b


class RepackPlan:
    """Index plan mapping current chunk axes onto dense survivor axes.

    Parameters
    ----------
    surv : bool[n_win_cur] — survivor mask on the current window rows
        (False for frozen, flagged and padded rows).
    win : int32[B_cur] — current per-lane window ids (padded lanes hold
        the current dummy id ``n_win_cur``).
    orig_ids : int32[n_win_cur] — current rows' original output rows.
    trash : int — the output accumulators' trash row (original n_win).
    n_shards : int — the new lane axis pads to a multiple of
        ``128 * n_shards``.

    Attributes (numpy)
    ----------
    n_surv, n_win, B : new real-window / padded-window / lane counts.
    win_map : int32[n_win + 1] — old window row per new row; padded rows
        and the new dummy row point at the old dummy row.
    win_real : bool[n_win] — which new rows carry a survivor.
    orig_ids : int32[n_win] — new rows' original output rows (padded rows
        -> ``trash``).
    lane_idx : int32[B] — old lane per new lane (padded -> 0; the gather's
        fill masks re-dummy those lanes).
    new_win : int32[B] — new window id per new lane (padded -> the new
        dummy ``n_win``); becomes the next dispatch's ``win`` array.
    """

    def __init__(self, surv: np.ndarray, win: np.ndarray,
                 orig_ids: np.ndarray, trash: int, n_shards: int = 1):
        surv = np.asarray(surv, bool)
        win = np.asarray(win, np.int64)
        n_win_cur = surv.shape[0]

        rows = np.flatnonzero(surv)             # ascending: order stable
        self.n_surv = int(rows.size)
        self.n_win = round_up(self.n_surv, 32)

        self.win_map = np.full(self.n_win + 1, n_win_cur, np.int32)
        self.win_map[:self.n_surv] = rows
        self.win_real = np.zeros(self.n_win, bool)
        self.win_real[:self.n_surv] = True
        self.orig_ids = np.full(self.n_win, trash, np.int32)
        self.orig_ids[:self.n_surv] = np.asarray(orig_ids, np.int32)[rows]

        old2new = np.full(n_win_cur + 1, self.n_win, np.int64)
        old2new[rows] = np.arange(self.n_surv)

        keep = (win < n_win_cur) & surv[np.minimum(win, n_win_cur - 1)]
        lanes = np.flatnonzero(keep)
        self.n_lanes = int(lanes.size)
        self.B = round_up(_bucket_b(max(self.n_lanes, 1)), 128 * n_shards)
        self.lane_idx = np.zeros(self.B, np.int32)
        self.lane_idx[:self.n_lanes] = lanes
        self.new_win = np.full(self.B, self.n_win, np.int32)
        self.new_win[:self.n_lanes] = old2new[win[lanes]]
