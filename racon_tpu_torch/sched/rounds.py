"""Device programs of the convergence scheduler — port of the JAX
package's ``sched/rounds.py``.

- :func:`sched_unpack` — a chunk's packed byte buffers -> round state,
  fresh output accumulators (indexed by original window row for the
  chunk's whole life, with a trash row) and the window membership;
- :func:`sched_rounds` — one dispatch of 1..k rounds, detecting fixed
  points on the last of them, whose merge runs M2 in its sched mode
  (kernels.merge_windows_sched): every window that freezes writes its
  final-scale output into the accumulators;
- :func:`sched_repack` — the gathers that compact the survivors' state
  onto the dense axes a host RepackPlan laid out;
- :func:`sched_pack` — the accumulators in the fixed engine's d2h layout.

Why a frozen window's output is the fixed engine's (the reference's
argument, which the port keeps):

1. All non-final rounds share one insertion scale (the engine's schedule
   is [base]*(R-1) + [final]) and from round 1 on the anchors carry zero
   weights, so a round that reproduced its own input state (anchor bytes,
   length and every lane span: device_merge.converged_windows) is
   replayed unchanged by every later non-final round.
2. The final round differs only in the assembly's scale: its sums are the
   detecting round's, and assembling them at the final scale (the dual
   assembly of M2's sched mode) is the fixed engine's final output.
3. Replay rounds share the narrowed band width (round_band_width), so
   the escape-bound flags replay too.

The reference's caveat about repacking — a different batch may
reassociate its fractional sums — does not apply here: M1 adds each
window's jobs in job order, and a repack keeps the lanes' order, so the
sums of a repacked window are bit for bit those it would have had.
"""

from __future__ import annotations

from typing import Tuple

import torch

from racon_tpu_torch.ops import device_merge as dm
from racon_tpu_torch.ops.device_poa import (_pack_body, _round_core, _stage,
                                            _unpack_bufs)


def sched_unpack(job_buf, win_buf, *, Lq: int, LA: int, n_win: int):
    """A chunk's packed byte buffers -> (bb, bbw, alen, begin, end, q, qw8,
    lq, w_read, win, ovf, out, members): the round state, the output
    accumulators ``out`` = (codes u8 [n_win+1, LA] zeros, cov i32 zeros,
    total i32 [n_win+1] ones, ovf bool [n_win+1] zeros), row n_win the
    trash row, and the chunk's window membership (on the merge stage's
    clock)."""
    (q, qw8, begin, end, lq, win, w_read, bb, bbw, alen) = \
        _unpack_bufs(job_buf, win_buf, Lq, LA)
    dev = q.device
    ovf = torch.zeros(n_win, dtype=torch.bool, device=dev)
    out = (torch.zeros((n_win + 1, LA), dtype=torch.uint8, device=dev),
           torch.zeros((n_win + 1, LA), dtype=torch.int32, device=dev),
           torch.ones(n_win + 1, dtype=torch.int32, device=dev),
           torch.zeros(n_win + 1, dtype=torch.bool, device=dev))
    with _stage("merge", dev):
        members = dm.window_members(win, n_win)
    return (bb, bbw, alen, begin, end, q, qw8, lq, w_read, win, ovf, out,
            members)


def sched_rounds(bb, bbw, alen, begin, end, q, qw8, lq, w_read, win, ovf,
                 out, orig_ids, last: bool, members, *, match: int,
                 mismatch: int, gap: int, scale: float, scale_final: float,
                 Lq: int, n_win: int, LA: int, band_ws: Tuple[int, ...],
                 detect: bool, adaptive: bool = False, nxt_k: int = 2):
    """Run ``len(band_ws)`` rounds, detect on the last of them, and write
    the frozen windows' final-scale outputs into ``out`` (in place).

    ``orig_ids`` i32 [n_win] maps the current window rows to accumulator
    rows (padding rows after a repack -> the trash row). ``last`` (a plain
    bool) freezes every window: the schedule's last round. A window
    freezes when it converged, is flagged (its sticky flag cannot clear),
    or the schedule ended.

    ``adaptive`` (the scheduler's fused tail: uniform band widths,
    detection off, ``last``): the non-final rounds run with detection
    while some window is neither converged nor flagged (one flag test a
    round on the host, as the fixed engine's adaptive exit), then the
    final round once. Returns (bb, bbw, alen, begin, end, ovf, conv, out,
    rounds_run)."""
    kw = dict(match=match, mismatch=mismatch, gap=gap, ins_scale=scale,
              Lq=Lq, n_win=n_win, LA=LA, nxt_k=nxt_k)
    freeze = (orig_ids, out, scale_final, bool(last))
    conv = torch.zeros(n_win, dtype=torch.bool, device=q.device)

    def run(bw, det, frz=None):
        nonlocal bb, bbw, alen, begin, end, ovf, conv
        bb, bbw, alen, begin, end, _, ovf, conv = _round_core(
            bb, bbw, alen, begin, end, q, qw8, lq, w_read, win, ovf, members,
            band_w=bw, detect=det, freeze=frz, **kw)

    if adaptive and len(band_ws) >= 2:
        if len(set(band_ws)) != 1 or detect:
            raise ValueError(
                "[racon_tpu_torch::sched_rounds] the adaptive tail needs "
                "uniform band widths and detection off")
        k = 0
        while k < len(band_ws) - 1 and \
                not bool(torch.all(conv | ovf).item()):
            run(band_ws[0], True)
            k += 1
        run(band_ws[-1], False, freeze)
        rounds_run = k + 1
    else:
        for i, bw in enumerate(band_ws):
            fin = i == len(band_ws) - 1
            run(bw, detect and fin, freeze if fin else None)
        rounds_run = len(band_ws)
    return bb, bbw, alen, begin, end, ovf, conv, out, rounds_run


def sched_repack(bb, bbw, alen, begin, end, q, qw8, lq, w_read, ovf,
                 lane_idx, new_win, win_map, win_real):
    """Gather the survivors' state onto new dense lane/window axes (index
    vectors of a host RepackPlan on the device: ``lane_idx`` i32 [B'],
    ``new_win`` i32 [B'], ``win_map`` i32 [n_win'+1], ``win_real`` bool
    [n_win']), on the repack stage's clock; padded lanes are re-dummied
    (lq=1, begin=0, end=1, w_read=0) as ChunkPlan pads. The new chunk's
    window membership is built on the merge stage's clock. Returns (bb,
    bbw, alen, begin, end, q, qw8, lq, w_read, ovf, members)."""
    dev = bb.device
    n_win = win_map.shape[0] - 1
    with _stage("repack", dev):
        pad = new_win == n_win
        li = lane_idx.long()

        def glane(a, fill=None):
            got = a.index_select(0, li)
            return got if fill is None else torch.where(pad, fill, got)

        wm = win_map.long()
        nbb = bb.index_select(0, wm)
        nalen = alen.index_select(0, wm)
        # Anchor weights are zero from round 1 on and a repack follows
        # round 1 at the earliest.
        nbbw = torch.zeros(nbb.shape, dtype=torch.float32, device=dev)
        novf = win_real & ovf.index_select(
            0, torch.clamp(wm[:-1], 0, ovf.shape[0] - 1))
        state = (nbb, nbbw, nalen, glane(begin, 0), glane(end, 1), glane(q),
                 glane(qw8), glane(lq, 1), glane(w_read, 0.0), novf)
    with _stage("merge", dev):
        members = dm.window_members(new_win, n_win)
    return state + (members,)


def sched_pack(out, rounds_exec: int, rounds_sched: int):
    """The accumulators (trash row dropped) in the fixed engine's d2h
    layout (device_poa._pack_body), so collect_chunk reads them."""
    codes, cov, total, ovf = out
    return _pack_body(codes[:-1], cov[:-1], total[:-1], ovf[:-1],
                      rounds_exec, rounds_sched)
