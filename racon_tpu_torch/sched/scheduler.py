"""Chunk loop for convergence-aware refinement — port of the JAX
package's ``sched/scheduler.py``.

ConvergenceScheduler.run_chunk replaces the fixed engine's all-rounds
chunk (device_poa.device_chunk_packed) with a short chain:

    sched_unpack ─ sched_rounds(rounds 0..1, detect) ─┐
      ┌───────────────────────────────────────────────┘
      │ while windows survive, from round 2:
      │   d2h: conv + ovf flags (the one flag pull a step)
      │   host: RepackPlan ─ h2d: index vectors (a few KB)
      │   sched_repack ─ sched_rounds(one round, detect, last?)
      │   or, when the survivors land in no smaller bucket, a fused tail
      │   of every remaining round on the current layout
      └─ early exit when every window froze
    sched_pack ─ collect_chunk (the fixed engine's d2h layout)

Rounds 0 and 1 run back to back because detection cannot fire before
round 1 (device_merge.converged_windows). A frozen window's output is the
final-scale dual assembly of its detecting round's sums, which M2's sched
mode writes into the chunk's accumulators (sched/rounds.py gives the
argument). Flagged windows freeze at once: their sticky flag already
sends them to the redo, so further rounds are wasted work.

The reference's retry sites, and only those: ``h2d/chunk`` (put_chunk,
through device_poa.put_chunk_bufs), ``sched/flags`` (the flag pull, which
waits for the rounds launched before it), ``h2d/repack`` (the repack's
index vectors) and ``d2h/chunk`` (collect_chunk). The round launches run
on the caller's thread, outside any envelope: the scheduler's rounds
write the chunk's accumulators, so they could not be retried whole, and
the reference has no ``dispatch/chunk`` site here either. Each dispatch
is traced as a ``round`` span, each repack as a ``dispatch`` span.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from racon_tpu_torch.obs.trace import get_tracer
from racon_tpu_torch.ops.budget import round_up, transfer_deadline_s
from racon_tpu_torch.ops.device_poa import (ChunkBufs, _bucket_b,
                                            chunk_statics, collect_chunk,
                                            host_part, put_chunk_bufs,
                                            round_band_width)
from racon_tpu_torch.pipeline.metrics import record_flag_pull, record_h2d
from racon_tpu_torch.resilience.retry import call as retry_call
from racon_tpu_torch.sched.repack import RepackPlan
from racon_tpu_torch.sched.rounds import (sched_pack, sched_repack,
                                          sched_rounds, sched_unpack)
from racon_tpu_torch.sched.telemetry import SchedTelemetry
from racon_tpu_torch.utils import env


class ConvergenceScheduler:
    """Runs ChunkPlans to consensus on ``device`` with per-window early
    exit.

    ``scales`` is PoaEngine's per-round insertion-scale schedule: every
    non-final entry must be equal — the dual assembly's argument needs
    every replayable round to share one scale. The engine's [base]*(R-1)
    + [final] schedule satisfies it; a schedule that does not is refused
    here.
    """

    def __init__(self, *, match: int, mismatch: int, gap: int,
                 scales: Sequence[float], device="cuda",
                 telemetry: Optional[SchedTelemetry] = None):
        self.match, self.mismatch, self.gap = match, mismatch, gap
        scales = tuple(float(s) for s in scales)
        if not scales:
            raise ValueError("[racon_tpu_torch::ConvergenceScheduler] empty "
                             "scale schedule")
        if len(set(scales[:-1])) > 1:
            raise ValueError(
                "[racon_tpu_torch::ConvergenceScheduler] non-final insertion "
                f"scales must be uniform, got {scales} — convergence "
                "freezing replays rounds and cannot honor a per-round "
                "varying scale (use RACON_TPU_SCHED=0)")
        self.scales = scales
        self.rounds = len(scales)
        self.scale = scales[0] if len(scales) > 1 else scales[-1]
        self.scale_final = scales[-1]
        self.device = torch.device(device)
        self.telemetry = telemetry if telemetry is not None \
            else SchedTelemetry(self.rounds)

    def put_chunk(self, plan) -> ChunkBufs:
        """Start the h2d of a chunk's packed buffers (put_chunk_bufs): call
        it for chunk i+1 before running chunk i's rounds, so that the copy
        overlaps them."""
        return put_chunk_bufs(plan, self.device)

    def run_chunk(self, plan, bufs: Optional[ChunkBufs] = None,
                  stats: Optional[dict] = None
                  ) -> Tuple[List[Optional[bytes]],
                             List[Optional[np.ndarray]]]:
        """Polish one ChunkPlan; returns collect_chunk's (codes, covs).
        ``bufs``: a put_chunk result (None ships the buffers here)."""
        R = self.rounds
        telem = self.telemetry
        dev = self.device
        tracer = get_tracer()
        # The band width and walk depth of every dispatch of the chunk,
        # the depth picked once at the plan's B and round-0 band.
        st = chunk_statics(plan, ins_scale=self.scales, rounds=R)
        band_w = st["band_w"]
        statics = dict(match=self.match, mismatch=self.mismatch,
                       gap=self.gap, scale=self.scale,
                       scale_final=self.scale_final, Lq=plan.Lq, LA=plan.LA,
                       nxt_k=st["nxt_k"])
        if bufs is None:
            bufs = self.put_chunk(plan)
        with host_part("rounds"):
            (bb, bbw, alen, begin, end, q, qw8, lq, w_read, win, ovf, out,
             members) = sched_unpack(*bufs.tensors(), Lq=plan.Lq, LA=plan.LA,
                                     n_win=plan.n_win)
            cur_orig = np.arange(plan.n_win, dtype=np.int32)
            orig_ids = torch.from_numpy(cur_orig).to(dev)

        n_real = plan.n_real_win
        telem.record_chunk(n_real)
        trash = plan.n_win
        real = np.zeros(plan.n_win, bool)
        real[:n_real] = True
        cur_win_h = plan.win          # host copy of the lane -> window map

        # Rounds 0..pre-1 back to back, detection on the last of them.
        pre = min(2, R)
        for r in range(pre):
            telem.record_round(r, n_real)
        with host_part("rounds"), tracer.span(
                "round", f"rounds0-{pre - 1}", lanes=plan.B,
                windows=n_real):
            (bb, bbw, alen, begin, end, ovf, conv, out, ran) = sched_rounds(
                bb, bbw, alen, begin, end, q, qw8, lq, w_read, win, ovf, out,
                orig_ids, pre == R, members, n_win=plan.n_win,
                band_ws=tuple(round_band_width(band_w, r)
                              for r in range(pre)),
                detect=R >= 2, **statics)
        rounds_exec = ran
        executed = pre

        n_alive = n_real
        cur_B, cur_nwin = plan.B, plan.n_win
        while executed < R and n_alive > 0:
            # The one d2h a step: the two flag vectors, for control flow
            # (and telemetry); it waits for the rounds launched so far.
            def _pull_flags(conv=conv, ovf=ovf):
                t_pull = time.perf_counter()
                flags = torch.stack([conv, ovf]).cpu().numpy()
                record_flag_pull(flags.nbytes, time.perf_counter() - t_pull)
                return flags

            with host_part("flags"):
                flags = retry_call("sched/flags", _pull_flags)
            conv_h, ovf_h = flags[0], flags[1]
            frozen = real & (conv_h | ovf_h)
            telem.record_freeze(executed, int(frozen.sum()))
            surv = real & ~conv_h & ~ovf_h
            n_alive = int(surv.sum())
            if n_alive == 0:
                telem.record_skip(R - executed)
                break

            # A repack pays only when the survivors land in a smaller
            # bucket (the lane axis, or a window axis at least halved);
            # otherwise every remaining round runs in one fused tail on
            # the current layout.
            n_wc = surv.shape[0]
            n_lanes = int(np.count_nonzero(
                (cur_win_h < n_wc) & surv[np.minimum(cur_win_h, n_wc - 1)]))
            B2 = round_up(_bucket_b(max(n_lanes, 1)), 128)
            nw2 = round_up(n_alive, 32)
            if B2 >= cur_B and 2 * nw2 > cur_nwin:
                for r in range(executed, R):
                    telem.record_round(r, n_alive)
                tail_ws = tuple(round_band_width(band_w, r)
                                for r in range(executed, R))
                adapt = (env.adaptive_enabled() and len(tail_ws) >= 2 and
                         len(set(tail_ws)) == 1)
                with host_part("rounds"), tracer.span(
                        "round", f"rounds{executed}-{R - 1}", lanes=cur_B,
                        windows=n_alive, fused_tail=1):
                    (bb, bbw, alen, begin, end, ovf, conv, out, ran) = \
                        sched_rounds(
                            bb, bbw, alen, begin, end, q, qw8, lq, w_read,
                            win, ovf, out, orig_ids, True, members,
                            n_win=cur_nwin, band_ws=tail_ws, detect=False,
                            adaptive=adapt, **statics)
                rounds_exec += ran
                executed = R
                break

            t0 = time.perf_counter()
            with host_part("repack"):
                rp = RepackPlan(surv, cur_win_h, cur_orig, trash=trash)
                host_idx = (rp.lane_idx, rp.new_win, rp.win_map,
                            rp.win_real, rp.orig_ids)
                nbytes = sum(a.nbytes for a in host_idx)

                def _put_repack(host_idx=host_idx, nbytes=nbytes):
                    t_put = time.perf_counter()
                    out_d = tuple(torch.from_numpy(a).to(dev)
                                  for a in host_idx)
                    record_h2d(nbytes, time.perf_counter() - t_put,
                               name="h2d/repack")
                    return out_d

                lane_idx, new_win, win_map, win_real, orig_ids = retry_call(
                    "h2d/repack", _put_repack,
                    deadline_s=transfer_deadline_s(nbytes, "h2d"))
                with tracer.span("dispatch", "repack", lanes=rp.B,
                                 windows=n_alive):
                    (bb, bbw, alen, begin, end, q, qw8, lq, w_read, ovf,
                     members) = sched_repack(
                        bb, bbw, alen, begin, end, q, qw8, lq, w_read, ovf,
                        lane_idx, new_win, win_map, win_real)
            win = new_win
            cur_win_h = rp.new_win
            cur_orig = rp.orig_ids
            real = rp.win_real
            cur_B, cur_nwin = rp.B, rp.n_win
            telem.record_repack(time.perf_counter() - t0)

            telem.record_round(executed, n_alive)
            with host_part("rounds"), tracer.span(
                    "round", f"round{executed}", lanes=rp.B,
                    windows=n_alive):
                (bb, bbw, alen, begin, end, ovf, conv, out, ran) = \
                    sched_rounds(
                        bb, bbw, alen, begin, end, q, qw8, lq, w_read, win,
                        ovf, out, orig_ids, executed == R - 1, members,
                        n_win=rp.n_win,
                        band_ws=(round_band_width(band_w, executed),),
                        detect=True, **statics)
            rounds_exec += ran
            executed += 1

        if n_alive > 0:
            # Whoever was still live froze on the schedule's last round.
            telem.record_freeze(R, n_alive)
        with host_part("rounds"):
            packed = sched_pack(out, rounds_exec, R)
        if stats is not None:
            stats["chunks"] = stats.get("chunks", 0) + 1
        return collect_chunk(plan, packed, stats=stats)
