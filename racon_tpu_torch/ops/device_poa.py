"""Device-resident POA consensus engine — port of the JAX package's
``ops/device_poa.py`` fixed-round chunk.

Per chunk:

  h2d once:  two packed byte buffers (ChunkPlan.packed_bufs): layer
             codes/weights/spans and the backbone anchors
  per round (all on the device):
    - job geometry from spans (full-span 1% rule, src/window.cpp:82)
    - the shifted target buffer (tband / tbuf) by gather from the anchors
    - banded NW forward (CUDA kernel csrc/band_fwd.cu), or the full-width
      forward (csrc/flat_fwd.cu) when the band is off
    - column-walk traceback (CUDA kernel csrc/col_walk.cu, both layouts)
    - vote extraction + window aggregation + assembly + compaction
      (ops/device_merge.py) -> next round's anchors and spans
  d2h once:  compact consensus codes + coverage + lengths + flags

Banded exactness is certified per lane every round by the escape bound;
a lane that fails it, or whose walk saturates, flags its window (sticky
``ovf``) for the wide-band redo (ops/redo.py) and, failing that, the host
path. With ``adaptive`` the middle rounds stop as soon as every window is
converged or flagged — the skipped rounds are exact replays.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from racon_tpu_torch.models.window import Window, window_arrays
from racon_tpu_torch.ops import device_merge as dm
from racon_tpu_torch.ops import kernels
from racon_tpu_torch.ops.band import band_geometry, band_targets
from racon_tpu_torch.ops.budget import (max_dir_elems, round_up,
                                        walk_k_for)
from racon_tpu_torch.utils import env

# Per-plane element budget for the cell planes (ops/budget.py).
MAX_DIR_ELEMS = max_dir_elems(1)

# Anchor slack for insertion growth across rounds; a window whose
# consensus outgrows it raises the sticky ovf flag.
LA_GROW = 64


def _bucket_b(n: int) -> int:
    """Batch-dim bucket (coarse grid; the JAX package's, unchanged, so the
    two engines pack identical chunks)."""
    for cap in (128, 256, 512, 1024, 2048):
        if n <= cap:
            return cap
    return round_up(n, 1024)


# Cap reuse history, per process: later runs pad up to a previous
# (Lq, LA) pair or band width within 2x. The port keeps it so its chunk
# geometry — and therefore its bytes — match the reference's.
_HISTORY_LOCK = threading.Lock()
_CAP_HISTORY: set = set()
_BAND_HISTORY: set = set()


def run_caps(lq: int, la: int) -> Tuple[int, int]:
    """(lq_cap, la_cap) covering a run's max layer/backbone lengths."""
    need = (round_up(lq, 128), round_up(la + LA_GROW, 128))
    if 128 * need[0] * need[1] > MAX_DIR_ELEMS:
        return need
    with _HISTORY_LOCK:
        best = None
        for c in _CAP_HISTORY:
            if (need[0] <= c[0] <= 2 * need[0] and
                    need[1] <= c[1] <= 2 * need[1] and
                    128 * c[0] * c[1] <= MAX_DIR_ELEMS and
                    (best is None or c[0] * c[1] < best[0] * best[1])):
                best = c
        if best is None:
            best = need
            _CAP_HISTORY.add(need)
        return best


def window_band_delta(w: Window) -> int:
    """Max |lt0 - lq| over a window's layers at round-0 geometry."""
    L = len(w.backbone)
    if w.n_layers == 0:
        return 0
    offs = L // 100
    b = np.clip(np.asarray(w.layer_begin, np.int64), 0, L - 1)
    e = np.maximum(
        np.minimum(np.asarray(w.layer_end, np.int64), L - 1), b)
    lqs = np.array([len(d) for d in w.layer_data], np.int64)
    full = (b < offs) & (e > L - offs)
    lt0 = np.where(full, L, e - b + 1)
    return int(np.abs(lt0 - lqs).max())


def band_width_for(max_delta: int) -> int:
    """Band slots covering a max length difference with >= 64 slack per
    side, on the 128 grid."""
    return round_up(max_delta + 2 * 64 + 1, 128)


def dir_elems(n_jobs: int, max_lq: int, max_bb: int) -> int:
    """Cell-plane element count for a chunk, with ChunkPlan's padding."""
    return (_bucket_b(n_jobs) * round_up(max_lq, 128) *
            round_up(max_bb + LA_GROW, 128))


class ChunkPlan:
    """Host-side padded arrays for one device chunk (the reference's
    layout and padding, byte for byte)."""

    def __init__(self, windows: List[Window], la_grow: int = LA_GROW,
                 lq_cap: Optional[int] = None, la_cap: Optional[int] = None,
                 band_cap: Optional[int] = None):
        self.windows = windows
        jobs_q: List[np.ndarray] = []
        jobs_w: List[np.ndarray] = []
        begin: List[int] = []
        end: List[int] = []
        win: List[int] = []
        anchors: List[np.ndarray] = []
        anchor_w: List[np.ndarray] = []
        for wi, w in enumerate(windows):
            lays, bb, bw = window_arrays(w)
            for codes, wts, b, e in lays:
                jobs_q.append(codes)
                jobs_w.append(wts)
                begin.append(b)
                end.append(e)
                win.append(wi)
            anchors.append(bb)
            anchor_w.append(bw)

        self.n_real_win = len(windows)
        self.n_win = round_up(len(windows), 32)
        self.n_jobs = len(jobs_q)
        B = round_up(_bucket_b(self.n_jobs), 128)
        max_lq = max(len(q) for q in jobs_q)
        LA0 = max(len(a) for a in anchors)
        Lq = lq_cap if lq_cap is not None else round_up(max_lq, 128)
        LA = la_cap if la_cap is not None else round_up(LA0 + la_grow, 128)
        if max_lq > Lq or LA0 + la_grow > LA:
            raise ValueError(
                "[racon_tpu_torch::ChunkPlan] caps below chunk max")
        self.B, self.Lq, self.LA = B, Lq, LA

        self.q = np.zeros((B, Lq), np.uint8)
        # Weights ship as uint8 (value + 1, 0 = padding), clipped at 126:
        # the vote extraction packs them as 7-bit fields.
        self.qw8 = np.zeros((B, Lq), np.uint8)
        self.lq = np.ones(B, np.int32)
        self.w_read = np.zeros(B, np.float32)
        # Padded lanes point at a dummy extra window (n_win).
        self.win = np.full(B, self.n_win, np.int32)
        self.begin = np.zeros(B, np.int32)
        self.end = np.ones(B, np.int32)
        if self.n_jobs:
            nj = self.n_jobs
            lens = np.fromiter((len(q) for q in jobs_q), np.int64, nj)
            flat_q = np.concatenate(jobs_q)
            flat_w = np.concatenate(jobs_w).astype(np.float64)
            mask = np.arange(Lq)[None, :] < lens[:, None]
            self.q[:nj][mask] = flat_q
            self.qw8[:nj][mask] = \
                np.clip(flat_w, 0, 126).astype(np.uint8) + 1
            self.lq[:nj] = lens
            # Segment means via prefix sums (f64, exact on integer
            # weights, like the host engine's per-job mean).
            offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
            cs = np.concatenate([[0.0], np.cumsum(flat_w)])
            sums = cs[offs + lens] - cs[offs]
            self.w_read[:nj] = np.where(
                lens > 0, sums / np.maximum(lens, 1), 0.0)
            self.win[:nj] = win
            self.begin[:nj] = begin
            self.end[:nj] = end

        Nw = self.n_win + 1   # + dummy row for padded lanes
        self.bb = np.zeros((Nw, LA), np.uint8)
        self.bbw = np.zeros((Nw, LA), np.float32)
        self.alen = np.ones(Nw, np.int32)
        for wi in range(self.n_real_win):
            L = len(anchors[wi])
            self.bb[wi, :L] = anchors[wi]
            self.bbw[wi, :L] = anchor_w[wi]
            self.alen[wi] = L

        # Static band width for the banded forward (0 = full width).
        W = band_width_for(max((window_band_delta(w) for w in windows),
                               default=0))
        if band_cap is not None and W > band_cap:
            raise ValueError(
                "[racon_tpu_torch::ChunkPlan] band width exceeds the "
                f"caller's sizing cap ({W} > {band_cap})")
        if W + 128 > LA:
            self.band_w = 0
        else:
            ceil = min(LA - 128, band_cap) if band_cap else LA - 128
            with _HISTORY_LOCK:
                best = None
                for c in _BAND_HISTORY:
                    if (W <= c <= 2 * W and c <= ceil and
                            (best is None or c < best)):
                        best = c
                if best is None:
                    _BAND_HISTORY.add(W)
                    best = W
            self.band_w = best

    def packed_bufs(self):
        """(job_buf u8[B, 2*Lq+20], win_buf u8[Nw+1, 5*LA+4]) — every
        chunk input in two byte buffers (the reference's layout)."""
        B, Lq, LA = self.B, self.Lq, self.LA
        job = np.empty((B, 2 * Lq + 20), np.uint8)
        job[:, :Lq] = self.q
        job[:, Lq:2 * Lq] = self.qw8
        sc = job[:, 2 * Lq:]
        sc[:, 0:4] = self.begin.astype(np.int32).view(np.uint8).reshape(B, 4)
        sc[:, 4:8] = self.end.astype(np.int32).view(np.uint8).reshape(B, 4)
        sc[:, 8:12] = self.lq.astype(np.int32).view(np.uint8).reshape(B, 4)
        sc[:, 12:16] = self.win.astype(np.int32).view(np.uint8).reshape(B, 4)
        sc[:, 16:20] = self.w_read.astype(np.float32).view(np.uint8) \
            .reshape(B, 4)
        Nw1 = self.n_win + 1
        winb = np.empty((Nw1, 5 * LA + 4), np.uint8)
        winb[:, :LA] = self.bb
        winb[:, LA:5 * LA] = self.bbw.astype(np.float32).view(np.uint8) \
            .reshape(Nw1, 4 * LA)
        winb[:, 5 * LA:] = self.alen.astype(np.int32).view(np.uint8) \
            .reshape(Nw1, 4)
        return job, winb


# ------------------------------------------------------------ stage clock

class StageClock:
    """Per-stage device time of the chunk rounds (tband, forward, walk,
    merge): CUDA events on a GPU, the host clock on the CPU; and the kernel
    launches made inside each stage (the change of ``kernels.LAUNCHES``).
    Enabled with :func:`set_stage_clock`; read once at the end (one
    synchronize)."""

    def __init__(self):
        self._ev: Dict[str, list] = {}
        self._launches: Dict[str, Dict[str, int]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, device: torch.device):
        before = dict(kernels.LAUNCHES)
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            self._ev.setdefault(name, []).append((a, b))
        else:
            t0 = time.perf_counter()
            yield
            self._ev.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
        got = self._launches.setdefault(name, {})
        for k, n in kernels.LAUNCHES.items():
            if n != before.get(k, 0):
                got[k] = got.get(k, 0) + n - before.get(k, 0)

    def launches(self) -> Dict[str, Dict[str, int]]:
        """Kernel launches made inside each stage: {stage: {kernel: n}}."""
        return {k: dict(v) for k, v in self._launches.items()}

    def ms(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        synced = False
        for k, vs in self._ev.items():
            tot = 0.0
            for v in vs:
                if isinstance(v, tuple):
                    if not synced:
                        torch.cuda.synchronize()
                        synced = True
                    tot += v[0].elapsed_time(v[1])
                else:
                    tot += v
            out[k] = tot
        return out


_CLOCK: Optional[StageClock] = None


def set_stage_clock(on: bool = True) -> Optional[StageClock]:
    """Start (or stop, ``on=False``) per-stage timing; returns the clock."""
    global _CLOCK
    _CLOCK = StageClock() if on else None
    return _CLOCK


def _stage(name: str, device: torch.device):
    if _CLOCK is None:
        return contextlib.nullcontext()
    return _CLOCK.stage(name, device)


# ------------------------------------------------------------ one round

def _lane_fwd(bb, alen, begin, end, q, lq, win, *, match, mismatch, gap,
              Lq, LA, band_w=0, nxt_k=2):
    """Job geometry + NW forward for every lane of one round.

    Returns ``(cells, nxt, nxt2, lt, t_off, klo, esc0)``: the packed cell
    plane, the predecessor planes (None below their depth), the per-lane
    geometry the walk reuses (``klo`` None on the flat path) and ``esc0``,
    the band-escape certificate term f32[B] (None on the flat path).
    """
    dev = q.device
    i32 = torch.int32
    L = alen[win.long()]
    b_c = torch.minimum(torch.clamp(begin, min=0), L - 1)
    e_c = torch.minimum(torch.maximum(end, b_c), L - 1)
    # offset = uint32(0.01 * L), strict end > L - offset (window.cpp:82).
    offs = torch.div(L, 100, rounding_mode="floor")
    full = (b_c < offs) & (e_c > L - offs)
    t_off = torch.where(full, 0, b_c).to(i32)
    lt = torch.where(full, L, e_c - b_c + 1).to(i32)
    flat = bb.reshape(-1)
    base = win.long() * LA + t_off.long()
    qT = q.t().contiguous()
    if band_w:
        with _stage("tband", dev):
            klo, wl = band_geometry(lq, lt, band_w)
            tband = band_targets(flat, base, klo, lt, band_w + Lq)
        with _stage("forward", dev):
            cells, nxt, nxt2, hlast = kernels.fw_dirs_band(
                tband, qT, klo, lq, match=match, mismatch=mismatch,
                gap=gap, W=band_w, nxt_k=nxt_k)
        # Escape bound (see nw.cpp): any path leaving the band carries at
        # least |lt-lq| + 2(wl+1) gap ops, so its score is at most
        #   max(m,0)*(min(lq,lt) - wl - 1) + g*(|lt-lq| + 2wl + 2).
        xend = torch.clamp(lt - lq - klo, 0, band_w - 1).long()
        score = torch.gather(hlast, 1, xend[:, None])[:, 0]
        bound = (max(match, 0) * (torch.minimum(lq, lt) - wl - 1) +
                 gap * ((lt - lq).abs() + 2 * wl + 2))
        esc0 = ((score < bound) | (wl < 16)).to(torch.float32)
        return cells, nxt, nxt2, lt, t_off, klo, esc0
    with _stage("tband", dev):
        x = torch.arange(LA, device=dev)[None, :]
        ok = x < lt.long()[:, None]
        idx = torch.clamp(base[:, None] + x, 0, flat.numel() - 1)
        tbuf = torch.where(ok, flat[idx], 7).to(torch.uint8)
    with _stage("forward", dev):
        cells = kernels.fw_dirs_flat(tbuf, qT, match=match,
                                     mismatch=mismatch, gap=gap)
    return cells, None, None, lt, t_off, None, None


def _lane_walk(cells, nxt, nxt2, lt, t_off, klo, esc0, q, qw8, lq, w_read,
               *, LA, band_w=0):
    """Column walk + vote extraction over _lane_fwd's planes. Returns
    (votes for dm.aggregate_votes, esc_w f32[B])."""
    with _stage("walk", q.device):
        if band_w:
            cols = kernels.col_walk_kernel(cells, lq, lt, klo, t_off, LA=LA,
                                           layout="band", nxt=nxt, nxt2=nxt2)
        else:
            cols = kernels.col_walk_kernel(cells, lq, lt, None, t_off, LA=LA,
                                           layout="flat")
    with _stage("merge", q.device):
        votes = dm.extract_votes_cols(cols, q, qw8, w_read, lt, t_off, LA)
    sat_w = cols["sat"].to(torch.float32)
    esc_w = sat_w if esc0 is None else esc0 + sat_w
    return votes, esc_w


def _lane_votes(bb, alen, begin, end, q, qw8, lq, w_read, win, *, match,
                mismatch, gap, Lq, LA, band_w=0, nxt_k=2):
    """Geometry + forward + walk + vote extraction for one round."""
    fwd = _lane_fwd(bb, alen, begin, end, q, lq, win, match=match,
                    mismatch=mismatch, gap=gap, Lq=Lq, LA=LA,
                    band_w=band_w, nxt_k=nxt_k)
    return _lane_walk(*fwd, q, qw8, lq, w_read, LA=LA, band_w=band_w)


def _remap_state(codes, total, map_b, map_e, bb, alen, begin, end, win,
                 LA: int):
    """Next-round anchors (dummy row re-appended) and spans remapped
    through the merge's coordinate maps."""
    L = alen[win.long()]
    new_bb = torch.cat([codes, bb[-1:]], dim=0)
    new_alen = torch.cat([torch.clamp(total, 1, LA), alen[-1:]],
                         dim=0).to(torch.int32)
    mb_flat = map_b.reshape(-1)
    me_flat = map_e.reshape(-1)
    winc = torch.clamp(win.long(), max=map_b.shape[0] - 1)
    nb = torch.where(
        begin < L, mb_flat[winc * LA + torch.clamp(begin, 0, LA - 1).long()],
        0).to(torch.int32)
    tot_j = torch.clamp(total, 1, LA)[winc]
    ne = torch.where(
        end < L, me_flat[winc * LA + torch.clamp(end, 0, LA - 1).long()],
        tot_j - 1).to(torch.int32)
    return new_bb, new_alen, nb, ne


def _merge_round(votes, esc_w, bb, bbw, alen, begin, end, win, ovf, *,
                 ins_scale, n_win, LA, detect=False):
    """Vote aggregation through state remap — the back half of a round.
    Returns (new_bb, new_bbw, new_alen, new_begin, new_end, cov, ovf,
    conv)."""
    with _stage("merge", bb.device):
        # Padded lanes (window id n_win) belong to no window here; the
        # reference sums them into a dummy row it then drops.
        acc = dm.aggregate_votes(votes, win, n_win, extras={"_esc": esc_w})
        wesc = acc.pop("_esc")
        acc = dm.add_backbone(acc, bb[:-1], bbw[:-1], alen[:-1])
        asm = dm.assemble(acc, alen[:-1], ins_scale)
        codes, cov, total = dm.compact(asm, LA)
        map_b, map_e = dm.coord_maps(asm, alen[:-1], LA)
        new_bb, new_alen, nb, ne = _remap_state(
            codes, total, map_b, map_e, bb, alen, begin, end, win, LA)
        new_bbw = torch.zeros_like(bbw)
        ovf = ovf | (total > LA) | (wesc > 0)
        if detect:
            chg = ((nb != begin) | (ne != end)).to(torch.float32)
            wchg = dm.aggregate_flags(chg, win, n_win)
            conv = dm.converged_windows(codes, total, bb[:-1], alen[:-1],
                                        wchg)
        else:
            conv = torch.zeros(n_win, dtype=torch.bool, device=bb.device)
    return new_bb, new_bbw, new_alen, nb, ne, cov, ovf, conv


def _round_core(bb, bbw, alen, begin, end, q, qw8, lq, w_read, win, ovf, *,
                match, mismatch, gap, ins_scale, Lq, n_win, LA, band_w=0,
                nxt_k=2, detect=False):
    """One alignment + merge round (see _merge_round for the outputs)."""
    votes, esc_w = _lane_votes(
        bb, alen, begin, end, q, qw8, lq, w_read, win, match=match,
        mismatch=mismatch, gap=gap, Lq=Lq, LA=LA, band_w=band_w,
        nxt_k=nxt_k)
    return _merge_round(votes, esc_w, bb, bbw, alen, begin, end, win, ovf,
                        ins_scale=ins_scale, n_win=n_win, LA=LA,
                        detect=detect)


def round_band_width(band_w: int, r: int) -> int:
    """Band width for refinement round ``r``: the full chunk band in round
    0, at most 192 slots afterwards (the anchor is near-converged; the
    escape bound still certifies every lane)."""
    return band_w if (r == 0 or not band_w) else min(band_w, 192)


# ------------------------------------------------------------ one chunk

def load_packed(job_buf: np.ndarray, win_buf: np.ndarray, plan_dims,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Move ChunkPlan.packed_bufs()' byte buffers — the port's or the JAX
    package's, they are the same layout — onto ``device``.

    ``plan_dims`` = (B, Lq, n_win, LA) of the plan that packed them."""
    B, Lq, n_win, LA = (int(v) for v in plan_dims)
    job = np.ascontiguousarray(job_buf, dtype=np.uint8)
    winb = np.ascontiguousarray(win_buf, dtype=np.uint8)
    if job.shape != (B, 2 * Lq + 20) or winb.shape != (n_win + 1,
                                                         5 * LA + 4):
        raise ValueError(
            "[racon_tpu_torch::load_packed] buffer shapes "
            f"{job.shape}/{winb.shape} do not match plan dims {plan_dims}")
    dev = torch.device(device)
    return (torch.from_numpy(job).to(dev), torch.from_numpy(winb).to(dev))


def _unpack_bufs(job_buf, win_buf, Lq: int, LA: int):
    """Slice the packed byte layouts back into round-state tensors:
    (q, qw8, begin, end, lq, win, w_read, bb, bbw, alen)."""

    def as_(cols, dtype):
        return cols.contiguous().view(dtype)

    q = job_buf[:, :Lq]
    qw8 = job_buf[:, Lq:2 * Lq]
    sc = job_buf[:, 2 * Lq:]
    i32 = torch.int32
    begin = as_(sc[:, 0:4], i32)[:, 0]
    end = as_(sc[:, 4:8], i32)[:, 0]
    lq = as_(sc[:, 8:12], i32)[:, 0]
    win = as_(sc[:, 12:16], i32)[:, 0]
    w_read = as_(sc[:, 16:20], torch.float32)[:, 0]
    bb = win_buf[:, :LA]
    bbw = as_(win_buf[:, LA:5 * LA], torch.float32)
    alen = as_(win_buf[:, 5 * LA:], i32)[:, 0]
    return (q.contiguous(), qw8.contiguous(), begin, end, lq, win, w_read,
            bb.contiguous(), bbw, alen)


def _pack_body(codes, cov, alen, ovf, rounds_exec: int, rounds_sched: int):
    """One uint8 buffer for a single d2h: codes, int16 coverage, int32
    lengths, ovf flags, and the executed/scheduled round counts."""
    c16 = torch.clamp(cov, 0, 32767).to(torch.int16).contiguous()
    tail = alen.to(torch.int32).contiguous()
    rr = torch.tensor([rounds_exec, rounds_sched], dtype=torch.int32,
                      device=codes.device)
    return torch.cat([
        codes.reshape(-1),
        c16.view(torch.uint8).reshape(-1),
        tail.view(torch.uint8).reshape(-1),
        ovf.to(torch.uint8),
        rr.view(torch.uint8),
    ])


def device_chunk_packed(job_buf, win_buf, *, match, mismatch, gap,
                        ins_scale, Lq, n_win, LA, band_w, rounds,
                        adaptive=False, nxt_k=2):
    """One chunk end to end from its two byte buffers (on the device).

    ``ins_scale``: a float or a per-round tuple of length ``rounds``.
    ``adaptive``: after round 0, run the middle rounds only while some
    window is neither converged nor flagged (needs rounds >= 3 and
    uniform non-final scales; the caller checks both). Returns the packed
    output buffer (see _pack_body).
    """
    (q, qw8, begin, end, lq, win, w_read, bb, bbw, alen) = \
        _unpack_bufs(job_buf, win_buf, Lq, LA)
    scales = ins_scale if isinstance(ins_scale, tuple) \
        else (ins_scale,) * rounds
    ovf = torch.zeros(n_win, dtype=torch.bool, device=q.device)

    def run(r, sc, detect):
        nonlocal bb, bbw, alen, begin, end, ovf
        bb, bbw, alen, begin, end, cov, ovf, conv = _round_core(
            bb, bbw, alen, begin, end, q, qw8, lq, w_read, win, ovf,
            match=match, mismatch=mismatch, gap=gap, ins_scale=sc, Lq=Lq,
            n_win=n_win, LA=LA, band_w=round_band_width(band_w, r),
            nxt_k=nxt_k, detect=detect)
        return cov, conv

    if not adaptive:
        for r in range(rounds - 1):
            run(r, scales[r], False)
        executed = rounds - 1
    else:
        # Round 0 cannot be a fixed point (its anchor carries backbone
        # quality weights); middle rounds stop once every window is
        # converged or flagged.
        _, conv = run(0, scales[0], False)
        executed = 1
        while executed < rounds - 1 and \
                not bool(torch.all(conv | ovf).item()):
            _, conv = run(1, scales[1], True)
            executed += 1
    cov, _ = run(rounds - 1, scales[-1], False)
    return _pack_body(bb[:-1], cov, alen[:-1], ovf, executed + 1, rounds)


def chunk_statics(plan: ChunkPlan, *, ins_scale, rounds: int) -> dict:
    """The per-chunk selections: band width (0 = full width), walk depth
    and the adaptive gate."""
    band_w = 0 if env.band_disabled() else plan.band_w
    nxt_k = walk_k_for(plan.B * plan.Lq * band_w) if band_w else 1
    sc = ins_scale if isinstance(ins_scale, tuple) \
        else (ins_scale,) * rounds
    adaptive = rounds >= 3 and len(set(sc[:-1])) <= 1
    return {"band_w": band_w, "nxt_k": nxt_k, "adaptive": adaptive}


def dispatch_chunk(plan: ChunkPlan, *, match: int, mismatch: int, gap: int,
                   ins_scale, rounds: int, device,
                   stats: Optional[dict] = None):
    """Ship a chunk to ``device`` and run all its rounds; returns the
    packed output buffer (still on the device)."""
    t0 = time.perf_counter()
    st = chunk_statics(plan, ins_scale=ins_scale, rounds=rounds)
    job_buf, win_buf = load_packed(
        *plan.packed_bufs(), (plan.B, plan.Lq, plan.n_win, plan.LA), device)
    packed = device_chunk_packed(
        job_buf, win_buf, match=match, mismatch=mismatch, gap=gap,
        ins_scale=ins_scale, Lq=plan.Lq, n_win=plan.n_win, LA=plan.LA,
        band_w=st["band_w"], rounds=rounds, adaptive=st["adaptive"],
        nxt_k=st["nxt_k"])
    if stats is not None:
        stats["chunks"] = stats.get("chunks", 0) + 1
        stats["dispatch_s"] = stats.get("dispatch_s", 0.0) + \
            time.perf_counter() - t0
    return packed


def collect_chunk(plan: ChunkPlan, packed, stats: Optional[dict] = None
                  ) -> Tuple[List[Optional[bytes]],
                             List[Optional[np.ndarray]]]:
    """Pull a chunk's packed output and unpack per window. A flagged
    window (sticky ``ovf``) yields ``None`` in both lists."""
    ph = packed.cpu().numpy()
    Nw, LA = plan.n_win, plan.LA
    codes_h = ph[:Nw * LA].reshape(Nw, LA)
    cov_h = ph[Nw * LA:3 * Nw * LA].view(np.int16).reshape(Nw, LA)
    alen_h = ph[3 * Nw * LA:3 * Nw * LA + 4 * Nw].view(np.int32)[:Nw]
    base = 3 * Nw * LA + 4 * Nw
    ovf_h = ph[base:base + Nw] != 0
    rex = int(ph[base + Nw:base + Nw + 4].view(np.int32)[0])
    rsch = int(ph[base + Nw + 4:base + Nw + 8].view(np.int32)[0])
    if stats is not None:
        stats["rounds_exec"] = stats.get("rounds_exec", 0) + rex
        stats["rounds_sched"] = stats.get("rounds_sched", 0) + rsch
    out_codes: List[Optional[bytes]] = []
    out_cov: List[Optional[np.ndarray]] = []
    for wi in range(plan.n_real_win):
        if ovf_h[wi]:
            out_codes.append(None)
            out_cov.append(None)
            continue
        L = int(alen_h[wi])
        out_codes.append(codes_h[wi, :L].tobytes())
        out_cov.append(cov_h[wi, :L].astype(np.int32))
    return out_codes, out_cov


def run_chunk(plan: ChunkPlan, *, match: int, mismatch: int, gap: int,
              ins_scale, rounds: int, device,
              stats: Optional[dict] = None):
    """dispatch_chunk + collect_chunk, back to back."""
    packed = dispatch_chunk(plan, match=match, mismatch=mismatch, gap=gap,
                            ins_scale=ins_scale, rounds=rounds,
                            device=device, stats=stats)
    return collect_chunk(plan, packed, stats=stats)
