"""Device-resident POA consensus engine — port of the JAX package's
``ops/device_poa.py`` fixed-round chunk.

Per chunk:

  h2d once:  two packed byte buffers (ChunkPlan.packed_bufs): layer
             codes/weights/spans and the backbone anchors, copied from
             pinned memory on a copy stream (put_chunk_bufs), so that a
             caller can start chunk i+1's copy before chunk i's rounds
  per round (all on the device):
    - job geometry from spans (full-span 1% rule, src/window.cpp:82)
    - the shifted target buffer (tband / tbuf) by gather from the anchors
    - banded NW forward (CUDA kernel csrc/band_fwd.cu), or the full-width
      forward (csrc/flat_fwd.cu) when the band is off
    - column-walk traceback (CUDA kernel csrc/col_walk.cu, both layouts)
    - the window merge: vote extraction and per-window sums (M1), then
      backbone, vote-out, compaction, coordinate maps and the state remap
      (M2) -> next round's anchors and spans (CUDA kernels csrc/merge.cu;
      their plain versions in ops/device_merge.py on the CPU)
  d2h once:  compact consensus codes + coverage + lengths + flags

Banded exactness is certified per lane every round by the escape bound;
a lane that fails it, or whose walk saturates, flags its window (sticky
``ovf``) for the wide-band redo (ops/redo.py) and, failing that, the host
path. With ``adaptive`` the middle rounds stop as soon as every window is
converged or flagged — the skipped rounds are exact replays.

This module is the fixed-round engine (``RACON_TPU_SCHED=0``); the
convergence scheduler (sched/) drives the same round pieces window by
window. The streaming pipeline can split a fixed-round chunk in two:
``dispatch_chunk_fwd`` runs every round but the final one's walk and
merge, which dispatch_walk then runs on another thread, with the
fused chunk's bytes. ``set_stage_clock`` times the device stages of both
(tband, forward, walk, merge, and the scheduler's repack gathers),
``set_host_clock`` the host parts of the chunk loops.
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
                                        walk_k_for, walk_plane_bytes)
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
    merge, and the scheduler's survivor gathers, repack): CUDA events on
    the calling thread's current stream on a GPU, the host clock on the
    CPU; and the kernel launches made inside each stage by the calling
    thread (the change of ``kernels.thread_launches``), so a stage is
    charged only its own thread's launches when the streaming pipeline
    launches from two threads. Those two threads share one stream
    (pipeline/streaming.py), so a stage's event span there can include
    kernels the other thread queued inside it. Enabled with
    :func:`set_stage_clock`; read once at the end (one synchronize)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ev: Dict[str, list] = {}
        self._launches: Dict[str, Dict[str, int]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, device: torch.device):
        before = kernels.thread_launches()
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(stream)
            yield
            b.record(stream)
            rec = (a, b)
        else:
            t0 = time.perf_counter()
            yield
            rec = (time.perf_counter() - t0) * 1e3
        after = kernels.thread_launches()
        with self._lock:
            self._ev.setdefault(name, []).append(rec)
            got = self._launches.setdefault(name, {})
            for k, n in after.items():
                if n != before.get(k, 0):
                    got[k] = got.get(k, 0) + n - before.get(k, 0)

    def launches(self) -> Dict[str, Dict[str, int]]:
        """Kernel launches made inside each stage: {stage: {kernel: n}}."""
        with self._lock:
            return {k: dict(v) for k, v in self._launches.items()}

    def ms(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        synced = False
        with self._lock:
            evs = {k: list(vs) for k, vs in self._ev.items()}
        for k, vs in evs.items():
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


class HostClock:
    """Host seconds of the chunk loops, summed by part over chunks:
    ``plan`` (ChunkPlan and packed_bufs), ``h2d`` (the copies' enqueue),
    ``rounds`` (the round launches; the fixed engine's adaptive test
    waits on the card here), ``flags`` (the scheduler's flag pulls, which
    wait on the card), ``walk`` (the decoupled final-round walk's
    launches, dispatch_walk), ``repack`` (RepackPlan, its index
    copies and the gathers' launches), ``collect`` (the d2h, which waits on the card)
    and ``apply`` (the windows' consensus applied); ``n`` counts the
    times each part ran. The streaming pipeline's stage threads time their
    parts concurrently, so there the parts overlap and their sum can pass
    the wall. Enabled with :func:`set_host_clock`."""

    def __init__(self):
        self._lock = threading.Lock()
        self.s: Dict[str, float] = {}
        self.n: Dict[str, int] = {}

    @contextlib.contextmanager
    def part(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.s[name] = self.s.get(name, 0.0) + dt
                self.n[name] = self.n.get(name, 0) + 1


_HOST: Optional[HostClock] = None


def set_host_clock(on: bool = True) -> Optional[HostClock]:
    """Start (or stop, ``on=False``) the host split; returns the clock."""
    global _HOST
    _HOST = HostClock() if on else None
    return _HOST


def host_part(name: str):
    """Time a host part of a chunk loop (no-op when the clock is off)."""
    if _HOST is None:
        return contextlib.nullcontext()
    return _HOST.part(name)


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


def _lane_walk(cells, nxt, nxt2, lt, t_off, klo, esc0, lq, *, LA,
               band_w=0):
    """Column walk over _lane_fwd's planes. Returns (cols, the walk's
    [B, LA+2] columns that the merge reads; esc_w f32[B])."""
    with _stage("walk", lq.device):
        if band_w:
            cols = kernels.col_walk_kernel(cells, lq, lt, klo, t_off, LA=LA,
                                           layout="band", nxt=nxt, nxt2=nxt2)
        else:
            cols = kernels.col_walk_kernel(cells, lq, lt, None, t_off, LA=LA,
                                           layout="flat")
    sat_w = cols["sat"].to(torch.float32)
    esc_w = sat_w if esc0 is None else esc0 + sat_w
    return cols, esc_w


def _merge_round(cols, esc_w, lt, t_off, q, qw8, w_read, bb, bbw, alen,
                 begin, end, win, ovf, members, *, ins_scale, n_win, LA,
                 detect=False, freeze=None):
    """The back half of a round, from the walk's columns to the next
    round's state: M1 (kernels.merge_votes: vote extraction and the
    per-window sums) and M2 (kernels.merge_windows: backbone, vote-out,
    compaction, coordinate maps, state remap), on the card with no host
    sync; their plain versions on the CPU. ``members``: the chunk's
    dm.window_members (the plain versions do not read it). ``freeze``:
    the convergence scheduler's (orig_ids, out, scale_final, last), which
    runs M2 in its sched mode (kernels.merge_windows_sched).
    Returns (new_bb, new_bbw, new_alen, new_begin, new_end, cov, ovf,
    conv)."""
    with _stage("merge", bb.device):
        # Padded lanes (window id n_win) belong to no window here; the
        # reference sums them into a dummy row it then drops.
        votes, wesc = kernels.merge_votes(
            cols, q, qw8, w_read, lt, t_off, esc_w, win, members, n_win=n_win,
            LA=LA)
        state = (votes, wesc, bb, bbw, alen, begin, end, win, ovf, members)
        if freeze is None:
            return kernels.merge_windows(
                *state, ins_scale=ins_scale, n_win=n_win, LA=LA,
                detect=detect)
        orig_ids, out, scale_final, last = freeze
        return kernels.merge_windows_sched(
            *state, orig_ids, out, ins_scale=ins_scale,
            scale_final=scale_final, last=last, n_win=n_win, LA=LA,
            detect=detect)


def _round_core(bb, bbw, alen, begin, end, q, qw8, lq, w_read, win, ovf,
                members, *, match, mismatch, gap, ins_scale, Lq, n_win, LA,
                band_w=0, nxt_k=2, detect=False, freeze=None):
    """One alignment + merge round (see _merge_round for the outputs,
    ``members`` and ``freeze``)."""
    fwd = _lane_fwd(bb, alen, begin, end, q, lq, win, match=match,
                    mismatch=mismatch, gap=gap, Lq=Lq, LA=LA,
                    band_w=band_w, nxt_k=nxt_k)
    lt, t_off = fwd[3], fwd[4]
    cols, esc_w = _lane_walk(*fwd, lq, LA=LA, band_w=band_w)
    return _merge_round(cols, esc_w, lt, t_off, q, qw8, w_read, bb, bbw,
                        alen, begin, end, win, ovf, members,
                        ins_scale=ins_scale, n_win=n_win, LA=LA,
                        detect=detect, freeze=freeze)


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


def _rounds_before_final(job_buf, win_buf, *, match, mismatch, gap,
                         ins_scale, Lq, n_win, LA, band_w, rounds, adaptive,
                         nxt_k):
    """Unpack a chunk and run its rounds 0 .. rounds-2: the shared prefix
    of the fused chunk (device_chunk_packed) and its forward half
    (device_chunk_fwd), so the decoupled walk path runs exactly the fused
    path's round chain, adaptive exit included. ``adaptive``: after round
    0, run the middle rounds only while some window is neither converged
    nor flagged.

    Returns ``(job, state, executed, scales)``: the round-invariant lane
    tensors (q, qw8, lq, w_read, win) and the chunk's membership, the
    state entering the final round (bb, bbw, alen, begin, end, ovf), the
    rounds run so far and the per-round scales."""
    (q, qw8, begin, end, lq, win, w_read, bb, bbw, alen) = \
        _unpack_bufs(job_buf, win_buf, Lq, LA)
    scales = ins_scale if isinstance(ins_scale, tuple) \
        else (ins_scale,) * rounds
    ovf = torch.zeros(n_win, dtype=torch.bool, device=q.device)
    # The lanes' windows do not change between rounds: one membership a
    # chunk for every round's merge kernels, on the merge stage's clock.
    with _stage("merge", q.device):
        mem = dm.window_members(win, n_win)

    def run(r, sc, detect):
        nonlocal bb, bbw, alen, begin, end, ovf
        bb, bbw, alen, begin, end, _cov, ovf, conv = _round_core(
            bb, bbw, alen, begin, end, q, qw8, lq, w_read, win, ovf, mem,
            match=match, mismatch=mismatch, gap=gap, ins_scale=sc, Lq=Lq,
            n_win=n_win, LA=LA, band_w=round_band_width(band_w, r),
            nxt_k=nxt_k, detect=detect)
        return conv

    if not adaptive:
        for r in range(rounds - 1):
            run(r, scales[r], False)
        executed = rounds - 1
    else:
        # Round 0 cannot be a fixed point (its anchor carries backbone
        # quality weights); middle rounds stop once every window is
        # converged or flagged.
        conv = run(0, scales[0], False)
        executed = 1
        while executed < rounds - 1 and \
                not bool(torch.all(conv | ovf).item()):
            conv = run(1, scales[1], True)
            executed += 1
    return ((q, qw8, lq, w_read, win, mem), (bb, bbw, alen, begin, end, ovf),
            executed, scales)


def device_chunk_packed(job_buf, win_buf, *, match, mismatch, gap,
                        ins_scale, Lq, n_win, LA, band_w, rounds,
                        adaptive=False, nxt_k=2):
    """One chunk end to end from its two byte buffers (on the device).

    ``ins_scale``: a float or a per-round tuple of length ``rounds``.
    ``adaptive``: the middle rounds' early exit (needs rounds >= 3 and
    uniform non-final scales; the caller checks both). Returns the packed
    output buffer (see _pack_body).
    """
    job, state, executed, scales = _rounds_before_final(
        job_buf, win_buf, match=match, mismatch=mismatch, gap=gap,
        ins_scale=ins_scale, Lq=Lq, n_win=n_win, LA=LA, band_w=band_w,
        rounds=rounds, adaptive=adaptive, nxt_k=nxt_k)
    q, qw8, lq, w_read, win, mem = job
    bb, bbw, alen, begin, end, ovf = state
    bb, _bbw, alen, _b, _e, cov, ovf, _conv = _round_core(
        bb, bbw, alen, begin, end, q, qw8, lq, w_read, win, ovf, mem,
        match=match, mismatch=mismatch, gap=gap, ins_scale=scales[-1],
        Lq=Lq, n_win=n_win, LA=LA,
        band_w=round_band_width(band_w, rounds - 1), nxt_k=nxt_k,
        detect=False)
    return _pack_body(bb[:-1], cov, alen[:-1], ovf, executed + 1, rounds)


def device_chunk_fwd(job_buf, win_buf, *, match, mismatch, gap, ins_scale,
                     Lq, n_win, LA, band_w, rounds, adaptive=False, nxt_k=2):
    """The forward half of a chunk: rounds 0 .. rounds-2 as
    device_chunk_packed runs them (adaptive exit included), then the final
    round's tband and forward only. Its walk and merge are left to
    walk_chunk_packed, which finishes the chunk with the same
    bytes: only the final round's walk has no later round waiting on it,
    so it alone can leave the chunk's launching thread.

    Returns ``(fwd_out, job)``: ``fwd_out`` = (cells, nxt, nxt2, lt,
    t_off, klo, esc0) of the final round's forward (None where the depth
    or layout has no such plane), then the state entering the final round
    (bb, bbw, alen, begin, end, ovf) and the rounds executed so far;
    ``job`` = the chunk's round-invariant lane tensors (q, qw8, lq,
    w_read, win) and its membership."""
    job, state, executed, _scales = _rounds_before_final(
        job_buf, win_buf, match=match, mismatch=mismatch, gap=gap,
        ins_scale=ins_scale, Lq=Lq, n_win=n_win, LA=LA, band_w=band_w,
        rounds=rounds, adaptive=adaptive, nxt_k=nxt_k)
    q, _qw8, lq, _w_read, win, _mem = job
    bb, bbw, alen, begin, end, ovf = state
    planes = _lane_fwd(bb, alen, begin, end, q, lq, win, match=match,
                       mismatch=mismatch, gap=gap, Lq=Lq, LA=LA,
                       band_w=round_band_width(band_w, rounds - 1),
                       nxt_k=nxt_k)
    return tuple(planes) + (bb, bbw, alen, begin, end, ovf, executed), job


def walk_chunk_packed(job, cells, nxt, nxt2, lt, t_off, klo, esc0, bb, bbw,
                      alen, begin, end, ovf, rounds_exec, *, ins_scale,
                      n_win, LA, band_w, rounds):
    """The walk half of a chunk: finish device_chunk_fwd's final round —
    the column walk (W1), M1 and M2 — and pack the output, byte for byte
    the buffer device_chunk_packed gives. It runs the fused chunk's own
    pieces (_lane_walk, _merge_round, _pack_body) on the planes and state
    device_chunk_fwd left on the device. ``job``: the chunk's (q, qw8, lq,
    w_read, win, members); ``ins_scale``: the final round's scale."""
    q, qw8, lq, w_read, win, members = job
    cols, esc_w = _lane_walk(cells, nxt, nxt2, lt, t_off, klo, esc0, lq,
                             LA=LA, band_w=band_w)
    new_bb, _bbw, new_alen, _b, _e, cov, ovf, _conv = _merge_round(
        cols, esc_w, lt, t_off, q, qw8, w_read, bb, bbw, alen, begin, end,
        win, ovf, members, ins_scale=ins_scale, n_win=n_win, LA=LA,
        detect=False)
    return _pack_body(new_bb[:-1], cov, new_alen[:-1], ovf, rounds_exec + 1,
                      rounds)


def chunk_statics(plan: ChunkPlan, *, ins_scale, rounds: int) -> dict:
    """The per-chunk selections: band width (0 = full width), walk depth
    (at the plan's B and round-0 band, so every round of the chunk shares
    it) and the adaptive gate (``RACON_TPU_ADAPTIVE``; only with a middle
    round to skip and uniform non-final scales)."""
    band_w = 0 if env.band_disabled() else plan.band_w
    nxt_k = walk_k_for(plan.B * plan.Lq * band_w) if band_w else 1
    sc = ins_scale if isinstance(ins_scale, tuple) \
        else (ins_scale,) * rounds
    adaptive = (env.adaptive_enabled() and rounds >= 3 and
                len(set(sc[:-1])) <= 1)
    return {"band_w": band_w, "nxt_k": nxt_k, "adaptive": adaptive}


_COPY_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


class ChunkBufs:
    """A chunk's two packed byte buffers on ``device``, maybe still in
    flight (put_chunk_bufs). ``tensors()`` makes the current stream wait
    for the copy and returns ``(job_buf, win_buf)``."""

    __slots__ = ("job", "win", "event", "host")

    def __init__(self, job, win, event=None, host=None):
        self.job, self.win, self.event, self.host = job, win, event, host

    def tensors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.event is not None:
            cur = torch.cuda.current_stream(self.job.device)
            cur.wait_event(self.event)
            # The buffers were allocated on the copy stream; the caching
            # allocator must not hand them out again before the compute
            # stream is done with them.
            self.job.record_stream(cur)
            self.win.record_stream(cur)
            self.event = None
            self.host = None
        return self.job, self.win


def put_chunk_bufs(plan: ChunkPlan, device) -> ChunkBufs:
    """Start the h2d of a chunk's two packed byte buffers without
    blocking: on a GPU, pinned host copies go up with ``non_blocking`` on
    a copy stream of their own, and an event marks their end, which the
    compute stream waits on before the unpack (ChunkBufs.tensors). On the
    CPU the buffers are ready at once."""
    with host_part("plan"):
        job_h, win_h = plan.packed_bufs()
    dims = (plan.B, plan.Lq, plan.n_win, plan.LA)
    dev = torch.device(device)
    with host_part("h2d"):
        if dev.type != "cuda":
            return ChunkBufs(*load_packed(job_h, win_h, dims, dev))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        stream = _COPY_STREAMS.get(dev.index)
        if stream is None:
            stream = _COPY_STREAMS[dev.index] = torch.cuda.Stream(dev)
        host = tuple(torch.from_numpy(a).pin_memory() for a in (job_h, win_h))
        # No wait on the compute stream: the buffers come from the copy
        # stream's own pool, whose blocks the allocator hands out again
        # only after the streams recorded on them (tensors()) are done.
        with torch.cuda.stream(stream):
            job, win = (h.to(dev, non_blocking=True) for h in host)
            event = torch.cuda.Event()
            event.record(stream)
        return ChunkBufs(job, win, event, host)


def dispatch_chunk(plan: ChunkPlan, *, match: int, mismatch: int, gap: int,
                   ins_scale, rounds: int, device,
                   stats: Optional[dict] = None,
                   bufs: Optional[ChunkBufs] = None):
    """Ship a chunk to ``device`` (or take ``bufs``, a put_chunk_bufs
    result started earlier) and launch all its rounds; returns the packed
    output buffer (still on the device: only the adaptive exit's test
    waits on the card)."""
    t0 = time.perf_counter()
    st = chunk_statics(plan, ins_scale=ins_scale, rounds=rounds)
    if bufs is None:
        bufs = put_chunk_bufs(plan, device)
    with host_part("rounds"):
        job_buf, win_buf = bufs.tensors()
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


def walk_plane_bytes_for(plan: ChunkPlan, *, ins_scale, rounds: int,
                         statics: Optional[dict] = None) -> int:
    """Device bytes of the final-round planes that one decoupled chunk
    holds between its forward and its walk: budget.walk_plane_bytes at
    the final round's band width (the only round whose planes outlive
    their launch). The streaming executor admits a chunk to the decoupled
    walk against budget.walk_queue_depth."""
    st = statics if statics is not None else \
        chunk_statics(plan, ins_scale=ins_scale, rounds=rounds)
    band_w = st["band_w"]
    W = round_band_width(band_w, rounds - 1) if band_w else plan.LA
    return walk_plane_bytes(plan.B, plan.Lq, W,
                            st["nxt_k"] if band_w else 1)


def dispatch_chunk_fwd(plan: ChunkPlan, *, match: int, mismatch: int,
                       gap: int, ins_scale, rounds: int, device,
                       bufs: Optional[ChunkBufs] = None):
    """Launch a chunk's forward half (device_chunk_fwd) from ``bufs`` (or
    ship the buffers here). Returns ``(fwd_out, meta)``: the final round's
    planes and the carried state, still being computed, and ``meta`` =
    the chunk's statics plus its lane tensors (``job``), ``ins_scale`` and
    ``rounds``, which dispatch_walk needs to finish the chunk."""
    st = chunk_statics(plan, ins_scale=ins_scale, rounds=rounds)
    if bufs is None:
        bufs = put_chunk_bufs(plan, device)
    with host_part("rounds"):
        job_buf, win_buf = bufs.tensors()
        fwd_out, job = device_chunk_fwd(
            job_buf, win_buf, match=match, mismatch=mismatch, gap=gap,
            ins_scale=ins_scale, Lq=plan.Lq, n_win=plan.n_win, LA=plan.LA,
            band_w=st["band_w"], rounds=rounds, adaptive=st["adaptive"],
            nxt_k=st["nxt_k"])
    meta = dict(st, job=job, ins_scale=ins_scale, rounds=rounds)
    return fwd_out, meta


def dispatch_walk(plan: ChunkPlan, fwd_out, meta):
    """Launch the walk half of a chunk whose forward half
    dispatch_chunk_fwd launched; returns the packed output buffer (still
    being computed) for collect_chunk."""
    rounds = meta["rounds"]
    sc = meta["ins_scale"]
    scales = sc if isinstance(sc, tuple) else (sc,) * rounds
    with host_part("walk"):
        return walk_chunk_packed(
            meta["job"], *fwd_out, ins_scale=scales[-1], n_win=plan.n_win,
            LA=plan.LA, band_w=round_band_width(meta["band_w"], rounds - 1),
            rounds=rounds)


def collect_chunk(plan: ChunkPlan, packed, stats: Optional[dict] = None
                  ) -> Tuple[List[Optional[bytes]],
                             List[Optional[np.ndarray]]]:
    """Pull a chunk's packed output and unpack per window. A flagged
    window (sticky ``ovf``) yields ``None`` in both lists."""
    with host_part("collect"):
        return _collect(plan, packed, stats)


def _collect(plan: ChunkPlan, packed, stats: Optional[dict]):
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
