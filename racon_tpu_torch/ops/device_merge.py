"""Device-resident consensus merge — port of the JAX package's
``ops/device_merge.py`` (the functions the fixed-round chunk runs).

Per round: ``extract_votes_cols`` turns each lane's column-walk output
into dense anchor-aligned vote channels (``extract_votes`` does the same
from right-aligned op strings, the batched aligner's output, through the
monotone count K5, csrc/count.cu), ``aggregate_votes`` sums them
per window, ``add_backbone`` folds the anchor's own votes in,
``assemble`` votes out the consensus into a per-gap prefix layout,
``compact`` gathers it into dense per-window strings and ``coord_maps``
gives the old-anchor -> new-consensus maps that re-slice layer spans.

Numerics: every channel is float32 here. The reference emits its
integer-valued channels (one-hot counts, integer Phred weights) in
bfloat16 — exact for those values — so the float32 values are equal.
The per-window sums run in job order, one deterministic add per job
(``_Members.sum``): no atomics, so the CUDA sums do not change from run to
run, and a fractional channel (read-mean weights, crossing weights,
run-mean length weights) sums in the order a one-hot matrix product
accumulates it.

A consensus round's back half has two plain versions, each the plain
version of one kernel of csrc/merge.cu (ops/kernels.py ``merge_votes``
and ``merge_windows``): ``merge_votes_plain`` (extract_votes_cols ->
aggregate_votes, M1) returns the per-window sums as one channel-major
buffer [n_win, VOTE_CH, LA+1] (``pack_votes``; ``vote_views`` gives
aggregate_votes' dict back as views of it), and ``merge_windows_plain``
(add_backbone -> assemble -> compact -> coord_maps -> remap_state, M2)
the next round's state. ``merge_windows_sched_plain`` is the plain
version of M2's sched mode, the convergence scheduler's round merge: the
same round, and the frozen windows' final-scale outputs written into the
scheduler's accumulators.
"""

from __future__ import annotations

import torch

from racon_tpu_torch.ops.cigar import DIAG, UP, LEFT
from racon_tpu_torch.ops.flat import PAD_OP
from racon_tpu_torch.ops.flat import U_SAT as _U_SAT

# Tie-break epsilon shared with the host merge (ops/poa.py).
EPS = 1e-3
# Pileup columns per gap kept on device; longer insertion runs raise the
# walk's sat flag (U_SAT = K_INS + 1) and take the redo route.
K_INS = 10
if _U_SAT != K_INS + 1:
    raise ValueError(
        "[racon_tpu_torch::device_merge] flat.U_SAT must equal K_INS + 1 "
        f"(U_SAT={_U_SAT}, K_INS={K_INS})")
NBASE = 5          # A C G T N
_HI = 2 ** 30


def _onehot(idx, depth):
    return (idx[..., None] == torch.arange(depth, device=idx.device)).to(
        torch.float32)


def _take1(a, idx):
    """take_along_axis on axis 1 with clipping."""
    return torch.gather(a, 1, torch.clamp(idx, 0, a.shape[1] - 1))


def monotone_count_plain(X: torch.Tensor, P: int) -> torch.Tensor:
    """``F[b, p] = #{s : X[b, s] < p}``, int32 [B, P]: the broadcast
    compare-reduce of the reference's ``monotone_count_xla``, the plain
    version of K5 (csrc/count.cu)."""
    pa = torch.arange(P, dtype=X.dtype, device=X.device)
    return (X[:, :, None] < pa[None, None, :]).sum(dim=1, dtype=torch.int32)


def block_keys(ops: torch.Tensor, t_off: torch.Tensor) -> torch.Tensor:
    """The monotone block key of right-aligned ops u8 [B, S], shifted by
    t_off: int32 [B, S], the count of target columns consumed before each
    op plus t_off, and t_off - 1 for the PAD_OP prefix (it sorts below
    every real op). The count of keys below p is then the first op of the
    block that consumes anchor column p (K5's input in extract_votes)."""
    valid = ops != PAD_OP
    tcons = (valid & (ops != UP)).to(torch.int32)
    ct_excl = torch.cumsum(tcons, dim=1, dtype=torch.int32) - tcons
    X = torch.where(valid, ct_excl, -1)
    return (X + t_off.to(torch.int32)[:, None]).contiguous()


def extract_votes(ops, q, qw, w_read, lt, t_off, LA: int):
    """Per-job anchor-aligned dense vote channels from right-aligned ops.

    Args:
      ops: uint8[B, S] right-aligned (PAD_OP prefix), start->end order
        (ops/align.py::nw_align_batch's output).
      q: uint8[B, Lq] query codes; qw: f32[B, Lq] per-base weights;
      w_read: f32[B] read-mean weight; lt, t_off: int32[B] target (slice)
        lengths and slice offsets in the window anchor.
      LA: anchor padding length.

    Returns the channel dict of :func:`extract_votes_cols` (every channel
    float32), which ``aggregate_votes`` takes unchanged.

    In a global alignment the ops with the same count of target columns
    consumed so far form one block ``[insertion run at gap v][the op
    consuming column v]``, so for every anchor position p the first op of
    block v = p - t_off is a count over the lane's monotone block key:
    the monotone count K5 on a CUDA tensor, its plain version on a CPU
    tensor. Four stacked gathers then read, per column, the consuming op
    and its query base/weight, and per gap the insertion run.
    """
    # kernels imports this module's plain versions.
    from racon_tpu_torch.ops import kernels
    B, S = ops.shape
    Lq = q.shape[1]
    dev = ops.device
    i32, i64, f32 = torch.int32, torch.int64, torch.float32
    lt = lt.to(i32)
    w_read = w_read.to(f32)
    qw = qw.to(f32)
    valid = ops != PAD_OP
    qcons = valid & (ops != LEFT)
    cq_excl = torch.cumsum(qcons, dim=1, dtype=i32) - qcons.to(i32)
    F = kernels.monotone_count(block_keys(ops, t_off), LA + 2).to(i64)
    Fa = F[:, :-1]                                    # F(c) at p
    F1 = F[:, 1:]                                     # F(c+1) at p

    ltc = lt.to(i64)[:, None]
    pa = torch.arange(LA + 2, dtype=i64, device=dev)[None, :]
    c = (pa - t_off.to(i64)[:, None])[:, :-1]         # slice-rel position
    in_cols = (c >= 0) & (c < ltc)
    in_gaps = (c >= 0) & (c <= ltc)

    # Insertion run before column c: block minus its t-step (none at lt).
    ins_len = torch.where(in_gaps, F1 - Fa - (c < ltc).to(i64), 0)

    # Stacked gather #1 (op axis) at s = F[p]: the first-insertion q index
    # (at p), the column consumer's q index and op code (at p+1). S+1 rows:
    # F reaches S when an alignment's last op consumes its last column.
    ops64 = ops.to(i64)
    cq64 = cq_excl.to(i64)
    stack_s = torch.stack(
        [torch.cat([cq64, cq64[:, -1:]], dim=1),
         torch.cat([cq64[:, :1], cq64], dim=1),
         torch.cat([ops64[:, :1], ops64], dim=1)], dim=-1)   # [B, S+1, 3]
    G = torch.gather(stack_s, 1,
                     torch.clamp(F, 0, S)[:, :, None].expand(-1, -1, 3))
    qstart = G[:, :-1, 0]
    qi = G[:, 1:, 1]
    op_at = G[:, 1:, 2]
    is_match = in_cols & (op_at == DIAG)

    # Stacked gather #2 (query axis) at qi: base code and weight.
    qx = q.to(i64)
    stack_qi = torch.stack([qx.to(f32), qw], dim=-1)
    Gqi = torch.gather(stack_qi, 1, torch.clamp(qi, 0, Lq - 1)[:, :, None]
                       .expand(-1, -1, 2))
    colbase = Gqi[..., 0].to(i64)
    colw = Gqi[..., 1]
    wq = torch.where(is_match, colw, w_read[:, None])

    cols = in_cols[:, :LA]
    base_idx = torch.where(is_match[:, :LA], colbase[:, :LA], NBASE)
    col_w = torch.where(cols, torch.where(is_match[:, :LA], colw[:, :LA],
                                          w_read[:, None]), 0.0)
    col_oh = _onehot(base_idx, NBASE + 1)
    col_w_ch = col_oh * col_w[..., None]                       # [B, LA, 6]
    col_c_ch = col_oh[..., :NBASE] * (is_match[:, :LA] &
                                      cols)[..., None].to(f32)  # [B, LA, 5]

    crossed = (c >= 1) & (c <= ltc - 1) & (ins_len == 0)
    wq_prev = torch.cat([w_read[:, None], wq[:, :LA]], dim=1)
    cross_w = torch.where(crossed, 0.5 * (wq_prev + wq), 0.0)  # [B, LA+1]

    # Stacked gather #3 (query axis) at qstart: the K_INS shifted base and
    # weight channels plus the weight prefix sum at the run start.
    qwcum = torch.cat([torch.zeros((B, 1), dtype=f32, device=dev),
                       torch.cumsum(qw, dim=1)], dim=1)
    qx_pad = torch.cat([qx, qx[:, -1:].expand(B, K_INS - 1)], dim=1)
    qw_pad = torch.cat([qw, qw[:, -1:].expand(B, K_INS - 1)], dim=1)
    chans = ([qx_pad[:, k:k + Lq].to(f32) for k in range(K_INS)] +
             [qw_pad[:, k:k + Lq] for k in range(K_INS)] + [qwcum[:, :Lq]])
    stack_qs = torch.stack(chans, dim=-1)             # [B, Lq, 2K+1]
    Gqs = torch.gather(stack_qs, 1, torch.clamp(qstart, 0, Lq - 1)[:, :, None]
                       .expand(-1, -1, 2 * K_INS + 1))
    b_k = Gqs[..., :K_INS].to(i64)
    w_k = Gqs[..., K_INS:2 * K_INS]
    cum_start = Gqs[..., 2 * K_INS]

    has1 = in_gaps & (ins_len == 1)
    multi = in_gaps & (ins_len >= 2)
    w1 = w_k[..., 0]
    ins1_oh = _onehot(torch.where(has1, b_k[..., 0], NBASE),
                      NBASE + 1)[..., :NBASE]
    ins1_w_ch = ins1_oh * torch.where(has1, w1, 0.0)[..., None]
    ins1_c_ch = ins1_oh * has1[..., None].to(f32)
    ins1_stop = torch.where(has1, w1, 0.0)

    pk_w, pk_c = [], []
    for k in range(K_INS):
        inrun = multi & (ins_len > k)
        oh = _onehot(torch.where(inrun, b_k[..., k], NBASE),
                     NBASE + 1)[..., :NBASE]
        pk_w.append(oh * torch.where(inrun, w_k[..., k], 0.0)[..., None])
        pk_c.append(oh * inrun[..., None].to(f32))
    pile_w_ch = torch.stack(pk_w, dim=2)              # [B, LA+1, K, 5]
    pile_c_ch = torch.stack(pk_c, dim=2)

    # Run mean weight -> stop-weight by run length (lengths 2..K_INS);
    # stacked gather #4: the weight prefix sum at the run end.
    run_sum = _take1(qwcum, qstart + ins_len) - cum_start
    wmean = torch.where(multi, run_sum / torch.clamp(ins_len, min=1), 0.0)
    lw_oh = (torch.clamp(ins_len, 0, K_INS)[..., None] ==
             torch.arange(2, K_INS + 1, device=dev)[None, None, :])
    lenw_ch = lw_oh.to(f32) * (wmean * multi)[..., None]  # [B, LA+1, K-1]

    return {
        "col_w": col_w_ch, "col_c": col_c_ch,
        "cross_w": cross_w[..., None],
        "ins1_w": ins1_w_ch, "ins1_c": ins1_c_ch,
        "ins1_stop": ins1_stop[..., None],
        "pile_w": pile_w_ch.reshape(B, LA + 1, -1),
        "pile_c": pile_c_ch.reshape(B, LA + 1, -1),
        "lenw": lenw_ch,
    }


def extract_votes_cols(cols, q, qw8, w_read, lt, t_off, LA: int):
    """Per-job anchor-aligned dense vote channels from column-walk output.

    Args:
      cols: dict from colwalk.col_walk ([B, LA+2] int16 arrays).
      q: uint8[B, Lq] query codes.
      qw8: uint8[B, Lq] encoded weights (value + 1, 0 = padding).
      w_read: f32[B] read-mean weight; lt, t_off: int32[B].

    The query window around each insertion run start ships as four
    packed words per query position (11 base codes at 3 bits, 11 weights
    at 7 bits), exactly as the reference lays them out.
    """
    B, Lq = q.shape
    dev = q.device
    i64, f32 = torch.int64, torch.float32
    ltc = lt.to(i64)[:, None]
    pa = torch.arange(LA + 1, dtype=i64, device=dev)[None, :]
    c = pa - t_off.to(i64)[:, None]
    in_cols = (c >= 0) & (c < ltc)
    in_gaps = (c >= 0) & (c <= ltc)
    w_read = w_read.to(f32)

    ins_len = torch.where(in_gaps, cols["ins_len"][:, :LA + 1].to(i64), 0)
    op_at = cols["op_c"][:, 1:].to(i64)
    qi = cols["qi_c"][:, 1:].to(i64)
    is_match = in_cols & (op_at == DIAG)

    QO = K_INS + 1
    qpad = torch.cat([q, q[:, -1:].expand(B, QO)], dim=1).to(i64)
    wpad = torch.clamp(torch.cat([qw8, qw8[:, -1:].expand(B, QO)], dim=1)
                       .to(i64), max=127)
    word0 = sum(qpad[:, o:o + Lq] << (3 * o) for o in range(10))
    word1 = sum(wpad[:, o:o + Lq] << (7 * o) for o in range(4)) \
        + (qpad[:, 10:10 + Lq] << 28)
    word2 = sum(wpad[:, o:o + Lq] << (7 * (o - 4)) for o in range(4, 8))
    word3 = sum(wpad[:, o:o + Lq] << (7 * (o - 8)) for o in range(8, 11))
    stack = torch.stack([word0, word1, word2, word3], dim=-1)
    qs_full = cols["qstart"].to(i64)                  # [B, LA+2]
    qsc_full = torch.clamp(qs_full, 0, Lq - 1)
    s0_full = torch.clamp(qsc_full - 1, min=0)
    Gfull = torch.gather(stack, 1, s0_full[:, :, None].expand(-1, -1, 4))
    Gg = Gfull[:, :LA + 1]                            # gap rows (step p)

    def _q_at(g, o):
        if o == 10:
            return (g[..., 1] >> 28) & 7
        return (g[..., 0] >> (3 * o)) & 7

    def _w_at(g, o):
        w, s = divmod(o, 4)
        raw = (g[..., 1 + w] >> (7 * s)) & 127
        return torch.clamp(raw.to(f32) - 1.0, min=0.0)

    o1 = (qsc_full - s0_full)[:, :LA + 1] == 1

    def sel_q(o):
        return torch.where(o1, _q_at(Gg, o + 1), _q_at(Gg, o))

    def sel_w(o):
        return torch.where(o1, _w_at(Gg, o + 1), _w_at(Gg, o))

    Gc = Gfull[:, 1:]                                 # column rows (p+1)
    qi1 = (torch.clamp(qi, 0, Lq - 1) - s0_full[:, 1:]) == 1
    colbase = torch.where(qi1, _q_at(Gc, 1), _q_at(Gc, 0))
    colw = torch.where(qi1, _w_at(Gc, 1), _w_at(Gc, 0))
    wq = torch.where(is_match, colw, w_read[:, None])

    cols_m = in_cols[:, :LA]
    base_idx = torch.where(is_match[:, :LA], colbase[:, :LA], NBASE)
    col_w = torch.where(cols_m, torch.where(is_match[:, :LA], colw[:, :LA],
                                            w_read[:, None]), 0.0)
    col_oh = _onehot(base_idx, NBASE + 1)
    col_w_ch = col_oh * col_w[..., None]                       # [B, LA, 6]
    col_c_ch = col_oh[..., :NBASE] * (is_match[:, :LA] &
                                      cols_m)[..., None].to(f32)

    crossed = (c >= 1) & (c <= ltc - 1) & (ins_len == 0)
    wq_prev = torch.cat([w_read[:, None], wq[:, :LA]], dim=1)
    cross_w = torch.where(crossed, 0.5 * (wq_prev + wq), 0.0)  # [B, LA+1]

    has1 = in_gaps & (ins_len == 1)
    multi = in_gaps & (ins_len >= 2)
    w1 = sel_w(0)
    ins1_oh = _onehot(torch.where(has1, sel_q(0), NBASE),
                      NBASE + 1)[..., :NBASE]
    ins1_w_ch = ins1_oh * torch.where(has1, w1, 0.0)[..., None]
    ins1_c_ch = ins1_oh * has1[..., None].to(f32)
    ins1_stop = torch.where(has1, w1, 0.0)

    pk_w, pk_c = [], []
    for k in range(K_INS):
        inrun = multi & (ins_len > k)
        oh = _onehot(torch.where(inrun, sel_q(k), NBASE),
                     NBASE + 1)[..., :NBASE]
        pk_w.append(oh * torch.where(inrun, sel_w(k), 0.0)[..., None])
        pk_c.append(oh * inrun[..., None].to(f32))
    pile_w_ch = torch.stack(pk_w, dim=2)              # [B, LA+1, K, 5]
    pile_c_ch = torch.stack(pk_c, dim=2)

    run_sum = sum(torch.where(ins_len > k, sel_w(k), 0.0)
                  for k in range(K_INS))
    wmean = torch.where(multi, run_sum / torch.clamp(ins_len, min=1), 0.0)
    lw_oh = (torch.clamp(ins_len, 0, K_INS)[..., None] ==
             torch.arange(2, K_INS + 1, device=dev)[None, None, :])
    lenw_ch = lw_oh.to(f32) * (wmean * multi)[..., None]  # [B, LA+1, K-1]

    return {
        "col_w": col_w_ch, "col_c": col_c_ch,
        "cross_w": cross_w[..., None],
        "ins1_w": ins1_w_ch, "ins1_c": ins1_c_ch,
        "ins1_stop": ins1_stop[..., None],
        "pile_w": pile_w_ch.reshape(B, LA + 1, -1),
        "pile_c": pile_c_ch.reshape(B, LA + 1, -1),
        "lenw": lenw_ch,
    }


class _Members:
    """Window membership of a chunk's lanes in job order: for window w,
    ``table[w, r]`` is the index of its r-th job (lanes whose window id
    lies outside [0, n_win) — the padded lanes — belong to none)."""

    def __init__(self, win, n_win: int):
        dev = win.device
        w = win.to(torch.int64)
        valid = (w >= 0) & (w < n_win)
        order = torch.argsort(torch.where(valid, w, n_win), stable=True)
        counts = torch.bincount(w[valid], minlength=n_win)[:n_win]
        starts = torch.cumsum(counts, 0) - counts
        self.maxc = int(counts.max().item()) if n_win else 0
        r = torch.arange(max(self.maxc, 1), device=dev)
        self.mask = r[None, :] < counts[:, None]               # [Nw, R]
        pos = torch.clamp(starts[:, None] + r[None, :], max=max(
            len(order) - 1, 0))
        self.table = order[pos] if len(order) else pos
        self.n_win = n_win

    def sum(self, x):
        """Per-window sums of ``x`` [B, ...] -> [n_win, ...], one add per
        job in job order."""
        acc = torch.zeros((self.n_win,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        bshape = (self.n_win,) + (1,) * (x.dim() - 1)
        for r in range(self.maxc):
            v = x[self.table[:, r]]
            acc = acc + torch.where(self.mask[:, r].reshape(bshape), v, 0.0)
        return acc


def aggregate_votes(votes, win, n_win: int, extras=None):
    """Sum per-job channels into per-window accumulators. ``extras``:
    optional dict of per-job [B] scalars summed per window alike."""
    mem = _Members(win, n_win)
    out = {}
    if extras:
        for k, v in extras.items():
            out[k] = mem.sum(v.to(torch.float32))
    out["base_w"] = mem.sum(votes["col_w"])            # [Nw, LA, 6]
    out["base_c"] = mem.sum(votes["col_c"])            # [Nw, LA, 5]
    out["direct_w"] = mem.sum(votes["cross_w"])[..., 0]
    out["ins1_w"] = mem.sum(votes["ins1_w"])
    out["ins1_c"] = mem.sum(votes["ins1_c"])
    out["ins1_stop"] = mem.sum(votes["ins1_stop"])[..., 0]
    pw = mem.sum(votes["pile_w"])
    pc = mem.sum(votes["pile_c"])
    out["pile_w"] = pw.reshape(pw.shape[0], pw.shape[1], K_INS, NBASE)
    out["pile_c"] = pc.reshape(pc.shape[0], pc.shape[1], K_INS, NBASE)
    out["lenw"] = mem.sum(votes["lenw"])
    return out


def aggregate_flags(flags, win, n_win: int):
    """Per-window sums of one per-job scalar (exact for 0/1 flags)."""
    return _Members(win, n_win).sum(flags.to(torch.float32))


def converged_windows(codes, total, bb_old, alen_old, wchg):
    """Per-window fixed-point predicate: this round reproduced its own
    input anchor (same length and bytes) and no lane span moved."""
    return (total == alen_old) & (wchg == 0) & \
        torch.all(codes == bb_old, dim=1)


def add_backbone(acc, bb, bbw, alen):
    """Fold the backbone's votes in (sequence 0, epsilon tie-break)."""
    Nw, LA = bb.shape
    dev = bb.device
    p = torch.arange(LA, device=dev)[None, :]
    vcol = p < alen[:, None]
    oh = _onehot(bb.to(torch.int64), NBASE + 1)[..., :NBASE]
    base_w = acc["base_w"].clone()
    base_w[..., :NBASE] = base_w[..., :NBASE] + \
        oh * torch.where(vcol, bbw + EPS, 0.0)[..., None]
    acc["base_w"] = base_w
    acc["base_c"] = acc["base_c"] + oh * vcol[..., None].to(torch.float32)
    bw0 = bbw[:, :1]
    bwl = _take1(bbw, torch.clamp(alen - 1, min=0).to(torch.int64)[:, None])
    left = torch.cat([bw0, bbw], dim=1)
    right = torch.cat([bbw, bwl], dim=1)
    pg = torch.arange(LA + 1, device=dev)[None, :]
    at_end = pg == alen[:, None]
    right = torch.where(at_end, bwl, right)
    left = torch.where(at_end, bwl, left)
    vgap = pg <= alen[:, None]
    cross = 0.5 * (left + right)
    acc["direct_w"] = acc["direct_w"] + torch.where(vgap, cross + EPS, 0.0)
    return acc


def assemble(acc, alen, ins_scale: float):
    """Vote out consensus into a per-gap prefix layout + coordinate maps
    (see the JAX package's docstring for the returned fields)."""
    base_w, base_c = acc["base_w"], acc["base_c"]
    Nw, LA, _ = base_c.shape
    dev = base_w.device
    i32 = torch.int32
    p = torch.arange(LA, device=dev)[None, :]
    vcol = p < alen[:, None]
    pg = torch.arange(LA + 1, device=dev)[None, :]
    vgap = pg <= alen[:, None]

    best_code = torch.argmax(base_w[..., :NBASE], dim=-1)
    best_w = torch.gather(base_w[..., :NBASE], -1, best_code[..., None])[..., 0]
    del_w = base_w[..., NBASE]
    kept = vcol & (del_w <= best_w)
    cov = torch.gather(base_c, -1, best_code[..., None])[..., 0]

    stopped = acc["direct_w"] * ins_scale
    emit_prev = vgap
    ins_codes, ins_cnt = [], []
    e = torch.zeros((Nw, LA + 1), dtype=i32, device=dev)
    for k in range(K_INS):
        cw = acc["pile_w"][:, :, k, :]
        cc = acc["pile_c"][:, :, k, :]
        if k == 0:
            cw = cw + acc["ins1_w"]
            cc = cc + acc["ins1_c"]
        tot = torch.sum(cw, dim=-1)
        em = emit_prev & (tot > stopped)
        bk = torch.argmax(cw, dim=-1)
        ck = torch.gather(cc, -1, bk[..., None])[..., 0]
        ins_codes.append(bk.to(i32))
        ins_cnt.append(ck.to(i32))
        e = e + em.to(i32)
        emit_prev = em
        if k == 0:
            stopped = stopped + acc["ins1_stop"]
        if k + 1 >= 2 and (k + 1) - 2 < acc["lenw"].shape[-1]:
            stopped = stopped + acc["lenw"][..., (k + 1) - 2]

    ins_codes = torch.stack(ins_codes, dim=2)         # [Nw, LA+1, K]
    ins_cnt = torch.stack(ins_cnt, dim=2)
    ulen = e + torch.cat([kept.to(i32),
                          torch.zeros((Nw, 1), dtype=i32, device=dev)], 1)
    cum_u = torch.cumsum(ulen, dim=1, dtype=i32)
    start = cum_u - ulen
    total = cum_u[:, -1]
    pos = start[:, :LA] + e[:, :LA]
    return {
        "ins_codes": ins_codes,
        "ins_cnt": ins_cnt,
        "e": e,
        "col_code": best_code.to(i32),
        "col_cov": cov.to(i32),
        "start": start,
        "total": total,
        "pos": pos,
        "kept": kept,
    }


def compact(asm, out_len: int):
    """Gather-based compaction of the per-gap prefix layout. Returns
    (codes u8 [Nw, out_len], cov i32 [Nw, out_len], total i32[Nw]);
    positions beyond ``total`` hold 0."""
    start, e, total = asm["start"], asm["e"], asm["total"]
    Nw, LA1 = start.shape
    dev = start.device
    i64 = torch.int64
    jj = torch.arange(out_len, dtype=start.dtype, device=dev)
    # Unit of output position j: #{p : start[p] <= j} - 1 (start is
    # non-decreasing, so a right-sided search counts it).
    g = torch.searchsorted(start.contiguous(),
                           jj[None, :].expand(Nw, -1).contiguous(),
                           right=True).to(i64) - 1
    off = jj[None, :].to(i64) - _take1(start, g).to(i64)
    eg = _take1(e, g).to(i64)
    is_ins = off < eg
    K = asm["ins_codes"].shape[2]
    flat_i = g * K + torch.clamp(off, max=K - 1)
    ins_code = _take1(asm["ins_codes"].reshape(Nw, LA1 * K), flat_i)
    ins_cov = _take1(asm["ins_cnt"].reshape(Nw, LA1 * K), flat_i)
    gc = torch.clamp(g, max=LA1 - 2)
    col_code = _take1(asm["col_code"], gc)
    col_cov = _take1(asm["col_cov"], gc)
    live = jj[None, :] < total[:, None]
    codes = torch.where(live, torch.where(is_ins, ins_code, col_code), 0)
    cov = torch.where(live, torch.where(is_ins, ins_cov, col_cov), 0)
    return codes.to(torch.uint8), cov, total


def coord_maps(asm, alen, LA: int):
    """map_b / map_e: for every old-anchor position, the landing position
    of the nearest kept column at-or-after / at-or-before it (falling
    back to the last / first kept column, 0 when none are kept)."""
    kept, pos = asm["kept"], asm["pos"]
    posk = torch.where(kept, pos, _HI)
    map_b = torch.flip(torch.cummin(torch.flip(posk, [1]), 1).values, [1])
    posk2 = torch.where(kept, pos, -_HI)
    map_e = torch.cummax(posk2, 1).values
    any_kept = torch.any(kept, dim=1, keepdim=True)
    last_kept = torch.max(posk2, dim=1, keepdim=True).values
    first_kept = torch.min(posk, dim=1, keepdim=True).values
    map_b = torch.where(map_b == _HI, last_kept, map_b)
    map_e = torch.where(map_e == -_HI, first_kept, map_e)
    map_b = torch.where(any_kept, map_b, 0)
    map_e = torch.where(any_kept, map_e, 0)
    hi = torch.clamp(asm["total"][:, None] - 1, min=0)
    map_b = torch.minimum(torch.clamp(map_b, min=0), hi)
    map_e = torch.minimum(torch.clamp(map_e, min=0), hi)
    return map_b.to(torch.int32), map_e.to(torch.int32)


# ------------------------------------------------------------ round merge

# aggregate_votes' channels, in the order of the per-gap channel axis of
# the buffer M1 (csrc/merge.cu) writes: (name, channels a gap). base_w
# and base_c hold LA columns; their entry at gap LA is 0.
VOTE_CHANNELS = (("base_w", NBASE + 1), ("base_c", NBASE), ("direct_w", 1),
                 ("ins1_w", NBASE), ("ins1_c", NBASE), ("ins1_stop", 1),
                 ("pile_w", K_INS * NBASE), ("pile_c", K_INS * NBASE),
                 ("lenw", K_INS - 1))
VOTE_CH = sum(n for _, n in VOTE_CHANNELS)


def pack_votes(acc) -> torch.Tensor:
    """aggregate_votes' dict as one channel-major float32 buffer
    [n_win, VOTE_CH, LA+1] (a copy)."""
    n, LA1 = acc["direct_w"].shape
    parts = []
    for name, width in VOTE_CHANNELS:
        x = acc[name].reshape(n, -1, width)
        if x.shape[1] != LA1:
            x = torch.cat([x, x.new_zeros((n, LA1 - x.shape[1], width))], 1)
        parts.append(x)
    return torch.cat(parts, dim=2).permute(0, 2, 1).contiguous()


def vote_views(votes: torch.Tensor) -> dict:
    """aggregate_votes' dict as views of a [n_win, VOTE_CH, LA+1] buffer."""
    LA = votes.shape[2] - 1
    out, o = {}, 0
    for name, width in VOTE_CHANNELS:
        x = votes[:, o:o + width].permute(0, 2, 1)
        o += width
        if name in ("base_w", "base_c"):
            x = x[:, :LA]
        if width == 1:
            x = x[..., 0]
        if name in ("pile_w", "pile_c"):
            x = x.unflatten(-1, (K_INS, NBASE))
        out[name] = x
    return out


def window_members(win, n_win: int):
    """The window membership of a chunk's lanes as device tensors, with no
    host sync: ``(order, starts, counts)`` int32, where order lists the
    lanes by window, in job order within one (lanes whose window id lies
    outside [0, n_win), the padded lanes, last), and window w's lanes are
    ``order[starts[w]:starts[w] + counts[w]]``. M1 and M2 loop over their
    own window's count."""
    w = win.to(torch.int64)
    key = torch.where((w >= 0) & (w < n_win), w, n_win)
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(n_win + 1, dtype=torch.int64,
                         device=win.device).scatter_add_(
        0, key, torch.ones_like(key))[:n_win]
    starts = torch.cumsum(counts, 0) - counts
    i32 = torch.int32
    return order.to(i32), starts.to(i32), counts.to(i32)


def merge_votes_plain(cols, q, qw8, w_read, lt, t_off, esc_w, win, *,
                      n_win: int, LA: int):
    """The plain version of M1: ``extract_votes_cols`` then
    ``aggregate_votes`` (with the per-window escape sums). Returns
    ``(votes f32 [n_win, VOTE_CH, LA+1], wesc f32 [n_win])``."""
    acc = aggregate_votes(
        extract_votes_cols(cols, q, qw8, w_read, lt, t_off, LA), win, n_win,
        extras={"_esc": esc_w})
    wesc = acc.pop("_esc")
    return pack_votes(acc), wesc


def remap_state(codes, total, map_b, map_e, bb, alen, begin, end, win,
                LA: int):
    """Next-round anchors (dummy row re-appended) and spans remapped
    through the merge's coordinate maps. Lanes of window n_win (the
    padded lanes) read window n_win - 1's maps."""
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


def _windows_plain(votes, wesc, bb, bbw, alen, begin, end, win, ovf, *,
                   ins_scale: float, n_win: int, LA: int, detect: bool):
    """merge_windows_plain's body; also returns the folded sums and the
    sticky flag before this round's assembly (``ovf_pre``)."""
    acc = add_backbone(vote_views(votes), bb[:-1], bbw[:-1], alen[:-1])
    asm = assemble(acc, alen[:-1], ins_scale)
    codes, cov, total = compact(asm, LA)
    map_b, map_e = coord_maps(asm, alen[:-1], LA)
    new_bb, new_alen, nb, ne = remap_state(
        codes, total, map_b, map_e, bb, alen, begin, end, win, LA)
    new_bbw = torch.zeros_like(bbw)
    ovf_pre = ovf | (wesc > 0)
    if detect:
        chg = ((nb != begin) | (ne != end)).to(torch.float32)
        wchg = aggregate_flags(chg, win, n_win)
        conv = converged_windows(codes, total, bb[:-1], alen[:-1], wchg)
    else:
        conv = torch.zeros(n_win, dtype=torch.bool, device=bb.device)
    out = (new_bb, new_bbw, new_alen, nb, ne, cov, ovf_pre | (total > LA),
           conv)
    return out, acc, ovf_pre


def merge_windows_plain(votes, wesc, bb, bbw, alen, begin, end, win, ovf, *,
                        ins_scale: float, n_win: int, LA: int,
                        detect: bool = False):
    """The plain version of M2: add_backbone -> assemble -> compact ->
    coord_maps -> remap_state over M1's sums, and with ``detect`` the
    per-window fixed-point predicate. bb/bbw/alen carry the dummy row
    (n_win + 1 rows). Returns (new_bb, new_bbw, new_alen, new_begin,
    new_end, cov, ovf, conv)."""
    return _windows_plain(votes, wesc, bb, bbw, alen, begin, end, win, ovf,
                          ins_scale=ins_scale, n_win=n_win, LA=LA,
                          detect=detect)[0]


def merge_windows_sched_plain(votes, wesc, bb, bbw, alen, begin, end, win,
                              ovf, orig_ids, out, *, ins_scale: float,
                              scale_final: float, last: bool, n_win: int,
                              LA: int, detect: bool = False):
    """The plain version of M2's sched mode, the convergence scheduler's
    round merge (the reference's sched/rounds.py ``_sched_core`` and the
    scatter of ``sched_rounds``): merge_windows_plain's round, and for
    every window that freezes (converged, flagged or ``last``) the dual
    assembly — the same sums assembled and compacted at ``scale_final`` —
    written into row ``orig_ids[w]`` of the scheduler's output
    accumulators ``out`` = (codes u8 [R+1, LA], cov i32 [R+1, LA], total
    i32 [R+1], ovf bool [R+1]), in place. Row R is the trash row of the
    windows with no output row (padding after a repack): nothing is
    written there. The written length is clip(total_f, 1, LA); the flag
    the final-scale one when ``last`` (the fixed engine's last round runs
    no base-scale assembly), else the carried flag with the final-scale
    overflow. Returns merge_windows_plain's tuple."""
    res, acc, ovf_pre = _windows_plain(
        votes, wesc, bb, bbw, alen, begin, end, win, ovf,
        ins_scale=ins_scale, n_win=n_win, LA=LA, detect=detect)
    ovf_new, conv = res[6], res[7]
    codes_f, cov_f, total_f = compact(
        assemble(acc, alen[:-1], scale_final), LA)
    ovf_f = ovf_pre | (total_f > LA)
    out_codes, out_cov, out_total, out_ovf = out
    sel = (conv | ovf_new | bool(last)) & \
        (orig_ids < out_codes.shape[0] - 1)
    rows = orig_ids[sel].long()
    out_codes[rows] = codes_f[sel]
    out_cov[rows] = cov_f[sel]
    out_total[rows] = torch.clamp(total_f, 1, LA)[sel].to(out_total.dtype)
    out_ovf[rows] = (ovf_f if last else ovf_new | (total_f > LA))[sel]
    return res
