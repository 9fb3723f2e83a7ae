"""A numpy model of the two merge kernels of csrc/merge.cu, in float32.

M1 (``model_votes``): for each window and each gap p, the window's jobs
in job order, each adding only its nonzero contributions at p (at most
one a channel), computed from the walk's entries at p and p+1 and the
query bytes they point at; every float32 operation rounds once, as the
kernel's __fadd_rn / __fmul_rn / __fdiv_rn do. The adds run over all
gaps of a job at once (the gaps are independent), but a gap's sums see
the same adds in the same order as the kernel's thread for that gap.

M2 (``model_windows``): for each window, the backbone fold and the
vote-out of each gap, an exclusive scan of the emitted lengths, a
scatter of each gap's insertions and kept column into the compacted row,
a suffix-min and a prefix-max scan of the kept columns' positions for the
coordinate maps, and the remap of the window's lanes (the padded lanes
with the last window).

``edge_windows`` builds windows (with the port's Window) whose chunk
holds the cases the kernels branch on: a window with one layer, one with
none, partial layer spans, an insertion run longer than K_INS and a
window whose consensus outgrows the chunk's anchor width.
"""

import numpy as np

from racon_tpu_torch.models.window import Window, WindowType
from racon_tpu_torch.ops.device_merge import (EPS, K_INS, NBASE,
                                              VOTE_CHANNELS, VOTE_CH)
from racon_tpu_torch.ops.encode import decode_bases

F32 = np.float32
CH = {}
_o = 0
for _name, _width in VOTE_CHANNELS:
    CH[_name] = _o
    _o += _width
HI = 1 << 30


def members(win, n_win):
    """Window w's lanes in job order, and the padded lanes (window id
    outside [0, n_win)) in job order."""
    win = np.asarray(win)
    real = [np.flatnonzero(win == w) for w in range(n_win)]
    pad = np.flatnonzero((win < 0) | (win >= n_win))
    return real, pad


def _weight(wq8, i, Lq):
    raw = np.minimum(wq8[np.minimum(i, Lq - 1)].astype(np.int64), 127)
    return np.maximum(raw.astype(F32) - F32(1.0), F32(0.0)).astype(F32)


def _base(q, i, Lq):
    return q[np.minimum(i, Lq - 1)].astype(np.int64) & 7


def _column_index(qstart, qi, Lq):
    qsc = np.clip(qstart, 0, Lq - 1)
    s0 = np.maximum(qsc - 1, 0)
    qic = np.clip(qi, 0, Lq - 1)
    return s0 + (qic - s0 == 1)


def _add(acc, ch, pred, v):
    """acc[ch, p] += v[p] where pred[p] and v[p] != 0 (one rounding)."""
    v = np.broadcast_to(np.asarray(v, F32), pred.shape)
    m = pred & (v != 0)
    acc[ch, m] = (acc[ch, m] + v[m]).astype(F32)


def job_votes(acc, walk, q, qw8, w_read, lt, t_off, LA):
    """Add one job's nonzero contributions at every gap into acc [VOTE_CH,
    LA+1]. walk: int [LA+2, 4] (ins_len, qstart, op_c, qi_c)."""
    Lq = len(q)
    p = np.arange(LA + 1)
    g0 = walk[:LA + 1].astype(np.int64)
    g1 = walk[1:LA + 2].astype(np.int64)
    c = p - int(t_off)
    L = int(lt)
    in_gaps = (c >= 0) & (c <= L)
    in_cols = (c >= 0) & (c < L)
    ins = np.where(in_gaps, g0[:, 0], 0)
    wr = F32(w_read)

    match = in_cols & (g1[:, 2] == 0)
    idx = _column_index(g1[:, 1], g1[:, 3], Lq)
    code = np.where(match, _base(q, idx, Lq), NBASE)
    wq = np.where(match, _weight(qw8, idx, Lq), wr).astype(F32)
    col = (p < LA) & in_cols
    for b in range(NBASE + 1):
        _add(acc, CH["base_w"] + b, col & (code == b), wq)
        if b < NBASE:
            _add(acc, CH["base_c"] + b, col & match & (code == b), 1.0)

    crossed = (c >= 1) & (c <= L - 1) & (ins == 0)
    prev_match = (p >= 1) & (c - 1 < L) & (g0[:, 2] == 0)
    wprev = np.where(prev_match, _weight(
        qw8, _column_index(g0[:, 1], g0[:, 3], Lq), Lq), wr).astype(F32)
    cross = (F32(0.5) * (wprev + wq).astype(F32)).astype(F32)
    _add(acc, CH["direct_w"], crossed, cross)

    qs = np.clip(g0[:, 1], 0, Lq - 1)
    has1 = ins == 1
    b1 = _base(q, qs, Lq)
    w1 = _weight(qw8, qs, Lq)
    for b in range(NBASE):
        _add(acc, CH["ins1_w"] + b, has1 & (b1 == b), w1)
        _add(acc, CH["ins1_c"] + b, has1 & (b1 == b), 1.0)
    _add(acc, CH["ins1_stop"], has1, w1)

    multi = ins >= 2
    m = np.minimum(ins, K_INS)
    run = np.zeros(LA + 1, F32)
    for k in range(K_INS):
        inrun = multi & (k < m)
        bk = _base(q, qs + k, Lq)
        wk = _weight(qw8, qs + k, Lq)
        for b in range(NBASE):
            ch = NBASE * k + b
            _add(acc, CH["pile_w"] + ch, inrun & (bk == b), wk)
            _add(acc, CH["pile_c"] + ch, inrun & (bk == b), 1.0)
        run = np.where(inrun, (run + wk).astype(F32), run).astype(F32)
    wmean = (run / np.maximum(ins, 1).astype(F32)).astype(F32)
    for ln in range(2, K_INS + 1):
        _add(acc, CH["lenw"] + ln - 2, multi & (m == ln), wmean)


def model_votes(walk, q, qw8, w_read, lt, t_off, esc_w, win, n_win, LA):
    """M1's outputs: (votes f32 [n_win, VOTE_CH, LA+1], wesc f32
    [n_win]). walk: int [B, LA+2, 4]."""
    real, _ = members(win, n_win)
    votes = np.zeros((n_win, VOTE_CH, LA + 1), F32)
    wesc = np.zeros(n_win, F32)
    for w, jobs in enumerate(real):
        for j in jobs:
            job_votes(votes[w], walk[j], q[j], qw8[j], w_read[j], lt[j],
                      t_off[j], LA)
            wesc[w] = F32(wesc[w] + F32(esc_w[j]))
    return votes, wesc


def _first_max(v):
    best = 0
    for i in range(1, len(v)):
        if v[i] > v[best]:
            best = i
    return best


def window_state(votes_w, bb, bbw, al, LA, ins_scale):
    """M2's vote-out of one window: per gap (e, kept, column code, column
    coverage, insertion codes, insertion counts)."""
    v = votes_w
    eps = F32(EPS)
    scale = F32(ins_scale)
    bwl = bbw[min(max(al - 1, 0), LA - 1)]
    out = []
    for p in range(LA + 1):
        dw = v[CH["direct_w"], p]
        if p <= al:
            left = bbw[0] if p == 0 else bbw[p - 1]
            right = bbw[p] if p < LA else bwl
            if p == al:
                left = right = bwl
            dw = F32(dw + F32(F32(F32(0.5) * F32(left + right)) + eps))
        kept, best, ccov = False, 0, 0
        if p < LA:
            bw = v[CH["base_w"]:CH["base_w"] + NBASE + 1, p].copy()
            bc = v[CH["base_c"]:CH["base_c"] + NBASE, p].copy()
            code = int(bb[p])
            if p < al and code < NBASE:
                bw[code] = F32(bw[code] + F32(bbw[p] + eps))
                bc[code] = F32(bc[code] + F32(1.0))
            best = _first_max(bw[:NBASE])
            kept = p < al and bw[NBASE] <= bw[best]
            ccov = int(bc[best])
        stopped = F32(dw * scale)
        emit = p <= al
        e, codes, cnts = 0, [], []
        for k in range(K_INS):
            if not emit:
                break
            cw = v[CH["pile_w"] + NBASE * k:CH["pile_w"] + NBASE * (k + 1), p]
            cc = v[CH["pile_c"] + NBASE * k:CH["pile_c"] + NBASE * (k + 1), p]
            if k == 0:
                cw = (cw + v[CH["ins1_w"]:CH["ins1_w"] + NBASE, p]).astype(F32)
                cc = (cc + v[CH["ins1_c"]:CH["ins1_c"] + NBASE, p]).astype(F32)
            tot = cw[0]
            for i in range(1, NBASE):
                tot = F32(tot + cw[i])
            emit = tot > stopped
            bk = _first_max(cw)
            codes.append(bk)
            cnts.append(int(cc[bk]))
            e += int(emit)
            if k == 0:
                stopped = F32(stopped + v[CH["ins1_stop"], p])
            if k >= 1:
                stopped = F32(stopped + v[CH["lenw"] + k - 1, p])
        out.append((e, kept, best, ccov, codes, cnts))
    return out


def model_windows(votes, wesc, bb, bbw, alen, begin, end, win, ovf, *,
                  ins_scale, n_win, LA, detect):
    """M2's outputs, as numpy arrays: (new_bb, new_bbw, new_alen, nb, ne,
    cov, ovf, conv)."""
    real, pad = members(win, n_win)
    B = len(begin)
    new_bb = np.zeros((n_win + 1, LA), np.uint8)
    new_bb[n_win] = bb[n_win]
    new_alen = np.zeros(n_win + 1, np.int32)
    new_alen[n_win] = alen[n_win]
    nb = np.zeros(B, np.int32)
    ne = np.zeros(B, np.int32)
    cov = np.zeros((n_win, LA), np.int32)
    ovf_out = np.zeros(n_win, bool)
    conv = np.zeros(n_win, bool)
    for w in range(n_win):
        al = int(alen[w])
        st = window_state(votes[w], bb[w], bbw[w], al, LA, ins_scale)
        ulen = np.array([e + kept for e, kept, *_ in st], np.int64)
        start = np.cumsum(ulen) - ulen
        total = int(ulen.sum())
        codes = np.zeros(LA, np.uint8)
        cv = np.zeros(LA, np.int32)
        posk = np.full(LA, HI, np.int64)
        posk2 = np.full(LA, -HI, np.int64)
        for p, (e, kept, best, ccov, icodes, icnts) in enumerate(st):
            s = int(start[p])
            for k in range(e):
                if s + k < LA:
                    codes[s + k] = icodes[k]
                    cv[s + k] = icnts[k]
            if kept:
                if s + e < LA:
                    codes[s + e] = best
                    cv[s + e] = ccov
                posk[p] = posk2[p] = s + e
        map_b = np.minimum.accumulate(posk[::-1])[::-1].copy()
        map_e = np.maximum.accumulate(posk2)
        first_kept, last_kept = int(posk.min()), int(posk2.max())
        any_kept = first_kept != HI
        map_b[map_b == HI] = last_kept
        map_e[map_e == -HI] = first_kept
        if not any_kept:
            map_b[:] = 0
            map_e[:] = 0
        hi = max(total - 1, 0)
        map_b = np.minimum(np.maximum(map_b, 0), hi)
        map_e = np.minimum(np.maximum(map_e, 0), hi)
        tot_c = min(max(total, 1), LA)
        lanes = list(real[w]) + (list(pad) if w == n_win - 1 else [])
        chg = 0
        for r, j in enumerate(lanes):
            L = int(alen[min(max(int(win[j]), 0), n_win)])
            b, en = int(begin[j]), int(end[j])
            nb[j] = map_b[min(max(b, 0), LA - 1)] if b < L else 0
            ne[j] = map_e[min(max(en, 0), LA - 1)] if en < L else tot_c - 1
            if r < len(real[w]) and (nb[j] != b or ne[j] != en):
                chg += 1
        new_bb[w] = codes
        cov[w] = cv
        new_alen[w] = tot_c
        ovf_out[w] = bool(ovf[w]) or total > LA or wesc[w] > 0
        conv[w] = bool(detect) and total == al and chg == 0 and \
            np.array_equal(codes, bb[w])
    return (new_bb, np.zeros(bbw.shape, F32), new_alen, nb, ne, cov,
            ovf_out, conv)


# ------------------------------------------- the redesigned kernels' orders

def _field(g, f):
    return g[..., f].astype(np.int64)


def _warp_up(x, fill):
    """Each thread's value from the thread before it in its warp (lane 0
    gets ``fill``)."""
    y = np.empty_like(x)
    w = x.reshape(x.shape[:-1] + (-1, 32))
    yw = y.reshape(w.shape)
    yw[..., 1:] = w[..., :-1]
    yw[..., 0] = fill.reshape(w.shape[:-1] + (32,))[..., 0] \
        if np.ndim(fill) else fill
    return y


RUN_CH = VOTE_CH - CH["pile_w"]      # channels of runs of 2 or more
ZERO_STEP = 4                        # run channels zeroed a job


def model_votes_tiled(walk, q, qw8, w_read, lt, t_off, esc_w, win, n_win,
                      LA, plan, stage=256):
    """M1 in the redesigned kernel's order (csrc/merge.cu,
    merge_votes_kernel) at ``plan`` (kernels.merge_votes_plan): each
    window's (tile, thread) grid at once, p = tile * gaps + thread; the
    window's jobs staged ``stage`` at a time; per job, thread p loads its
    walk entries p and p+1 where the job's slice needs them (zero where
    it loads nothing) and the query bytes its contributions read, and
    takes the left column's weight from the previous thread of its warp
    (lane 0 reads its own). The 23 register channels add every
    contribution (zeros too). A run channel's first contribution at a gap
    is stored and the next ones added; after each job the thread zeroes
    the next ZERO_STEP run channels it has not added to, and at the end
    the rest. Returns (votes, wesc) as model_votes does."""
    real, _ = members(win, n_win)
    Lq = q.shape[1]
    tiles, gaps, T = plan["tiles"], plan["gaps"], plan["threads"]
    t = np.arange(T)[None, :]
    p = (np.arange(tiles)[:, None] * gaps + t).reshape(-1)
    t = np.broadcast_to(t, (tiles, T)).reshape(-1)
    lane = t & 31
    own = (t < gaps) & (p <= LA)
    pe = np.minimum(p, LA + 1)
    pn = np.minimum(p + 1, LA + 1)
    reg_base = CH["pile_w"]
    votes = np.zeros((n_win, VOTE_CH, LA + 1), F32)
    wesc = np.zeros(n_win, F32)

    def wt(raw):
        return np.maximum(np.minimum(raw, 127).astype(F32) - F32(1.0),
                          F32(0.0)).astype(F32)

    for w, jobs in enumerate(real):
        reg = np.zeros((reg_base, p.size), F32)
        out = np.full((VOTE_CH, LA + 2 + T * tiles), np.nan, F32)
        touched = np.zeros((RUN_CH, p.size), bool)

        def run_add(ch, i, v):
            col = p[i]
            if touched[ch, i]:
                out[reg_base + ch, col] = F32(out[reg_base + ch, col] + v)
            else:
                out[reg_base + ch, col] = v
                touched[ch, i] = True

        zc = 0
        esc = F32(0.0)
        for r0 in range(0, len(jobs), stage):
            staged = jobs[r0:r0 + stage]
            for j in staged:
                esc = F32(esc + F32(esc_w[j]))
            for j in staged:
                c = p - int(t_off[j])
                L = int(lt[j])
                wr = F32(w_read[j])
                in_gaps = (c >= 0) & (c <= L)
                in_cols = (c >= 0) & (c < L)
                g0 = np.where((own & in_gaps)[:, None], walk[j][pe], 0)
                g1 = np.where((own & in_cols)[:, None], walk[j][pn], 0)
                ins = np.where(in_gaps, _field(g0, 0), 0)
                match = own & in_cols & (_field(g1, 2) == 0)
                idx = _column_index(_field(g1, 1), _field(g1, 3), Lq)
                cb = np.where(match, q[j][idx], 0).astype(np.int64)
                cw = np.where(match, qw8[j][idx], 0).astype(np.int64)
                qs = np.clip(_field(g0, 1), 0, Lq - 1)
                ib = np.where(own & (ins >= 1), q[j][qs], 0).astype(np.int64)
                iw = np.where(own & (ins >= 1), qw8[j][qs], 0).astype(
                    np.int64)
                lane0 = (lane == 0) & own & (p >= 1) & (c >= 1) & \
                    (c <= L - 1) & (ins == 0) & (_field(g0, 2) == 0)
                idx0 = _column_index(_field(g0, 1), _field(g0, 3), Lq)
                pw = np.where(lane0, qw8[j][idx0], 0).astype(np.int64)
                wq = np.where(match, wt(cw), wr).astype(F32)
                code = np.where(match, cb & 7, NBASE)
                own0 = (p >= 1) & (_field(g0, 2) == 0)
                wq_prev = _warp_up(wq, np.where(own0, wt(pw), wr).astype(F32))
                col = own & (p < LA) & in_cols
                for b in range(NBASE + 1):
                    m = col & (code == b)
                    reg[CH["base_w"] + b, m] = reg[CH["base_w"] + b, m] + wq[m]
                    if b < NBASE:
                        m = m & match
                        reg[CH["base_c"] + b, m] += F32(1.0)
                cross = own & (c >= 1) & (c <= L - 1) & (ins == 0)
                half = (F32(0.5) * (wq_prev + wq).astype(F32)).astype(F32)
                reg[CH["direct_w"], cross] += half[cross]
                one = own & (ins == 1)
                b1 = ib & 7
                w1 = wt(iw)
                for b in range(NBASE):
                    m = one & (b1 == b)
                    reg[CH["ins1_w"] + b, m] += w1[m]
                    reg[CH["ins1_c"] + b, m] += F32(1.0)
                reg[CH["ins1_stop"], one] += w1[one]
                for i in np.flatnonzero(own & (ins >= 2)):
                    mr = min(int(ins[i]), K_INS)
                    run = F32(0.0)
                    for k in range(mr):
                        b = int(_base(q[j], qs[i] + k, Lq))
                        wk = F32(_weight(qw8[j], qs[i] + k, Lq))
                        if b < NBASE:
                            run_add(NBASE * k + b, i, wk)
                            run_add(CH["pile_c"] - reg_base + NBASE * k + b,
                                    i, F32(1.0))
                        run = F32(run + wk)
                    run_add(CH["lenw"] - reg_base + mr - 2, i,
                            F32(run / F32(int(ins[i]))))
                for ch in range(zc, min(zc + ZERO_STEP, RUN_CH)):
                    m = own & ~touched[ch]
                    out[reg_base + ch, p[m]] = 0.0
                zc += ZERO_STEP
        for ch in range(zc, RUN_CH):
            m = own & ~touched[ch]
            out[reg_base + ch, p[m]] = 0.0
        out[:reg_base, p[own]] = reg[:, own]
        votes[w] = out[:, :LA + 1]
        wesc[w] = esc
    return votes, wesc


def model_votes_reads(walk, lt, t_off, win, n_win, Lq, LA):
    """What M1 reads of the walk and the queries (csrc/merge.cu
    fetch_walk, fetch_bytes, add_job), job by job: ``(walk_need bool [B,
    LA+2], q_need bool [B, Lq])``. Real job j, at each gap p <= LA with c
    = p - t_off: entry p where 0 <= c <= lt, entry p + 1 where 0 <= c <
    lt; the byte at the column index of entry p + 1 where that column is
    a match; the bytes of the insertion run of entry p (clamped qstart
    + k, k < min(ins_len, K_INS), the last byte past the row's end).
    Padded lanes read nothing."""
    B = walk.shape[0]
    walk_need = np.zeros((B, LA + 2), bool)
    q_need = np.zeros((B, Lq), bool)
    p = np.arange(LA + 1)
    for jobs in members(win, n_win)[0]:
        for j in jobs:
            c = p - int(t_off[j])
            gap = (c >= 0) & (c <= lt[j])
            col = (c >= 0) & (c < lt[j])
            walk_need[j, p[gap]] = True
            walk_need[j, p[col] + 1] = True
            g1 = walk[j, p[col] + 1].astype(np.int64)
            m = g1[:, 2] == 0
            q_need[j, _column_index(g1[m, 1], g1[m, 3], Lq)] = True
            g0 = walk[j, p[gap]].astype(np.int64)
            qsc = np.clip(g0[:, 1], 0, Lq - 1)
            for k in range(K_INS):
                run = g0[:, 0] > k
                q_need[j, np.minimum(qsc[run] + k, Lq - 1)] = True
    return walk_need, q_need


def _scan(v, identity, op, reverse):
    """merge_windows_kernel's scan_block over one block's values (a
    multiple of 32): Hillis-Steele shuffle scans within each warp, then
    every warp scans the warp totals. Returns (inclusive scan, total)."""
    def warp_scan(x):
        x = x.copy()
        lane = np.arange(32)
        off = 1
        while off < 32:
            if reverse:
                u = np.concatenate([x[..., off:], x[..., :off]], -1)
                ok = lane + off < 32
            else:
                u = np.concatenate([x[..., -off:], x[..., :-off]], -1)
                ok = lane >= off
            x = np.where(ok, op(x, u), x)
            off *= 2
        return x

    nw = v.size // 32
    incl = warp_scan(v.reshape(nw, 32))
    tot = incl[:, 0] if reverse else incl[:, 31]
    x = np.full(32, identity, np.int64)
    x[:nw] = tot
    x = warp_scan(x)
    src = np.arange(nw) + (1 if reverse else -1)
    before = np.where((src >= 0) & (src < nw), x[src % 32], identity)
    return op(before[:, None], incl).reshape(-1), int(x[0 if reverse else
                                                         nw - 1])


def model_windows_narrow(votes, wesc, bb, bbw, alen, begin, end, win, ovf,
                         *, ins_scale, n_win, LA, detect, threads):
    """M2's narrow kernel in its own order (csrc/merge.cu,
    merge_windows_kernel): a thread a gap with its state in registers
    (emitted ranks' codes packed 3 bits a rank, their counts read from the
    sums again when scattered), the start and map scans one value a
    thread (``_scan``), the scatter writing each position below LA once
    and comparing it with the anchor as it writes, the maps in a shared
    array. Returns M2's outputs as model_windows does."""
    real, pad = members(win, n_win)
    B = len(begin)
    eps, scale = F32(EPS), F32(ins_scale)
    new_bb = np.zeros((n_win + 1, LA), np.uint8)
    new_bb[n_win] = bb[n_win]
    new_alen = np.zeros(n_win + 1, np.int32)
    new_alen[n_win] = alen[n_win]
    nb = np.zeros(B, np.int32)
    ne = np.zeros(B, np.int32)
    cov = np.zeros((n_win, LA), np.int32)
    ovf_out = np.zeros(n_win, bool)
    conv = np.zeros(n_win, bool)
    p = np.arange(threads)
    for w in range(n_win):
        V = votes[w]
        al = int(alen[w])
        bbr, bwr = bb[w], bbw[w]
        e = np.zeros(threads, np.int64)
        kept = np.zeros(threads, bool)
        best = np.zeros(threads, np.int64)
        ccov = np.zeros(threads, np.int64)
        icode = np.zeros(threads, np.int64)
        for g in range(min(LA + 1, threads)):
            v = V[:, g]
            dw = v[CH["direct_w"]]
            if g <= al:
                bwl = bwr[min(max(al - 1, 0), LA - 1)]
                left = bwr[0] if g == 0 else bwr[g - 1]
                right = bwr[g] if g < LA else bwl
                if g == al:
                    left = right = bwl
                dw = F32(dw + F32(F32(F32(0.5) * F32(left + right)) + eps))
            if g < LA:
                bw = [v[CH["base_w"] + i] for i in range(NBASE + 1)]
                vcol = g < al
                code = int(bbr[g])
                if vcol and code < NBASE:
                    add = F32(bwr[g] + eps)
                    bw[code] = F32(bw[code] + add)
                top, bi = bw[0], 0
                for i in range(1, NBASE):
                    if bw[i] > top:
                        top, bi = bw[i], i
                best[g] = bi
                kept[g] = vcol and bw[NBASE] <= top
                if kept[g]:
                    cc = v[CH["base_c"] + bi]
                    if code == bi:
                        cc = F32(cc + F32(1.0))
                    ccov[g] = int(cc)
            stopped = F32(dw * scale)
            emit = g <= al
            for k in range(K_INS):
                if not emit:
                    break
                cw = [v[CH["pile_w"] + NBASE * k + i] for i in range(NBASE)]
                if k == 0:
                    cw = [F32(cw[i] + v[CH["ins1_w"] + i])
                          for i in range(NBASE)]
                tot = cw[0]
                for i in range(1, NBASE):
                    tot = F32(tot + cw[i])
                emit = tot > stopped
                top, bk = cw[0], 0
                for i in range(1, NBASE):
                    if cw[i] > top:
                        top, bk = cw[i], i
                if emit:
                    icode[g] |= bk << (3 * k)
                    e[g] += 1
                    if k + 1 < K_INS:
                        ch = CH["ins1_stop"] if k == 0 else \
                            CH["lenw"] + k - 1
                        stopped = F32(stopped + v[ch])
        ulen = e + kept
        incl, total = _scan(ulen, 0, np.add, False)
        st = incl - ulen
        codes = np.full(LA, 255, np.int64)
        cv = np.full(LA, -1, np.int64)
        same = True
        for g in range(threads):
            if g < LA and g >= total:
                assert codes[g] == 255          # each position written once
                codes[g], cv[g] = 0, 0
                same = same and bbr[g] == 0
            for k in range(int(e[g])):
                pos = int(st[g]) + k
                if pos < LA:
                    bk = (int(icode[g]) >> (3 * k)) & 7
                    c = V[CH["pile_c"] + NBASE * k + bk, g]
                    if k == 0:
                        c = F32(c + V[CH["ins1_c"] + bk, g])
                    assert codes[pos] == 255
                    codes[pos], cv[pos] = bk, int(c)
                    same = same and bbr[pos] == bk
            pk = int(st[g] + e[g])
            if kept[g] and pk < LA:
                assert codes[pk] == 255
                codes[pk], cv[pk] = best[g], ccov[g]
                same = same and bbr[pk] == best[g]
        assert (codes != 255).all()
        pk = st + e
        mb, first_kept = _scan(np.where(kept, pk, HI), np.iinfo(np.int32).max,
                               np.minimum, True)
        me, last_kept = _scan(np.where(kept, pk, -HI),
                              np.iinfo(np.int32).min, np.maximum, False)
        any_kept = first_kept != HI
        hi = max(total - 1, 0)
        mb, me = mb[:LA].copy(), me[:LA].copy()
        mb[mb == HI] = last_kept
        me[me == -HI] = first_kept
        if not any_kept:
            mb[:] = 0
            me[:] = 0
        map_b, map_e = np.clip(mb, 0, hi), np.clip(me, 0, hi)
        tot_c = min(max(total, 1), LA)
        lanes = list(real[w]) + (list(pad) if w == n_win - 1 else [])
        changed = False
        for r, j in enumerate(lanes):
            L = int(alen[min(max(int(win[j]), 0), n_win)])
            b, en = int(begin[j]), int(end[j])
            nb[j] = map_b[min(max(b, 0), LA - 1)] if b < L else 0
            ne[j] = map_e[min(max(en, 0), LA - 1)] if en < L else tot_c - 1
            changed = changed or (r < len(real[w]) and
                                  (nb[j] != b or ne[j] != en))
        new_bb[w] = codes
        cov[w] = cv
        new_alen[w] = tot_c
        ovf_out[w] = bool(ovf[w]) or total > LA or wesc[w] > 0
        conv[w] = bool(detect) and total == al and same and not changed
    return (new_bb, np.zeros(bbw.shape, F32), new_alen, nb, ne, cov,
            ovf_out, conv)


# ------------------------------------------------------------ inputs

def _noisy(rng, true, rate=0.10):
    n = len(true)
    r = rng.random(n)
    dele = r < rate / 3
    sub = (r >= rate / 3) & (r < 2 * rate / 3)
    ins = (r >= 2 * rate / 3) & (r < rate)
    counts = np.where(dele, 0, np.where(ins, 2, 1))
    base = np.where(sub, rng.integers(0, 4, n).astype(np.uint8), true)
    starts = np.cumsum(counts) - counts
    out = np.zeros(int(counts.sum()), np.uint8)
    keep = ~dele
    out[starts[keep]] = base[keep]
    out[starts[ins] + 1] = rng.integers(0, 4, int(ins.sum()))
    return out


def _qual(rng, n):
    return bytes(rng.integers(33 + 8, 33 + 25, n, dtype=np.uint8))


def edge_windows(seed=0, wlen=240, coverage=8):
    """Windows for a chunk that reaches every branch of the merge kernels:
    noisy windows with full and partial layer spans (insertion runs of 1
    and 2 come with the noise), one with a single layer, one with none,
    one whose layers carry a 40-base insertion (a run longer than K_INS,
    which saturates the walk), and one whose layers all repeat every
    base (a consensus twice as long as its backbone, past the chunk's
    anchor width)."""
    rng = np.random.default_rng(seed)

    def window(true, layers):
        bb = _noisy(rng, true)
        w = Window(0, 0, WindowType.TGS, decode_bases(bb), _qual(rng, len(bb)))
        for lay, b, e in layers(len(bb)):
            w.add_layer(decode_bases(lay), _qual(rng, len(lay)), b, e)
        return w

    out = []
    for i in range(4):
        true = rng.integers(0, 4, wlen).astype(np.uint8)

        def full_and_partial(L, true=true):
            lays = [(_noisy(rng, true), 0, L - 1) for _ in range(coverage)]
            for _ in range(3):
                b = int(rng.integers(0, L // 3))
                e = int(rng.integers(2 * L // 3, L - 1))
                seg = true[b * len(true) // L:e * len(true) // L + 1]
                lays.append((_noisy(rng, seg), b, e))
            return lays
        out.append(window(true, full_and_partial))
    true = rng.integers(0, 4, wlen).astype(np.uint8)
    out.append(window(true, lambda L: [(_noisy(rng, true), 0, L - 1)]))
    out.append(window(rng.integers(0, 4, wlen).astype(np.uint8),
                      lambda L: []))
    true = rng.integers(0, 4, wlen).astype(np.uint8)
    ins = rng.integers(0, 4, 40).astype(np.uint8)
    mid = wlen // 2
    long_ins = np.concatenate([true[:mid], ins, true[mid:]])
    out.append(window(true, lambda L: [(_noisy(rng, long_ins, 0.02), 0, L - 1)
                                       for _ in range(coverage)]))
    true = rng.integers(0, 4, wlen).astype(np.uint8)
    grown = np.repeat(true, 2)
    out.append(window(true, lambda L: [(_noisy(rng, grown, 0.01), 0, L - 1)
                                       for _ in range(coverage)]))
    return out


def noisy_windows(n_windows, coverage, wlen, seed=0):
    """``bench.build_windows``' workload with the port's Window: per window
    a hidden truth, a 10%-error backbone and ``coverage`` 10%-error full-
    span layers."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_windows):
        true = rng.integers(0, 4, wlen).astype(np.uint8)
        bb = _noisy(rng, true)
        w = Window(0, 0, WindowType.TGS, decode_bases(bb), _qual(rng, len(bb)))
        for _ in range(coverage):
            lay = _noisy(rng, true)
            w.add_layer(decode_bases(lay), _qual(rng, len(lay)), 0,
                        len(bb) - 1)
        out.append(w)
    return out


def random_round(seed, B, Lq, LA, n_win):
    """Merge inputs that no walk would give, for the kernels' edges: walk
    entries over their whole range (insertion runs 0-12, query starts
    and indices past both ends, every op code), query codes 0-7, weights
    0-255, negative slice offsets, empty windows; anchors, lengths and
    spans past the anchor's ends. Returns a dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    walk = np.stack([
        rng.choice(13, (B, LA + 2), p=[.55, .2, .08, .04] + [.13 / 9] * 9),
        rng.integers(-3, Lq + 4, (B, LA + 2)),
        rng.integers(0, 4, (B, LA + 2)),
        rng.integers(-3, Lq + 4, (B, LA + 2))], axis=-1).astype(np.int16)
    win = rng.integers(0, n_win - 2, B).astype(np.int32)
    win[win == 3] = 4                                  # window 3: no job
    win[rng.random(B) < 0.1] = n_win                   # padded lanes
    return dict(
        walk=walk,
        q=rng.choice(8, (B, Lq), p=[.22] * 4 + [.08, .01, .01, .02]).astype(
            np.uint8),
        qw8=rng.integers(0, 256, (B, Lq)).astype(np.uint8),
        w_read=(rng.random(B) * 30).astype(np.float32),
        lt=rng.integers(1, LA + 1, B).astype(np.int32),
        t_off=rng.integers(-4, LA // 2, B).astype(np.int32),
        esc_w=rng.integers(0, 3, B).astype(np.float32) * (rng.random(B) <
                                                          0.05),
        win=win,
        bb=rng.integers(0, 6, (n_win + 1, LA)).astype(np.uint8),
        bbw=(rng.random((n_win + 1, LA)) * 40).astype(np.float32),
        alen=rng.integers(1, LA + 1, n_win + 1).astype(np.int32),
        begin=rng.integers(-2, LA + 3, B).astype(np.int32),
        end=rng.integers(-2, LA + 3, B).astype(np.int32),
        ovf=rng.random(n_win) < 0.1)


# ------------------------------------------------------------ scheduler inputs
# Windows for the convergence scheduler's tests (tests/test_torch_sched.py
# with both packages' Window classes, tests/test_torch_cuda.py with the
# port's): the reference's tests/test_sched.py batches.

def _noisy_seq(rng, seq, rate):
    out = []
    for b in seq:
        r = rng.random()
        if r < rate / 3:
            continue
        elif r < 2 * rate / 3:
            out.append(int(rng.integers(0, 4)))
        elif r < rate:
            out.append(int(b))
            out.append(int(rng.integers(0, 4)))
        else:
            out.append(int(b))
    return decode_bases(np.array(out, np.uint8))


def sched_noisy_windows(seed, n, wlen, layers, rate=0.1, W=Window,
                        WT=WindowType):
    """Windows of a ``rate``-error backbone and ``layers`` layers of a
    hidden truth: rarely a fixed point."""
    rng = np.random.default_rng(seed)
    ws = []
    for _ in range(n):
        true = rng.integers(0, 4, wlen).astype(np.uint8)
        backbone = _noisy_seq(rng, true, rate)
        w = W(0, 0, WT.TGS, backbone, None)
        for _ in range(layers):
            w.add_layer(_noisy_seq(rng, true, rate), None, 0,
                        len(backbone) - 1)
        ws.append(w)
    return ws


def sched_stable_windows(seed, n, wlen, layers=6, W=Window, WT=WindowType):
    """Windows whose layers equal the backbone: a fixed point after round
    1, so detection freezes them with rounds_used = 2."""
    rng = np.random.default_rng(seed)
    ws = []
    for _ in range(n):
        backbone = decode_bases(rng.integers(0, 4, wlen).astype(np.uint8))
        w = W(0, 0, WT.TGS, backbone, None)
        for _ in range(layers):
            w.add_layer(backbone, None, 0, len(backbone) - 1)
        ws.append(w)
    return ws


def growing_window(seed, wlen=150, W=Window, WT=WindowType):
    """A window whose layers are twice its backbone's length: its
    consensus outgrows the anchor slack, so it carries the sticky flag."""
    rng = np.random.default_rng(seed)
    true = rng.integers(0, 4, 2 * wlen).astype(np.uint8)
    w = W(0, 0, WT.TGS, decode_bases(true[:wlen]), None)
    for _ in range(6):
        w.add_layer(_noisy_seq(rng, true, 0.05), None, 0, wlen - 1)
    return w


# The three control-flow paths of the scheduler's chunk loop: 10% noise
# rarely reaches a fixed point (the fused tail); 28 self-converging windows
# beside 8 noisy ones halve the window bucket (a repack); windows that all
# converge skip rounds 2 and 3 (full early exit).
SCHED_BATCHES = {
    "fused_tail": lambda W, WT: sched_noisy_windows(21, 10, 200, 8, W=W,
                                                    WT=WT),
    "repack": lambda W, WT: (sched_stable_windows(31, 28, 160, W=W, WT=WT) +
                             sched_noisy_windows(32, 8, 160, 8, W=W, WT=WT)),
    "early_exit": lambda W, WT: sched_stable_windows(41, 8, 150, W=W, WT=WT),
}
