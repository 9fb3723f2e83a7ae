"""The port's device overlap aligner against the JAX package, bitwise.

Same numpy inputs (made from a seed) go through the reference, run on the
CPU through its XLA twins (``pallas=False``), and through the port's plain
versions on the CPU:

- the tiled band forward (K3's plain version) chained over tiles against
  ``fw_dirs_band_xla_tile``, and one tile from the row-0 frontier against
  the port's untiled ``fw_dirs_band_plain``;
- the tiled column walk (per-tile origins, int32 emission) against the
  reference's;
- both chunk functions (all six fields, and the per-tile origins), with
  B = 8 lanes, reads of 1.8-3.9 kb, W = 512 and T = 2048, plus a drift
  case that re-centers the band;
- the admission rules (``tile_plan`` and the untiled gate) over a grid of
  (lq, lt);
- the group planner (chunks into launch groups, a halved tail chunk, the
  memory ceiling), and a group of three tiled chunks, and one of three
  untiled chunks, run as one against each chunk alone, through the port
  and through the reference;
- ``device_breaking_points(device="cpu")`` on a small synthetic overlap
  set: rows equal to the reference's and to the host aligner's, and the
  same fallback counts; grouped tiled launches, and grouped untiled
  ones, give the rows of ungrouped ones.
"""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from racon_tpu.ops import budget as rbudget
from racon_tpu.ops import colwalk as rcw
from racon_tpu.ops import ovl_align as rovl
from racon_tpu.ops.pallas.band_kernel import fw_dirs_band_xla_tile
from racon_tpu_torch.models.overlap import breaking_points_from_cigar
from racon_tpu_torch.native.aligner import NativeAligner
from racon_tpu_torch.ops import band as pband
from racon_tpu_torch.ops import budget as pbudget
from racon_tpu_torch.ops import colwalk as pcw
from racon_tpu_torch.ops import ovl_align as povl
from racon_tpu_torch.ops.cigar import ops_to_cigar
from racon_tpu_torch.ops.encode import encode_bases


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_BASES = np.frombuffer(b"ACGT", np.uint8)


def _mutate_codes(rng, tgt, err):
    """Codes 0..3 mutated at ``err`` total error (deletions,
    substitutions and insertions in equal thirds)."""
    out = []
    for base in tgt:
        r = rng.random()
        if r < err / 3:
            continue
        out.append(int(rng.integers(0, 4)) if r < 2 * err / 3 else int(base))
        if rng.random() < err / 3:
            out.append(int(rng.integers(0, 4)))
    return np.array(out, np.uint8)


def _mk_chunk(rng, read_len, err, B, Lq, LA):
    q = np.zeros((B, Lq), np.uint8)
    t = np.zeros((B, LA), np.uint8)
    lq = np.ones(B, np.int32)
    lt = np.ones(B, np.int32)
    t_begin = np.zeros(B, np.int32)
    for b in range(B):
        tgt = rng.integers(0, 4, read_len).astype(np.uint8)
        qq = _mutate_codes(rng, tgt, err)
        q[b, :len(qq)] = qq
        t[b, :len(tgt)] = tgt
        lq[b] = len(qq)
        lt[b] = len(tgt)
        t_begin[b] = int(rng.integers(0, 700))
    return q, t, lq, lt, t_begin


# ------------------------------------------------------------ tile forward

def _tile_case(seed, B=8, Lq=64, W=128):
    rng = np.random.default_rng(seed)
    lq = rng.integers(40, Lq + 1, B).astype(np.int32)
    lt = (lq + rng.integers(-5, 6, B)).clip(5).astype(np.int32)
    qT = rng.integers(0, 4, (Lq, B)).astype(np.uint8)
    klo, _ = pband.band_geometry(torch.from_numpy(lq), torch.from_numpy(lt),
                                 W)
    klo_h = klo.numpy()
    ts = rng.integers(0, 4, (B, int(lt.max()))).astype(np.uint8)

    def window(row0, height):
        win = np.full((B, height), 7, np.uint8)
        for b in range(B):
            for y in range(height):
                j = klo_h[b] + row0 + y
                if 0 <= j < lt[b]:
                    win[b, y] = ts[b, j]
        return win
    return lq, lt, qT, klo, window


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("scoring", [(0, -1, -1), (5, -4, -8)])
def test_tile_plain_chain_matches_xla_tile(k, scoring):
    """Chained over four tiles with the carried frontier, every tile's
    planes and frontier equal the reference's tiled twin."""
    m, x, g = scoring
    B, Lq, W, T = 8, 64, 128, 16
    lq, lt, qT, klo, window = _tile_case(3 + k, B, Lq, W)
    klo_j = jnp.asarray(klo.numpy())
    prev = pband.row0_scores(klo, W, g)
    uc = torch.full((B, W), pband.uc_boundary(k), dtype=torch.int32)
    hl = prev.clone()
    r_prev, r_uc, r_hl = (jnp.asarray(a.numpy()) for a in (prev, uc, hl))
    for tile in range(Lq // T):
        i0 = tile * T
        tb = window(i0, W + T)
        qt = qT[i0:i0 + T]
        ref = fw_dirs_band_xla_tile(
            jnp.asarray(tb), jnp.asarray(qt), klo_j, jnp.asarray(lq),
            jnp.full((B,), i0, jnp.int32), r_prev, r_uc, r_hl, match=m,
            mismatch=x, gap=g, W=W, nxt_k=k)
        out = pband.fw_dirs_band_tile_plain(
            torch.from_numpy(tb), torch.from_numpy(qt), klo,
            torch.from_numpy(lq), i0, prev, uc, hl, match=m, mismatch=x,
            gap=g, W=W, nxt_k=k)
        planes = [out[0], out[1]] + ([out[2]] if k == 4 else [])
        for r, o in zip(list(ref[:len(planes)]), planes):
            if o.dtype == torch.uint16:
                o = o.view(torch.int16)
                r = np.asarray(r).view(np.int16)
            assert np.array_equal(np.asarray(r), o.numpy())
        for r, o in zip(ref[len(planes):], out[3:]):
            assert np.array_equal(np.asarray(r), o.numpy())
        r_hl, r_prev, r_uc = ref[len(planes):]
        hl, prev, uc = out[3:]


@pytest.mark.parametrize("k", [2, 4])
def test_single_tile_equals_untiled_plain(k):
    """One tile from the row-0 frontier is the untiled forward, and a
    tile written into stitched planes lands at its row slice."""
    B, Lq, W = 8, 64, 128
    lq, lt, qT, klo, window = _tile_case(9, B, Lq, W)
    tb = torch.from_numpy(window(0, W + Lq))
    q = torch.from_numpy(qT)
    lqt = torch.from_numpy(lq)
    un = pband.fw_dirs_band_plain(tb, q, klo, lqt, match=5, mismatch=-4,
                                  gap=-8, W=W, nxt_k=k)
    prev = pband.row0_scores(klo, W, -8)
    uc = torch.full((B, W), pband.uc_boundary(k), dtype=torch.int32)
    out = pband.fw_dirs_band_tile_plain(tb, q, klo, lqt, 0, prev, uc,
                                        prev.clone(), match=5, mismatch=-4,
                                        gap=-8, W=W, nxt_k=k)
    for a, b in zip(un[:3], out[:3]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a.view(torch.int16) if a.dtype == torch.uint16
                               else a, b.view(torch.int16)
                               if b.dtype == torch.uint16 else b)
    assert torch.equal(un[3], out[3])
    stitched = (torch.zeros((Lq + 16, B, W), dtype=torch.uint8),
                torch.zeros((Lq + 16, B, W), dtype=torch.uint8),
                torch.zeros((Lq + 16, B, W), dtype=torch.uint16)
                if k == 4 else None)
    pband.fw_dirs_band_tile_plain(tb[:, :W + Lq], q, klo, lqt, 8, prev, uc,
                                  prev.clone(), match=5, mismatch=-4, gap=-8,
                                  W=W, nxt_k=k, out=stitched)
    solo = pband.fw_dirs_band_tile_plain(tb, q, klo, lqt, 8, prev, uc,
                                         prev.clone(), match=5, mismatch=-4,
                                         gap=-8, W=W, nxt_k=k)
    assert torch.equal(stitched[0][8:8 + Lq], solo[0])
    assert not stitched[0][:8].any() and not stitched[0][8 + Lq:].any()


# -------------------------------------------------------------- tiled walk

def _j(t):
    if t is None:
        return None
    if t.dtype == torch.uint16:
        return jnp.asarray(t.view(torch.int16).numpy().view(np.uint16))
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("k", [1, 2, 4])
def test_tiled_col_walk_int32_matches_reference(k):
    """Stitched planes with per-tile origins that move between tiles,
    int32 emission: every channel and sat equal the reference's."""
    rng = np.random.default_rng(21 + k)
    B, Lq, W, T, LA = 8, 96, 64, 32, 100
    lq = rng.integers(60, Lq + 1, B).astype(np.int32)
    lt = (lq + rng.integers(-6, 7, B)).clip(8).astype(np.int32)
    t_off = rng.integers(0, LA - int(lt.max()) + 1, B).astype(np.int32)
    klo0, _ = pband.band_geometry(torch.from_numpy(lq), torch.from_numpy(lt),
                                  W)
    klos = (klo0.numpy()[None, :] +
            rng.integers(-3, 4, (Lq // T, B))).astype(np.int32)
    # Real planes: each tile's forward at its own origin.
    ts = rng.integers(0, 4, (B, LA)).astype(np.uint8)
    qT = rng.integers(0, 4, (Lq, B)).astype(np.uint8)
    kf = max(k, 2)
    planes = (torch.empty((Lq, B, W), dtype=torch.uint8),
              torch.empty((Lq, B, W), dtype=torch.uint8),
              torch.empty((Lq, B, W), dtype=torch.uint16)
              if kf == 4 else None)
    kt = torch.from_numpy(klos[0])
    prev = pband.row0_scores(kt, W, -1)
    uc = torch.full((B, W), pband.uc_boundary(kf), dtype=torch.int32)
    hl = prev.clone()
    for ti in range(Lq // T):
        kt = torch.from_numpy(klos[ti])
        tb = pband.band_targets(torch.from_numpy(ts).reshape(-1),
                                torch.arange(B) * LA, kt,
                                torch.from_numpy(lt), W + T, origin=ti * T)
        *_, hl, prev, uc = pband.fw_dirs_band_tile_plain(
            tb, torch.from_numpy(qT[ti * T:(ti + 1) * T]), kt,
            torch.from_numpy(lq), ti * T, prev, uc, hl, match=0,
            mismatch=-1, gap=-1, W=W, nxt_k=kf, out=planes)
    cells = planes[0]
    nxt = planes[1] if k >= 2 else None
    nxt2 = planes[2] if k >= 4 else None
    ref = rcw.col_walk(_j(cells), jnp.asarray(lq), jnp.asarray(lt), None,
                       jnp.asarray(t_off), LA=LA, layout="band", nxt=_j(nxt),
                       nxt2=_j(nxt2), tile_klo=jnp.asarray(klos),
                       tile_len=T, emit=jnp.int32)
    out = pcw.col_walk(cells, torch.from_numpy(lq), torch.from_numpy(lt),
                       None, torch.from_numpy(t_off), LA=LA, layout="band",
                       nxt=nxt, nxt2=nxt2, tile_klo=torch.from_numpy(klos),
                       tile_len=T, emit=torch.int32)
    for name in ("ins_len", "qstart", "op_c", "qi_c"):
        assert out[name].dtype == torch.int32
        assert np.array_equal(np.asarray(ref[name]), out[name].numpy()), name
    assert np.array_equal(np.asarray(ref["sat"]), out["sat"].numpy())


# ----------------------------------------------------------------- chunks

def _run_chunks(q, t, lq, lt, t_begin, *, W, Lq, LA, T=None, nxt_k=2,
                scoring=(0, -1, -1)):
    m, x, g = scoring
    kw = dict(match=m, mismatch=x, gap=g, W=W, w_len=500,
              NW=LA // 500 + 2, Lq=Lq, LA=LA, nxt_k=nxt_k)
    args = (q, t, lq, lt, t_begin)
    targs = tuple(torch.from_numpy(a) for a in args)
    if T is None:
        ref = rovl._chunk_breaking_points(*args, pallas=False, **kw)
        out = povl._chunk_breaking_points(*targs, **kw)
    else:
        ref = rovl._tiled_chunk_breaking_points(
            *args, T=T, tb=q.shape[0], ch=4, pallas=False, **kw)
        out = povl._tiled_chunk_breaking_points(*targs, T=T, **kw)
    ref = [np.asarray(a) for a in ref]
    out = [a.numpy() for a in out]
    assert len(ref) == len(out)
    for i, (a, b) in enumerate(zip(ref, out)):
        assert a.dtype == b.dtype, f"field {i} dtype"
        assert np.array_equal(a, b), f"field {i} differs"
    return out


@pytest.mark.parametrize("nxt_k", [2, 4])
def test_untiled_chunk_matches_reference(nxt_k):
    rng = np.random.default_rng(11)
    q, t, lq, lt, t_begin = _mk_chunk(rng, 1800, 0.10, B=8, Lq=2048,
                                      LA=2048)
    out = _run_chunks(q, t, lq, lt, t_begin, W=512, Lq=2048, LA=2048,
                      nxt_k=nxt_k)
    assert not out[5].any()


def test_tiled_chunk_single_tile_matches_reference():
    rng = np.random.default_rng(11)
    q, t, lq, lt, t_begin = _mk_chunk(rng, 1800, 0.10, B=8, Lq=2048,
                                      LA=2048)
    out = _run_chunks(q, t, lq, lt, t_begin, W=512, Lq=2048, LA=2048,
                      T=2048)
    assert not out[5].any()


def test_tiled_chunk_two_tiles_matches_reference():
    rng = np.random.default_rng(12)
    q, t, lq, lt, t_begin = _mk_chunk(rng, 3900, 0.08, B=8, Lq=4096,
                                      LA=4096)
    out = _run_chunks(q, t, lq, lt, t_begin, W=512, Lq=4096, LA=4096,
                      T=2048, nxt_k=4)
    assert not out[5].any()
    assert out[6].shape == (2, 8) and np.array_equal(out[6][0], out[6][1])


def test_tiled_chunk_recentering_matches_reference():
    """A -300 diagonal excursion and back (net delta 0) moves lane 0's
    band origin between tiles; the drift-free lanes never move."""
    rng = np.random.default_rng(4)
    n = 2000
    qq = rng.integers(0, 4, n).astype(np.uint8)
    mid = np.array([b for i, b in enumerate(qq[500:1400]) if i % 3 != 0],
                   np.uint8)
    tail = []
    for i, b in enumerate(qq[1400:2000]):
        tail.append(int(b))
        if i % 2 == 1:
            tail.append(int(rng.integers(0, 4)))
    tt = np.concatenate([qq[:500], mid, np.array(tail, np.uint8)])
    B, W, T, Lq, LA = 8, 1024, 256, 2048, 2048
    q = np.zeros((B, Lq), np.uint8)
    t = np.zeros((B, LA), np.uint8)
    q[:, :n] = qq
    t[0, :n] = tt
    t[1:, :n] = qq
    lq = np.full(B, n, np.int32)
    lt = np.full(B, n, np.int32)
    out = _run_chunks(q, t, lq, lt, np.zeros(B, np.int32), W=W, Lq=Lq,
                      LA=LA, T=T)
    assert not out[5].any()
    klos = out[6]
    assert len(np.unique(klos[:, 0])) > 1
    for b in range(1, B):
        assert len(np.unique(klos[:, b])) == 1


# ------------------------------------------------------------ tile groups

@pytest.mark.parametrize("lanes,group,lane_bytes,cap,want", [
    # The main path's bucket: 42 chunks of 64 lanes, 4 a group.
    ([64] * 42, 4, 1, None, [list(range(i, min(i + 4, 42)))
                             for i in range(0, 42, 4)]),
    # A halved tail chunk joins the last group.
    ([64] * 5 + [16], 4, 1, None, [[0, 1, 2, 3], [4, 5]]),
    # The memory ceiling closes a group before G chunks.
    ([8, 8, 8, 4], 4, 100, 2000, [[0, 1], [2, 3]]),
    ([8, 8, 8, 4], 4, 100, 2700, [[0, 1, 2], [3]]),
    ([8, 8, 8, 4], 4, 100, 2800, [[0, 1, 2, 3]]),
    # A chunk over the ceiling still runs, alone.
    ([8, 8], 4, 100, 500, [[0], [1]]),
    # G = 1: every chunk alone (the CPU's default).
    ([8, 8, 4], 1, 1, None, [[0], [1], [2]]),
])
def test_plan_groups(lanes, group, lane_bytes, cap, want):
    groups = povl.plan_groups(lanes, group, lane_bytes, cap)
    assert groups == want
    assert [c for g in groups for c in g] == list(range(len(lanes)))


def test_group_size_is_one_on_cpu():
    assert povl.group_size(64, 1536, 2048, 2, "cpu") == 1
    assert povl.group_mem_cap("cpu") is None


def test_untiled_group_size_is_one_on_cpu():
    assert povl.group_size(povl.TB, 1536, 8192, 2, "cpu", tiled=False) == 1
    assert povl.group_size(povl.TB, 1024, 6144, 4, "cpu", tiled=False) == 1


def _tail_pair(rng, lq=161, lt=110, err=0.10):
    """A short tiled lane the padding rows past it push off its band: a
    110-base target at ``err`` error with random bases inserted through
    the query up to 161 bases (d = lt - lq = -51: band clearance 38 at W =
    128). At T = 32 its rows end one row into a tile, so that tile's other
    31 rows are padding, whose plateau re-centers the band 25 slots down
    for the next tile: a certificate over that tile reads clearance 13."""
    tt = rng.integers(0, 4, lt).astype(np.uint8)
    qq = _mutate_codes(rng, tt, err)
    pos = np.sort(rng.integers(0, len(qq) + 1, lq - len(qq)))
    ins = rng.integers(0, 4, len(pos)).astype(np.uint8)
    return np.insert(qq, pos, ins), tt


def _put_lane(chunk, b, qq, tt):
    """Lane ``b`` of a chunk's padded arrays set to the pair (qq, tt)."""
    q, t, lq, lt, _ = chunk
    q[b], t[b] = 0, 0
    q[b, :len(qq)], t[b, :len(tt)] = qq, tt
    lq[b], lt[b] = len(qq), len(tt)


def _group_chunks(seed):
    """Three tiled chunks of 8, 8 and 4 lanes (the last a halved tail) at
    Lq = 256, T = 32: 180-base reads at 5% error (two tiles past their
    last row), in each chunk one :func:`_tail_pair` lane at lane 5, 6 and
    3 (two tiles and 31 rows past), and in chunk 1 one 240-base lane that
    drifts 40 diagonals off and back (every third base of 120 missing
    from the target, then 40 extra bases), so its band re-centers between
    tiles."""
    rng = np.random.default_rng(seed)
    Lq = LA = 256
    chunks = [_mk_chunk(rng, 180, 0.05, B, Lq, LA) for B in (8, 8, 4)]
    for chunk, b in zip(chunks, TAIL_LANES):
        _put_lane(chunk, b, *_tail_pair(rng))
    q, t, lq, lt, _ = chunks[1]
    qq = rng.integers(0, 4, 240).astype(np.uint8)
    tt = list(qq[:30]) + [b for i, b in enumerate(qq[30:150]) if i % 3]
    for i, b in enumerate(qq[150:]):
        tt.append(b)
        if i % 2 and i < 80:
            tt.append(int(rng.integers(0, 4)))
    _put_lane(chunks[1], 2, qq, np.array(tt, np.uint8))
    return chunks, dict(W=128, w_len=50, NW=LA // 50 + 2, Lq=Lq, LA=LA,
                        T=32)


TAIL_LANES = (5, 6, 3)       # each chunk's _tail_pair lane in _group_chunks


@pytest.mark.parametrize("nxt_k", [2, 4])
@pytest.mark.parametrize("scoring", [(0, -1, -1), (5, -4, -8)])
def test_tiled_group_matches_chunks_alone(nxt_k, scoring):
    """One grouped run (one tile forward a tile over all 20 lanes, one
    re-centering pass, one walk) gives each chunk the breaking-point
    fields, fail flags and per-tile origins of that chunk run alone."""
    m, x, g = scoring
    chunks, kw = _group_chunks(31)
    kw.update(match=m, mismatch=x, gap=g, nxt_k=nxt_k)
    tch = [tuple(torch.from_numpy(a) for a in c) for c in chunks]
    group = [torch.cat(f) for f in zip(*tch)]
    outs = povl._tiled_group_breaking_points(*group, lanes=[8, 8, 4], **kw)
    assert len(outs) == 3
    for c, out in zip(tch, outs):
        alone = povl._tiled_chunk_breaking_points(*c, **kw)
        assert len(out) == len(alone) == 7
        for a, b in zip(alone, out):
            assert a.dtype == b.dtype and torch.equal(a, b)
    klos = outs[1][6]
    assert len(torch.unique(klos[:, 2])) > 1      # the excursion re-centers
    assert not outs[0][5].any()


def _lane_rows(out, b, t_begin):
    """Lane ``b``'s breaking-point rows from a chunk tuple, as the collect
    builds them (query start 0)."""
    first_c, qi_f, last_c, qi_l, valid = (np.asarray(a)[b] for a in out[:5])
    return np.stack([t_begin + first_c[valid], qi_f[valid],
                     t_begin + last_c[valid] + 1, qi_l[valid] + 1],
                    axis=1).astype(np.int64)


def _native_lane_rows(q, t, lq, lt, t_begin, w_len):
    """The host aligner's rows for one lane's operands."""
    ops = NativeAligner().align_batch([(q[:lq], t[:lt])])[0]
    return breaking_points_from_cigar(ops_to_cigar(ops), t_begin,
                                      t_begin + lt, 0, w_len)


def _assert_matches_reference_tiled(chunk, out, ref, w_len):
    """A tiled chunk's port tuple against the reference's: every field
    but ``fail`` bitwise, ``fail`` at most the reference's lane by lane,
    and every lane the port alone certifies with the host aligner's
    rows. Returns those lanes."""
    assert len(ref) == len(out)
    out = [np.asarray(a) for a in out]
    ref = [np.asarray(a) for a in ref]
    for i, (a, b) in enumerate(zip(ref, out)):
        assert a.dtype == b.dtype, f"field {i} dtype"
        if i != 5:
            assert np.array_equal(a, b), f"field {i} differs"
    assert (out[5] <= ref[5]).all()
    q, t, lq, lt, t_begin = chunk
    newly = np.flatnonzero(out[5] != ref[5])
    for b in newly:
        assert out[5][b] == 0
        assert np.array_equal(
            _lane_rows(out, b, t_begin[b]),
            _native_lane_rows(q[b], t[b], lq[b], lt[b], t_begin[b], w_len))
    return newly.tolist()


def test_tiled_group_matches_reference_per_chunk():
    """The same group against the reference's tiled chunk function run on
    each chunk alone (XLA twins on the CPU): the rows, the per-tile
    origins and the walk's fields equal, and the port certifies each
    chunk's tail lane, which the reference fails because it takes the
    band clearance over the tiles past the lane's rows too (every chunk
    here runs tiles past some lane's last row)."""
    chunks, kw = _group_chunks(32)
    kw.update(match=0, mismatch=-1, gap=-1, nxt_k=2)
    tch = [tuple(torch.from_numpy(a) for a in c) for c in chunks]
    group = [torch.cat(f) for f in zip(*tch)]
    outs = povl._tiled_group_breaking_points(*group, lanes=[8, 8, 4], **kw)
    for c, out, tail in zip(chunks, outs, TAIL_LANES):
        assert (-(-c[2] // kw["T"]) * kw["T"] < kw["Lq"]).any()
        ref = rovl._tiled_chunk_breaking_points(*c, tb=c[0].shape[0], ch=4,
                                                pallas=False, **kw)
        newly = _assert_matches_reference_tiled(c, out, ref, kw["w_len"])
        assert tail in newly


@pytest.mark.parametrize("tiles_past", [1, 2, 3])
def test_tiled_tail_lane_certifies_in_longer_bucket(tiles_past):
    """A short lane (:func:`_tail_pair`, 161 query rows: 6 tiles at T =
    32, W = 128) beside a lane that fills a bucket 1-3 tiles longer: its
    fail flag and rows are those it gives alone at Lq = 192, and the host
    aligner's. The reference, whose certificate also reads the band
    clearance of the tiles past the lane's rows, fails it in each such
    bucket and certifies it alone; every other field of the two equals."""
    rng = np.random.default_rng(60 + tiles_past)
    T, w_len = 32, 50
    short = _tail_pair(rng)
    Lq = 192 + T * tiles_past
    tt = rng.integers(0, 4, Lq - 9).astype(np.uint8)
    bucket = (np.zeros((2, Lq), np.uint8), np.zeros((2, Lq), np.uint8),
              np.ones(2, np.int32), np.ones(2, np.int32),
              rng.integers(0, 700, 2).astype(np.int32))
    _put_lane(bucket, 0, *short)
    _put_lane(bucket, 1, _mutate_codes(rng, tt, 0.05), tt)
    alone = tuple(a[:1, :192] if a.ndim == 2 else a[:1] for a in bucket)

    def run(args, L):
        kw = dict(match=0, mismatch=-1, gap=-1, W=128, w_len=w_len,
                  NW=L // w_len + 2, Lq=L, LA=L, T=T, nxt_k=2)
        out = povl._tiled_chunk_breaking_points(
            *(torch.from_numpy(a) for a in args), **kw)
        ref = rovl._tiled_chunk_breaking_points(*args, tb=len(args[2]),
                                                ch=4, pallas=False, **kw)
        return [a.numpy() for a in out], ref

    a_out, a_ref = run(alone, 192)
    b_out, b_ref = run(bucket, Lq)
    assert a_out[5][0] == np.asarray(a_ref[5])[0] == 0
    assert np.asarray(b_ref[5])[0] > 0
    assert b_out[5][0] == 0
    assert _assert_matches_reference_tiled(bucket, b_out, b_ref,
                                           w_len) == [0]
    rows = _lane_rows(b_out, 0, bucket[4][0])
    assert np.array_equal(rows, _lane_rows(a_out, 0, bucket[4][0]))
    assert np.array_equal(rows, _native_lane_rows(
        short[0], short[1], len(short[0]), len(short[1]), bucket[4][0],
        w_len))


def test_tail_lanes_counter_and_span(tmp_path, monkeypatch):
    """device_breaking_points on a small tier (8 lanes, W = 128, T = 32;
    the untiled route closed so these short jobs take the tiled one):
    three tail lanes and a 250-base lane that fills the bucket's eight
    tiles. ``ovl_tail_lanes`` and the ``ovl_tiled_chunk`` span's
    ``tail_lanes`` count the three, the card keeps every lane, and the
    tail lanes' rows are the host aligner's."""
    from racon_tpu_torch.obs import metrics as pmetrics, trace as ptrace
    monkeypatch.setattr(povl, "untiled_admits", lambda lq, lt: False)
    rng = np.random.default_rng(71)
    specs = []
    for i in range(3):
        qq, tt = _tail_pair(rng)
        specs.append((_BASES[qq].tobytes(), _BASES[tt].tobytes(), 61 * i))
    tt = rng.integers(0, 4, 250).astype(np.uint8)
    specs.append((_BASES[_mutate_codes(rng, tt, 0.03)].tobytes(),
                  _BASES[tt].tobytes(), 7))
    ovls = [_Ovl(*sp) for sp in specs]
    povl.reset_stats()
    fb, spans, snap = _traced(
        ptrace, pmetrics, str(tmp_path / "port.jsonl"),
        lambda: povl.device_breaking_points(
            ovls, None, 500, match=0, mismatch=-1, gap=-1, device="cpu",
            tiers=((8, 128, 32, 4),)))
    assert fb == []
    assert povl.TILED_GROUPS == [dict(lanes=8, W=128, T=32, Lq=256,
                                      nxt_k=4, chunks=1, G=1, groups=1)]
    assert snap["ovl_tail_lanes"] == 3
    assert snap["ovl_device_jobs"] == 4 and snap["ovl_native_jobs"] == 0
    assert [s["tail_lanes"] for s in spans
            if s["name"] == "ovl_tiled_chunk"] == [3]
    for o in ovls[:3]:
        assert np.array_equal(_native_rows(o), o.breaking_points)


def _untiled_group_chunks(seed):
    """Three untiled chunks of 8, 16 and 8 lanes: 250-400-base reads at 6%
    error, and in chunk 2 one unrelated pair, whose certificate fails."""
    rng = np.random.default_rng(seed)
    Lq = LA = 512
    chunks = []
    for B in (8, 16, 8):
        chunks.append(_mk_chunk(rng, int(rng.integers(250, 400)), 0.06, B,
                                Lq, LA))
    q, t, lq, lt, _ = chunks[2]
    q[5], t[5] = 0, 0
    q[5, :300] = rng.integers(0, 4, 300)
    t[5, :320] = rng.integers(0, 4, 320)
    lq[5], lt[5] = 300, 320
    return chunks, dict(W=128, w_len=50, NW=LA // 50 + 2, Lq=Lq, LA=LA)


@pytest.mark.parametrize("nxt_k", [2, 4])
def test_untiled_group_matches_chunks_alone(nxt_k):
    """One grouped run (one forward over all 32 lanes, one walk) gives
    each chunk the breaking-point fields and fail flags of that chunk run
    alone."""
    chunks, kw = _untiled_group_chunks(41)
    kw.update(match=0, mismatch=-1, gap=-1, nxt_k=nxt_k)
    tch = [tuple(torch.from_numpy(a) for a in c) for c in chunks]
    group = [torch.cat(f) for f in zip(*tch)]
    outs = povl._untiled_group_breaking_points(*group, lanes=[8, 16, 8],
                                               **kw)
    assert len(outs) == 3
    for c, out in zip(tch, outs):
        alone = povl._chunk_breaking_points(*c, **kw)
        assert len(out) == len(alone) == 6
        for a, b in zip(alone, out):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert outs[2][5][5] and not outs[0][5].any()


def test_untiled_group_matches_reference_per_chunk():
    """The same group against the reference's untiled chunk function run
    on each chunk alone (XLA twins on the CPU), at both walk depths."""
    chunks, kw = _untiled_group_chunks(42)
    tch = [tuple(torch.from_numpy(a) for a in c) for c in chunks]
    group = [torch.cat(f) for f in zip(*tch)]
    for nxt_k in (2, 4):
        kw.update(match=0, mismatch=-1, gap=-1, nxt_k=nxt_k)
        outs = povl._untiled_group_breaking_points(*group, lanes=[8, 16, 8],
                                                   **kw)
        for c, out in zip(chunks, outs):
            ref = rovl._chunk_breaking_points(*c, pallas=False, **kw)
            assert len(ref) == len(out)
            for i, (a, b) in enumerate(zip(ref, out)):
                a = np.asarray(a)
                assert a.dtype == b.numpy().dtype, f"field {i} dtype"
                assert np.array_equal(a, b.numpy()), f"field {i} differs"


# -------------------------------------------------------------- admission

def _ref_untiled(lq, lt):
    W = rovl._round_up(rovl.band_width_for_read(lq, lt), 512)
    lqp = rovl._round_up(lq, 2048)
    return (rovl.TB * lqp * W <= rovl.MAX_DIR_ELEMS and
            rbudget.vmem_est(W, lqp, 4) <= rbudget.VMEM_BUDGET and
            max(lq, lt) < 2 ** 14)


def test_admission_matches_reference():
    assert pbudget.TILE_TIERS == rbudget.TILE_TIERS
    assert pbudget.VMEM_BUDGET == rbudget.VMEM_BUDGET
    lens = [1, 500, 2047, 2048, 5000, 8000, 9000, 9400, 9500, 10_000,
            12_000, 16_383, 16_384, 19_000, 19_660, 19_700, 30_000, 58_000,
            59_000, 100_000, 117_964, 118_000, 130_000]
    for lq in lens:
        for d in (-3000, -1025, -1024, -768, -769, -100, 0, 7, 768, 769,
                  1024, 1025, 3000):
            lt = max(1, lq + d)
            assert (povl.band_width_for_read(lq, lt) ==
                    rovl.band_width_for_read(lq, lt))
            assert povl.untiled_admits(lq, lt) == _ref_untiled(lq, lt)
            for k in (1, 2, 4):
                for ch in (4, 8):
                    W = 512 * (1 + lq % 4)
                    assert (pbudget.vmem_est(W, lq, ch, k) ==
                            rbudget.vmem_est(W, lq, ch, k))
            r = rbudget.tile_plan(lq, lt)
            p = pbudget.tile_plan(lq, lt)
            assert (r is None) == (p is None), (lq, lt)
            if r is not None:
                assert ((p.key(), p.Lq, p.n_tiles) ==
                        (r.key(), r.Lq, r.n_tiles)), (lq, lt)


def test_walk_depth_env_reaches_tile_plan(monkeypatch):
    monkeypatch.setenv("RACON_TPU_WALK_K", "2")
    assert pbudget.tile_plan(3000, 3000).nxt_k == 2
    assert rbudget.tile_plan(3000, 3000).nxt_k == 2


# ------------------------------------------------- device_breaking_points

class _Ovl:
    """Overlap stub: what device_breaking_points and the host route read."""

    def __init__(self, q, t, t_begin, q_begin=0, strand=False):
        self._q, self._t = q, t
        self.strand = strand
        self.q_begin, self.q_end = q_begin, q_begin + len(q)
        self.q_length = self.q_end + 37
        self.t_begin, self.t_end = t_begin, t_begin + len(t)
        self.breaking_points = None

    def alignment_operands(self, sequences):
        return self._q, self._t


def _overlap_set(seed):
    """Untiled jobs (1.2-1.9 kb at 8% error), one tiled job (9.6 kb), one
    job no route admits and one uncertified job (unrelated sequences)."""
    rng = np.random.default_rng(seed)

    def seq(n):
        return _BASES[rng.integers(0, 4, n)].tobytes()

    specs = []
    for i, n in enumerate((1200, 1500, 1700, 1900)):
        t = seq(n)
        q = _BASES[_mutate_codes(rng, encode_bases(t), 0.08)].tobytes()
        specs.append((q, t, int(rng.integers(0, 5000)), 11 * i, i % 2 == 1))
    t = seq(9600)
    q = _BASES[_mutate_codes(rng, encode_bases(t), 0.03)].tobytes()
    specs.append((q, t, 731, 5, False))
    specs.append((seq(10_000), seq(12_500), 0, 0, False))    # over budget
    specs.append((seq(1200), seq(1200), 250, 0, False))      # uncertified
    return specs


def _native_rows(o):
    ops = NativeAligner().align_batch([(encode_bases(o._q),
                                        encode_bases(o._t))])[0]
    q_start = o.q_begin if not o.strand else o.q_length - o.q_end
    return breaking_points_from_cigar(ops_to_cigar(ops), o.t_begin,
                                      o.t_end, q_start, 500)


def _ovl_counts():
    """The port registry's overlap-aligner counters: jobs the card took,
    jobs sent to the host aligner, tile launches."""
    from racon_tpu_torch.obs.metrics import registry
    reg = registry()
    return {"device_jobs": reg.get("ovl_device_jobs"),
            "native_jobs": reg.get("ovl_native_jobs"),
            "tiles": reg.get("ovl_tiles_exec")}


def _ovl_delta(before):
    """The counters' change since ``before`` (an :func:`_ovl_counts`)."""
    return {k: v - before[k] for k, v in _ovl_counts().items()}


def _traced(trace_mod, metrics_mod, path, fn):
    """``fn()`` with the package's tracer on ``path`` and its registry
    from zero; returns (fn's result, the trace's spans, the final
    snapshot)."""
    import json
    metrics_mod.reset()
    tracer = trace_mod.configure(path)
    try:
        out = fn()
        tracer.finish(metrics=metrics_mod.registry().snapshot())
    finally:
        trace_mod._tracer = None
        snap = metrics_mod.registry().snapshot()
        metrics_mod.reset()
    spans = [json.loads(ln) for ln in open(path, encoding="utf-8")][1:-1]
    return out, spans, snap


def test_device_breaking_points_match_reference_and_native(tmp_path):
    """Both routes against the reference's and the host aligner: the
    rows, the fallbacks and their stderr line, and the run telemetry
    (the ``ovl_*`` counters, one ``tile`` point a tile launch inside its
    ``dispatch`` span)."""
    from racon_tpu.obs import metrics as rmetrics, trace as rtrace
    from racon_tpu_torch.obs import metrics as pmetrics, trace as ptrace
    specs = _overlap_set(31)
    ref = [_Ovl(*s) for s in specs]
    port = [_Ovl(*s) for s in specs]
    rbuf, pbuf = io.StringIO(), io.StringIO()
    rfb, rspans, rsnap = _traced(
        rtrace, rmetrics, str(tmp_path / "ref.jsonl"),
        lambda: rovl.device_breaking_points(ref, None, 500, match=0,
                                            mismatch=-1, gap=-1, log=rbuf))
    povl.reset_stats()
    pfb, pspans, psnap = _traced(
        ptrace, pmetrics, str(tmp_path / "port.jsonl"),
        lambda: povl.device_breaking_points(port, None, 500, match=0,
                                            mismatch=-1, gap=-1,
                                            device="cpu", log=pbuf))
    assert [ref.index(o) for o in rfb] == [port.index(o) for o in pfb]
    assert [port.index(o) for o in pfb] == [5, 6]
    assert "2 of 7 overlap alignments fall back" in pbuf.getvalue()
    assert "(1 over the device length budget, 1 uncertified)" in \
        pbuf.getvalue()
    assert pbuf.getvalue().replace("racon_tpu_torch", "racon_tpu") == \
        rbuf.getvalue()
    ovl = {"ovl_device_jobs": 5, "ovl_native_jobs": 2, "ovl_tiles_exec": 5,
           "ovl_device_fraction": round(5 / 7, 4)}
    assert rmetrics.ovl_extras(_as_reg(rmetrics, rsnap)) == ovl
    assert pmetrics.ovl_extras(_as_reg(pmetrics, psnap)) == \
        dict(ovl, ovl_tail_lanes=0)

    def points(spans):
        return sorted((s["kind"], s["name"], s.get("index"), s.get("rows"),
                       s.get("W"), s.get("lanes")) for s in spans
                      if s["kind"] in ("tile", "dispatch") and
                      s["name"] not in ("ovl_prep", "ovl_collect"))

    # The launch spans and tile points are the reference's; the port adds
    # its prep and collect spans before and after them.
    assert points(pspans) == points(rspans)
    disp = [s["name"] for s in sorted(pspans, key=lambda s: s["t0"])
            if s["kind"] == "dispatch"]
    assert disp == ["ovl_prep", "ovl_chunk", "ovl_tiled_chunk",
                    "ovl_collect"]
    tiles = [s for s in pspans if s["kind"] == "tile"]
    assert [s["index"] for s in tiles] == list(range(5))
    tiled = [s for s in pspans if s["name"] == "ovl_tiled_chunk"]
    assert len(tiled) == 1 and all(s["parent"] == tiled[0]["id"]
                                   for s in tiles)
    assert povl.TILED_GROUPS == [dict(lanes=64, W=1536, T=2048, Lq=10240,
                                      nxt_k=2, chunks=1, G=1, groups=1)]
    assert povl.UNTILED_GROUPS == [dict(lanes=128, W=512, Lq=2048, LA=2048,
                                        nxt_k=4, chunks=1, G=1, groups=1)]
    for r, p in zip(ref, port):
        if p in pfb:
            assert p.breaking_points is None
            continue
        assert p.breaking_points.dtype == np.int64
        assert np.array_equal(r.breaking_points, p.breaking_points)
        assert np.array_equal(_native_rows(p), p.breaking_points)


def _as_reg(metrics_mod, snap):
    reg = metrics_mod.MetricsRegistry()
    for k, v in snap.items():
        reg.set(k, v)
    return reg


def test_tiled_gate_off_routes_native(monkeypatch):
    monkeypatch.setenv("RACON_TPU_OVL_TILED", "0")
    rng = np.random.default_rng(8)
    s = _BASES[rng.integers(0, 4, 10_000)].tobytes()
    o = _Ovl(s, s, 0)
    assert pbudget.tile_plan(10_000, 10_000) is not None
    buf = io.StringIO()
    povl.reset_stats()
    before = _ovl_counts()
    fb = povl.device_breaking_points([o], None, 500, match=0, mismatch=-1,
                                     gap=-1, device="cpu", log=buf)
    assert fb == [o]
    assert "exceed the device length budget" in buf.getvalue()
    assert _ovl_delta(before) == {"device_jobs": 0, "native_jobs": 1,
                                  "tiles": 0}
    assert povl.TILED_GROUPS == []


def test_grouped_tiled_launches_give_ungrouped_rows():
    """Five 8.3-8.5 kb tiled jobs through a small tier of 2 lanes: three
    chunks in one group of G=3 (5 tile launches) give the rows and
    fallbacks of the three chunks run one by one (15)."""
    rng = np.random.default_rng(17)
    specs = []
    for i in range(5):
        t = _BASES[rng.integers(0, 4, 8300 + 50 * i)].tobytes()
        q = _BASES[_mutate_codes(rng, encode_bases(t), 0.03)].tobytes()
        specs.append((q, t, 97 * i, 3 * i, i % 2 == 1))
    tiers = ((2, 512, 2048, 4),)
    runs = []
    for group in (1, 3):
        ovls = [_Ovl(*s) for s in specs]
        povl.reset_stats()
        before = _ovl_counts()
        fb = povl.device_breaking_points(ovls, None, 500, match=0,
                                         mismatch=-1, gap=-1, device="cpu",
                                         tiers=tiers, group=group)
        runs.append(([ovls.index(o) for o in fb], ovls, _ovl_delta(before),
                     list(povl.TILED_GROUPS)))
    (fb1, o1, st1, tg1), (fb3, o3, st3, tg3) = runs
    assert fb1 == fb3
    assert st1["tiles"] == 15 and st3["tiles"] == 5
    assert [(r["chunks"], r["G"], r["groups"]) for r in tg1] == [(3, 1, 3)]
    assert [(r["chunks"], r["G"], r["groups"]) for r in tg3] == [(3, 3, 1)]
    assert st3["device_jobs"] == 5 - len(fb3) >= 4
    for a, b in zip(o1, o3):
        assert (a.breaking_points is None) == (b.breaking_points is None)
        if a.breaking_points is not None:
            assert np.array_equal(a.breaking_points, b.breaking_points)


def test_grouped_untiled_launches_give_ungrouped_rows(monkeypatch):
    """Twenty 300-680 base untiled jobs and one uncertified pair in chunks
    of 8 lanes (TB cut from 128 so that the bucket spans three chunks on
    the CPU): one group of G=3 (one forward, one walk) gives the rows and
    fallbacks of the three chunks run one by one."""
    monkeypatch.setattr(povl, "TB", 8)
    rng = np.random.default_rng(19)
    specs = []
    for i in range(20):
        t = _BASES[rng.integers(0, 4, 300 + 20 * i)].tobytes()
        q = _BASES[_mutate_codes(rng, encode_bases(t), 0.06)].tobytes()
        specs.append((q, t, 41 * i, 2 * i, i % 3 == 1))
    specs.append((_BASES[rng.integers(0, 4, 1200)].tobytes(),
                  _BASES[rng.integers(0, 4, 1200)].tobytes(), 9, 0, False))
    runs = []
    for group in (1, 3):
        ovls = [_Ovl(*s) for s in specs]
        povl.reset_stats()
        before = _ovl_counts()
        fb = povl.device_breaking_points(ovls, None, 500, match=0,
                                         mismatch=-1, gap=-1, device="cpu",
                                         group=group)
        runs.append(([ovls.index(o) for o in fb], ovls, _ovl_delta(before),
                     list(povl.UNTILED_GROUPS), list(povl.TILED_GROUPS)))
    (fb1, o1, st1, ug1, tg1), (fb3, o3, st3, ug3, tg3) = runs
    assert fb1 == fb3 == [20]
    assert st1 == st3 == {"device_jobs": 20, "native_jobs": 1, "tiles": 0}
    assert tg1 == tg3 == []
    assert [(r["chunks"], r["G"], r["groups"]) for r in ug1] == [(3, 1, 3)]
    assert [(r["chunks"], r["G"], r["groups"]) for r in ug3] == [(3, 3, 1)]
    for a, b in zip(o1, o3):
        assert (a.breaking_points is None) == (b.breaking_points is None)
        if a.breaking_points is not None:
            assert np.array_equal(a.breaking_points, b.breaking_points)
