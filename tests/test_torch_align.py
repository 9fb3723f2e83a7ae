"""The port's batched aligner and op-string vote extraction against the JAX
package.

Same numpy inputs (made from a seed) through the reference and the port:

- ``align.nw_dirs_plain`` (the plain version of K4) against the XLA twin
  ``_nw_dirs`` and against the Pallas body ``nw_kernel._kernel`` in
  interpret mode; ``traceback_plain`` (plain T1) against
  ``_traceback_flat`` on both of its layouts; ``nw_align_batch``,
  ``nw_align_auto``, ``nw_scores`` and ``nw_oracle`` against theirs;
- ``device_merge.monotone_count_plain`` (plain K5) against
  ``monotone_count_xla`` and the Pallas ``count_kernel._kernel`` in
  interpret mode; ``extract_votes`` against the reference's, every
  channel (bitwise on integer weights, rtol 1e-6 otherwise: the f32
  cumsum of fractional weights may be summed in another order);
- the op-string round (``PoaEngine._align`` on the CPU, then the device
  merge) against the port's host merge, and against the column-walk
  votes on the flat and band layouts.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from racon_tpu.ops import align as ralign
from racon_tpu.ops import device_merge as rdm
from racon_tpu.ops.cigar import nw_oracle as ref_oracle
from racon_tpu.ops.pallas import count_kernel as rcount
from racon_tpu.ops.pallas import nw_kernel as rnw
from racon_tpu.ops.pallas.band_kernel import fw_traceback_band
from racon_tpu.ops.pallas.compat import CompilerParams
from racon_tpu.ops.poa import PoaEngine as RefEngine
from racon_tpu_torch.models.window import window_arrays
from racon_tpu_torch.native.aligner import NativeAligner
from racon_tpu_torch.ops import align as palign
from racon_tpu_torch.ops import device_merge as pdm
from racon_tpu_torch.ops import kernels
from racon_tpu_torch.ops.band import band_geometry
from racon_tpu_torch.ops.cigar import DIAG, UP, nw_oracle
from racon_tpu_torch.ops.colwalk import col_walk
from racon_tpu_torch.ops.flat import fw_dirs_flat_plain
from racon_tpu_torch.ops.poa import PoaEngine
from tests.test_colwalk import _pad, _random_jobs
from tests.test_flat import _build_windows

SCORINGS = [(5, -4, -8), (0, -1, -1), (1, -1, -1)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _batch(seed, B, Lq, Lt, alphabet=5):
    """Zero-padded random pairs with random true lengths inside the
    (Lq, Lt) bucket."""
    rng = np.random.default_rng(seed)
    q = np.zeros((B, Lq), np.uint8)
    t = np.zeros((B, Lt), np.uint8)
    lq = rng.integers(1, Lq + 1, B).astype(np.int32)
    lt = rng.integers(1, Lt + 1, B).astype(np.int32)
    lq[0], lt[0] = Lq, Lt
    for b in range(B):
        q[b, :lq[b]] = rng.integers(0, alphabet, lq[b])
        t[b, :lt[b]] = rng.integers(0, alphabet, lt[b])
    return q, t, lq, lt


def _score(q, t, ops, m, x, g):
    """Score of an op string (and a check that it consumes q and t)."""
    qi = ti = s = 0
    for d in ops:
        if d == DIAG:
            s += m if q[qi] == t[ti] else x
            qi += 1
            ti += 1
        elif d == UP:
            s += g
            qi += 1
        else:
            s += g
            ti += 1
    assert qi == len(q) and ti == len(t)
    return s


# ------------------------------------------------------------ K4 and T1

@pytest.mark.parametrize("scoring", SCORINGS)
def test_nw_dirs_plain_matches_xla_twin(scoring):
    m, x, g = scoring
    q, t, _, _ = _batch(1, 12, 48, 56)
    ref = jax.vmap(lambda a, b: ralign._nw_dirs(a, b, m, x, g))(
        jnp.asarray(q), jnp.asarray(t))
    out = palign.nw_dirs_plain(_t(q), _t(t), match=m, mismatch=x, gap=g)
    assert out.dtype == torch.uint8 and tuple(out.shape) == (48, 12, 56)
    assert np.array_equal(np.asarray(ref).transpose(1, 0, 2), out.numpy())


def test_nw_dirs_plain_matches_pallas_interpret():
    """The Pallas body ``nw_kernel._kernel`` (interpret mode, its own
    [Lq, B, Lt] layout, 128-lane tiles, an int8 substitution tensor
    formed as ``nw_dirs_pallas`` forms it) against the port."""
    m, x, g = 5, -4, -8
    B, Lq, Lt = 128, 64, 128
    q, t, _, _ = _batch(2, B, Lq, Lt)
    sub = jnp.where(jnp.asarray(q).T[:, :, None] == jnp.asarray(t)[None],
                    m, x).astype(jnp.int8)
    ref = pl.pallas_call(
        functools.partial(rnw._kernel, gap=g, Lt=Lt),
        grid=(B // rnw.TB, Lq // rnw.CH),
        in_specs=[pl.BlockSpec((rnw.CH, rnw.TB, Lt), lambda b, c: (c, b, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((rnw.CH, rnw.TB, Lt), lambda b, c: (c, b, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((Lq, B, Lt), jnp.uint8),
        scratch_shapes=[pltpu.VMEM((rnw.TB, Lt), jnp.int32)],
        compiler_params=CompilerParams(
            dimension_semantics=("arbitrary", "arbitrary")),
        interpret=True)(sub)
    out = palign.nw_dirs_plain(_t(q), _t(t), match=m, mismatch=x, gap=g)
    assert np.array_equal(np.asarray(ref), out.numpy())


@pytest.mark.parametrize("layout", ["xla", "pallas"])
def test_traceback_plain_matches_reference(layout):
    """``traceback_plain`` on the [Lq, B, Lt] plane equals
    ``_traceback_flat`` read through either of its strides: the XLA
    [B, Lq, Lt] plane or the Pallas [Lq, B, Lt] one."""
    q, t, lq, lt = _batch(3, 10, 40, 48)
    B, Lq = q.shape
    Lt = t.shape[1]
    dirs = palign.nw_dirs_plain(_t(q), _t(t), match=5, mismatch=-4, gap=-8)
    if layout == "xla":
        d1 = jnp.asarray(dirs.numpy().transpose(1, 0, 2).reshape(-1))
        stride, b_off = Lt, np.arange(B, dtype=np.int32) * (Lq * Lt)
    else:
        d1 = jnp.asarray(dirs.numpy().reshape(-1))
        stride, b_off = B * Lt, np.arange(B, dtype=np.int32) * Lt
    ref = ralign._traceback_flat(d1, stride, jnp.asarray(b_off), Lq + Lt,
                                 jnp.asarray(lq), jnp.asarray(lt))
    out = palign.traceback_plain(dirs, _t(lq), _t(lt), Lq + Lt)
    assert np.array_equal(np.asarray(ref), out.numpy())


@pytest.mark.parametrize("scoring", SCORINGS)
def test_nw_align_batch_matches_reference(scoring):
    """ops and n equal the reference's ``nw_align_batch``; every path is
    the oracle's path, with the oracle's score and ``nw_scores``' score;
    ``nw_align_auto`` gives the same."""
    m, x, g = scoring
    q, t, lq, lt = _batch(4, 12, 48, 56)
    args = (jnp.asarray(q), jnp.asarray(t), jnp.asarray(lq), jnp.asarray(lt))
    r_ops, r_n = ralign.nw_align_batch(*args, match=m, mismatch=x, gap=g)
    targs = (_t(q), _t(t), _t(lq), _t(lt))
    ops, n = palign.nw_align_batch(*targs, match=m, mismatch=x, gap=g)
    assert ops.dtype == torch.uint8 and n.dtype == torch.int32
    assert np.array_equal(np.asarray(r_ops), ops.numpy())
    assert np.array_equal(np.asarray(r_n), n.numpy())
    a_ops, a_n = palign.nw_align_auto(*targs, match=m, mismatch=x, gap=g)
    assert torch.equal(a_ops, ops) and torch.equal(a_n, n)
    sc = palign.nw_scores(*targs, match=m, mismatch=x, gap=g).numpy()
    W = ops.shape[1]
    for b in range(len(lq)):
        o = ops[b, W - int(n[b]):].numpy()
        assert (ops[b, :W - int(n[b])] == palign.PAD_OP).all()
        qq, tt = q[b, :lq[b]], t[b, :lt[b]]
        o_sc, o_ops = nw_oracle(qq, tt, m, x, g)
        assert np.array_equal(o, o_ops)
        assert _score(qq, tt, o, m, x, g) == o_sc == sc[b]


@pytest.mark.parametrize("scoring", SCORINGS)
def test_nw_scores_matches_reference(scoring):
    m, x, g = scoring
    q, t, lq, lt = _batch(5, 16, 32, 40)
    ref = ralign.nw_scores(jnp.asarray(q), jnp.asarray(t), jnp.asarray(lq),
                           jnp.asarray(lt), match=m, mismatch=x, gap=g)
    out = palign.nw_scores(_t(q), _t(t), _t(lq), _t(lt), match=m,
                           mismatch=x, gap=g)
    assert np.array_equal(np.asarray(ref), out.numpy())


def test_nw_oracle_matches_reference():
    rng = np.random.default_rng(6)
    for _ in range(20):
        q = rng.integers(0, 4, int(rng.integers(0, 40))).astype(np.uint8)
        t = rng.integers(0, 4, int(rng.integers(0, 40))).astype(np.uint8)
        for m, x, g in SCORINGS:
            r_sc, r_ops = ref_oracle(q, t, m, x, g)
            sc, ops = nw_oracle(q, t, m, x, g)
            assert sc == r_sc and np.array_equal(ops, r_ops)


# ------------------------------------------------------------ K5

def _count_input(kind, B, S, P, seed=7):
    rng = np.random.default_rng(seed)
    if kind == "monotone":
        X = np.cumsum(rng.integers(0, 2, (B, S)), axis=1) - \
            rng.integers(1, 20, (B, 1))
    else:
        X = rng.integers(-5, P + 5, (B, S))
    return X.astype(np.int32)


@pytest.mark.parametrize("kind", ["monotone", "unsorted"])
def test_monotone_count_plain_matches_xla(kind):
    X = _count_input(kind, 9, 70, 40)
    ref = rcount.monotone_count_xla(jnp.asarray(X), 40)
    out = pdm.monotone_count_plain(_t(X), 40)
    assert out.dtype == torch.int32
    assert np.array_equal(np.asarray(ref), out.numpy())
    assert torch.equal(kernels.monotone_count(_t(X), 40), out)


@pytest.mark.parametrize("kind", ["monotone", "unsorted"])
def test_monotone_count_plain_matches_pallas_interpret(kind):
    """The Pallas body ``count_kernel._kernel`` (interpret mode, X
    transposed to [S, B], 8 p values by 128 lanes a program)."""
    B, S, P = 128, 48, 21
    X = _count_input(kind, B, S, P, seed=8)
    Pp = -(-P // rcount.PB) * rcount.PB
    outT = pl.pallas_call(
        functools.partial(rcount._kernel, S=S),
        grid=(Pp // rcount.PB, B // rcount.TB),
        in_specs=[pl.BlockSpec((S, rcount.TB), lambda p, b: (0, b),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((rcount.PB, rcount.TB), lambda p, b: (p, b),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((Pp, B), jnp.int32),
        compiler_params=CompilerParams(
            dimension_semantics=("arbitrary", "arbitrary")),
        interpret=True)(jnp.asarray(X).T)
    out = pdm.monotone_count_plain(_t(X), P)
    assert np.array_equal(np.asarray(outT)[:P].T, out.numpy())


# ------------------------------------------------------------ votes

def _aligned_jobs(seed, B, integer_weights):
    """Random jobs, their op strings from the port's aligner and the
    extract_votes inputs."""
    rng = np.random.default_rng(seed)
    qs, ts = _random_jobs(rng, B)
    tbuf, qT, lq, lt = _pad(qs, ts)
    q = np.ascontiguousarray(qT.T)
    t = np.where(tbuf == 7, 0, tbuf).astype(np.uint8)
    ops, _ = palign.nw_align_batch(_t(q), _t(t), _t(lq), _t(lt), match=5,
                                   mismatch=-4, gap=-8)
    qw = rng.integers(0, 40, q.shape).astype(np.float32)
    if not integer_weights:
        qw = qw + rng.random(q.shape).astype(np.float32)
    w_read = rng.uniform(1, 20, B).astype(np.float32)
    t_off = rng.integers(0, 9, B).astype(np.int32)
    LA = tbuf.shape[1] + 16
    return dict(ops=ops.numpy(), q=q, qw=qw, w_read=w_read, lt=lt,
                t_off=t_off, LA=LA, tbuf=tbuf, qT=qT, lq=lq, qs=qs, ts=ts)


@pytest.mark.parametrize("integer_weights", [True, False])
def test_extract_votes_matches_reference(integer_weights):
    jb = _aligned_jobs(13, 15, integer_weights)
    names = ("ops", "q", "qw", "w_read", "lt", "t_off")
    ref = rdm.extract_votes(*(jnp.asarray(jb[n]) for n in names), jb["LA"])
    out = pdm.extract_votes(*(_t(jb[n]) for n in names), jb["LA"])
    assert set(out) == set(ref)
    for name in ref:
        r = np.asarray(ref[name], np.float32)
        assert out[name].dtype == torch.float32, name
        assert out[name].shape == r.shape, name
        if integer_weights or name not in ("lenw",):
            assert np.array_equal(r, out[name].numpy()), name
        else:   # run means from the f32 weight cumsum: summation order
            np.testing.assert_allclose(out[name].numpy(), r, rtol=1e-6,
                                       atol=0, err_msg=name)


def _votes_equal(va, vb):
    assert set(va) == set(vb)
    for k in va:
        assert torch.equal(va[k], vb[k]), k


def test_op_string_votes_match_column_walk_flat():
    """extract_votes(ops of the batched aligner) ==
    extract_votes_cols(col_walk(full-width planes)), bitwise."""
    jb = _aligned_jobs(11, 17, True)
    qw8 = (jb["qw"] + 1).astype(np.uint8)
    cells = fw_dirs_flat_plain(_t(jb["tbuf"]), _t(jb["qT"]), match=5,
                               mismatch=-4, gap=-8)
    cols = col_walk(cells, _t(jb["lq"]), _t(jb["lt"]), None,
                    _t(jb["t_off"]), LA=jb["LA"], layout="flat")
    assert not cols["sat"].any()
    new = pdm.extract_votes_cols(cols, _t(jb["q"]), _t(qw8),
                                 _t(jb["w_read"]), _t(jb["lt"]),
                                 _t(jb["t_off"]), jb["LA"])
    old = pdm.extract_votes(_t(jb["ops"]), _t(jb["q"]), _t(jb["qw"]),
                            _t(jb["w_read"]), _t(jb["lt"]), _t(jb["t_off"]),
                            jb["LA"])
    _votes_equal(old, new)


def test_op_string_votes_match_column_walk_band():
    """The same on banded planes with per-lane band origins: the op
    strings come from the reference's banded traceback over the port's
    planes."""
    jb = _aligned_jobs(12, 9, True)
    W = 128
    lq, lt, ts = jb["lq"], jb["lt"], jb["ts"]
    B, Lq = len(lq), jb["qT"].shape[0]
    klo, _ = band_geometry(_t(lq), _t(lt), W)
    tband = np.full((B, W + Lq), 7, np.uint8)
    for b in range(B):
        for y in range(W + Lq):
            j = int(klo[b]) + y
            if 0 <= j < lt[b]:
                tband[b, y] = ts[b][j]
    cells, _, _, _ = kernels.fw_dirs_band(_t(tband), _t(jb["qT"]), klo,
                                          _t(lq), match=5, mismatch=-4,
                                          gap=-8, W=W, nxt_k=1)
    rev = fw_traceback_band(jnp.asarray(cells.numpy()), jnp.asarray(lq),
                            jnp.asarray(lt), jnp.asarray(klo.numpy()),
                            Lq + W)
    ops = np.ascontiguousarray(np.flip(np.asarray(rev), axis=1))
    cols = col_walk(cells, _t(lq), _t(lt), klo, _t(jb["t_off"]),
                    LA=jb["LA"], layout="band")
    assert not cols["sat"].any()
    qw8 = (jb["qw"] + 1).astype(np.uint8)
    new = pdm.extract_votes_cols(cols, _t(jb["q"]), _t(qw8),
                                 _t(jb["w_read"]), _t(lt), _t(jb["t_off"]),
                                 jb["LA"])
    old = pdm.extract_votes(_t(ops), _t(jb["q"]), _t(jb["qw"]),
                            _t(jb["w_read"]), _t(lt), _t(jb["t_off"]),
                            jb["LA"])
    _votes_equal(old, new)


# ------------------------------------------------------------ engine

def _round0(windows, eng):
    """Round-0 anchors, layers and spans of the active windows, and their
    jobs."""
    anchors, jobs = [], []
    for wi, w in enumerate(windows):
        lays, bb, bw = window_arrays(w)
        anchors.append((bb, bw))
        jobs.extend(eng._build_jobs(wi, bb, [(c, wt) for c, wt, _, _ in lays],
                                    [(b, e) for _, _, b, e in lays]))
    return anchors, jobs


@pytest.mark.parametrize("with_quality", [True, False])
def test_op_string_round_matches_host_merge(with_quality):
    """The op-string round on the CPU (``PoaEngine._align``: the plain K4
    and T1; then extract_votes with the plain K5, aggregate_votes,
    add_backbone, assemble, compact, coord_maps) gives the consensus,
    coverage and coordinate maps of the host ``_merge_round`` on the same
    op strings."""
    windows = [w for w in _build_windows(7, 5, 10, 220, with_quality)
               if w.n_layers >= 2]
    eng = PoaEngine(device="cpu")
    anchors, jobs = _round0(windows, eng)
    eng._align(jobs)
    ref = eng._merge_round(anchors, jobs)

    B = len(jobs)
    S = max(len(j.ops) for j in jobs) + 8
    Lq = max(len(j.q) for j in jobs)
    LA = max(len(bb) for bb, _ in anchors) + 8
    ops = np.full((B, S), palign.PAD_OP, np.uint8)
    q = np.zeros((B, Lq), np.uint8)
    qw = np.zeros((B, Lq), np.float32)
    for b, j in enumerate(jobs):
        ops[b, S - len(j.ops):] = j.ops
        q[b, :len(j.q)] = j.q
        qw[b, :len(j.q)] = j.w
    col = {n: np.array([getattr(j, a) for j in jobs], dt) for n, a, dt in (
        ("w_read", "w_read", np.float32), ("lt", "t_len", np.int32),
        ("t_off", "t_off", np.int32), ("win", "win", np.int32))}
    Nw = len(anchors)
    bb_pad = np.zeros((Nw, LA), np.uint8)
    bbw_pad = np.zeros((Nw, LA), np.float32)
    alen = np.array([len(bb) for bb, _ in anchors], np.int32)
    for wi, (bb, bw) in enumerate(anchors):
        bb_pad[wi, :len(bb)] = bb
        bbw_pad[wi, :len(bb)] = bw

    votes = pdm.extract_votes(_t(ops), _t(q), _t(qw), _t(col["w_read"]),
                              _t(col["lt"]), _t(col["t_off"]), LA)
    acc = pdm.aggregate_votes(votes, _t(col["win"]), Nw)
    acc = pdm.add_backbone(acc, _t(bb_pad), _t(bbw_pad), _t(alen))
    asm = pdm.assemble(acc, _t(alen), eng.ins_scale)
    codes, cov, total = pdm.compact(asm, LA + 64)
    map_b, map_e = pdm.coord_maps(asm, _t(alen), LA)
    for wi, (cons_ref, cov_ref, mb_ref, me_ref) in enumerate(ref):
        L = len(cons_ref)
        assert int(total[wi]) == L
        assert np.array_equal(codes[wi, :L].numpy(), cons_ref)
        assert np.array_equal(cov[wi, :L].numpy(), cov_ref)
        assert np.array_equal(map_b[wi, :len(mb_ref)].numpy(), mb_ref)
        assert np.array_equal(map_e[wi, :len(me_ref)].numpy(), me_ref)


def test_align_matches_reference_engine():
    """``PoaEngine._align`` on the CPU sets every job's ops to the ops of
    the reference's device-engine aligner (``_align_jax``): the same
    length bucketing, B grid and dummy rows, the same paths."""
    windows = [w for w in _build_windows(3, 4, 8, 100, True)
               if w.n_layers >= 2]
    eng = PoaEngine(device="cpu")
    stats = eng.stats = {}
    _, jobs = _round0(windows, eng)
    ref_eng = RefEngine(backend="jax")
    _, ref_jobs = _round0(windows, ref_eng)
    eng._align(jobs)
    ref_eng._align(ref_jobs)
    assert stats["align_shapes"] == [(512, 128, 128)]
    for j, r in zip(jobs, ref_jobs):
        assert np.array_equal(j.ops, np.asarray(r.ops))


def test_host_impl_keeps_native_aligner(monkeypatch):
    """The host path aligns on the native aligner (the reference's
    force_native host path): the batched aligner is never called there,
    and its FASTA does not change."""
    calls = {"native": 0, "device": 0}
    native = NativeAligner.align_batch

    def spy_native(self, pairs):
        calls["native"] += 1
        return native(self, pairs)

    def spy_device(self, jobs):
        calls["device"] += 1
        raise AssertionError("the host path reached the batched aligner")

    monkeypatch.setattr(NativeAligner, "align_batch", spy_native)
    monkeypatch.setattr(PoaEngine, "_align_device", spy_device)
    windows = [w for w in _build_windows(5, 3, 6, 120, True)
               if w.n_layers >= 2]
    eng = PoaEngine(device="cpu", refine_rounds=1)
    assert eng._consensus_host_impl(windows) == len(windows)
    assert calls == {"native": 2, "device": 0}
    assert all(w.polished and len(w.consensus) for w in windows)
