"""The port's column walk and window merge against the JAX package.

Planes come from a real round-0 forward over ``bench.build_windows``
lanes (the port's plain forward, bitwise equal to the reference's twin);
both walks read the same planes. Then extract_votes_cols ->
aggregate_votes -> add_backbone -> assemble -> compact -> coord_maps run
on both sides. Integer-valued channels, codes, lengths and maps must be
equal; float32 channels agree to rtol 1e-6 — the only difference allowed
is the order of the float32 per-window sums.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
from racon_tpu.ops import colwalk as rcw
from racon_tpu.ops import device_merge as rdm
from racon_tpu_torch.ops import colwalk as pcw
from racon_tpu_torch.ops import device_merge as pdm
from racon_tpu_torch.ops import device_poa as P
from racon_tpu_torch.ops import kernels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rounds0():
    """Round-0 state and planes of one 6-window chunk, per layout/depth."""
    wins = bench.build_windows(6, 20, 300, seed=4)
    plan = P.ChunkPlan(wins, lq_cap=384, la_cap=512)
    job, winb = P.load_packed(*plan.packed_bufs(),
                              (plan.B, plan.Lq, plan.n_win, plan.LA), "cpu")
    st = P._unpack_bufs(job, winb, plan.Lq, plan.LA)
    q, qw8, begin, end, lq, win, w_read, bb, bbw, alen = st
    out = {"plan": plan, "state": st}
    W = 256
    for k in (1, 2, 4):
        out[("band", k)] = P._lane_fwd(
            bb, alen, begin, end, q, lq, win, match=5, mismatch=-4, gap=-8,
            Lq=plan.Lq, LA=plan.LA, band_w=W, nxt_k=k)
    out[("flat", 0)] = P._lane_fwd(
        bb, alen, begin, end, q, lq, win, match=5, mismatch=-4, gap=-8,
        Lq=plan.Lq, LA=plan.LA, band_w=0)
    return out


def _j(t):
    if t is None:
        return None
    if t.dtype == torch.uint16:
        return jnp.asarray(t.view(torch.int16).numpy().view(np.uint16))
    return jnp.asarray(t.numpy())


def _walks(r0, key):
    plan = r0["plan"]
    cells, nxt, nxt2, lt, t_off, klo, _ = r0[key]
    lq = r0["state"][4]
    layout = key[0]
    ref = rcw.col_walk(_j(cells), _j(lq), _j(lt), _j(klo), _j(t_off),
                       LA=plan.LA, layout=layout, nxt=_j(nxt), nxt2=_j(nxt2))
    out = pcw.col_walk(cells, lq, lt, klo, t_off, LA=plan.LA, layout=layout,
                       nxt=nxt, nxt2=nxt2)
    return ref, out


@pytest.mark.parametrize("key", [("band", 1), ("band", 2), ("band", 4),
                                 ("flat", 0)])
def test_col_walk_matches_reference(rounds0, key):
    ref, out = _walks(rounds0, key)
    for name in ("ins_len", "qstart", "op_c", "qi_c"):
        assert out[name].dtype == torch.int16
        assert np.array_equal(np.asarray(ref[name]), out[name].numpy()), name
    assert np.array_equal(np.asarray(ref["sat"]), out["sat"].numpy())


def test_walk_depths_agree(rounds0):
    """k = 1, 2 and 4 give the same walk (the nxt planes only shorten the
    dependent-gather chain)."""
    base = _walks(rounds0, ("band", 1))[1]
    for k in (2, 4):
        o = _walks(rounds0, ("band", k))[1]
        for name in ("ins_len", "qstart", "op_c", "qi_c", "sat"):
            assert torch.equal(base[name], o[name])


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("key", [("band", 4), ("flat", 0)])
def test_merge_matches_reference(rounds0, key):
    plan = rounds0["plan"]
    q, qw8, begin, end, lq, win, w_read, bb, bbw, alen = rounds0["state"]
    _, _, _, lt, t_off, _, _ = rounds0[key]
    ref_cols, cols = _walks(rounds0, key)
    LA, n_win = plan.LA, plan.n_win
    rv = rdm.extract_votes_cols(ref_cols, _j(q), _j(qw8), _j(w_read),
                                _j(lt), _j(t_off), LA)
    pv = pdm.extract_votes_cols(cols, q, qw8, w_read, lt, t_off, LA)
    for name in rv:
        assert np.array_equal(_f32(rv[name]), pv[name].numpy()), name

    racc = rdm.aggregate_votes(rv, _j(win), n_win + 1)
    pacc = pdm.aggregate_votes(pv, win, n_win)
    exact = ("base_c", "ins1_w", "ins1_c", "ins1_stop", "pile_w", "pile_c")
    for name in racc:
        r = _f32(racc[name])[:n_win]
        if name in exact:
            assert np.array_equal(r, pacc[name].numpy()), name
        else:   # fractional f32 channels: sum order only
            np.testing.assert_allclose(pacc[name].numpy(), r, rtol=1e-6,
                                       atol=0, err_msg=name)

    racc = {k: v[:-1] for k, v in racc.items()}
    racc = rdm.add_backbone(racc, _j(bb)[:-1], _j(bbw)[:-1], _j(alen)[:-1])
    pacc = pdm.add_backbone(pacc, bb[:-1], bbw[:-1], alen[:-1])
    rasm = rdm.assemble(racc, _j(alen)[:-1], 0.2)
    pasm = pdm.assemble(pacc, alen[:-1], 0.2)
    for name in ("ins_codes", "ins_cnt", "e", "col_code", "col_cov",
                 "start", "total", "pos", "kept"):
        assert np.array_equal(np.asarray(rasm[name]),
                              pasm[name].numpy()), name
    rc, rcov, rtot = rdm.compact(rasm, LA)
    pc, pcov, ptot = pdm.compact(pasm, LA)
    assert np.array_equal(np.asarray(rc), pc.numpy())
    assert np.array_equal(np.asarray(rcov), pcov.numpy())
    assert np.array_equal(np.asarray(rtot), ptot.numpy())
    rmb, rme = rdm.coord_maps(rasm, _j(alen)[:-1], LA)
    pmb, pme = pdm.coord_maps(pasm, alen[:-1], LA)
    assert np.array_equal(np.asarray(rmb), pmb.numpy())
    assert np.array_equal(np.asarray(rme), pme.numpy())


def test_chain_len_matches_reference():
    for la in (0, 1, 511, 640):
        for k in (1, 2, 4):
            assert pcw.chain_len(la, k) == rcw.chain_len(la, k)


def test_chase_follows_chain_of_loads():
    """The walk's latency probe on the CPU: chains of loads ``stride``
    entries apart, one a lane, followed from the top of the array."""
    loads = kernels.chain_of_loads(7, 5, "cpu")
    assert loads.numel() == 36 and loads.dtype == torch.int32
    assert kernels.chase(loads, 3).tolist() == [20]
    assert kernels.chase(loads, 7).tolist() == [0]
    loads = kernels.chain_of_loads(4, 10, "cpu", lanes=3, lane_stride=2)
    assert kernels.chase(loads, 4, lanes=3, lane_stride=2).tolist() == [4, 2,
                                                                        0]
    with pytest.raises(kernels.KernelError):
        kernels.chase(loads, 1, lanes=30, lane_stride=2)
    with pytest.raises(kernels.KernelError):
        kernels.chain_of_loads(2 ** 16, 2 ** 15, "cpu")
