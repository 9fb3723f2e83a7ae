"""The round merge's two kernels (csrc/merge.cu) on the CPU: their numpy
model (tests/merge_model.py) against the plain versions, bitwise, and
the wrappers' CPU path against the JAX package's merge.

Round-0 walks of two chunks feed them: ``bench.build_windows`` windows
(the band route, k=4) and ``merge_model.edge_windows`` (band and
full-width routes), whose chunk holds a window with no job and one with
a single job, partial spans, insertion runs of 1, 2 and more than K_INS
(a saturated walk, so an escape flag), a window whose consensus outgrows
the anchor width, and padded lanes. The model adds each gap's nonzero
contributions in job order, as M1 does, and compacts by a scatter from
each gap and scans, as M2 does; both must give the plain chains' bits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
import merge_model as M
from racon_tpu.ops import device_merge as rdm
from racon_tpu.ops import device_poa as R
from racon_tpu_torch.ops import device_merge as pdm
from racon_tpu_torch.ops import device_poa as P
from racon_tpu_torch.ops import kernels

FIELDS = ("ins_len", "qstart", "op_c", "qi_c")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chunk(wins, W, **caps):
    """A chunk's round-0 state, the walk's columns and escape flags."""
    plan = P.ChunkPlan(wins, **caps)
    job, winb = P.load_packed(*plan.packed_bufs(),
                              (plan.B, plan.Lq, plan.n_win, plan.LA), "cpu")
    st = P._unpack_bufs(job, winb, plan.Lq, plan.LA)
    q, qw8, begin, end, lq, win, w_read, bb, bbw, alen = st
    fwd = P._lane_fwd(bb, alen, begin, end, q, lq, win, match=5, mismatch=-4,
                      gap=-8, Lq=plan.Lq, LA=plan.LA, band_w=W,
                      nxt_k=4 if W else 1)
    cols, esc_w = P._lane_walk(*fwd, lq, LA=plan.LA, band_w=W)
    return dict(plan=plan, n_win=plan.n_win, LA=plan.LA, q=q, qw8=qw8,
                begin=begin, end=end, win=win, w_read=w_read, bb=bb, bbw=bbw,
                alen=alen, lt=fwd[3], t_off=fwd[4], cols=cols, esc_w=esc_w)


@pytest.fixture(scope="module")
def chunks():
    edge = M.edge_windows(1)
    return {
        "bench-band": _chunk(bench.build_windows(6, 20, 300, seed=4), 256,
                             lq_cap=384, la_cap=512),
        "edge-band": _chunk(edge, 256),
        "edge-flat": _chunk(edge, 0),
    }


@pytest.fixture(scope="module")
def plain(chunks):
    """M1's plain outputs of each chunk."""
    return {k: pdm.merge_votes_plain(
        c["cols"], c["q"], c["qw8"], c["w_read"], c["lt"], c["t_off"],
        c["esc_w"], c["win"], n_win=c["n_win"], LA=c["LA"])
        for k, c in chunks.items()}


def _walk(c):
    return torch.stack([c["cols"][n] for n in FIELDS], -1).numpy()


KEYS = ["bench-band", "edge-band", "edge-flat"]


def test_edge_chunk_reaches_every_case(chunks, plain):
    for key in ("edge-band", "edge-flat"):
        c = chunks[key]
        n_win, LA = c["n_win"], c["LA"]
        win = c["win"].numpy()
        counts = np.bincount(win[win < n_win], minlength=n_win)
        n_real = c["plan"].n_real_win
        assert 0 in counts[:n_real] and 1 in counts[:n_real]
        assert c["plan"].n_jobs < c["plan"].B                  # padded lanes
        ins = c["cols"]["ins_len"].numpy()
        assert {1, 2} <= set(np.unique(ins)) and ins.max() > pdm.K_INS
        assert (c["t_off"] > 0).any()                          # partial spans
        assert (plain[key][1] > 0).any()                       # escape flags
        acc = pdm.add_backbone(pdm.vote_views(plain[key][0]), c["bb"][:-1],
                               c["bbw"][:-1], c["alen"][:-1])
        total = pdm.assemble(acc, c["alen"][:-1], 0.2)["total"]
        assert (total > LA).any()                              # outgrown


@pytest.mark.parametrize("key", KEYS)
def test_model_votes_matches_plain(chunks, plain, key):
    """Skip-zero, job-order adds a gap (the model of M1) give the bits of
    extract_votes_cols -> aggregate_votes, every channel."""
    c = chunks[key]
    votes, wesc = plain[key]
    mv, mw = M.model_votes(_walk(c), c["q"].numpy(), c["qw8"].numpy(),
                           c["w_read"].numpy(), c["lt"].numpy(),
                           c["t_off"].numpy(), c["esc_w"].numpy(),
                           c["win"].numpy(), c["n_win"], c["LA"])
    assert mv.tobytes() == votes.numpy().tobytes()
    assert mw.tobytes() == wesc.numpy().tobytes()
    # Every sum is >= +0.0: the premise of skipping zero contributions.
    assert not np.signbit(mv).any()


@pytest.mark.parametrize("key", KEYS)
def test_vote_buffer_views_match_aggregate_votes(chunks, plain, key):
    c = chunks[key]
    ref = pdm.aggregate_votes(
        pdm.extract_votes_cols(c["cols"], c["q"], c["qw8"], c["w_read"],
                               c["lt"], c["t_off"], c["LA"]),
        c["win"], c["n_win"])
    views = pdm.vote_views(plain[key][0])
    assert set(views) == set(ref)
    for name, r in ref.items():
        assert views[name].shape == r.shape, name
        assert torch.equal(views[name], r), name
    assert torch.equal(pdm.pack_votes(views), plain[key][0])


@pytest.mark.parametrize("detect", [False, True])
@pytest.mark.parametrize("key", KEYS)
def test_model_windows_matches_plain(chunks, plain, key, detect):
    """Per-gap vote-out, scan, scatter compaction and map scans (the model
    of M2) give the bits of the plain back half, every output."""
    c = chunks[key]
    votes, wesc = plain[key]
    ovf = torch.zeros(c["n_win"], dtype=torch.bool)
    ovf[1] = True
    args = (votes, wesc, c["bb"], c["bbw"], c["alen"], c["begin"], c["end"],
            c["win"], ovf)
    kw = dict(ins_scale=0.2, n_win=c["n_win"], LA=c["LA"], detect=detect)
    ref = pdm.merge_windows_plain(*args, **kw)
    got = M.model_windows(*(a.numpy() for a in args), **kw)
    for i, (r, g) in enumerate(zip(ref, got)):
        assert r.numpy().dtype == g.dtype and np.array_equal(r.numpy(), g), i
    if detect:
        assert ref[7].any()


def test_model_windows_padded_lanes_read_last_window(chunks, plain):
    """Padded lanes (window id n_win) take the last window's maps: their
    spans remap alike in the plain version and the model, also when that
    window has a consensus of its own."""
    c = chunks["edge-band"]
    n_win, LA = c["n_win"], c["LA"]
    pad = (c["win"] == n_win).nonzero()[:, 0]
    assert len(pad)
    win = c["win"].clone()
    win[:3] = n_win - 1                     # lanes of the last window
    begin, end = c["begin"].clone(), c["end"].clone()
    begin[pad[:4]] = torch.tensor([0, 5, 200, -3], dtype=torch.int32)
    end[pad[:4]] = torch.tensor([1, 7, 300, LA + 9], dtype=torch.int32)
    alen = c["alen"].clone()
    alen[-1] = LA                           # the dummy row's length
    args = (plain["edge-band"][0], plain["edge-band"][1], c["bb"], c["bbw"],
            alen, begin, end, win, torch.zeros(n_win, dtype=torch.bool))
    kw = dict(ins_scale=0.2, n_win=n_win, LA=LA, detect=True)
    ref = pdm.merge_windows_plain(*args, **kw)
    got = M.model_windows(*(a.numpy() for a in args), **kw)
    for r, g in zip(ref, got):
        assert np.array_equal(r.numpy(), g)


@pytest.mark.parametrize("seed", [0, 1])
def test_model_matches_plain_on_random_inputs(seed):
    """Inputs no walk would give (merge_model.random_round: walk entries
    over their whole range, query codes up to 7, weights past 127,
    negative slice offsets, an empty window, spans past the anchor):
    the model of M1 and M2 still gives the plain versions' bits."""
    n_win, LA = 8, 200
    r = M.random_round(seed, 96, 80, LA, n_win)
    cols = {n: torch.from_numpy(r["walk"][..., i].copy())
            for i, n in enumerate(FIELDS)}
    t = {k: torch.from_numpy(v) for k, v in r.items() if k != "walk"}
    votes, wesc = pdm.merge_votes_plain(
        cols, t["q"], t["qw8"], t["w_read"], t["lt"], t["t_off"], t["esc_w"],
        t["win"], n_win=n_win, LA=LA)
    mv, mw = M.model_votes(r["walk"], r["q"], r["qw8"], r["w_read"], r["lt"],
                           r["t_off"], r["esc_w"], r["win"], n_win, LA)
    assert mv.tobytes() == votes.numpy().tobytes()
    assert mw.tobytes() == wesc.numpy().tobytes()
    for detect in (False, True):
        kw = dict(ins_scale=0.3, n_win=n_win, LA=LA, detect=detect)
        ref = pdm.merge_windows_plain(
            votes, wesc, t["bb"], t["bbw"], t["alen"], t["begin"], t["end"],
            t["win"], t["ovf"], **kw)
        got = M.model_windows(mv, mw, r["bb"], r["bbw"], r["alen"],
                              r["begin"], r["end"], r["win"], r["ovf"], **kw)
        for r_, g in zip(ref, got):
            assert np.array_equal(r_.numpy(), g)


def test_skip_zero_sums_are_bitwise():
    """The exactness argument on its own: adding a sequence of float32
    values >= 0 from +0.0 in order, one rounding an add, gives the same
    bits with and without its zeros."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, 60))
        v = (rng.random(n) * rng.choice([1e-3, 1.0, 37.0, 1e5])).astype(
            np.float32)
        v[rng.random(n) < 0.5] = 0.0
        a = b = np.float32(0.0)
        for x in v:
            a = np.float32(a + x)
            if x != 0:
                b = np.float32(b + x)
        assert a.tobytes() == b.tobytes()


def test_window_members(chunks):
    c = chunks["edge-band"]
    win, n_win = c["win"], c["n_win"]
    order, starts, counts = pdm.window_members(win, n_win)
    assert order.dtype == starts.dtype == counts.dtype == torch.int32
    real, pad = M.members(win.numpy(), n_win)
    for w in range(n_win):
        s, n = int(starts[w]), int(counts[w])
        assert np.array_equal(order[s:s + n].numpy(), real[w])
    tail = int(starts[-1] + counts[-1])
    assert np.array_equal(order[tail:].numpy(), pad)
    mem = pdm._Members(win, n_win)
    for w in range(n_win):
        got = order[int(starts[w]):int(starts[w] + counts[w])]
        assert torch.equal(got.long(), mem.table[w][mem.mask[w]])


@pytest.mark.parametrize("key", ["bench-band", "edge-flat"])
def test_merge_wrappers_cpu_match_reference(chunks, key):
    """kernels.merge_votes and merge_windows on CPU tensors (the plain
    versions) against the JAX package's aggregate_votes and _merge_round
    on the same walk: integer-valued channels and every output of the
    back half equal; float32 channels to rtol 1e-6 (their sum order)."""
    c = chunks[key]
    n_win, LA = c["n_win"], c["LA"]
    n0 = dict(kernels.LAUNCHES)
    mem = pdm.window_members(c["win"], n_win)
    votes, wesc = kernels.merge_votes(
        c["cols"], c["q"], c["qw8"], c["w_read"], c["lt"], c["t_off"],
        c["esc_w"], c["win"], mem, n_win=n_win, LA=LA)
    j = {k: jnp.asarray(v.numpy()) for k, v in c.items()
         if isinstance(v, torch.Tensor)}
    rcols = {n: jnp.asarray(c["cols"][n].numpy()) for n in FIELDS}
    rv = rdm.extract_votes_cols(rcols, j["q"], j["qw8"], j["w_read"],
                                j["lt"], j["t_off"], LA)
    racc = rdm.aggregate_votes(rv, j["win"], n_win + 1,
                               extras={"_esc": j["esc_w"]})
    exact = ("base_c", "ins1_w", "ins1_c", "ins1_stop", "pile_w", "pile_c",
             "_esc")
    views = dict(pdm.vote_views(votes), _esc=wesc)
    for name, r in racc.items():
        r = np.asarray(jnp.asarray(r, jnp.float32))[:n_win]
        if name in exact:
            assert np.array_equal(r, views[name].numpy()), name
        else:
            np.testing.assert_allclose(views[name].numpy(), r, rtol=1e-6,
                                       atol=0, err_msg=name)
    for detect in (False, True):
        ovf = torch.zeros(n_win, dtype=torch.bool)
        got = kernels.merge_windows(
            votes, wesc, c["bb"], c["bbw"], c["alen"], c["begin"], c["end"],
            c["win"], ovf, mem, ins_scale=0.2, n_win=n_win, LA=LA,
            detect=detect)
        ref = R._merge_round(rv, j["esc_w"], j["bb"], j["bbw"], j["alen"],
                             j["begin"], j["end"], j["win"],
                             jnp.asarray(ovf.numpy()), ins_scale=0.2,
                             n_win=n_win, LA=LA, detect=detect)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert np.array_equal(g.numpy(), np.asarray(r)), (detect, i)
    assert kernels.LAUNCHES == n0          # the plain versions launch nothing
    meta = c["q"].to("meta")               # neither the CPU nor the card
    with pytest.raises(kernels.KernelError):
        kernels.merge_votes(
            c["cols"], meta, c["qw8"], c["w_read"], c["lt"], c["t_off"],
            c["esc_w"], c["win"], mem, n_win=n_win, LA=LA)
    with pytest.raises(kernels.KernelError):
        kernels.merge_windows(
            votes.to("meta"), wesc, c["bb"], c["bbw"], c["alen"], c["begin"],
            c["end"], c["win"], ovf, mem, ins_scale=0.2, n_win=n_win, LA=LA)


# ------------------------------------- the redesigned kernels' orders, plans

def _hand_plan(LA, gaps, threads):
    return {"tiles": -(-(LA + 1) // gaps), "gaps": gaps, "threads": threads}


@pytest.mark.parametrize("plan", ["planner", "32 of 64", "64 of 64",
                                  "31 of 32"])
@pytest.mark.parametrize("key", KEYS)
def test_model_votes_tiled_matches_plain(chunks, plain, key, plan):
    """M1's redesigned order (merge_model.model_votes_tiled: tiles of
    merge_votes_plan, staged jobs, the left column's weight from the
    previous thread, 23 register channels adding zeros too, a run
    channel's first contribution stored and the channels a gap never
    adds to zeroed as the jobs go) gives the plain sums' bits; so do
    tiles whose edges fall elsewhere in a warp."""
    c = chunks[key]
    LA = c["LA"]
    pl = kernels.merge_votes_plan(LA) if plan == "planner" else _hand_plan(
        LA, *map(int, plan.split(" of ")))
    votes, wesc = plain[key]
    mv, mw = M.model_votes_tiled(
        _walk(c), c["q"].numpy(), c["qw8"].numpy(), c["w_read"].numpy(),
        c["lt"].numpy(), c["t_off"].numpy(), c["esc_w"].numpy(),
        c["win"].numpy(), c["n_win"], LA, pl)
    assert mv.tobytes() == votes.numpy().tobytes()
    assert mw.tobytes() == wesc.numpy().tobytes()


@pytest.mark.parametrize("detect", [False, True])
@pytest.mark.parametrize("key", KEYS)
def test_model_windows_narrow_matches_plain(chunks, plain, key, detect):
    """M2's narrow order (merge_model.model_windows_narrow: a gap a
    thread with its codes packed in a register, counts read again when
    scattered, one-value-a-thread scans, every position written once)
    gives the plain back half's bits, every output."""
    c = chunks[key]
    votes, wesc = plain[key]
    ovf = torch.zeros(c["n_win"], dtype=torch.bool)
    ovf[1] = True
    args = (votes, wesc, c["bb"], c["bbw"], c["alen"], c["begin"], c["end"],
            c["win"], ovf)
    kw = dict(ins_scale=0.2, n_win=c["n_win"], LA=c["LA"], detect=detect)
    ref = pdm.merge_windows_plain(*args, **kw)
    got = M.model_windows_narrow(
        *(a.numpy() for a in args), **kw,
        threads=kernels.merge_windows_plan(c["LA"])["threads"])
    for i, (r, g) in enumerate(zip(ref, got)):
        assert r.numpy().dtype == g.dtype and np.array_equal(r.numpy(), g), i
    if detect:
        assert ref[7].any()


@pytest.mark.parametrize("seed,LA", [(2, 127), (3, 450), (4, 640),
                                     (5, 1023)])
def test_redesigned_models_match_plain_on_random_inputs(seed, LA):
    """merge_model.random_round inputs at the card tests' widths: both
    redesigned orders give the plain versions' bits."""
    n_win = 8
    r = M.random_round(seed, 96, 80, LA, n_win)
    cols = {n: torch.from_numpy(r["walk"][..., i].copy())
            for i, n in enumerate(FIELDS)}
    t = {k: torch.from_numpy(v) for k, v in r.items() if k != "walk"}
    votes, wesc = pdm.merge_votes_plain(
        cols, t["q"], t["qw8"], t["w_read"], t["lt"], t["t_off"], t["esc_w"],
        t["win"], n_win=n_win, LA=LA)
    mv, mw = M.model_votes_tiled(r["walk"], r["q"], r["qw8"], r["w_read"],
                                 r["lt"], r["t_off"], r["esc_w"], r["win"],
                                 n_win, LA, kernels.merge_votes_plan(LA),
                                 stage=5)
    assert mv.tobytes() == votes.numpy().tobytes()
    assert mw.tobytes() == wesc.numpy().tobytes()
    threads = kernels.merge_windows_plan(LA)["threads"]
    for detect in (False, True):
        kw = dict(ins_scale=0.3, n_win=n_win, LA=LA, detect=detect)
        ref = pdm.merge_windows_plain(
            votes, wesc, t["bb"], t["bbw"], t["alen"], t["begin"], t["end"],
            t["win"], t["ovf"], **kw)
        got = M.model_windows_narrow(mv, mw, r["bb"], r["bbw"], r["alen"],
                                     r["begin"], r["end"], r["win"],
                                     r["ovf"], **kw, threads=threads)
        for r_, g in zip(ref, got):
            assert np.array_equal(r_.numpy(), g)


@pytest.mark.parametrize("LA1,tiles,gaps,threads", [
    (641, 6, 107, 128), (1025, 9, 114, 128), (129, 2, 65, 96),
    (128, 1, 128, 128), (33, 1, 33, 64), (2, 1, 2, 32)])
def test_merge_votes_plan_even_tiles(LA1, tiles, gaps, threads):
    """As few tiles of at most MERGE_TILE gaps as LA + 1 takes, the gaps
    split evenly (the last tile at most tiles - 1 gaps short of the
    others), threads the tile rounded up to whole warps."""
    plan = kernels.merge_votes_plan(LA1 - 1)
    assert (plan["tiles"], plan["gaps"], plan["threads"]) == (tiles, gaps,
                                                              threads)
    assert (tiles - 1) * gaps < LA1 <= tiles * gaps
    assert LA1 - (tiles - 1) * gaps >= gaps - tiles + 1
    assert plan["threads"] <= kernels.MERGE_TILE


@pytest.mark.parametrize("seed,B,Lq,LA,n_win", [
    (0, 40, 24, 30, 6), (1, 300, 96, 200, 12), (2, 64, 50, 127, 5)])
def test_votes_reads_are_m1s_reads(seed, B, Lq, LA, n_win):
    """chip_smoke.votes_reads, from which M1's bound counts its bytes,
    marks exactly the walk entries and query bytes that the kernel's
    model reads (merge_model.model_votes_reads: real jobs only, each
    job's entries t_off..t_off+lt, the bytes of its matching columns and
    insertion runs); the plain version over a walk and queries poisoned
    everywhere else gives the same bits, and poisoning one marked entry
    or byte changes them."""
    import chip_smoke as cs
    r = M.random_round(seed, B, Lq, LA, n_win)
    walk = torch.from_numpy(r["walk"])
    cols = {n: walk[..., i] for i, n in enumerate(FIELDS)}
    t = {k: torch.from_numpy(r[k]) for k in ("q", "qw8", "w_read", "lt",
                                              "t_off", "esc_w", "win")}
    w_sec, q_sec, walk_need, q_need = cs.votes_reads(
        cols, t["q"], t["qw8"], t["lt"], t["t_off"], t["win"], n_win, LA)
    want_w, want_q = M.model_votes_reads(r["walk"], r["lt"], r["t_off"],
                                         r["win"], n_win, Lq, LA)
    assert np.array_equal(walk_need.numpy(), want_w)
    assert np.array_equal(q_need.numpy(), want_q)
    assert 0 < w_sec < -(-B * (LA + 2) * 8 // 32) + B
    assert 0 < q_sec <= 2 * (-(-B * Lq // 32) + 1)
    args = (t["w_read"], t["lt"], t["t_off"], t["esc_w"], t["win"])
    kw = dict(n_win=n_win, LA=LA)
    ref = pdm.merge_votes_plain(cols, t["q"], t["qw8"], *args, **kw)
    for i in range(2):
        pc, pq, pw = cs.votes_poisoned(cols, t["q"], t["qw8"], walk_need,
                                       q_need, i)
        assert cs.same_bits(ref, pdm.merge_votes_plain(pc, pq, pw, *args,
                                                       **kw))
    rng = np.random.default_rng(seed)
    for need, other in ((walk_need, q_need), (q_need, walk_need)):
        hit = need.nonzero()
        cut = need.clone()
        cut[tuple(hit[rng.integers(len(hit))])] = False
        masks = (cut, other) if need is walk_need else (other, cut)
        pc, pq, pw = cs.votes_poisoned(cols, t["q"], t["qw8"], *masks, 0)
        assert not cs.same_bits(ref, pdm.merge_votes_plain(pc, pq, pw,
                                                           *args, **kw))


def test_merge_votes_plan_waves():
    """M1's plan holds only its tiles, gaps and threads; waves come from a
    measured occupancy (merge_occupancy on the card) through grid_waves:
    phase 7's grid (LA = 640, 160 windows: 960 blocks) runs in one wave
    on 132 SMs at 8 blocks an SM, twice the windows take two, and 3
    blocks an SM would take three."""
    plan = kernels.merge_votes_plan(640)
    assert set(plan) == {"tiles", "gaps", "threads"}
    blocks = plan["tiles"] * 160
    assert blocks == 960 and kernels.grid_waves(blocks, 8, 132) == 1
    assert kernels.grid_waves(2 * blocks, 8, 132) == 2
    assert kernels.grid_waves(blocks, 3, 132) == 3
    assert kernels.grid_waves(8 * 132 + 1, 8, 132) == 2
    with pytest.raises(kernels.KernelError):
        kernels.merge_votes_plan(0)


@pytest.mark.parametrize("LA,variant,threads", [
    (640, "narrow", 672), (1022, "narrow", 1024), (1023, "narrow", 1024),
    (1024, "wide", 256), (3200, "wide", 256), (1, "narrow", 32)])
def test_merge_windows_plan_variants(LA, variant, threads):
    """A gap a thread up to LA + 1 = 1024 (the maps in 8 bytes a column of
    shared memory); past it the wide kernel, whose state lies in device
    memory; the wide kernel may be asked for at any width, the narrow
    one only up to its limit."""
    plan = kernels.merge_windows_plan(LA)
    assert plan["variant"] == variant and plan["threads"] == threads
    if variant == "narrow":
        assert plan["smem"] == 8 * LA
        assert threads >= LA + 1 and threads % 32 == 0
        assert kernels.merge_windows_plan(LA, "wide") == {
            "variant": "wide", "threads": 256, "smem": 0}
    else:
        assert plan["smem"] == 0
        with pytest.raises(kernels.KernelError):
            kernels.merge_windows_plan(LA, "narrow")
    with pytest.raises(kernels.KernelError):
        kernels.merge_windows_plan(LA, "other")


def test_merge_windows_variant_is_the_cards(chunks, plain):
    """A variant is not taken on the CPU."""
    c = chunks["edge-band"]
    n_win = c["n_win"]
    with pytest.raises(kernels.KernelError):
        kernels.merge_windows(
            plain["edge-band"][0], plain["edge-band"][1], c["bb"], c["bbw"],
            c["alen"], c["begin"], c["end"], c["win"],
            torch.zeros(n_win, dtype=torch.bool),
            pdm.window_members(c["win"], n_win), ins_scale=0.2, n_win=n_win,
            LA=c["LA"], variant="narrow")
