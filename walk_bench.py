"""Time the column walk (W1, racon_tpu_torch/csrc/col_walk.cu) on the main
path's walk shapes, the NW traceback (T1, csrc/nw_traceback.cu) at the
op-string route's batch shapes, or the round merge's kernels (M1, M2,
csrc/merge.cu) at the main path's chunk shape, on one NVIDIA GPU.

    python3 walk_bench.py [--tree DIR] [--plans] [--main] [--traceback]
                          [--merge]

The cases are chip_smoke.py's (phase 2): the tiled overlap group (G
chunks of 64 lanes, LA = 10240, W = 1536, k = 2, int32), the untiled
overlap chunk (128 lanes, LA = 6144, W = 1024, k = 4), the consensus
chunk (4096 lanes, Lq = 640, W = 256, k = 4) on a forward of 8%-error
reads and of random codes, and the flat layout on the full-width
forward's planes (1024 lanes, Lt = 640, k = 1). Each forward is the
tree's own kernel. Each case prints one JSON line: the walk's time (warm
median of 10, CUDA events), the plan, and with --plans the time of each
alternative plan (threads a lane, window shape, lanes a block), each held
bitwise against the default plan's outputs.

--traceback  time T1 instead, on chip_smoke.py's cases (phase 2): K4's
            planes of 8%-error pairs (chip_smoke.nw_pairs) at [B, Lq, Lt]
            = [4096, 512, 512], [3072, 640, 512] and [4096, 640, 512].
            Each case prints one JSON line: T1's device time a call (a
            CUDA graph of 5 calls, median of 10 replays), bitwise against
            the plain traceback, its lanes a block, windows and misses a
            lane, registers, spills and blocks an SM. With --plans, an
            SM's share of the lanes split into blocks of at most 1, 4, 8
            or 16 lanes too, timed in turns with the planner's.

--merge     time M1 and M2 instead, as chip_smoke.py's phase 7 builds
            them: phase 4's dataset, its first consensus chunk at round 0
            ([B, Lq, LA, n_win] = [4096, 640, 640, 160]). Prints one JSON
            line: each kernel's device time a call (CUDA graphs of 10
            calls, median of 20 replays, in turns; the wide M2 too where
            the tree has it), each bitwise against its plain version. Run
            it for the parent's tree and this one in one call (parent,
            change, change, parent) to compare the two trees' kernels.
            merge_edits.py times edited copies of M1.

--tree DIR  time the racon_tpu_torch of another checkout, e.g. an
            unpacked ``git archive`` of the parent commit (run parent,
            change, change, parent in one call to compare them); its
            kernels build into DIR/build. The inputs come from this
            checkout's chip_smoke.py helpers.
--main      then run that tree's chip_smoke.py phase 4 (the main path at
            full size) and print its record (stage ms, consensus seconds,
            windows/s, peak device memory, launches).
--cases S   run only the cases whose name contains S: with --main and an
            S that names no case (``--cases none``), phase 4 alone, as
            the parent and change A/B of a main-path stage runs it.

The line before the last holds the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIELDS = ("ins_len", "qstart", "op_c", "qi_c", "sat")
TB_SHAPES = ((4096, 512, 512), (3072, 640, 512), (4096, 640, 512))


def load_smoke(root):
    """chip_smoke.py of ``root`` as a module (its helpers import the
    racon_tpu_torch first on sys.path)."""
    spec = importlib.util.spec_from_file_location(
        f"chip_smoke_{abs(hash(root))}", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiled_group(cs, dev):
    """The tiled overlap group's stitched planes, from K3 over 5 tiles."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.band import band_targets, row0_scores, \
        uc_boundary
    from racon_tpu_torch.ops.ovl_align import group_size
    lanes, L, W, T, k = 64, 9900, 1536, 2048, 2
    B = group_size(lanes, W, T, k, dev) * lanes
    c = cs.overlap_chunk(dev, B, L, W, T)
    Lq = c["Lq"]
    qT = c["q"].t().contiguous()
    base = torch.arange(B, dtype=torch.int64, device=dev) * Lq
    planes = (torch.empty((Lq, B, W), dtype=torch.uint8, device=dev),
              torch.empty((Lq, B, W), dtype=torch.uint8, device=dev), None)
    prev = row0_scores(c["klo"], W, -1)
    front = (prev, torch.full((B, W), uc_boundary(k), dtype=torch.int32,
                              device=dev), prev.clone())
    for ti in range(Lq // T):
        out = kernels.fw_dirs_band_tile(
            band_targets(c["t"].reshape(-1), base, c["klo"], c["lt"], W + T,
                         origin=ti * T), qT[ti * T:(ti + 1) * T], c["klo"],
            c["lq"], ti * T, *front, match=0, mismatch=-1, gap=-1, W=W,
            nxt_k=k, out=planes)
        front = (out[4], out[5], out[3])
    klos = c["klo"][None, :].repeat(Lq // T, 1).contiguous()
    return (planes[0], c["lq"], c["lt"], None, torch.zeros_like(c["lq"])), \
        dict(LA=Lq, layout="band", nxt=planes[1], tile_klo=klos,
             tile_len=T, emit=torch.int32)


def untiled_chunk(cs, dev):
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.band import band_targets
    from racon_tpu_torch.ops.ovl_align import untiled_walk_k
    B, W = 128, 1024
    c = cs.overlap_chunk(dev, B, 5400, W, T=2048, tiled=False, seed=6)
    Lq = c["Lq"]
    k = untiled_walk_k(Lq, W)
    base = torch.arange(B, dtype=torch.int64, device=dev) * Lq
    cells, nxt, nxt2, _ = kernels.fw_dirs_band(
        band_targets(c["t"].reshape(-1), base, c["klo"], c["lt"], W + Lq),
        c["q"].t().contiguous(), c["klo"], c["lq"], match=0, mismatch=-1,
        gap=-1, W=W, nxt_k=k)
    return (cells, c["lq"], c["lt"], c["klo"], torch.zeros_like(c["lq"])), \
        dict(LA=Lq, layout="band", nxt=nxt, nxt2=nxt2)


def consensus(cs, dev, reads):
    import torch
    from racon_tpu_torch.ops import kernels
    B, Lq, W = 4096, 640, 256
    if reads:
        tb, qT, klo, lq, lt = cs.consensus_reads(dev, B, Lq, W)
    else:
        tb, qT, klo, lq, lt = cs.band_inputs(dev, B, Lq, W)
    cells, nxt, nxt2, _ = kernels.fw_dirs_band(tb, qT, klo, lq, match=5,
                                               mismatch=-4, gap=-8, W=W,
                                               nxt_k=4)
    t_off = torch.from_numpy(np.random.default_rng(4).integers(
        0, 48, B).astype(np.int32)).to(dev)
    return (cells, lq, lt, klo, t_off), dict(
        LA=int(lt.max().item()) + 48, layout="band", nxt=nxt, nxt2=nxt2)


def flat(cs, dev):
    import torch
    from racon_tpu_torch.ops import kernels
    B, Lq, Lt = 1024, 640, 640
    rng = np.random.default_rng(2)
    tbuf = torch.from_numpy(rng.integers(0, 4, (B, Lt)).astype(
        np.uint8)).to(dev)
    qT = torch.from_numpy(rng.integers(0, 4, (Lq, B)).astype(
        np.uint8)).to(dev)
    cells = kernels.fw_dirs_flat(tbuf, qT, match=5, mismatch=-4, gap=-8)
    rng = np.random.default_rng(6)
    t_off = rng.integers(0, 48, B).astype(np.int32)
    lt = rng.integers(Lt * 3 // 4, Lt - 47, B).astype(np.int32)
    lq = rng.integers(Lq * 3 // 4, Lq + 1, B).astype(np.int32)
    return tuple([cells] + [torch.from_numpy(a).to(dev) for a in (lq, lt)] +
                 [None, torch.from_numpy(t_off).to(dev)]), dict(
        LA=Lt, layout="flat")


def alternative_plans(kernels, B, k, layout, n_tiles, sms):
    """(G, window) pairs around the planner's: G in 4..32 (and 1, 2 with
    many lanes), the windows of WALK_WINDOWS and a few others (short ones
    with many lanes), lanes a block as the planner would give them."""
    lanes_sm = -(-B // sms)
    many = lanes_sm >= 8
    wins = list(kernels.WALK_WINDOWS[layout])
    if layout == "flat":
        wins.append((64, 128))
    else:
        wins += [(128, 64), (64, 32), (32, 16), (16, 16)]
        if many:
            wins += [(8, 16), (8, 32), (4, 16), (4, 32), (2, 16), (1, 16),
                     (1, 32)]
    for G in ((1, 2) if many else ()) + (4, 8, 16, 32):
        for R, S in wins:
            lane = kernels.walk_lane_bytes(k, R, S, n_tiles)
            lpb = max(1, min(128 // G, lanes_sm))
            while lpb > 1 and lpb * lane > kernels.SMEM_MAX:
                lpb -= 1
            if lpb * lane <= kernels.SMEM_MAX:
                yield {"G": G, "R": R, "S": S, "lanes_per_block": lpb,
                       "lane_bytes": lane, "smem": lpb * lane}


def traceback_cases(cs, tree, plans):
    """T1 at TB_SHAPES (see --traceback); a tree whose wrapper takes lanes
    a block (this one) is also timed at the alternatives and reports its
    refill counts and occupancy."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.align import PAD_OP, traceback_plain
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    planned = "lanes_per_block" in inspect.signature(
        kernels.nw_traceback).parameters
    for B, Lq, Lt in TB_SHAPES:
        q, t, lq, lt = cs.nw_pairs(dev, B, Lq, Lt)
        dirs = kernels.nw_dirs(q, t, match=5, mismatch=-4, gap=-8)
        del q, t
        L = Lq + Lt
        rev = traceback_plain(dirs, lq, lt, L)
        ref = (torch.flip(rev, dims=[1]),
               (rev != PAD_OP).sum(dim=1, dtype=torch.int32))
        del rev
        lanes = [None]
        if planned and plans:
            lanes_sm = -(-B // sms)
            lanes += sorted({-(-lanes_sm // -(-lanes_sm // cap))
                             for cap in (1, 4, 8, 16)} - {
                kernels.traceback_plan(B, Lq, Lt, sms=sms)[
                    "lanes_per_block"]})
        fns, recs = [], []
        for lpb in lanes:
            kw = {} if lpb is None else {"lanes_per_block": lpb}
            err = cs.max_abs_err(ref, kernels.nw_traceback(dirs, lq, lt, L,
                                                           **kw))
            rec = {"tree": tree, "shape": [B, Lq, Lt], "max_abs_err": err}
            if planned:
                refills = torch.zeros((B, 2), dtype=torch.int32, device=dev)
                kernels.nw_traceback(dirs, lq, lt, L, refills=refills, **kw)
                w, m = refills.to(torch.float64).mean(dim=0).tolist()
                occ = kernels.traceback_occupancy(B, Lq, Lt, **kw)
                rec.update(windows_per_lane=w, misses_per_lane=m, **{
                    k: occ[k] for k in ("lanes_per_block", "smem", "regs",
                                        "spills", "blocks_per_sm")})
            if err:
                cs.fail(f"nw_traceback ({rec}) disagrees with its plain "
                        f"version (max_abs_err={err})")
            fns.append(lambda kw=kw: kernels.nw_traceback(dirs, lq, lt, L,
                                                          **kw))
            recs.append(rec)
        for rec, ms in zip(recs, cs.time_graph_turns(fns, reps=10, calls=5)):
            rec["ms"] = ms
            print(json.dumps(rec), flush=True)
        del dirs, ref
        torch.cuda.empty_cache()


def merge_cases(cs, tree):
    """M1 and M2 at phase 7's shape (see --merge)."""
    from racon_tpu_torch.ops import device_merge as dm
    from racon_tpu_torch.ops import kernels
    with tempfile.TemporaryDirectory(dir=tree) as tmp:
        c = cs.merge_chunk("cuda", cs.main_dataset(tmp)["paths"])
    plan = c["plan"]
    n_win, LA = plan.n_win, plan.LA
    vargs = (c["cols"], c["q"], c["qw8"], c["w_read"], c["lt"], c["t_off"],
             c["esc_w"], c["win"])
    mem = dm.window_members(c["win"], n_win)
    kw = dict(n_win=n_win, LA=LA)
    ref_v = dm.merge_votes_plain(*vargs, **kw)
    same = cs.same_bits(ref_v, kernels.merge_votes(*vargs, mem, **kw))
    wargs = (ref_v[0], ref_v[1], c["bb"], c["bbw"], c["alen"], c["begin"],
             c["end"], c["win"], c["ovf"])
    wkw = dict(ins_scale=0.2, n_win=n_win, LA=LA)
    ref_w = dm.merge_windows_plain(*wargs, **wkw)
    fns = {"merge_votes": lambda: kernels.merge_votes(*vargs, mem, **kw),
           "merge_windows": lambda: kernels.merge_windows(*wargs, mem,
                                                          **wkw)}
    if "variant" in inspect.signature(kernels.merge_windows).parameters:
        fns["merge_windows_wide"] = lambda: kernels.merge_windows(
            *wargs, mem, variant="wide", **wkw)
    for name in ("merge_windows", "merge_windows_wide"):
        if name in fns:
            same = same and cs.same_bits(ref_w, fns[name]())
    rec = {"tree": tree, "shape": [plan.B, plan.Lq, LA, n_win],
           "bitwise": same}
    rec.update(zip(fns, cs.time_graph_turns(list(fns.values()), reps=20,
                                            calls=10)))
    print(json.dumps(rec), flush=True)
    if not same:
        cs.fail(f"merge kernels of {tree} disagree with their plain "
                f"versions")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--main", action="store_true")
    ap.add_argument("--cases", default="",
                    help="run only the cases whose name contains this")
    ap.add_argument("--traceback", action="store_true",
                    help="time T1 instead of W1")
    ap.add_argument("--merge", action="store_true",
                    help="time M1 and M2 instead of W1")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        print("walk_bench: no CUDA device", file=sys.stderr)
        return 1
    cs = load_smoke(HERE)
    from racon_tpu_torch.ops import kernels
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(kernels.__file__)))
    if os.path.dirname(pkg) != tree:
        cs.fail(f"racon_tpu_torch came from {pkg}, not from {tree}")
    cs.CARD = cs.card()
    kernels.build()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if args.traceback:
        traceback_cases(cs, tree, args.plans)
        print(cs.CARD)
        return 0
    if args.merge:
        merge_cases(cs, tree)
        cases = ()
    else:
        cases = (("tiled overlap group", lambda: tiled_group(cs, dev)),
                 ("untiled overlap chunk", lambda: untiled_chunk(cs, dev)),
                 ("consensus 8%-error reads",
                  lambda: consensus(cs, dev, True)),
                 ("consensus random", lambda: consensus(cs, dev, False)),
                 ("flat layout", lambda: flat(cs, dev)))
    for name, build in cases:
        if args.cases not in name:
            continue
        pos, wk = build()
        B = pos[1].shape[0]
        k = 4 if wk.get("nxt2") is not None else (
            2 if wk.get("nxt") is not None else 1)
        rec = {"tree": tree, "case": name, "B": B, "nxt_k": k,
               "ms": cs.time_ms(lambda: kernels.col_walk_kernel(*pos, **wk),
                                reps=10)}
        if args.plans:
            n_tiles = 0 if wk.get("tile_klo") is None else \
                wk["tile_klo"].shape[0]
            rec["plan"] = kernels.walk_plan(B, k, layout=wk["layout"],
                                            n_tiles=n_tiles, sms=sms)
            ref = kernels.col_walk_kernel(*pos, **wk)
            rec["plans"] = []
            for plan in alternative_plans(kernels, B, k, wk["layout"],
                                          n_tiles, sms):
                out = kernels.col_walk_kernel(*pos, plan=plan, **wk)
                same = all(torch.equal(ref[n], out[n]) for n in FIELDS)
                rec["plans"].append(dict(
                    plan, same=same, ms=cs.time_ms(
                        lambda: kernels.col_walk_kernel(*pos, plan=plan,
                                                        **wk), reps=10)))
                if not same:
                    print(json.dumps(rec), flush=True)
                    cs.fail(f"{name}: plan {plan} changed the walk")
            del ref, out
        print(json.dumps(rec), flush=True)
        del pos, wk
        torch.cuda.empty_cache()
    if args.main:
        smoke = load_smoke(tree)
        smoke.CARD = cs.CARD
        with tempfile.TemporaryDirectory(dir=tree) as tmp:
            smoke.phase_main("cuda", tmp)
    print(cs.CARD)
    return 0


if __name__ == "__main__":
    sys.exit(main())
