"""Chip smoke of the PyTorch/CUDA port (racon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line with the card's name and power limit;
any failure exits non-zero and prints no result):

1. build      the CUDA kernels (csrc/*.cu, one nvcc per source, started
              together) and the host C++ aligner, from this checkout;
              then each band kernel instantiation the paths launch, with
              its registers, spills (local-memory bytes) and resident
              blocks an SM on this card;
2. kernels    each kernel against its plain PyTorch version on the card,
              bitwise, at the main path's shapes; kernel and plain times
              from CUDA events: band_fwd (K1) at the consensus shape, on
              an untiled overlap chunk as phase 3 runs it (128 lanes,
              Lq=6144, W=1024, k=4) and on the main path's untiled
              bucket as the path launches it (3 chunks of 128 lanes at
              Lq=8192, W=1536, k=2, in the group planner's launch groups
              of G chunks; each chunk launched alone must give its slice
              of its group's outputs, and the groups are timed in turns
              against the chunks launched one at a time), band_tile_fwd
              (K3) on tile 1 of an overlap group of G chunks of 64 lanes
              (G from the group planner, as the main path launches it)
              from tile 0's frontier and on its first 64 lanes, flat_fwd
              (K2), and col_walk (W1) on the group's stitched planes
              (tiled, int32), on the untiled chunk and the untiled
              bucket's groups (int16; timed in turns against its chunks'
              walks), at the consensus shape (k=4, int16) on K1's planes
              of random inputs and of 8%-error reads, and on K2's
              full-width planes (flat layout, k=1). Each walk's bound is
              the larger of its bytes bound and its serial floor, its
              chain_len dependent loads through shared memory; beside it
              the chain floor (the same loads through device memory at
              the walk's addresses: csrc/probe.cu in both modes), the
              windows and misses a lane from the kernel's refill counter,
              and its launch plan's registers and shared memory a block.
              Then the op-string route's kernels: nw_fwd (K4) at the
              route's batch shapes ([4096, 512, 512], [3072, 640, 512])
              and at [4096, 640, 512], the warp kernel timed in turns
              against the wide kernel forced at the same shape (both
              bitwise, with registers, spills and blocks an SM);
              nw_traceback (T1) on K4's planes at the same three
              shapes, with its sector bound, serial floor and chain
              floor, windows and misses a lane, registers, spills and
              blocks an SM; monotone_count (K5) at the merge's shape
              [14965, 532, 510] on route-like block keys and at [4096,
              1152, 514] on T1's op strings, in turns with
              torch.searchsorted (20 repetitions); K4, T1 and K5 times
              are device times from CUDA graphs of several calls;
3. small      the CLI with --device cuda and --device cpu on small
              synthetic inputs: the FASTA must be byte-identical (the
              cuda run aligns the overlaps on the card, untiled, and
              merges each round on M1 and M2; the cpu run uses the host
              aligner and the plain versions). Cases: kC on ~20 kb; -f
              (fragment correction) on an all-vs-all set of 24 reads; the
              option cases of tests/test_torch_cli_cases.py: partial-length
              reads (2 x 6 kb, 2.5 kb reads at 30x) with PAF and with MHAP
              overlaps, then on one such contig gzipped inputs, -u with a
              contig no read covers, and -w 200 -q 5 -e 0.2 (anchor width
              about 200 instead of 500); these run the convergence
              scheduler (the default, M2's sched mode launched); then kC
              and -f again under RACON_TPU_SCHED=0 (the fixed-round
              engine, no sched mode);
4. main       the main path at full size through the CLI entry point: a
              1 Mbp synthetic draft (20 contigs x 50 kb), 10 kb reads at
              30x, PAF overlaps aligned on the card (tiled route), w=500.
              Launch counts reset just before and read just after;
              band_fwd, band_tile_fwd and col_walk must have launched,
              band_tile_fwd once a tile of each launch group, band_fwd
              once for each untiled launch group beside the consensus
              forward's launches, every bucket of more than one chunk
              (tiled or untiled) in groups of G > 1, the
              consensus engine must have walked on the card (col_walk
              launches inside the stage clock's walk stage) and the
              overlap aligner must have handled jobs on the card. The
              host phases are split from the logger's phase lines.
              Polished edit distance to the truth must be at most a third
              of the draft's. The run takes the default chunk loop, the
              convergence scheduler; then the same inputs run under
              RACON_TPU_SCHED=0 (the fixed engine's depth-2 pipeline),
              with its own counts, and the FASTA must be the same. Each
              run prints its stage ms (tband, forward, walk, merge, and
              the scheduler's repack), the host split of its chunk
              loop summed over chunks (plan and packed_bufs, h2d
              enqueue, round launches, flag pulls, repack plans, collect,
              apply), its peak bytes and consensus seconds; the
              scheduler's run also its telemetry (survivor fraction a
              round, freeze histogram, window-rounds saved). In both,
              merge_votes = merge_windows + merge_windows_sched =
              consensus K1 launches, and the sched mode launches only
              under the scheduler. The inputs parse on the ingest plane
              (RACON_TPU_INGEST, default on: a prefetch thread a file,
              mmap readers), which must have run; each run prints the
              logger's "loaded ..." seconds and the ingest counters.
              The run telemetry (obs/metrics.py) of both runs, and of
              phase 8's, against the run's own counters: ovl_tiles_exec
              = the K3 launches, the align phase's step seconds
              (ovl_card_s + ovl_host_align_s + ovl_walk_s) <=
              align_phase_seconds,
              sched_* = the scheduler telemetry's (none under
              RACON_TPU_SCHED=0), device_dispatches = the host clock's
              rounds + repack + walk parts, adaptive rounds executed <=
              scheduled, align_phase_seconds <= the logger's "aligned
              overlaps" seconds, one h2d_transfer_s observation a
              transfer, ingest_enabled 1;
5. flat path  the band-off route (RACON_TPU_NO_BAND=1, the full-width
              forward) through the CLI on a 100 kb input, with its own
              launch counts; flat_fwd must have launched and the
              consensus engine must have walked on the card (flat layout);
6. op strings the batched aligner's route at full size: the windows of
              phase 4's first 5 contigs (Polisher.initialize), round 0's
              ~15k jobs through PoaEngine._align on the card (K4 and T1 in
              batches of up to 4096 lanes), then extract_votes (K5) and
              the device merge. Every path must score what the native
              aligner's path scores, and every window's consensus,
              coverage and coordinate maps must equal the host
              _merge_round's on the same op strings, except windows with
              an insertion run longer than K_INS (the device merge keeps
              K_INS pileup columns by design), which are counted;
7. merge      the round merge's kernels at the main path's chunk shape:
              phase 4's windows, chunked as the engine chunks them, the
              first chunk's round-0 forward and walk on the card, then
              merge_votes (M1) and merge_windows (M2, both variants:
              the narrow kernel the main path runs and the wide one,
              with and without detect) bitwise against their plain
              versions (the eager PyTorch chain), each timed as CUDA
              graphs in turns (time_graph_turns, the wide M2 as
              wide_ms), the plain chain warm (medians of 3 in turns);
              M1's tiles, gaps a tile and waves on this card; beside
              them the
              whole back half (M1 and M2 through device_poa._merge_round
              with the chunk's membership, as a round runs them), timed
              eagerly as the stage clock sees it, and
              registers, spills and blocks an SM of each kernel. M1's
              bound counts the sectors of the walk and the queries that
              its real jobs read on this data (votes_reads), M2's the
              sectors of the sums that its vote-out reads (vote_needs),
              and the phase fails unless each plain version over inputs
              poisoned outside its count gives the same bits. Then M2's
              sched mode at the chunk's round 1 (round 0's M1 and M2 on
              the card, round 1's forward and walk): windows that
              converge there freeze, two more carry the sticky flag,
              padding, ``last`` off and on, both variants bitwise
              against merge_windows_sched_plain, timed as graphs in turns
              against the base mode; its bound adds the sums that the
              freezing windows' final-scale vote-out reads and their
              output rows;
8. pipeline   phase 4's input through the CLI with --pipeline-depth 2
              (the streaming pipeline: build, pack, h2d, compute and walk
              stages on threads with bounded queues), under the scheduler
              and under RACON_TPU_SCHED=0, where every chunk but the last
              walks its final round decoupled (dispatch_chunk_fwd on the
              compute thread, dispatch_walk on the walk thread, the walk
              queue sized from the card's memory). Counts reset just
              before each run and read just after. Both FASTAs must be
              phase 4's serial FASTA byte for byte; the scheduler's run
              walks nothing decoupled, the fixed run all chunks but one;
              the launch rules of phase 4 hold exactly with two launching
              threads (col_walk's consensus walks = merge_votes =
              consensus K1). Each run prints its consensus seconds beside
              phase 4's serial run of the same chunk loop, every stage's busy
              and blocked seconds and items, every queue's peak and
              blocked seconds, the walk meter (decoupled walks, fused
              chunks, walk and overlap seconds), the ingest parse and
              wait seconds, stage ms, host split and peak bytes; the
              kernels line adds each row's launches in both runs.
9. faults     the fault plane on the card (resilience/: the retry and
              watchdog envelope, host degradation, stall recovery, the
              tracer), one JSON line a run, each run's FASTA byte for
              byte its clean run's in this call, counts reset just before
              and read just after: (1) phase 4's input with
              RACON_TPU_RETRY=attempts=3,base=0 under the scheduler with
              h2d/chunk:0,1;sched/flags:3;h2d/repack:0;d2h/chunk:4, and
              under RACON_TPU_SCHED=0 with dispatch/chunk:2;d2h/chunk:1:
              retries = injected faults, nothing degraded, the kernel
              launches exactly phase 4's clean run's (an injected raise
              fires before the body); (2) RACON_TPU_SCHED=0 with a 0.5 s
              dispatch deadline and dispatch/chunk:1!hang=2: one watchdog
              breach, the run finishes, the launches exactly the clean
              RACON_TPU_SCHED=0 run's (the abandoned attempt never runs
              its body); (3) phase 3's kC case with h2d/chunk:p=1.0 and 2
              attempts: every device window degraded to the host path, no
              consensus K1 launch, the overlap K1 and K3 launches as in
              phase 3; (4) phase 4's input with --pipeline-depth 2,
              RACON_TPU_STALL_S=0.5 and pipe/pack:0!hang=3: the stall
              detected, one stall event, the windows recovered on the
              host path counted; (5) phase 4's input with --trace: span
              counts by kind, the file's bytes, consensus seconds beside
              phase 4's; 3 ingest points parse/prefetch (the inputs
              parsed on prefetch threads) and one tile point a K3
              launch, = the final snapshot's ovl_tiles_exec; (6) phase 4's input under RACON_TPU_SCHED=0
              with a 1 us d2h deadline and 2 attempts: a real breach
              where kernels run is not degraded, the run exits 1 with no
              FASTA, one exhaustion at d2h/chunk, and every breach there
              (each a retry or the exhaustion).
              Phases 4 and 8 print each run's res_* counters
              (obs/metrics.resilience_extras), which must be empty:
              no retry, fault, breach, exhaustion or degraded window on a
              clean run.
10. serve     the service core on the card (server/, cache/,
              resilience/checkpoint.py), one JSON line a part: (1) an
              in-process PolishServer with HTTP on an ephemeral port:
              job A (phase 4's input, tenant acme) and jobs B and C
              (phase 3's kC and partial-PAF cases, tenant umbrella)
              submitted together; each stream byte for byte its phase's
              CLI FASTA; the consensus K1, W1, M1 and M2 launches > 0
              and equal to the sum over the batcher's dispatches, each
              kernel's count = the dispatches' + the jobs' own threads'
              (their overlap alignment); the res_* counters other than
              the checkpoint's (res_ckpt_*) empty; then B and C on a
              second server (cache off, a 3 s batch wait) one at a time
              and together: the occupancy together strictly above one
              at a time, a dispatch carrying both; then A resubmitted to
              the first server: a Tier-1 cache hit, the same bytes and
              no kernel launch; (2) a daemon subprocess (python -m
              racon_tpu_torch.server) with serve/commit:1!kill on the
              partial-PAF case exits 137; a standby restart adopts the
              state dir, re-queues the job and streams the same bytes;
              SIGTERM drains it with exit 0; (3) phase 4's input through
              the CLI with --checkpoint-dir under ckpt/commit:5!kill
              (exit 137), then --resume: phase 4's FASTA with fewer
              consensus K1 launches than phase 4. The phase prints its
              seconds. Part (1)'s /metrics renders ovl_device_jobs,
              sched_rounds, device_dispatches and h2d_transfer_s_bucket.
11. fleet     the ledger fleet on the card (distributed/, obs/fleet.py),
              one JSON line a part, the card's used memory (all
              processes) sampled throughout: (1) phase 4's input on one
              ledger (--workers 2 with RACON_TPU_DIST_SHARDS=2: 2 shards
              of 10 contigs, a 12 s lease; the default 4 shards of 5
              contigs cost more consensus K1 launches than a serial run,
              as each shard plans its own chunks, so the K1 check below
              does not hold there): worker A, a subprocess with
              dist/contig:7!kill, claims a shard, then worker B runs in
              this process, counts reset just before and read just
              after; A exits 137 after 7 commits, B polishes the other
              shard, steals A's after its lease expires, resumes A's 7
              contigs and merges: phase 4's FASTA byte for byte, one
              steal, dist_contigs_resumed = A's commits, each target once
              across the shard manifests, phase 4's launch rules, res_*
              empty, and B's consensus K1 launches and polished windows
              above 0 and below phase 4's (a split may happen; no check
              depends on it); (2) a 5-contig input polished
              serially on the card, then ``--autoscale --workers 2`` as a
              subprocess with spawn #0 killed at its second commit
              (RACON_TPU_AUTOSCALE_FAULT_PLAN) and RACON_TPU_METRICS_PORT
              set: the supervisor's stdout is the serial FASTA, its
              heartbeat shows the eviction replaced (3 spawns or more),
              /healthz answered 200 with the fleet's view while it ran,
              the fleet model renders as valid OpenMetrics listing as0
              and its replacement as2, and every worker that claimed a
              shard published consensus K1 launches above 0 in its
              metric shard; the fleet model folds the workers' ovl_* by
              sum and sched_* by the last worker's value. The kernels
              line adds each row's launches in B's run.
12. gateway   the gateway's fleet route and the wrapper tools on the card
              (gateway/, tools/), on phase 11's 5-contig cut and its
              serial bytes, one JSON line a part: (a) an in-process
              PolishServer with RACON_TPU_GATE_FLEET=1, _MIN_TARGETS=2,
              RACON_TPU_GATE_WORKERS=2 and its cache off routes the job
              to the fleet: a supervisor in the job's runner thread
              spawns two worker processes of the CLI on the card; the
              stream is the serial bytes, gate_routed_fleet and
              gate_fleet_runs are 1, the workers' metric shards show
              consensus K1, K3, W1, M1 and M2 launches above 0 (counted
              from 0 in each new worker process; W1's cases add up to its
              count, one consensus walk a consensus K1), this process launched
              nothing (counts reset just before), and the card's used
              memory (all processes) stays under 80 GB; (b) the same
              fingerprint again replays the finished ledger: the same
              bytes, no spawn, no launch; (c) with _MIN_TARGETS=99 the
              job routes local through this process's batcher, the same
              bytes; (d) python -m racon_tpu_torch.tools.wrapper --split
              120000 (3 chunks) as a subprocess: the serial bytes; then
              chunk_1.fasta deleted and --resume: the same bytes, only
              that chunk rewritten; each run's metric shard (under
              RACON_TPU_OBS_DIR) shows consensus K1 and K3 launches above
              0, the resumed run fewer consensus K1. The kernels line
              adds each row's launches in (a)'s workers, K1 and W1 by
              case.
13. mesh      the dp mesh on the card (parallel/dispatch.py, the sharded
              round), one JSON line a part, the replicated window state
              compared across the shards after every round: (a) phase
              4's input through the CLI with --dp 1 (a one-shard mesh):
              phase 4's FASTA byte for byte, phase 4's consensus K1
              launches, polished ED at most a third of the draft's, M1
              and M2 once a consensus round, M2 fused as in phase 4 (its
              launches of each form phase 4's; one shard sees every lane,
              so no emit or freeze half); (b) phase 11's 5-contig cut
              through the library polisher on a two-shard mesh over
              cuda:0, with the reads written as FASTA (integral vote
              weights: byte for byte the unsharded run) and as FASTQ (the
              cross-shard sum reassociates f32: at least 9 of 10 windows
              identical, ED at most a third of the draft's), M1 twice the
              unsharded run's launches and both M2 halves launched; (c)
              the cut's CLI
              with --distributed as one NCCL rank (WORLD_SIZE=1) in a
              process of its own: the serial FASTA byte for byte, M1 once
              a consensus K1; (d) nw_align_batch_sharded (dp 2) and
              sp_nw_align (dp 1 x sp 2) at [4096, 512, 512] bitwise
              nw_align_batch, with their times, K4 and T1 once a shard.
              The phase fails past 120 s. Phase 7 adds the mesh's M2
              halves at the main path's chunk split into two shards (the
              emit half and the freeze half, both variants, bitwise
              against their plain versions and the unsharded sched mode;
              timed as graphs). The kernels line adds each row's
              launches in (a) (by case), (b), (c) (K1 and W1 by case) and
              (d) as dp_dp1_launches, dp_dp2_launches, dp_dist_launches
              and dp_align_launches.

The last four lines: the run telemetry's checked numbers with the
seconds the checks took (``{"telemetry": ...}``), the kernel records,
the card's name and power limit, and the ok record.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM rates used for the bounds: HBM 3.35 TB/s; int32
# 16.7 TOP/s = 132 SMs x 64 INT32 lanes x 1.98 GHz (the 67 TFLOP/s fp32
# figure counts 128 lanes and an FMA as two operations).
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9
# Integer operations per DP cell, counted from the kernel sources (the
# tiled entry runs the same row body as band_fwd). nw_fwd counts what one
# pass over a row needs: the substitution's compare and select (2), diag
# and up (2), their max (1), the column's gap offset taken off and put
# back (2), the prefix max (1), h == diag and h == up (2), two selects
# (2) and the code packed into its stored word (2); the second sweep over
# a row that both K4 variants make, which recomputes diag and up after
# the scan, is not counted.
OPS_PER_CELL = {("band_fwd", 4): 50, ("band_fwd", 2): 40,
                ("band_fwd", 1): 30, ("flat_fwd", 0): 25,
                ("nw_fwd", 0): 14}
# Integer operations per traceback step (nw_traceback.cu) and, for the
# monotone count (count.cu), per X element and per output bin.
OPS_PER_STEP = 14
OPS_PER_X, OPS_PER_BIN = 5, 7
REPLACES = {
    "merge_windows_sched": "racon_tpu/sched/rounds.py:53",
    "merge_windows_emit": "racon_tpu/ops/device_poa.py:630",
    "merge_windows_freeze": "racon_tpu/sched/rounds.py:100",
    "band_fwd": "racon_tpu/ops/pallas/band_kernel.py:96",
    "band_tile_fwd": "racon_tpu/ops/pallas/band_kernel.py:428",
    "flat_fwd": "racon_tpu/ops/pallas/flat_kernel.py:31",
    "col_walk": "racon_tpu/ops/colwalk.py:66",
    "nw_fwd": "racon_tpu/ops/pallas/nw_kernel.py:42",
    "nw_fwd_wide": "racon_tpu/ops/pallas/nw_kernel.py:42",
    "nw_traceback": "racon_tpu/ops/align.py:75",
    "monotone_count": "racon_tpu/ops/pallas/count_kernel.py:33",
    "merge_votes": "racon_tpu/ops/device_merge.py:251",
    "merge_windows": "racon_tpu/ops/device_poa.py:601",
}
SOURCE = {"band_fwd": "band_fwd.cu", "band_tile_fwd": "band_fwd.cu",
          "flat_fwd": "flat_fwd.cu", "col_walk": "col_walk.cu",
          "nw_fwd": "nw_fwd.cu", "nw_fwd_wide": "nw_fwd.cu",
          "nw_traceback": "nw_traceback.cu",
          "monotone_count": "count.cu", "merge_votes": "merge.cu",
          "merge_windows": "merge.cu", "merge_windows_sched": "merge.cu",
          "merge_windows_emit": "merge.cu",
          "merge_windows_freeze": "merge.cu"}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, "card": CARD, **kw}), flush=True)


def time_turns(fns, reps: int = 5):
    """Warm medians of ``reps`` timed calls of each function (CUDA
    events), taken in turns: in order, then in reverse."""
    import torch
    for fn in fns:
        fn()
    ts = [[] for _ in fns]
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    for _ in range(reps):
        for i in order:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fns[i]()
            b.record()
            torch.cuda.synchronize()
            ts[i].append(a.elapsed_time(b))
    return [float(np.median(t)) for t in ts]


def time_graph_turns(fns, reps: int = 20, calls: int = 20):
    """Device time of one call of each function: ``calls`` calls captured
    in a CUDA graph, the graph's replays timed with CUDA events and
    divided by ``calls``; warm medians of ``reps`` replays, taken in
    turns (in order, then in reverse). For kernels of a few microseconds,
    whose eager call costs the host more than the card: events around an
    eager call time the host's launch."""
    import torch
    graphs = []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
        graphs.append(g)
    return [ms / calls for ms in time_turns([g.replay for g in graphs],
                                            reps)]


def time_ms(fn, reps: int = 5) -> float:
    """Warm median of ``reps`` timed calls (CUDA events)."""
    import torch
    fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def timed_once(fn):
    """(result, ms) of one call (CUDA events): for the plain versions,
    whose single run takes seconds."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by) from bytes over HBM and int32 ops over the
    int32 throughput."""
    b_ms = nbytes / HBM_BYTES_S * 1e3
    o_ms = ops / INT32_OPS_S * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def max_abs_err(ref, out, block: int = 1 << 27) -> int:
    """Largest |ref - out| over pairs of tensors (u8/u16/i16 compared as
    unsigned), a block of about ``block`` elements at a time along dim 0,
    so that a group's planes (billions of elements) need little scratch."""
    import torch
    err = 0
    for r, o in zip(ref, out):
        if r is None or o is None:
            if (r is None) != (o is None):
                return 1 << 30
            continue
        if r.dtype == torch.uint16:
            r, o = r.view(torch.int16), o.view(torch.int16)
        mask = {torch.int16: 0xFFFF, torch.uint8: 0xFF}.get(r.dtype)
        if r.dim() == 0:
            r, o = r.reshape(1), o.reshape(1)
        step = max(1, block // max(1, r[0].numel()))
        for i in range(0, r.shape[0], step):
            a = r[i:i + step].to(torch.int64)
            b = o[i:i + step].to(torch.int64)
            if mask is not None:
                a, b = a & mask, b & mask
            err = max(err, int((a - b).abs().max().item()))
    return err


def band_inputs(device, B, Lq, W, seed=1):
    """Main-path-like band inputs: query lengths ~ w=500 windows, target
    slices within the band, tband filled with 7 outside the slice."""
    import torch
    from racon_tpu_torch.ops.band import band_geometry
    rng = np.random.default_rng(seed)
    lq = rng.integers(Lq * 3 // 4, Lq - 8, B).astype(np.int32)
    lt = (lq + rng.integers(-40, 41, B)).astype(np.int32)
    klo, _ = band_geometry(torch.from_numpy(lq), torch.from_numpy(lt), W)
    y = np.arange(W + Lq)[None, :]
    rel = klo.numpy()[:, None] + y
    tband = rng.integers(0, 4, (B, W + Lq)).astype(np.uint8)
    tband[(rel < 0) | (rel >= lt[:, None])] = 7
    qT = rng.integers(0, 4, (Lq, B)).astype(np.uint8)
    return (torch.from_numpy(tband).to(device), torch.from_numpy(qT).to(device),
            klo.to(device), torch.from_numpy(lq).to(device),
            torch.from_numpy(lt).to(device))


def consensus_reads(device, B, Lq, W, seed=8):
    """Band inputs as a consensus chunk's lanes give them: targets of
    window-slice lengths (3/4 of Lq to Lq - 8 bases), queries 8%-error
    reads of them cut to Lq rows, the band origin of band_geometry and the
    target band of band_targets. Returns (tband, qT, klo, lq, lt)."""
    import torch
    from racon_tpu_torch.ops.band import band_geometry, band_targets
    from racon_tpu_torch.ops.encode import encode_bases
    from racon_tpu_torch.utils.synth import _BASES, mutate
    rng = np.random.default_rng(seed)
    q = np.zeros((B, Lq), np.uint8)
    t = np.zeros((B, Lq), np.uint8)
    lq = np.zeros(B, np.int32)
    lt = np.zeros(B, np.int32)
    for b in range(B):
        tt = _BASES[rng.integers(0, 4, int(rng.integers(Lq * 3 // 4,
                                                         Lq - 8)))]
        qq = mutate(rng, tt, 0.08)[0][:Lq]
        q[b, :len(qq)] = encode_bases(qq.tobytes())
        t[b, :len(tt)] = encode_bases(tt.tobytes())
        lq[b], lt[b] = len(qq), len(tt)
    lq_t, lt_t = torch.from_numpy(lq), torch.from_numpy(lt)
    klo = band_geometry(lq_t, lt_t, W)[0]
    base = torch.arange(B, dtype=torch.int64) * Lq
    tband = band_targets(torch.from_numpy(t).reshape(-1), base, klo, lt_t,
                         W + Lq)
    return tuple(a.to(device) for a in (
        tband, torch.from_numpy(q).t().contiguous(), klo, lq_t, lt_t))


def band_bound(B, rows, W, k, tiled=False):
    """bound() of the banded forward over B lanes, ``rows`` query rows and
    W band slots at walk depth k: the target window, query and klo/lq
    read; cells (+ nxt at k >= 2, + u16 nxt2 at k = 4) and hlast written;
    on the tiled entry also the frontier read and written."""
    cells = B * rows * W
    return bound(B * (W + rows) + rows * B + 8 * B +
                 cells * (1 + (k >= 2) + 2 * (k >= 4)) +
                 (24 if tiled else 4) * B * W,
                 cells * OPS_PER_CELL[("band_fwd", k)])


def overlap_chunk(device, B=64, L=9900, W=1536, T=2048, tiled=True,
                  seed=3):
    """An overlap chunk as the main path builds it: B lanes of L-base
    targets and 8%-error reads of them, padded to Lq = LA, a multiple of
    T, with the band origin of the tiled route's first tile (``tiled``)
    or of the untiled route."""
    import torch
    from racon_tpu_torch.ops.band import band_geometry
    from racon_tpu_torch.ops.encode import encode_bases
    from racon_tpu_torch.ops.ovl_align import tiled_origin
    from racon_tpu_torch.utils.synth import _BASES, mutate
    rng = np.random.default_rng(seed)
    ts = [_BASES[rng.integers(0, 4, L)] for _ in range(B)]
    qs = [mutate(rng, tt, 0.08)[0] for tt in ts]
    Lq = -(-max(L, *(len(qq) for qq in qs)) // T) * T
    q = np.zeros((B, Lq), np.uint8)
    t = np.zeros((B, Lq), np.uint8)
    lq = np.zeros(B, np.int32)
    lt = np.zeros(B, np.int32)
    for b, (tt, qq) in enumerate(zip(ts, qs)):
        q[b, :len(qq)] = encode_bases(qq.tobytes())
        t[b, :L] = encode_bases(tt.tobytes())
        lq[b], lt[b] = len(qq), L
    lq_t, lt_t = torch.from_numpy(lq), torch.from_numpy(lt)
    klo = (tiled_origin(lq_t, lt_t, W) if tiled else
           band_geometry(lq_t, lt_t, W))[0]
    return dict(q=torch.from_numpy(q).to(device), t=torch.from_numpy(t).to(
        device), lq=lq_t.to(device), lt=lt_t.to(device), klo=klo.to(device),
        B=B, Lq=Lq, W=W, T=T)


WALK_FIELDS = ("ins_len", "qstart", "op_c", "qi_c", "sat")


def chain_floor_ms(device, steps, step_bytes, lanes, lane_bytes) -> float:
    """Time of ``steps`` dependent loads ``step_bytes`` apart, one chain a
    lane with lanes ``lane_bytes`` apart, and no other work: the latency
    probe (csrc/probe.cu) on int32 entries at a walk's addresses."""
    import torch
    from racon_tpu_torch.ops import kernels
    probe = dict(lanes=lanes, lane_stride=lane_bytes // 4)
    loads = kernels.chain_of_loads(steps, step_bytes // 4, device, **probe)
    ends = kernels.chase(loads, steps, **probe)
    want = torch.arange(lanes - 1, -1, -1, device=device) * (lane_bytes // 4)
    if not torch.equal(ends.long(), want):
        fail("the latency probe did not reach the ends of its chains")
    return time_ms(lambda: kernels.chase(loads, steps, **probe))


@functools.lru_cache(maxsize=None)
def shared_step_ms(device) -> float:
    """Time of one dependent load through shared memory: the latency
    probe's shared mode, 2^20 loads down a chain of its most entries."""
    from racon_tpu_torch.ops import kernels
    loads = kernels.chain_of_loads(kernels.CHASE_SHARED_ENTRIES - 1, 1,
                                   device)
    steps = 1 << 20
    if kernels.chase(loads, steps, shared=True).item() != 0:
        fail("the shared-memory probe did not reach the end of its chain")
    return time_ms(lambda: kernels.chase(loads, steps, shared=True)) / steps


def walk_case(case, cells, lq, lt, klo, t_off, extra_bytes=0, **wk):
    """W1 against its plain version (bitwise) on one walk, with its time,
    the plain time and its bound: the larger of the bytes bound and the
    serial floor, chain_len dependent loads through shared memory (the
    probe's shared mode; bound_by "operations"). Beside it the chain
    floor, the same loads through device memory at the walk's addresses
    (the floor of a walk that loads every step from there), the windows
    and misses a lane (the kernel's refill counter), and what the launch
    plan gets on this card. Returns the record."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.colwalk import chain_len, col_walk
    B = lq.shape[0]
    W = cells.shape[2]
    k = 4 if wk.get("nxt2") is not None else (
        2 if wk.get("nxt") is not None else 1)
    LA = wk["LA"]
    ref, plain_ms = timed_once(lambda: col_walk(cells, lq, lt, klo, t_off,
                                                **wk))
    out = kernels.col_walk_kernel(cells, lq, lt, klo, t_off, **wk)
    err = max_abs_err([ref[n] for n in WALK_FIELDS],
                      [out[n] for n in WALK_FIELDS])
    esize = out["op_c"].element_size()
    del ref, out
    ms = time_ms(lambda: kernels.col_walk_kernel(cells, lq, lt, klo, t_off,
                                                 **wk))
    chain = chain_len(LA, k)
    bytes_ms, _ = bound(B * chain * k + B * (LA + 2) * 4 * esize + 16 * B +
                        extra_bytes, 0)
    serial_ms = chain * shared_step_ms(cells.device)
    bms, by = ((bytes_ms, "bytes") if bytes_ms >= serial_ms else
               (serial_ms, "operations"))
    # The old design's addresses: lanes W bytes apart, k plane rows a step.
    floor_ms = chain_floor_ms(cells.device, chain, k * B * W, B, W)
    refills = torch.zeros((B, 2), dtype=torch.int32, device=cells.device)
    kernels.col_walk_kernel(cells, lq, lt, klo, t_off, refills=refills,
                            **wk)
    per_lane = refills.to(torch.float64).mean(dim=0).tolist()
    n_tiles = 0 if wk.get("tile_klo") is None else wk["tile_klo"].shape[0]
    plan = kernels.walk_plan(
        B, k, layout=wk["layout"], n_tiles=n_tiles,
        sms=torch.cuda.get_device_properties(
            cells.device).multi_processor_count)
    occ = kernels.walk_occupancy(k, layout=wk["layout"],
                                 emit=wk.get("emit", torch.int16), plan=plan)
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, bytes_bound_ms=bytes_ms,
               serial_floor_ms=serial_ms, chain_floor_ms=floor_ms,
               windows_per_lane=per_lane[0], misses_per_lane=per_lane[1],
               regs=occ["regs"], spills=occ["spills"],
               blocks_per_sm=occ["blocks_per_sm"], smem_per_block=plan["smem"])
    emit("kernels", kernel="col_walk", case=case, nxt_k=k,
         shape=[B, cells.shape[0], W], LA=LA, emit=f"int{8 * esize}",
         chain_len=chain, plan=plan, threads=occ["threads"], **rec)
    if err:
        fail(f"col_walk ({case}) disagrees with its plain version "
             f"(max_abs_err={err})")
    return rec


def band_occ(W, rows, k, tiled):
    """Registers, spills and resident blocks an SM of the band kernel
    instantiation for (W, rows, k) on this card."""
    from racon_tpu_torch.ops import kernels
    occ = kernels.band_occupancy(W, rows, k, tiled=tiled)
    return {n: occ[n] for n in ("regs", "spills", "blocks_per_sm")}


def phase_build_occupancy():
    """Phase 1's record of every band kernel instantiation the paths
    launch: K1 at the consensus shape and the untiled overlap chunk, K3
    at each tiled tier (ops/budget.py TILE_TIERS) and walk depth."""
    from racon_tpu_torch.ops.budget import TILE_TIERS
    cases = [("band_fwd", 256, 640, 4), ("band_fwd", 256, 640, 2),
             ("band_fwd", 1024, 6144, 4), ("band_fwd", 1536, 8192, 2)]
    cases += sorted({("band_tile_fwd", W, T, k) for _, W, T, _ in TILE_TIERS
                     for k in (2, 4)})
    return [dict(kernel=n, W=W, rows=rows, nxt_k=k,
                 **band_occ(W, rows, k, n == "band_tile_fwd"))
            for n, W, rows, k in cases]


def phase_overlap_kernels(device, lanes=64, L=9900, W=1536, T=2048):
    """K3 on tile 1 of an overlap group (G chunks of 64 lanes, G from the
    group planner as the main path launches it; T=2048, W=1536, k=2) from
    tile 0's frontier, and on the group's first 64 lanes; then W1 over
    the group's stitched 5-tile planes (LA = 10240, tiled, int32); all
    bitwise against their plain versions. Returns the group's records."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.band import (band_targets,
                                          fw_dirs_band_tile_plain,
                                          row0_scores, uc_boundary)
    from racon_tpu_torch.ops.ovl_align import group_size
    k = 2
    G = group_size(lanes, W, T, k, device)
    B = G * lanes
    c = overlap_chunk(device, B, L, W, T)
    Lq = c["Lq"]
    sc = dict(match=0, mismatch=-1, gap=-1, W=W, nxt_k=k)
    qT = c["q"].t().contiguous()
    base = torch.arange(B, dtype=torch.int64, device=device) * Lq
    planes = (torch.empty((Lq, B, W), dtype=torch.uint8, device=device),
              torch.empty((Lq, B, W), dtype=torch.uint8, device=device),
              None)
    prev = row0_scores(c["klo"], W, -1)
    front = (prev, torch.full((B, W), uc_boundary(k), dtype=torch.int32,
                              device=device), prev.clone())
    occ = band_occ(W, T, k, True)

    def check(case, args, front, out_planes, n):
        """One tile over the first n lanes: kernel vs plain, time, bound."""
        out = kernels.fw_dirs_band_tile(*args, *front, out=out_planes, **sc)
        ref, plain_ms = timed_once(lambda: fw_dirs_band_tile_plain(
            *args, *front, **sc))
        err = max_abs_err(ref, out)
        del ref
        ms = time_ms(lambda: kernels.fw_dirs_band_tile(
            *args, *front, out=out_planes, **sc))
        bms, by = band_bound(n, T, W, k, tiled=True)
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                   bound_by=by, **occ)
        emit("kernels", kernel="band_tile_fwd", case=case, nxt_k=k,
             shape=[n, T, W], i0=args[4], G=G, **rec)
        if err:
            fail(f"band_tile_fwd ({case}) disagrees with its plain version "
                 f"(max_abs_err={err})")
        return out, rec

    recs = {}
    for ti in range(Lq // T):
        args = (band_targets(c["t"].reshape(-1), base, c["klo"], c["lt"],
                             W + T, origin=ti * T),
                qT[ti * T:(ti + 1) * T], c["klo"], c["lq"], ti * T)
        if ti == 1:
            # Tile 1 starts from tile 0's frontier, as on the main path:
            # first the group, then its first 64 lanes alone.
            out, recs["band_tile_fwd"] = check(f"group of {G} chunks", args,
                                               front, planes, B)
            tb, q1, klo, lq, i0 = args
            sub = (tb[:lanes], q1[:, :lanes].contiguous(), klo[:lanes],
                   lq[:lanes], i0)
            own = tuple(torch.empty((2 * T, lanes, W), dtype=torch.uint8,
                                    device=device) for _ in range(2))
            check(f"{lanes} lanes", sub, tuple(f[:lanes] for f in front),
                  own + (None,), lanes)
            del own
        else:
            out = kernels.fw_dirs_band_tile(*args, *front, out=planes, **sc)
        hl, p, u = out[3:]
        front = (p, u, hl)
    klos = c["klo"][None, :].repeat(Lq // T, 1).contiguous()
    recs["col_walk"] = walk_case(
        f"overlap group of {G} chunks", planes[0], c["lq"], c["lt"], None,
        torch.zeros_like(c["lq"]), extra_bytes=4 * klos.numel(), LA=Lq,
        layout="band", nxt=planes[1], tile_klo=klos, tile_len=T,
        emit=torch.int32)
    return recs


def phase_untiled_overlap_kernels(device, B=128, L=5400, W=1024):
    """K1 and W1 on an untiled overlap chunk as phase 3 runs it (128 lanes
    of ~5.4 kb, W=1024, Lq = LA = 6144, the untiled route's walk depth,
    int16 emission): both bitwise against their plain versions. Then the
    main path's untiled launch group (:func:`untiled_group_kernels`),
    whose records it returns."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.band import band_targets, fw_dirs_band_plain
    from racon_tpu_torch.ops.ovl_align import untiled_walk_k
    c = overlap_chunk(device, B, L, W, T=2048, tiled=False, seed=6)
    Lq = c["Lq"]
    k = untiled_walk_k(Lq, W)
    base = torch.arange(B, dtype=torch.int64, device=device) * Lq
    args = (band_targets(c["t"].reshape(-1), base, c["klo"], c["lt"],
                         W + Lq), c["q"].t().contiguous(), c["klo"], c["lq"])
    sc = dict(match=0, mismatch=-1, gap=-1, W=W, nxt_k=k)
    out = kernels.fw_dirs_band(*args, **sc)
    ref, plain_ms = timed_once(lambda: fw_dirs_band_plain(*args, **sc))
    err = max_abs_err(ref, out)
    del ref
    ms = time_ms(lambda: kernels.fw_dirs_band(*args, **sc))
    bms, by = band_bound(B, Lq, W, k)
    emit("kernels", kernel="band_fwd", case="overlap untiled", nxt_k=k,
         shape=[B, Lq, W], max_abs_err=err, ms=ms, plain_ms=plain_ms,
         bound_ms=bms, bound_by=by, **band_occ(W, Lq, k, False))
    if err:
        fail(f"band_fwd (overlap untiled) disagrees with its plain version "
             f"(max_abs_err={err})")
    cells, nxt, nxt2, _ = out
    walk_case("overlap untiled", cells, c["lq"], c["lt"], c["klo"],
              torch.zeros_like(c["lq"]), LA=Lq, layout="band", nxt=nxt,
              nxt2=nxt2)
    del out, cells, nxt, nxt2
    return untiled_group_kernels(device)


def untiled_group_kernels(device, n_chunks=3, L=7500, W=1536, Lq=8192,
                          LA=10240):
    """K1 and W1 on the main path's untiled bucket as the path launches it:
    ``n_chunks`` chunks of 128 lanes of reads up to ~8 kb (those at
    contig ends: Lq = 8192, LA = 10240, W = 1536, the route's walk depth),
    in the group planner's launch groups (G chunks a group from K1's
    occupancy, one wave of the card), one K1 launch and one walk a group.
    Each group is held bitwise against the plain versions, and each chunk
    launched alone must give its slice of its group's outputs. The
    records' ms is the first group's launch (G x 128 lanes, beside its
    bound); ``bucket_ms`` is every group of the bucket and ``chunks_ms``
    the bucket's chunks launched one at a time, timed in turns in this
    call. Returns the K1 and W1 records."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.band import band_targets, fw_dirs_band_plain
    from racon_tpu_torch.ops.ovl_align import (TB, group_mem_cap, group_size,
                                               plan_groups, untiled_walk_k)
    k = 4 if untiled_walk_k(Lq, W) >= 4 else 2
    G = group_size(TB, W, Lq, k, device, tiled=False)
    groups = plan_groups([TB] * n_chunks, G, Lq * W * (4 if k >= 4 else 2),
                         group_mem_cap(device))
    B = n_chunks * TB
    c = overlap_chunk(device, B, L, W, T=2048, tiled=False, seed=12)
    if c["Lq"] != Lq:
        fail(f"untiled bucket: reads padded to {c['Lq']} rows, not {Lq}")
    base = torch.arange(B, dtype=torch.int64, device=device) * Lq
    tband = band_targets(c["t"].reshape(-1), base, c["klo"], c["lt"], W + Lq)
    qT = c["q"].t().contiguous()
    zeros = torch.zeros_like(c["lq"])
    sc = dict(match=0, mismatch=-1, gap=-1, W=W, nxt_k=k)

    def lanes(s):
        """(K1 arguments, walk lane arguments) of the lanes in slice s."""
        return ((tband[s], qT[:, s].contiguous(), c["klo"][s], c["lq"][s]),
                (c["lq"][s], c["lt"][s], c["klo"][s], zeros[s]))
    g_lanes = [lanes(slice(g[0] * TB, (g[-1] + 1) * TB)) for g in groups]
    c_lanes = [lanes(slice(i * TB, (i + 1) * TB)) for i in range(n_chunks)]
    case = f"untiled overlap group of {len(groups[0])} chunks"
    outs, plain_ms, err = [], [], 0
    for ka, _ in g_lanes:
        outs.append(kernels.fw_dirs_band(*ka, **sc))
        ref, ms_plain = timed_once(lambda: fw_dirs_band_plain(*ka, **sc))
        plain_ms.append(ms_plain)
        err = max(err, max_abs_err(ref, outs[-1]))
        del ref
    alone = [kernels.fw_dirs_band(*ka, **sc) for ka, _ in c_lanes]
    for g, out in zip(groups, outs):
        for j, ci in enumerate(g):
            s = slice(j * TB, (j + 1) * TB)
            err = max(err, max_abs_err(
                [None if p is None else p[:, s] for p in out[:3]] +
                [out[3][s]], alone[ci]))
    ms, bucket_ms, chunks_ms = time_turns(
        [lambda: kernels.fw_dirs_band(*g_lanes[0][0], **sc),
         lambda: [kernels.fw_dirs_band(*ka, **sc) for ka, _ in g_lanes],
         lambda: [kernels.fw_dirs_band(*ka, **sc) for ka, _ in c_lanes]])
    bms, by = band_bound(len(groups[0]) * TB, Lq, W, k)
    k1 = dict(max_abs_err=err, ms=ms, bucket_ms=bucket_ms,
              chunks_ms=chunks_ms, plain_ms=plain_ms[0], bound_ms=bms,
              bound_by=by, G=G, **band_occ(W, Lq, k, False))
    emit("kernels", kernel="band_fwd", case=case, nxt_k=k,
         shape=[len(groups[0]) * TB, Lq, W], groups=groups, **k1)
    if err:
        fail(f"band_fwd ({case}) disagrees with its plain version or with "
             f"its chunks launched alone (max_abs_err={err})")

    def walks(planes, lane_args):
        return [kernels.col_walk_kernel(p[0], *wa, LA=LA, layout="band",
                                        nxt=p[1], nxt2=p[2])
                for p, (_, wa) in zip(planes, lane_args)]
    w1 = [walk_case(f"{case} (group {gi})", out[0], *wa, LA=LA,
                    layout="band", nxt=out[1], nxt2=out[2])
          for gi, (out, (_, wa)) in enumerate(zip(outs, g_lanes))][0]
    for g, got in zip(groups, walks(outs, g_lanes)):
        for j, want in enumerate(walks([alone[ci] for ci in g],
                                       [c_lanes[ci] for ci in g])):
            s = slice(j * TB, (j + 1) * TB)
            err = max_abs_err([got[n][s] for n in WALK_FIELDS],
                              [want[n] for n in WALK_FIELDS])
            if err:
                fail(f"col_walk ({case}): a chunk walked alone differs from "
                     f"its slice of its group's walk (max_abs_err={err})")
    w1["ms"], w1["bucket_ms"], w1["chunks_ms"] = time_turns(
        [lambda: walks(outs[:1], g_lanes[:1]), lambda: walks(outs, g_lanes),
         lambda: walks(alone, c_lanes)])
    w1["G"] = G
    emit("untiled_bucket", chunks=n_chunks, G=G, groups=groups,
         shape=[B, Lq, W], LA=LA, nxt_k=k, band_fwd_ms=ms,
         band_fwd_bucket_ms=bucket_ms, band_fwd_chunks_ms=chunks_ms,
         col_walk_ms=w1["ms"], col_walk_bucket_ms=w1["bucket_ms"],
         col_walk_chunks_ms=w1["chunks_ms"])
    return {("band_fwd", "untiled"): k1, ("col_walk", "untiled"): w1}


def phase_kernels(device, B=4096, Lq=640, W=256, Bf=1024, Lt=640):
    """Each kernel against its plain version on the card, bitwise."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.band import fw_dirs_band_plain
    from racon_tpu_torch.ops.flat import fw_dirs_flat_plain
    sc = dict(match=5, mismatch=-4, gap=-8)
    recs = {}
    *args, lt = band_inputs(device, B, Lq, W)
    for k in (4, 2):
        def run_k():
            return kernels.fw_dirs_band(*args, W=W, nxt_k=k, **sc)

        def run_p():
            return fw_dirs_band_plain(*args, W=W, nxt_k=k, **sc)
        out = run_k()
        ref = run_p()
        err = max_abs_err(ref, out)
        del ref
        if k == 4:
            # W1 at the consensus shape (k=4, int16) on these random
            # planes, whose paths wander off the diagonal.
            rng = np.random.default_rng(4)
            t_off = torch.from_numpy(rng.integers(0, 48, B).astype(
                np.int32)).to(device)
            walk_case("consensus random", out[0], args[3], lt, args[2],
                      t_off, LA=int(lt.max().item()) + 48, layout="band",
                      nxt=out[1], nxt2=out[2])
        del out
        ms = time_ms(run_k)
        plain_ms = time_ms(run_p, reps=1)
        bms, by = band_bound(B, Lq, W, k)
        recs[("band_fwd", k)] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=bms,
                                     bound_by=by, **band_occ(W, Lq, k, False))
        emit("kernels", kernel="band_fwd", case="consensus", nxt_k=k,
             shape=[B, Lq, W], **recs[("band_fwd", k)])
        if err:
            fail(f"band_fwd k={k} disagrees with its plain version "
                 f"(max_abs_err={err})")
    del args
    # W1 at the consensus shape on a forward of 8%-error reads of their
    # targets, whose paths stay near the diagonal as the main path's do.
    tb, qT, klo, lq, lt = consensus_reads(device, B, Lq, W)
    cells, nxt, nxt2, _ = kernels.fw_dirs_band(tb, qT, klo, lq, W=W,
                                               nxt_k=4, **sc)
    t_off = torch.from_numpy(np.random.default_rng(4).integers(
        0, 48, B).astype(np.int32)).to(device)
    recs[("col_walk", "consensus")] = walk_case(
        "consensus 8%-error reads", cells, lq, lt, klo, t_off,
        LA=int(lt.max().item()) + 48, layout="band", nxt=nxt, nxt2=nxt2)
    del tb, qT, cells, nxt, nxt2
    rng = np.random.default_rng(2)
    tbuf = torch.from_numpy(rng.integers(0, 4, (Bf, Lt)).astype(
        np.uint8)).to(device)
    qT = torch.from_numpy(rng.integers(0, 4, (Lq, Bf)).astype(
        np.uint8)).to(device)

    def run_fk():
        return kernels.fw_dirs_flat(tbuf, qT, **sc)

    def run_fp():
        return fw_dirs_flat_plain(tbuf, qT, **sc)
    err = max_abs_err([run_fp()], [run_fk()])
    ms = time_ms(run_fk)
    plain_ms = time_ms(run_fp, reps=1)
    cells = Bf * Lq * Lt
    bms, by = bound(Bf * Lt + Lq * Bf + cells,
                    cells * OPS_PER_CELL[("flat_fwd", 0)])
    recs[("flat_fwd", 0)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bms, bound_by=by)
    emit("kernels", kernel="flat_fwd", shape=[Bf, Lq, Lt],
         **recs[("flat_fwd", 0)])
    if err:
        fail(f"flat_fwd disagrees with its plain version (max_abs_err={err})")
    # W1 on K2's planes, as the band-off consensus path and the
    # full-width redo walk them (flat layout, k=1, LA = Lt).
    rng = np.random.default_rng(6)
    t_off = rng.integers(0, 48, Bf).astype(np.int32)
    lt_f = rng.integers(Lt * 3 // 4, Lt - 47, Bf).astype(np.int32)
    lq_f = rng.integers(Lq * 3 // 4, Lq + 1, Bf).astype(np.int32)
    recs[("col_walk", "flat")] = walk_case(
        "consensus flat", run_fk(), *(torch.from_numpy(a).to(device)
                                      for a in (lq_f, lt_f)), None,
        torch.from_numpy(t_off).to(device), LA=Lt, layout="flat")
    return recs


def nw_pairs(device, B, Lq, Lt, seed=10):
    """Pairs as the op-string route packs them: targets of window-slice
    lengths (up to Lt - 12 bases), queries 8%-error copies of them, codes
    zero-padded to (Lq, Lt), lanes in the route's order (sorted by target
    and then query length, as PoaEngine._align_device sorts its jobs)."""
    import torch
    from racon_tpu_torch.ops.encode import encode_bases
    from racon_tpu_torch.utils.synth import _BASES, mutate
    rng = np.random.default_rng(seed)
    q = np.zeros((B, Lq), np.uint8)
    t = np.zeros((B, Lt), np.uint8)
    lq = np.zeros(B, np.int32)
    lt = np.zeros(B, np.int32)
    for b in range(B):
        tt = _BASES[rng.integers(0, 4, int(rng.integers(Lt * 3 // 4,
                                                         Lt - 11)))]
        qq = mutate(rng, tt, 0.08)[0][:Lq]
        t[b, :len(tt)] = encode_bases(tt.tobytes())
        q[b, :len(qq)] = encode_bases(qq.tobytes())
        lq[b], lt[b] = len(qq), len(tt)
    order = np.lexsort((lq, lt))
    return tuple(torch.from_numpy(a[order]).to(device)
                 for a in (q, t, lq, lt))


def route_keys(device, B=14965, S=532, LA=508, seed=12):
    """Block keys as the op-string route's merge gives K5 (its shape
    [14965, 532, 510] in phase 6): right-aligned op strings of 8%-error
    alignments (4% insertions, 3% deletions) of window slices (3/4 of LA
    to LA - 12 columns) behind a PAD_OP prefix, at slice offsets that keep
    every slice inside the anchor, through device_merge.block_keys."""
    import torch
    from racon_tpu_torch.ops.align import PAD_OP
    from racon_tpu_torch.ops.cigar import DIAG, LEFT, UP
    from racon_tpu_torch.ops.device_merge import block_keys
    rng = np.random.default_rng(seed)
    lt = rng.integers(LA * 3 // 4, LA - 11, B)
    u = rng.random((B, S))
    ops = np.where(u < 0.04, UP, np.where(u < 0.07, LEFT, DIAG)).astype(
        np.uint8)
    ct = np.cumsum(ops != UP, axis=1)
    reached = ct[:, -1] >= lt
    n = np.where(reached, np.argmax(ct >= lt[:, None], axis=1) + 1, S)
    idx = np.arange(S)[None, :] - (S - n)[:, None]
    ops = np.where(idx >= 0, np.take_along_axis(ops, np.clip(idx, 0, None),
                                                axis=1), PAD_OP)
    t_off = rng.integers(0, LA - 8 - lt + 1).astype(np.int32)
    return block_keys(torch.from_numpy(ops.astype(np.uint8)).to(device),
                      torch.from_numpy(t_off).to(device))


def nw_case(device, B, Lq, Lt, sc):
    """K4 at one shape: the warp kernel (the planner's pick) and the wide
    kernel forced at the same shape, each bitwise against the plain
    version, timed in turns (warp, wide, wide, warp; device time a call
    from CUDA graphs of 5 calls, median of 10 replays).
    Returns (record, the warp kernel's planes, lq, lt)."""
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.align import nw_dirs_plain
    q, t, lq, lt = nw_pairs(device, B, Lq, Lt)
    ref, plain_ms = timed_once(lambda: nw_dirs_plain(q, t, **sc))
    err = max_abs_err([ref], [kernels.nw_dirs(q, t, **sc)])
    wide_err = max_abs_err([ref], [kernels.nw_dirs(q, t, variant="wide",
                                                   **sc)])
    del ref
    ms, wide_ms = time_graph_turns(
        [lambda: kernels.nw_dirs(q, t, **sc),
         lambda: kernels.nw_dirs(q, t, variant="wide", **sc)], reps=10,
        calls=5)
    cells = B * Lq * Lt
    bms, by = bound(B * (Lq + Lt) + cells,
                    cells * OPS_PER_CELL[("nw_fwd", 0)])
    rec = dict(shape=[B, Lq, Lt], max_abs_err=err, wide_max_abs_err=wide_err,
               ms=ms, wide_ms=wide_ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, warp=kernels.nw_occupancy(Lq, Lt),
               wide=kernels.nw_occupancy(Lq, Lt, "wide"))
    emit("kernels", kernel="nw_fwd", **rec)
    if err or wide_err:
        fail(f"nw_fwd at {[B, Lq, Lt]} disagrees with its plain version "
             f"(warp max_abs_err={err}, wide {wide_err})")
    return rec, kernels.nw_dirs(q, t, **sc), lq, lt


def count_case(case, Xs, P):
    """K5 on keys Xs at P bins, bitwise against the plain version, timed
    in turns with torch.searchsorted (which computes the same counts on
    these non-decreasing keys): device time a call from CUDA graphs of 20
    calls (median of 20 replays), and beside it ``eager_ms``, events
    around one eager call (median of 20), which the host's launch cost
    dominates."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.device_merge import monotone_count_plain
    B, S = Xs.shape
    ref, plain_ms = timed_once(lambda: monotone_count_plain(Xs, P))
    err = max_abs_err([ref], [kernels.monotone_count(Xs, P)])
    pa = torch.arange(P, dtype=torch.int32, device=Xs.device).expand(
        B, P).contiguous()
    lib_same = torch.equal(torch.searchsorted(Xs, pa).to(torch.int32), ref)
    del ref
    fns = [lambda: kernels.monotone_count(Xs, P),
           lambda: torch.searchsorted(Xs, pa)]
    ms, lib_ms = time_graph_turns(fns, reps=20)
    eager_ms, eager_lib_ms = time_turns(fns, reps=20)
    bms, by = bound(4 * B * (S + P), B * (OPS_PER_X * S + OPS_PER_BIN * P))
    occ = kernels.count_occupancy(P)
    rec = dict(case=case, shape=[B, S, P], max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               library_ms=lib_ms, library_equal=lib_same,
               eager_ms=eager_ms, eager_library_ms=eager_lib_ms,
               **{n: occ[n] for n in ("regs", "spills", "blocks_per_sm",
                                      "lanes_per_block")})
    emit("kernels", kernel="monotone_count", **rec)
    if err:
        fail(f"monotone_count ({case}) disagrees with its plain version "
             f"(max_abs_err {err})")
    if not lib_same:
        fail(f"torch.searchsorted disagrees with monotone_count ({case}) "
             "on non-decreasing keys")
    return rec


def path_sectors(dirs, lq, lt, ops, n, block: int = 1024) -> int:
    """32-byte sectors of the plane that the paths read: the cells (i, j)
    with i, j >= 1 each lane's walk stands on before a step, recovered
    from its op string, by address (a block of lanes at a time)."""
    import torch
    Lq, B, Lt = dirs.shape
    L = ops.shape[1]
    dev = dirs.device
    s = torch.arange(L, device=dev)[None, :]
    secs = []
    for b0 in range(0, B, block):
        sl = slice(b0, min(B, b0 + block))
        rev = torch.flip(ops[sl], dims=[1]).to(torch.int64)
        di = ((rev == 0) | (rev == 1)).to(torch.int64)
        dj = ((rev == 0) | (rev == 2)).to(torch.int64)
        ci = (lq[sl].clamp(0, Lq).to(torch.int64)[:, None] -
              torch.cumsum(di, dim=1) + di)
        cj = (lt[sl].clamp(0, Lt).to(torch.int64)[:, None] -
              torch.cumsum(dj, dim=1) + dj)
        bb = torch.arange(b0, sl.stop, device=dev)[:, None]
        addr = dirs.data_ptr() + ((ci - 1) * B + bb) * Lt + cj - 1
        read = (s < n[sl, None]) & (ci >= 1) & (cj >= 1)
        secs.append(torch.unique(addr[read] >> 5))
    return int(torch.unique(torch.cat(secs)).numel())


def tb_case(dirs, lq, lt):
    """T1 on K4's planes at one shape (L = Lq + Lt), bitwise against the
    plain traceback, its device time a call from CUDA graphs of 5 calls
    (median of 10 replays). Bound: the larger of the sector bound (the
    32-byte sectors the paths read, and the op strings and counts
    written once; bound_by "bytes"), the operations and the serial floor
    (the longest path's steps, each one dependent load through shared
    memory; bound_by "operations"). Beside it the bytes bound of one
    byte a step (the column the sector bound replaces), the chain floor
    (the longest lane's rows, each a dependent load one plane row below
    the last, through device memory), the windows and misses a lane (the
    kernel's refill counter) and what the planner's launch gets on this
    card. Returns (record, ops)."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.align import PAD_OP, traceback_plain
    Lq, B, Lt = dirs.shape
    L = Lq + Lt

    def plain_tb():
        rev = traceback_plain(dirs, lq, lt, L)
        return (torch.flip(rev, dims=[1]),
                (rev != PAD_OP).sum(dim=1, dtype=torch.int32))
    ref, plain_ms = timed_once(plain_tb)
    ops, n = kernels.nw_traceback(dirs, lq, lt, L)
    err = max_abs_err(ref, (ops, n))
    del ref
    ms, = time_graph_turns([lambda: kernels.nw_traceback(dirs, lq, lt, L)],
                           reps=10, calls=5)
    steps = int(n.sum().item())
    out_bytes = B * L + 12 * B
    bytes_ms, _ = bound(steps + out_bytes, 0)
    sectors = path_sectors(dirs, lq, lt, ops, n)
    sector_ms, _ = bound(32 * sectors + out_bytes, 0)
    ops_ms = bound(0, steps * OPS_PER_STEP)[0]
    max_n = int(n.max().item())
    serial_ms = max_n * shared_step_ms(dirs.device)
    bms, by = max((sector_ms, "bytes"), (ops_ms, "operations"),
                  (serial_ms, "operations"))
    rows = int(lq.max().item())
    floor_ms = chain_floor_ms(dirs.device, rows, B * Lt, B, Lt)
    refills = torch.zeros((B, 2), dtype=torch.int32, device=dirs.device)
    kernels.nw_traceback(dirs, lq, lt, L, refills=refills)
    per_lane = refills.to(torch.float64).mean(dim=0).tolist()
    occ = kernels.traceback_occupancy(B, Lq, Lt)
    rec = dict(shape=[B, Lq, Lt], max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=bms, bound_by=by, library_ms=None,
               sector_bound_ms=sector_ms, bytes_bound_ms=bytes_ms,
               serial_floor_ms=serial_ms, chain_floor_ms=floor_ms,
               sectors=sectors, steps=steps, max_n=max_n,
               windows_per_lane=per_lane[0], misses_per_lane=per_lane[1],
               plan={k: occ[k] for k in ("R", "C", "M", "lanes_per_block")},
               smem_per_block=occ["smem"],
               **{k: occ[k] for k in ("regs", "spills", "blocks_per_sm")})
    emit("kernels", kernel="nw_traceback", **rec)
    if err:
        fail(f"nw_traceback at {[B, Lq, Lt]} disagrees with its plain "
             f"version (max_abs_err={err})")
    return rec, ops


def phase_op_string_kernels(device):
    """K4, T1 and K5 at the op-string route's shapes, each bitwise against
    its plain version. K4 (both variants, in turns) and T1 on K4's planes
    at the route's batch shapes [4096, 512, 512] and [3072, 640, 512]
    and at [4096, 640, 512] (the shape of the earlier rows); K5 on the
    block keys of T1's op strings at [4096, 640, 512] with P = LA + 2
    (LA = Lt), [4096, 1152, 514], and on route keys at the merge's shape
    [14965, 532, 510], in turns with torch.searchsorted."""
    import torch
    from racon_tpu_torch.ops.device_merge import block_keys
    sc = dict(match=5, mismatch=-4, gap=-8)
    recs = {}
    shapes, tbs = [], []
    for B, Lq, Lt in ((4096, 512, 512), (3072, 640, 512), (4096, 640, 512)):
        rec, dirs, lq, lt = nw_case(device, B, Lq, Lt, sc)
        shapes.append(rec)
        tb, ops = tb_case(dirs, lq, lt)
        tbs.append(tb)
        del dirs
    # The rows: both K4 variants and T1 at the route's first batch shape.
    route = shapes[0]
    occ_keys = ("regs", "spills", "blocks_per_sm")
    recs["nw_fwd", 0] = dict(
        route, library_ms=None, C=route["warp"]["C"],
        shapes=[{n: r[n] for n in ("shape", "ms", "wide_ms", "plain_ms",
                                   "bound_ms")} for r in shapes],
        **{n: route["warp"][n] for n in occ_keys})
    recs["nw_fwd_wide", 0] = dict(
        shape=route["shape"], max_abs_err=route["wide_max_abs_err"],
        ms=route["wide_ms"], plain_ms=route["plain_ms"],
        bound_ms=route["bound_ms"], bound_by=route["bound_by"],
        library_ms=None, **{n: route["wide"][n] for n in occ_keys})
    recs["nw_traceback", 0] = dict(
        tbs[0], max_abs_err=max(r["max_abs_err"] for r in tbs),
        shapes=[{n: r[n] for n in ("shape", "ms", "plain_ms", "bound_ms",
                                   "sector_bound_ms", "serial_floor_ms",
                                   "chain_floor_ms", "windows_per_lane",
                                   "misses_per_lane")} for r in tbs])

    # K5 on the op strings of the last shape, [4096, 640, 512].
    B, Lt = lt.shape[0], tbs[-1]["shape"][2]
    rng = np.random.default_rng(11)
    t_off = torch.from_numpy((rng.random(B) * (Lt - lt.cpu().numpy() + 1))
                             .astype(np.int32)).to(device)
    LA = 508    # phase 6's merge shape: P = LA + 2 = 510
    recs["monotone_count", "merge"] = count_case(
        "route merge shape", route_keys(device, LA=LA), LA + 2)
    recs["monotone_count", "T1"] = count_case(
        "T1 op strings", block_keys(ops, t_off), Lt + 2)
    return recs


def run_cli(argv):
    """racon_tpu_torch.cli.main in this process; returns (rc, stdout
    bytes, stderr text, wall seconds)."""
    from racon_tpu_torch import cli
    out_b = io.BytesIO()
    out_t = io.TextIOWrapper(out_b, encoding="utf-8")
    err_t = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out_t), contextlib.redirect_stderr(err_t):
        rc = cli.main(argv)
        out_t.flush()
    return rc, out_b.getvalue(), err_t.getvalue(), time.perf_counter() - t0


def fasta_records(blob: bytes):
    lines = blob.split(b"\n")
    return {lines[i][1:].split(b" ")[0].decode(): lines[i + 1]
            for i in range(0, len(lines) - 1, 2)}


def write_mhap(paths, out):
    """The PAF's overlaps as MHAP: 1-based read and contig indices, the
    read's strand bit, spans and lengths."""
    def names(path):
        with open(path, "rb") as fh:
            lines = fh.read().split(b"\n")
        step = 4 if lines[0].startswith(b"@") else 2
        return {lines[i][1:].split()[0].decode(): i // step + 1
                for i in range(0, len(lines) - 1, step)}
    reads, contigs = names(paths["reads"]), names(paths["draft"])
    with open(paths["overlaps"]) as src, open(out, "w") as dst:
        for line in src:
            f = line.split("\t")
            dst.write(f"{reads[f[0]]} {contigs[f[5]]} 0.1 100 "
                      f"{int(f[4] == '-')} {f[2]} {f[3]} {f[1]} 0 {f[7]} "
                      f"{f[8]} {f[6]}\n")
    return out


def gzipped(path):
    import gzip
    import shutil
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    return path + ".gz"


def small_cases(tmp):
    """Phase 3's CLI cases: (name, argv, env). The 20 kb kC case; -f on an
    all-vs-all set; the five option cases of tests/test_torch_cli_cases.py
    (partial-length reads with PAF and with MHAP overlaps; on one such
    contig gzipped inputs, -u with a contig no read covers, and -w 200
    -q 5 -e 0.2); then kC and -f again on the fixed-round engine
    (RACON_TPU_SCHED=0). The rest run the scheduler, the default."""
    from racon_tpu_torch.utils.synth import write_dataset
    ds = write_dataset(os.path.join(tmp, "small"), seed=5, contig_len=20000,
                       read_len=5000, coverage=20)
    p = ds["paths"]
    cases = [("kC", [p["reads"], p["overlaps"], p["draft"]])]
    ava = write_dataset(os.path.join(tmp, "ava"), seed=12, contig_len=2000,
                        coverage=12, fastq=True, ava=True)["paths"]
    cases.append(("-f", ["-f", ava["reads"], ava["ava"], ava["reads"]]))
    two = write_dataset(os.path.join(tmp, "partial2"), seed=21, n_contigs=2,
                        contig_len=6000, read_len=2500,
                        coverage=30)["paths"]
    cases.append(("partial PAF", [two["reads"], two["overlaps"],
                                  two["draft"]]))
    cases.append(("partial MHAP", [two["reads"], write_mhap(
        two, os.path.join(tmp, "partial2", "overlaps.mhap")), two["draft"]]))
    one = write_dataset(os.path.join(tmp, "partial1"), seed=21,
                        contig_len=6000, read_len=2500,
                        coverage=30)["paths"]
    cases.append(("gzipped", [gzipped(one["reads"]),
                              gzipped(one["overlaps"]),
                              gzipped(one["draft"])]))
    lonely = os.path.join(tmp, "partial1", "draft_lonely.fasta")
    rng = np.random.default_rng(22)
    with open(one["draft"], "rb") as src, open(lonely, "wb") as dst:
        dst.write(src.read() + b">lonely\n" + np.frombuffer(
            b"ACGT", np.uint8)[rng.integers(0, 4, 3000)].tobytes() + b"\n")
    cases.append(("-u", ["-u", one["reads"], one["overlaps"], lonely]))
    cases.append(("-w 200 -q 5 -e 0.2",
                  ["-w", "200", "-q", "5", "-e", "0.2", one["reads"],
                   one["overlaps"], one["draft"]]))
    cases = [(name, argv, {}) for name, argv in cases]
    fixed = {"RACON_TPU_SCHED": "0"}
    return cases + [(f"{name} RACON_TPU_SCHED=0", argv, fixed)
                    for name, argv, _ in cases[:2]]


def phase_small(device, tmp):
    """Phase 3: each of small_cases' CLI runs with --device cuda and
    --device cpu, byte-identical; the overlaps of each aligned on the card
    and its consensus merged by M1 and M2. Returns each case's argv,
    --device cuda FASTA and launches."""
    from racon_tpu_torch.ops import kernels, ovl_align
    recs = []
    runs = {}
    for name, argv, env in small_cases(tmp):
        argv = argv + ["-t", "8"]
        os.environ.update(env)
        try:
            kernels.reset_launches()
            ovl_align.reset_stats()
            ovl0 = ovl_counts()
            rc_g, out_g, err_g, wall_g = run_cli(argv + ["--device", device])
            launches = dict(kernels.LAUNCHES)
            ovl = {k: v - ovl0[k] for k, v in ovl_counts().items()}
            rc_c, out_c, err_c, wall_c = run_cli(argv + ["--device", "cpu"])
        finally:
            for k in env:
                os.environ.pop(k, None)
        if rc_g or rc_c:
            fail(f"small CLI run {name!r} failed: {err_g[-2000:]} "
                 f"{err_c[-2000:]}")
        recs.append(dict(case=name, sched=not env, bytes=len(out_g),
                         records=out_g.count(b">"),
                         identical=out_g == out_c and len(out_g) > 0,
                         wall_s_gpu=wall_g, wall_s_cpu=wall_c,
                         launches=launches, ovl=ovl))
        runs[name] = dict(argv=argv, out=out_g, launches=launches)
    emit("small", cases=recs)
    for r in recs:
        if not r["identical"]:
            fail(f"small run {r['case']!r}: --device cuda and --device cpu "
                 f"FASTA differ")
        if r["ovl"]["device_jobs"] <= 0:
            fail(f"small run {r['case']!r}: no overlap was aligned on the "
                 f"card")
        n = r["launches"]
        if not n["merge_votes"] == n["merge_windows"] + \
                n["merge_windows_sched"] > 0:
            fail(f"small run {r['case']!r}: the consensus did not merge on "
                 f"the card ({n})")
        if (n["merge_windows_sched"] > 0) != r["sched"]:
            fail(f"small run {r['case']!r}: M2's sched mode launched "
                 f"{n['merge_windows_sched']} times (scheduler "
                 f"{'on' if r['sched'] else 'off'})")
    return runs


def consensus_seconds(err: str) -> float:
    m = re.findall(r"generated consensus ([0-9.]+) s", err)
    return float(m[-1]) if m else float("nan")


def phase_seconds(err: str) -> dict:
    """Seconds of each logger phase line (``[...] <phase> <s> s``)."""
    return {name: float(sec) for name, sec in re.findall(
        r"^\[racon_tpu_torch::Polisher::\w+\] ([a-z ]+?) ([0-9.]+) s$",
        err, flags=re.M)}


def ovl_counts() -> dict:
    """The overlap aligner's registry counters: jobs the card took, jobs
    sent to the host aligner, and tile launches."""
    from racon_tpu_torch.obs.metrics import registry
    reg = registry()
    return {"device_jobs": reg.get("ovl_device_jobs", 0),
            "native_jobs": reg.get("ovl_native_jobs", 0),
            "tiles": reg.get("ovl_tiles_exec", 0)}


def routed(err: str):
    flagged = sum(int(x) for x in re.findall(
        r"(\d+) window\(s\) flagged", err))
    host = sum(int(x) for x in re.findall(
        r"(\d+) window\(s\) unresolved", err))
    return flagged, host


def main_dataset(tmp, n_contigs=20, contig_len=50000, read_len=10000,
                 coverage=30):
    """Phase 4's synthetic input (module docstring) under tmp/main."""
    from racon_tpu_torch.utils.synth import write_dataset
    return write_dataset(os.path.join(tmp, "main"), seed=7,
                         n_contigs=n_contigs, contig_len=contig_len,
                         read_len=read_len, coverage=coverage,
                         draft_err=0.03, read_err=0.08)


@contextlib.contextmanager
def sched_telemetry():
    """The convergence scheduler's telemetry of the engines made inside
    the block (PoaEngine._make_scheduler watched): a list of
    SchedTelemetry."""
    from racon_tpu_torch.ops.poa import PoaEngine
    seen = []
    make = PoaEngine._make_scheduler

    def watched(self):
        sched = make(self)
        if all(t is not sched.telemetry for t in seen):
            seen.append(sched.telemetry)
        return sched

    PoaEngine._make_scheduler = watched
    try:
        yield seen
    finally:
        PoaEngine._make_scheduler = make


def main_run(device, argv, sched: bool, pipeline: bool = False,
             expect_rc: int = 0):
    """One CLI run of phase 4's input, under the convergence scheduler or
    (``sched`` False) RACON_TPU_SCHED=0, serial or (``pipeline``) with
    --pipeline-depth 2: launch counts, stage clock, host split and the
    pipeline's and ingest plane's counters from zero just before, read
    just after. A run whose exit code is not ``expect_rc`` fails."""
    import torch
    from racon_tpu_torch.ops import device_poa, kernels, ovl_align
    from racon_tpu_torch.obs import metrics
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    clock = device_poa.set_stage_clock(True)
    host = device_poa.set_host_clock(True)
    ovl_align.reset_stats()
    metrics.reset()
    kernels.reset_launches()
    if not sched:
        os.environ["RACON_TPU_SCHED"] = "0"
    try:
        with sched_telemetry() as telem:
            rc, out, err, wall = run_cli(
                argv + (["--pipeline-depth", "2"] if pipeline else []))
    finally:
        os.environ.pop("RACON_TPU_SCHED", None)
        device_poa.set_stage_clock(False)
        device_poa.set_host_clock(False)
    launches = dict(kernels.LAUNCHES)
    r = dict(rc=rc, out=out, err=err, wall=wall, launches=launches,
             ovl=ovl_counts(),
             groups=[dict(g) for g in ovl_align.TILED_GROUPS],
             ugroups=[dict(g) for g in ovl_align.UNTILED_GROUPS],
             stages=clock.ms(), stage_launches=clock.launches(),
             host_s=dict(host.s), host_n=dict(host.n),
             counters=metrics.registry().snapshot(),
             resilience=metrics.resilience_extras(),
             peak=torch.cuda.max_memory_allocated() if device == "cuda"
             else None, telemetry=telem[-1] if telem else None)
    r["walks"] = r["stage_launches"].get("walk", {}).get("col_walk", 0)
    r["k1_consensus"] = r["stage_launches"].get("forward", {}).get(
        "band_fwd", 0)
    if rc != expect_rc:
        fail(f"{'pipeline' if pipeline else 'main'} run "
             f"({'scheduler' if sched else 'RACON_TPU_SCHED=0'}) "
             f"failed: {err[-3000:]}")
    return r


def check_launches(name, r):
    """The launch rules of one run of phase 4's input (phases 4 and 8):
    K1 once a consensus round beside one launch a untiled overlap group;
    M1 and M2 (either mode) once a consensus round each, inside the stage
    clock's merge stage; W1 once a consensus round beside the overlap
    groups' walks. The stage clock counts each thread's launches, so the
    rules hold with the pipeline's two launching threads too."""
    n = r["launches"]
    k1 = r["k1_consensus"]
    untiled = sum(g["groups"] for g in r["ugroups"])
    tiled = sum(g["groups"] for g in r["groups"])
    if n["band_fwd"] != k1 + untiled:
        fail(f"{name}: band_fwd launched {n['band_fwd']} times, not {k1} "
             f"consensus + {untiled} untiled groups")
    ml = r["stage_launches"].get("merge", {})
    m2 = n["merge_windows"] + n["merge_windows_sched"]
    m2_stage = ml.get("merge_windows", 0) + ml.get("merge_windows_sched", 0)
    if not (n["merge_votes"] == ml.get("merge_votes") == m2 == m2_stage
            == k1):
        fail(f"{name}: merge_votes {n['merge_votes']}, merge_windows + "
             f"sched {m2} ({ml} in the merge stage), not once a consensus "
             f"round ({k1})")
    if n["col_walk"] != tiled + r["walks"] + untiled:
        fail(f"{name}: col_walk launched {n['col_walk']} times, not "
             f"{tiled} tiled + {r['walks']} consensus + {untiled} untiled")
    if r["walks"] != k1:
        fail(f"{name}: {r['walks']} consensus walks, not one a consensus "
             f"round ({k1})")


def launches_by_case(r):
    """A run's launches of each kernels-line row (W1 and K1 by case)."""
    n = r["launches"]
    untiled = sum(g["groups"] for g in r["ugroups"])
    return {("col_walk", 0): sum(g["groups"] for g in r["groups"]),
            ("col_walk", "consensus"): r["walks"],
            ("col_walk", "untiled"): untiled,
            ("band_fwd", 4): r["k1_consensus"],
            ("band_fwd", "untiled"): untiled,
            ("merge_votes", 0): n["merge_votes"],
            ("merge_windows", 0): n["merge_windows"],
            ("merge_windows_sched", 0): n["merge_windows_sched"]}


def check_clean(name, r):
    """A clean run retried, injected, breached, exhausted and degraded
    nothing: no degrade can hide a kernel on the main path."""
    res = r["resilience"]
    for key in ("res_retry_total", "res_fault_injected_total",
                "res_watchdog_breach_total", "res_retry_exhausted",
                "res_degraded_windows"):
        if res.get(key, 0) != 0:
            fail(f"{name}: {key} = {res[key]} on a clean run ({res})")


def main_record(r, ds, n_windows):
    """Phase 4's record of one run: times, stages, host split, launches,
    memory, routes and edit distances."""
    recs = fasta_records(r["out"])
    ed_draft = ed_pol = 0
    from racon_tpu_torch.utils.synth import edit_distance
    for c, (t, d) in enumerate(zip(ds["truth"], ds["drafts"])):
        pol = recs.get(f"ctg{c}")
        if pol is None or len(pol) == 0:
            fail(f"main run: contig ctg{c} missing from the output")
        ed_draft += edit_distance(d, t)
        ed_pol += edit_distance(pol, t)
    cons_s = consensus_seconds(r["err"])
    phases = phase_seconds(r["err"])
    flagged, host = routed(r["err"])
    # One h2d a chunk (the redo's chunks too).
    chunks = r["host_n"].get("h2d", 0)
    rec = dict(wall_s=r["wall"], consensus_s=cons_s,
               windows_per_s=n_windows / cons_s,
               windows_per_s_end_to_end=n_windows / r["wall"],
               align_s=phases.get("aligned overlaps"), phase_s=phases,
               stage_ms=r["stages"], host_split_s=r["host_s"],
               host_split_n=r["host_n"], chunks=chunks,
               chunk_rounds=r["k1_consensus"], chunk_rounds_scheduled=4 *
               chunks, max_memory_allocated=r["peak"],
               launches=r["launches"], consensus_walks=r["walks"],
               redo_windows=flagged, host_windows=host, ed_draft=ed_draft,
               ed_polished=ed_pol,
               ingest={k: v for k, v in r["counters"].items()
                       if k.startswith("ingest_")},
               resilience=r["resilience"])
    t = r["telemetry"]
    if t is not None:
        line = re.findall(r"scheduler (windows=.*)$", r["err"], flags=re.M)
        rec["sched"] = dict(
            t.as_extras(), window_rounds=t.window_rounds(),
            window_rounds_scheduled=t.windows * t.rounds,
            summary=line[-1] if line else None)
    return rec


#: The run telemetry's checks of phases 4, 8, 9, 10 and 11 (obs/metrics.py
#: against what each run's own counters saw), printed as one line before
#: the kernels line; ``check_s`` sums the seconds the checks took.
TELEMETRY = {"check_s": 0.0}


def check_telemetry(name, r):
    """The run telemetry of one run of phase 4's input (phases 4 and 8)
    against the run's own counters: ``ovl_tiles_exec`` = the K3
    launches, the align phase's step seconds at most
    ``align_phase_seconds``,
    ``sched_*`` = the scheduler telemetry's (none without it),
    ``device_dispatches`` = the dispatches the host clock counted (the
    scheduler's unpack, rounds, repacks and pack, the fixed engine's
    chunks and forward halves, and the decoupled walks), adaptive rounds
    executed <= scheduled, ``align_phase_seconds`` <= the logger's
    "aligned overlaps" seconds, one ``h2d_transfer_s`` observation a
    transfer, and the ingest gate on. Returns the numbers read."""
    from racon_tpu_torch.obs.metrics import OVL_STEP_KEYS, SCHED_KEYS
    t0 = time.perf_counter()
    c = r["counters"]
    if c.get("ovl_tiles_exec") != r["launches"].get("band_tile_fwd"):
        fail(f"{name}: ovl_tiles_exec {c.get('ovl_tiles_exec')}, not the "
             f"{r['launches'].get('band_tile_fwd')} K3 launches")
    steps = sum(c.get(k, 0.0) for k in OVL_STEP_KEYS)
    if not 0 < steps <= c.get("align_phase_seconds", 0.0) + 1e-6:
        fail(f"{name}: the align phase's step seconds {steps} not in "
             f"(0, align_phase_seconds {c.get('align_phase_seconds')}]")
    t = r["telemetry"]
    sched = {k: c.get(k) for k in SCHED_KEYS if k in c}
    if (t.as_extras() if t is not None else {}) != sched:
        fail(f"{name}: sched_* {sched} differ from the scheduler "
             f"telemetry's {t.as_extras() if t is not None else None}")
    n = r["host_n"]
    dispatches = n.get("rounds", 0) + n.get("repack", 0) + n.get("walk", 0)
    if c.get("device_dispatches") != dispatches or not dispatches:
        fail(f"{name}: device_dispatches {c.get('device_dispatches')}, "
             f"not the {dispatches} the host clock counted ({n})")
    rex = c.get("adaptive_rounds_executed", 0)
    rsch = c.get("adaptive_rounds_scheduled", 0)
    if not 0 < rex <= rsch:
        fail(f"{name}: adaptive rounds executed {rex}, scheduled {rsch}")
    align = phase_seconds(r["err"]).get("aligned overlaps")
    if align is None or not c.get("align_phase_seconds", -1) <= \
            align + 1e-6:
        fail(f"{name}: align_phase_seconds {c.get('align_phase_seconds')} "
             f"past the logger's 'aligned overlaps' {align} s")
    h2d = c.get("h2d_transfer_s") or {}
    if h2d.get("count") != c.get("h2d_transfers") or not h2d.get("count"):
        fail(f"{name}: h2d_transfer_s counted {h2d.get('count')}, not the "
             f"{c.get('h2d_transfers')} transfers")
    if c.get("ingest_enabled") != 1 or not c.get("ingest_records"):
        fail(f"{name}: the inputs did not parse on the ingest plane "
             f"(ingest_enabled {c.get('ingest_enabled')}, "
             f"{c.get('ingest_records')} records)")
    rec = dict(ovl_tiles_exec=c["ovl_tiles_exec"],
               ovl_device_jobs=c["ovl_device_jobs"],
               ovl_native_jobs=c["ovl_native_jobs"],
               ovl_device_fraction=c.get("ovl_device_fraction"),
               device_dispatches=c["device_dispatches"],
               adaptive_rounds_executed=rex,
               adaptive_rounds_scheduled=rsch,
               adaptive_early_exits=c.get("adaptive_early_exits", 0),
               walk_chain_len=c.get("walk_chain_len"),
               align_phase_seconds=c["align_phase_seconds"],
               aligned_overlaps_s=align, h2d_transfers=h2d["count"],
               redo_passes=c.get("redo_passes", 0),
               sched_rounds_hist=c.get("sched_rounds_hist"),
               ingest_fraction_of_wall=c.get("ingest_fraction_of_wall"))
    TELEMETRY[name] = rec
    TELEMETRY["check_s"] += time.perf_counter() - t0
    return rec


def phase_main(device, tmp, n_contigs=20, contig_len=50000,
               read_len=10000, coverage=30):
    t0 = time.perf_counter()
    ds = main_dataset(tmp, n_contigs, contig_len, read_len, coverage)
    synth_s = time.perf_counter() - t0
    p = ds["paths"]
    n_windows = sum(-(-len(d) // 500) for d in ds["drafts"])
    argv = [p["reads"], p["overlaps"], p["draft"], "-t",
            str(os.cpu_count() or 1), "--device", device]
    # The main path (the convergence scheduler, the default), then the same
    # inputs on the fixed-round engine.
    main = main_run(device, argv, True)
    fixed = main_run(device, argv, False)
    rec = main_record(main, ds, n_windows)
    rec_fixed = main_record(fixed, ds, n_windows)
    launches, ovl = main["launches"], main["ovl"]
    groups, ugroups = main["groups"], main["ugroups"]
    emit("main", draft_bp=sum(len(d) for d in ds["drafts"]),
         windows=n_windows, synth_s=synth_s, ovl=ovl, tiled_groups=groups,
         untiled_groups=ugroups, **rec)
    emit("main_fixed", identical=fixed["out"] == main["out"], **rec_fixed)
    if fixed["out"] != main["out"]:
        fail("main run: the scheduler's FASTA differs from RACON_TPU_SCHED=0's")
    if rec.get("sched") is None or not rec["sched"]["sched_windows"]:
        fail("main run: the convergence scheduler did not run")
    if rec_fixed.get("sched") is not None:
        fail("main run: RACON_TPU_SCHED=0 ran the scheduler")
    if launches["merge_windows_sched"] <= 0:
        fail("main run: M2's sched mode never launched")
    if fixed["launches"]["merge_windows_sched"] != 0:
        fail("main run: M2's sched mode launched under RACON_TPU_SCHED=0")
    for name in ("band_fwd", "band_tile_fwd", "col_walk"):
        if launches[name] <= 0:
            fail(f"main run: {name} never launched")
    if main["walks"] <= 0:
        fail("main run: the consensus engine never launched col_walk")
    if ovl["device_jobs"] <= 0:
        fail("main run: no overlap was aligned on the card")
    # One K3 launch a tile of each group; a bucket of several chunks runs
    # in groups of more than one.
    tile_launches = sum(g["groups"] * (g["Lq"] // g["T"]) for g in groups)
    if not launches["band_tile_fwd"] == ovl["tiles"] == tile_launches:
        fail(f"main run: band_tile_fwd launched {launches['band_tile_fwd']} "
             f"times, not groups x tiles = {tile_launches}")
    for g in groups + ugroups:
        if g["chunks"] > 1 and (g["G"] <= 1 or g["groups"] >= g["chunks"]):
            fail(f"main run: bucket {g} was not grouped")
    for name, r in (("scheduler", main), ("RACON_TPU_SCHED=0", fixed)):
        check_launches(f"main run ({name})", r)
        check_clean(f"main run ({name})", r)
    for rr in (rec, rec_fixed):
        if not rr["ed_polished"] * 3 <= rr["ed_draft"]:
            fail(f"main run: polished ED {rr['ed_polished']} > draft ED "
                 f"{rr['ed_draft']} / 3")
    if "aligned overlaps" not in rec["phase_s"]:
        fail("main run: the logger printed no 'aligned overlaps' phase")
    # The run telemetry; its ingest check replaces a count of prefetched
    # files (the prefetch points are read from phase 9's trace).
    for name, r in (("main", main), ("main_fixed", fixed)):
        check_telemetry(name, r)
    if main["counters"].get("ovl_tiles_exec") != tile_launches:
        fail(f"main run: ovl_tiles_exec {main['counters'].get('ovl_tiles_exec')}"
             f", not the {tile_launches} K3 launches")
    serial = dict(argv=argv, ds=ds, n_windows=n_windows, out=main["out"],
                  rec=rec, rec_fixed=rec_fixed, launches=main["launches"],
                  launches_fixed=fixed["launches"])
    return launches, launches_by_case(main), p, serial


def pipeline_record(r, serial_rec):
    """Phase 8's record of one streamed run beside phase 4's serial run of
    the same chunk loop: consensus seconds, the stages' busy and blocked
    seconds, the queues' peaks and blocked seconds, the walk meter, the
    ingest plane's seconds, stage ms, host split and peak bytes."""
    c = r["counters"]
    stages = {}
    for k, v in c.items():
        m = re.match(r"pipe_stage_(\w+?)_(busy_s|stall_in_s|stall_out_s|"
                     r"items)$", k)
        if m:
            stages.setdefault(m.group(1), {})[m.group(2)] = v
    queues = {}
    for k, v in c.items():
        m = re.match(r"pipe_queue_(\w+?)_(peak|put_wait_s|get_wait_s)$", k)
        if m:
            queues.setdefault(m.group(1), {})[m.group(2)] = v
    cons_s = consensus_seconds(r["err"])
    return dict(
        consensus_s=cons_s, serial_consensus_s=serial_rec["consensus_s"],
        wall_s=r["wall"], serial_wall_s=serial_rec["wall_s"],
        pipe_wall_s=c.get("pipe_wall_s"), stages=stages, queues=queues,
        walk={k: v for k, v in c.items() if k.startswith("walk_")},
        ingest={k: v for k, v in c.items() if k.startswith("ingest_")},
        phase_s=phase_seconds(r["err"]), stage_ms=r["stages"],
        host_split_s=r["host_s"], host_split_n=r["host_n"],
        launches=r["launches"], consensus_k1=r["k1_consensus"],
        consensus_walks=r["walks"], max_memory_allocated=r["peak"],
        serial_max_memory_allocated=serial_rec["max_memory_allocated"],
        resilience=r["resilience"])


def phase_pipeline(device, serial):
    """Phase 8 (module docstring): phase 4's input through the CLI with
    --pipeline-depth 2, under the scheduler and under RACON_TPU_SCHED=0
    (the decoupled walk). Returns each run's (launches by kernels-line
    row, launches by kernel)."""
    argv = serial["argv"]
    streamed = {}
    for sched in (True, False):
        streamed[sched] = main_run(device, argv, sched, pipeline=True)
    for sched, r in streamed.items():
        name = f"pipeline ({'scheduler' if sched else 'RACON_TPU_SCHED=0'})"
        if r["out"] != serial["out"]:
            fail(f"{name}: the FASTA differs from phase 4's serial FASTA")
        if not r["counters"].get("pipe_runs"):
            fail(f"{name}: the streaming pipeline did not run")
        check_launches(name, r)
        check_clean(name, r)
        check_telemetry(name.replace(" (scheduler)", "").replace(
            " (RACON_TPU_SCHED=0)", "_fixed"), r)
    sch, fixed = streamed[True], streamed[False]
    rec = pipeline_record(sch, serial["rec"])
    rec_fixed = pipeline_record(fixed, serial["rec_fixed"])
    # The walk gate: under the scheduler every chunk runs fused; under
    # RACON_TPU_SCHED=0 every chunk but the last walks decoupled (the
    # card's walk-queue budget admits phase 4's chunk), one h2d a chunk.
    w, wf = rec["walk"], rec_fixed["walk"]
    if w.get("walk_dispatches") != 0 or w.get("walk_async_enabled") != 0:
        fail(f"pipeline (scheduler): decoupled walks under the scheduler "
             f"({w})")
    chunks = fixed["host_n"].get("h2d", 0)
    if not (wf.get("walk_async_enabled") == 1
            and wf.get("walk_fused_chunks") == 1
            and wf.get("walk_dispatches", 0) > 0
            and wf["walk_dispatches"] + 1 == chunks):
        fail(f"pipeline (RACON_TPU_SCHED=0): {wf.get('walk_dispatches')} "
             f"decoupled walks and {wf.get('walk_fused_chunks')} fused "
             f"chunks, not {chunks - 1} and 1 ({wf})")
    if fixed["host_n"].get("walk") != wf["walk_dispatches"]:
        fail("pipeline (RACON_TPU_SCHED=0): dispatch_walk ran "
             f"{fixed['host_n'].get('walk')} times, not once a decoupled "
             "chunk")
    emit("pipeline", depth=2, chunks=chunks, **rec)
    emit("pipeline_fixed", depth=2, chunks=chunks, **rec_fixed)
    return [(launches_by_case(r), r["launches"]) for r in (sch, fixed)]


@contextlib.contextmanager
def _environ(**kw):
    """Set (a str) or unset (None) environment variables for the block."""
    saved = {k: os.environ.get(k) for k in kw}
    for k, v in kw.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def fault_plan(spec, **gates):
    """Run the block under the fault plan ``spec`` and the env ``gates``
    (the retry policy re-read from them), then clear both."""
    from racon_tpu_torch.resilience import faults, retry, watchdog
    try:
        with _environ(**gates):
            retry.configure(None)
            watchdog.reset()
            faults.configure(spec)
            try:
                yield
            finally:
                faults.configure(None)
    finally:
        retry.configure(None)


@contextlib.contextmanager
def planned_windows():
    """The windows the engines made inside the block planned into device
    chunks (PoaEngine._plan_device_slice watched): a one-item list."""
    from racon_tpu_torch.ops.poa import PoaEngine
    n = [0]
    plan = PoaEngine._plan_device_slice

    def watched(self, *a, **k):
        sp = plan(self, *a, **k)
        n[0] += sum(len(g) for g in sp.groups)
        return sp

    PoaEngine._plan_device_slice = watched
    try:
        yield n
    finally:
        PoaEngine._plan_device_slice = plan


def fault_record(run, r, clean_out, **extra):
    """One phase 9 line: the run's FASTA against its clean run's, its
    res_* counters, stall events, launches and consensus seconds."""
    rec = dict(run=run, identical=r["out"] == clean_out,
               resilience=r["resilience"],
               stall_events=r["counters"].get("pipe_stall_events", 0),
               launches=r["launches"], consensus_k1=r["k1_consensus"],
               consensus_s=consensus_seconds(r["err"]), wall_s=r["wall"],
               **extra)
    emit("faults", **rec)
    if not rec["identical"]:
        fail(f"faults ({run}): the FASTA differs from its clean run's")
    return rec


def phase_faults(device, tmp, small, serial):
    """Phase 9 (module docstring): the retry envelope, the watchdog, host
    degradation, stall recovery and the tracer on the card, each run's
    FASTA against its clean run's in this call."""
    from racon_tpu_torch.ops import kernels
    argv = serial["argv"]
    # (1) Retries, under each chunk driver with the sites it calls.
    retry_gates = {"RACON_TPU_RETRY": "attempts=3,base=0"}
    for sched, spec, clean in (
            (True, "h2d/chunk:0,1;sched/flags:3;h2d/repack:0;d2h/chunk:4",
             serial["launches"]),
            (False, "dispatch/chunk:2;d2h/chunk:1",
             serial["launches_fixed"])):
        with fault_plan(spec, **retry_gates):
            r = main_run(device, argv, sched)
        name = f"retries ({'scheduler' if sched else 'RACON_TPU_SCHED=0'})"
        res = r["resilience"]
        fault_record(name, r, serial["out"], spec=spec)
        if not res.get("res_fault_injected_total"):
            fail(f"faults ({name}): no fault fired ({res})")
        if res.get("res_retry_total") != res.get("res_fault_injected_total") \
                or res.get("res_degraded_windows", 0):
            fail(f"faults ({name}): retries and faults differ, or windows "
                 f"degraded ({res})")
        if r["launches"] != clean:
            fail(f"faults ({name}): launches {r['launches']} differ from "
                 f"the clean run's {clean}")
    # (2) A hang past a 0.5 s dispatch deadline (the cells term off).
    spec = "dispatch/chunk:1!hang=2"
    with fault_plan(spec, RACON_TPU_DEADLINE_DISPATCH="0.5",
                    RACON_TPU_DEADLINE_CELLS_PER_S="1e18"):
        r = main_run(device, argv, False)
        time.sleep(2.0)          # the abandoned attempt has woken
        launches = dict(kernels.LAUNCHES)
    res = r["resilience"]
    fault_record("hang", r, serial["out"], spec=spec,
                 launches_after_wake=launches)
    if res.get("res_watchdog_breach_total") != 1:
        fail(f"faults (hang): {res.get('res_watchdog_breach_total')} "
             f"watchdog breaches, not 1 ({res})")
    if r["launches"] != serial["launches_fixed"] or \
            launches != serial["launches_fixed"]:
        fail(f"faults (hang): launches {r['launches']} (after the wake "
             f"{launches}) differ from the clean RACON_TPU_SCHED=0 run's "
             f"{serial['launches_fixed']}")
    # (3) Every upload fails: the kC case of phase 3 degraded whole.
    kc = small["kC"]
    spec = "h2d/chunk:p=1.0"
    with fault_plan(spec, RACON_TPU_RETRY="attempts=2,base=0"), \
            planned_windows() as planned:
        r = main_run(device, kc["argv"] + ["--device", device], True)
    res = r["resilience"]
    n = r["launches"]
    untiled = sum(g["groups"] for g in r["ugroups"])
    fault_record("degrade", r, kc["out"], spec=spec,
                 device_windows=planned[0],
                 phase3_launches=kc["launches"])
    if not 0 < planned[0] == res.get("res_degraded_windows"):
        fail(f"faults (degrade): {res.get('res_degraded_windows')} windows "
             f"degraded, not the {planned[0]} planned for the card")
    if r["k1_consensus"] or n["merge_votes"] or r["walks"]:
        fail(f"faults (degrade): consensus kernels launched ({n})")
    p3 = kc["launches"]
    if n["band_tile_fwd"] != p3["band_tile_fwd"] or \
            n["band_fwd"] != untiled or \
            not p3["band_fwd"] > n["band_fwd"]:
        fail(f"faults (degrade): overlap K1/K3 launches {n} differ from "
             f"phase 3's {p3}")
    # (4) A wedged pack stage: the stall detector, then the host path.
    spec = "pipe/pack:0!hang=3"
    with fault_plan(spec, RACON_TPU_STALL_S="0.5"):
        r = main_run(device, argv, True, pipeline=True)
    res = r["resilience"]
    fault_record("stall", r, serial["out"], spec=spec,
                 recovered_windows=res.get("res_degraded_windows", 0))
    if "stall detected" not in r["err"] or \
            r["counters"].get("pipe_stall_events") != 1:
        fail(f"faults (stall): the stall was not detected once "
             f"({r['counters'].get('pipe_stall_events')})")
    if not res.get("res_degraded_windows"):
        fail(f"faults (stall): no window recovered on the host ({res})")
    # (5) The JSONL trace of phase 4's input.
    path = os.path.join(tmp, "trace.jsonl")
    with fault_plan(None):
        r = main_run(device, argv + ["--trace", path], True)
    kinds = {}
    with open(path, encoding="utf-8") as fh:
        lines = [json.loads(ln) for ln in fh]
    for ln in lines:
        if ln.get("ev") == "span":
            kinds[ln["kind"]] = kinds.get(ln["kind"], 0) + 1
    check_clean("faults (trace)", r)
    fault_record("trace", r, serial["out"], spans=kinds,
                 trace_bytes=os.path.getsize(path),
                 serial_consensus_s=serial["rec"]["consensus_s"])
    if lines[0].get("ev") != "begin" or lines[-1].get("ev") != "metrics" \
            or not kinds.get("chunk") or not kinds.get("transfer"):
        fail(f"faults (trace): a malformed trace ({kinds})")
    # The trace's ingest and tile points: one ``parse/prefetch`` a plain
    # input (parsed on the ingest plane's prefetch threads), one ``tile``
    # a K3 launch, and the final snapshot's ovl_tiles_exec beside them.
    t_check = time.perf_counter()
    points = collections.Counter(
        (ln["kind"], ln["name"]) for ln in lines[1:-1]
        if ln.get("kind") in ("ingest", "tile"))
    tiles = sum(n for (k, _), n in points.items() if k == "tile")
    final = lines[-1]
    TELEMETRY["trace"] = dict(
        ingest={nm: n for (k, nm), n in points.items() if k == "ingest"},
        tile_points=tiles, ovl_tiles_exec=final.get("ovl_tiles_exec"),
        band_tile_fwd=r["launches"]["band_tile_fwd"])
    if points[("ingest", "parse/prefetch")] != 3 or \
            tiles != r["launches"]["band_tile_fwd"] or \
            final.get("ovl_tiles_exec") != tiles or \
            final.get("device_dispatches") != \
            r["counters"].get("device_dispatches"):
        fail(f"faults (trace): ingest and tile points "
             f"{TELEMETRY['trace']} do not match the run")
    TELEMETRY["check_s"] += time.perf_counter() - t_check
    # (6) A real breach where kernels run: a 1 us d2h deadline under
    # RACON_TPU_SCHED=0, where the pull is the first wait on the chunk's
    # kernels. A pull whose data is already on the host can still beat
    # the caller's wake-up, so a chunk may pass on its retry; the first
    # chunk that breaches twice ends the run. Nothing is degraded: the
    # run exits 1 with no FASTA, and every failed attempt is a breach at
    # d2h/chunk that was retried or exhausted the budget.
    with fault_plan(None, RACON_TPU_RETRY="attempts=2,base=0",
                    RACON_TPU_DEADLINE_D2H="1e-6",
                    RACON_TPU_DEADLINE_MBPS="1e9"):
        r = main_run(device, argv, False, expect_rc=1)
    res = r["resilience"]
    emit("faults", run="real breach", rc=r["rc"], fasta_bytes=len(r["out"]),
         resilience=res, wall_s=r["wall"])
    breaches = res.get("res_watchdog_breach_total", 0)
    if r["out"] or res.get("res_degraded_windows", 0) or \
            res.get("res_fault_injected_total", 0) or \
            res.get("res_retry_exhausted") != 1 or breaches < 2 or \
            breaches != res.get("res_retry_total", 0) + 1 or \
            breaches != res.get("res_watchdog_site_d2h_chunk") or \
            res.get("res_retry_total", 0) != \
            res.get("res_retry_site_d2h_chunk", 0) or \
            "d2h/chunk failed after 2 attempt(s)" not in r["err"]:
        fail(f"faults (real breach): the run did not end at d2h/chunk "
             f"with nothing degraded ({res}; {r['err'][-1500:]})")


def phase_flat(device, tmp, contig_len=100000):
    from racon_tpu_torch.ops import device_poa, kernels
    from racon_tpu_torch.utils.synth import write_dataset
    ds = write_dataset(os.path.join(tmp, "flat"), seed=9,
                       contig_len=contig_len, read_len=10000, coverage=30,
                       draft_err=0.03)
    p = ds["paths"]
    os.environ["RACON_TPU_NO_BAND"] = "1"
    clock = device_poa.set_stage_clock(True)
    try:
        kernels.reset_launches()
        rc, out, err, wall = run_cli([p["reads"], p["overlaps"], p["draft"],
                                      "-t", str(os.cpu_count() or 1),
                                      "--device", device])
        launches = dict(kernels.LAUNCHES)
    finally:
        del os.environ["RACON_TPU_NO_BAND"]
        device_poa.set_stage_clock(False)
    if rc or not out:
        fail(f"flat-path run failed: {err[-3000:]}")
    # The overlap chunks walk the band layout; the consensus, the flat one.
    walks = clock.launches().get("walk", {}).get("col_walk", 0)
    emit("flat_path", wall_s=wall, consensus_s=consensus_seconds(err),
         launches=launches, consensus_walks=walks)
    if launches["flat_fwd"] <= 0:
        fail("flat-path run: flat_fwd never launched")
    if walks <= 0:
        fail("flat-path run: the consensus engine never launched col_walk")
    return dict(launches, col_walk_flat=walks)


def path_score(q, t, ops, m, x, g):
    """Score of an op string, or None when it does not consume exactly q
    and t."""
    cq = ops != 2
    ct = ops != 1
    if int(cq.sum()) != len(q) or int(ct.sum()) != len(t):
        return None
    d = ops == 0
    qi = (np.cumsum(cq) - cq)[d]
    ti = (np.cumsum(ct) - ct)[d]
    eq = int((q[qi] == t[ti]).sum())
    nd = int(d.sum())
    return m * eq + x * (nd - eq) + g * (len(ops) - nd)


def longest_insertion(ops) -> int:
    edges = np.diff(np.concatenate([[0], (ops == 1).astype(np.int8), [0]]))
    starts, ends = np.flatnonzero(edges == 1), np.flatnonzero(edges == -1)
    return int((ends - starts).max()) if len(starts) else 0


def phase_op_strings(device, paths, n_contigs=5, device_batch=4096):
    """The batched aligner's route at full size (see the module
    docstring, phase 6). Returns its launch counts."""
    import torch
    from racon_tpu_torch.models.polisher import PolisherType, create_polisher
    from racon_tpu_torch.models.window import window_arrays
    from racon_tpu_torch.native.aligner import NativeAligner
    from racon_tpu_torch.ops import device_merge as dm
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.align import PAD_OP
    from racon_tpu_torch.ops.poa import PoaEngine
    m, x, g = 5, -4, -8
    threads = os.cpu_count() or 1
    t0 = time.perf_counter()
    pol = create_polisher(paths["reads"], paths["overlaps"], paths["draft"],
                          PolisherType.kC, 500, 10.0, 0.3, m, x, g,
                          device=device, threads=threads)
    pol.initialize()
    windows = [w for w in pol.windows if w.id < n_contigs and
               w.n_layers >= 2]
    eng = PoaEngine(m, x, g, device=device, device_batch=device_batch,
                    threads=threads)
    eng.stats = {}
    anchors, jobs = [], []
    for wi, w in enumerate(windows):
        lays, bb, bw = window_arrays(w)
        anchors.append((bb, bw))
        jobs.extend(eng._build_jobs(wi, bb, [(c, wt) for c, wt, _, _ in lays],
                                    [(b, e) for _, _, b, e in lays]))
    setup_s = time.perf_counter() - t0

    kernels.reset_launches()
    t0 = time.perf_counter()
    eng._align(jobs)
    torch.cuda.synchronize()
    align_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    B = len(jobs)
    S = max(len(j.ops) for j in jobs)
    Lq = max(len(j.q) for j in jobs)
    LA = max(len(bb) for bb, _ in anchors) + 8
    ops = np.full((B, S), PAD_OP, np.uint8)
    q = np.zeros((B, Lq), np.uint8)
    qw = np.zeros((B, Lq), np.float32)
    for b, j in enumerate(jobs):
        ops[b, S - len(j.ops):] = j.ops
        q[b, :len(j.q)] = j.q
        qw[b, :len(j.q)] = j.w
    col = [np.array([getattr(j, a) for j in jobs], dt) for a, dt in (
        ("w_read", np.float32), ("t_len", np.int32), ("t_off", np.int32),
        ("win", np.int32))]
    Nw = len(anchors)
    bb_pad = np.zeros((Nw, LA), np.uint8)
    bbw_pad = np.zeros((Nw, LA), np.float32)
    alen = np.array([len(bb) for bb, _ in anchors], np.int32)
    for wi, (bb, bw) in enumerate(anchors):
        bb_pad[wi, :len(bb)] = bb
        bbw_pad[wi, :len(bb)] = bw
    dv = [torch.from_numpy(a).to(device) for a in (ops, q, qw, *col)]
    bb_d, bbw_d, alen_d = (torch.from_numpy(a).to(device)
                           for a in (bb_pad, bbw_pad, alen))
    votes = dm.extract_votes(*dv[:6], LA)
    acc = dm.aggregate_votes(votes, dv[6], Nw)
    del votes
    acc = dm.add_backbone(acc, bb_d, bbw_d, alen_d)
    asm = dm.assemble(acc, alen_d, eng.ins_scale)
    codes, cov, total = (a.cpu().numpy() for a in dm.compact(asm, LA + 64))
    map_b, map_e = (a.cpu().numpy() for a in dm.coord_maps(asm, alen_d, LA))
    merge_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    del acc, asm, dv

    nat = NativeAligner(m, x, g, threads=threads).align_batch(
        [(j.q, j.t) for j in jobs])
    bad_paths = 0
    for j, o in zip(jobs, nat):
        sc = path_score(j.q, j.t, j.ops, m, x, g)
        bad_paths += sc is None or sc != path_score(j.q, j.t, o, m, x, g)
    host = eng._merge_round(anchors, jobs)
    long_ins = {j.win for j in jobs if longest_insertion(j.ops) > dm.K_INS}
    differ = []
    for wi, (cons, hcov, mb, me) in enumerate(host):
        L = len(cons)
        if not (total[wi] == L and np.array_equal(codes[wi, :L], cons) and
                np.array_equal(cov[wi, :L], hcov) and
                np.array_equal(map_b[wi, :len(mb)], mb) and
                np.array_equal(map_e[wi, :len(me)], me)):
            differ.append(wi)
    unexplained = [wi for wi in differ if wi not in long_ins]
    shapes = eng.stats["align_shapes"]
    emit("op_strings", contigs=n_contigs, windows=Nw, jobs=B,
         batches=len(shapes), batch_shapes=shapes, launches=launches,
         setup_s=setup_s, align_s=align_s, merge_s=merge_s,
         route_s=align_s + merge_s, merge_shape=[B, S, LA + 2],
         path_score_mismatches=bad_paths,
         windows_equal=Nw - len(differ),
         long_insertion_windows=sorted(long_ins),
         long_insertion_windows_differing=sorted(set(differ) & long_ins),
         windows_differing_unexplained=unexplained)
    if bad_paths:
        fail(f"op strings: {bad_paths} of {B} paths do not score what the "
             "native aligner's path scores")
    if unexplained:
        fail(f"op strings: windows {unexplained[:20]} differ from the host "
             "merge without an insertion run longer than K_INS")
    for name in ("nw_fwd", "nw_traceback", "monotone_count"):
        if launches[name] <= 0:
            fail(f"op strings: {name} never launched")
    if max(sh[0] for sh in shapes) < eng.device_batch:
        fail(f"op strings: no batch of {eng.device_batch} lanes ({shapes})")
    return launches


def float_err(ref, out) -> float:
    """Largest |ref - out| over pairs of tensors, as float64 (bool and
    integer tensors compared as numbers)."""
    import torch
    err = 0.0
    for r, o in zip(ref, out):
        d = (r.to(torch.float64) - o.to(torch.float64)).abs()
        err = max(err, float(d.max().item()) if d.numel() else 0.0)
    return err


def same_bits(ref, out) -> bool:
    """Every pair of tensors equal bit for bit (floats by their bytes)."""
    import torch
    for r, o in zip(ref, out):
        if r.dtype != o.dtype or r.shape != o.shape:
            return False
        if r.dtype == torch.bool:
            r, o = r.to(torch.uint8), o.to(torch.uint8)
        if not torch.equal(r.contiguous().view(torch.uint8),
                           o.contiguous().view(torch.uint8)):
            return False
    return True


def merge_chunk(device, paths, scale=0.2):
    """The first chunk of phase 4's run at round 0, as the engine builds
    it: the windows of phase 4's dataset (Polisher.initialize), the
    engine's device slice plan, the first chunk's ChunkPlan at the run's
    caps, its round-0 forward and walk on the card. Returns the merge
    inputs and the plan."""
    import torch
    from racon_tpu_torch.models.polisher import PolisherType, create_polisher
    from racon_tpu_torch.ops import device_poa as P
    from racon_tpu_torch.ops.poa import PoaEngine
    threads = os.cpu_count() or 1
    pol = create_polisher(paths["reads"], paths["overlaps"], paths["draft"],
                          PolisherType.kC, 500, 10.0, 0.3, 5, -4, -8,
                          device=device, threads=threads)
    pol.initialize()
    eng = PoaEngine(5, -4, -8, device=device, threads=threads)
    active = [w for w in pol.windows if w.n_layers >= 2]
    dev, _, lq_max, la_max = eng._partition_device(active)
    sp = eng._plan_device_slice(dev, lq_max, la_max)
    plan = P.ChunkPlan(sp.groups[0], lq_cap=sp.lq_cap, la_cap=sp.la_cap,
                       band_cap=sp.band_cap)
    st = P.chunk_statics(plan, ins_scale=scale, rounds=4)
    job, winb = P.load_packed(*plan.packed_bufs(),
                              (plan.B, plan.Lq, plan.n_win, plan.LA), device)
    q, qw8, begin, end, lq, win, w_read, bb, bbw, alen = P._unpack_bufs(
        job, winb, plan.Lq, plan.LA)
    fwd = P._lane_fwd(bb, alen, begin, end, q, lq, win, match=5, mismatch=-4,
                      gap=-8, Lq=plan.Lq, LA=plan.LA, band_w=st["band_w"],
                      nxt_k=st["nxt_k"])
    cols, esc_w = P._lane_walk(*fwd, lq, LA=plan.LA, band_w=st["band_w"])
    torch.cuda.synchronize()
    ovf = torch.zeros(plan.n_win, dtype=torch.bool, device=device)
    return dict(cols=cols, esc_w=esc_w, q=q, qw8=qw8, w_read=w_read,
                lt=fwd[3], t_off=fwd[4], bb=bb, bbw=bbw, alen=alen,
                begin=begin, end=end, win=win, ovf=ovf, plan=plan,
                band_w=st["band_w"], lq=lq, nxt_k=st["nxt_k"])


def vote_needs(votes, bb, bbw, alen, scale):
    """``(sectors, need)``: the 32-byte sectors of M1's sums (f32 [n_win, 132, LA+1], channel
    rows of LA+1 gaps) that M2's function must read on this data, from
    what the plain vote-out does with them: the six column weights of
    each column inside the anchor, the coverage of the winning base of
    each kept column; the crossing weight of each gap inside the anchor;
    the five pileup (and, at k = 0, single-insertion) weights of each
    insertion rank k the vote-out reaches (rank 0, then rank k while every
    rank before it emitted), the count of the winning base of each rank
    that emits, and the stop weights that the next rank's test adds
    (ins1_stop before rank 1, lenw[k-1] before rank k+1). A count read for
    an emitted base whose position falls past LA is counted too. ``need``
    is the bool mask of the entries read, the shape of ``votes``."""
    import torch
    import torch.nn.functional as F
    from racon_tpu_torch.ops import device_merge as dm
    n_win, nch, LA1 = votes.shape
    dev = votes.device
    acc = dm.add_backbone(dm.vote_views(votes), bb[:-1], bbw[:-1], alen[:-1])
    asm = dm.assemble(acc, alen[:-1], scale)
    p = torch.arange(LA1, device=dev)[None]
    al = alen[:-1, None]
    vgap, vcol = p <= al, p < al
    e = asm["e"]
    kept = F.pad(asm["kept"], (0, 1))
    code = F.pad(asm["col_code"], (0, 1))
    K, NB = dm.K_INS, dm.NBASE
    need = torch.zeros((n_win, nch, LA1), dtype=torch.bool, device=dev)
    need[:, 0:NB + 1] = vcol[:, None]                       # base_w
    for i in range(NB):
        need[:, NB + 1 + i] = kept & (code == i)            # base_c
    need[:, 11] = vgap                                      # direct_w
    need[:, 22] = vgap & (e >= 1)                           # ins1_stop
    for k in range(K):
        reached = vgap & (e >= k)
        need[:, 23 + NB * k:23 + NB * (k + 1)] = reached[:, None]
        if k == 0:
            need[:, 12:12 + NB] = reached[:, None]          # ins1_w
        bk = asm["ins_codes"][..., k]
        for i in range(NB):
            sel = (e > k) & (bk == i)
            need[:, 73 + NB * k + i] = sel                  # pile_c
            if k == 0:
                need[:, 17 + i] = sel                       # ins1_c
        if k + 2 < K:
            need[:, 123 + k] = vgap & (e >= k + 2)          # lenw
    return need_sectors(need), need


def need_sectors(need) -> int:
    """The 32-byte sectors of M1's f32 sums that a bool mask of entries
    touches."""
    import torch.nn.functional as F
    flat = F.pad(need.reshape(-1), (0, (-need.numel()) % 8))
    return int(flat.view(-1, 8).any(1).sum().item())


def votes_reads(cols, q, qw8, lt, t_off, win, n_win, LA):
    """What M1's function must read of the walk and the queries on this
    data: ``(walk_sectors, query_sectors, walk_need, q_need)``. Only real
    jobs (win < n_win) are read. Job j reads walk entries p of its row for
    the gaps p of its slice (0 <= p - t_off <= lt, p <= LA) and entries
    p + 1 for its columns p (0 <= p - t_off < lt): entries t_off ..
    t_off + lt. Of its query and weight rows it reads the byte of each
    matching column (the column index of entry p + 1) and, at each gap
    with an insertion run, the run's bytes clamp(qstart) + k for k <
    min(ins_len, K_INS) (the last byte past the row's end). ``walk_need``
    ([B, LA+2]) and ``q_need`` ([B, Lq]) are those masks; the sectors are
    the 32-byte sectors of the tensors as they lie in memory (the walk's
    interleaved 8-byte entries, q and qw8 each)."""
    import torch
    from racon_tpu_torch.ops import device_merge as dm
    from racon_tpu_torch.ops import kernels
    B, Lq = q.shape
    dev = q.device
    real = (win < n_win)[:, None]
    e = torch.arange(LA + 2, device=dev)[None]
    c = e - t_off.long()[:, None]
    L = lt.long()[:, None]
    gap = real & (c >= 0) & (c <= L) & (e <= LA)     # entry e is gap e
    col = real & (c >= 1) & (c <= L) & (e >= 1)      # column e - 1
    walk_need = gap | col
    ins, qst, op, qi = (cols[n].long() for n in kernels.WALK_FIELDS)
    qsc = qst.clamp(0, Lq - 1)
    s0 = (qsc - 1).clamp(min=0)
    col_idx = s0 + (qi.clamp(0, Lq - 1) - s0 == 1).long()
    rows = torch.arange(B, device=dev)[:, None].expand(B, LA + 2)
    q_need = torch.zeros((B, Lq), dtype=torch.bool, device=dev)
    match = col & (op == dm.DIAG)
    q_need[rows[match], col_idx[match]] = True
    for k in range(dm.K_INS):
        run = gap & (ins > k)
        q_need[rows[run], (qsc + k).clamp(max=Lq - 1)[run]] = True
    walk, row = kernels._walk_words(cols, B, LA, dev)

    def sectors(need, ptr, offsets):
        return int(torch.unique((ptr % 32 + offsets[need]) // 32).numel())

    j = torch.arange(B, device=dev)[:, None]
    w_sec = sectors(walk_need, walk.data_ptr(),
                    2 * (j * row + 4 * e))
    p = torch.arange(Lq, device=dev)[None]
    q_sec = sum(sectors(q_need, t.data_ptr(), j * t.stride(0) + p)
                for t in (q, qw8))
    return w_sec, q_sec, walk_need, q_need


def votes_poisoned(cols, q, qw8, walk_need, q_need, i):
    """The walk's columns and the queries with every entry and byte
    outside ``walk_need``/``q_need`` overwritten (poison ``i`` of two:
    other walk fields, other codes and weights)."""
    import torch
    from racon_tpu_torch.ops import kernels
    fill = ((3, 1, 0, 2), (1, 40, 1, 0))[i]
    pc = {n: cols[n].masked_fill(~walk_need, v)
          for n, v in zip(kernels.WALK_FIELDS, fill)}
    pq = torch.where(q_need, q, (q + 3 + i) % 8)
    pw = torch.where(q_need, qw8, (qw8.int() + 37 + i) % 128).to(qw8.dtype)
    return pc, pq, pw


def phase_merge_kernels(device, paths, scale=0.2):
    """M1 and M2 at the main path's chunk shape (module docstring, phase
    7), bitwise against their plain versions. Returns their records."""
    import torch
    from racon_tpu_torch.ops import device_merge as dm
    from racon_tpu_torch.ops import device_poa as P
    from racon_tpu_torch.ops import kernels
    c = merge_chunk(device, paths, scale)
    plan = c["plan"]
    B, Lq, LA, n_win = plan.B, plan.Lq, plan.LA, plan.n_win
    lt, t_off = c["lt"], c["t_off"]
    vargs = (c["cols"], c["q"], c["qw8"], c["w_read"], lt, t_off, c["esc_w"],
             c["win"])
    mem = dm.window_members(c["win"], n_win)
    kw = dict(n_win=n_win, LA=LA)
    ref_v = dm.merge_votes_plain(*vargs, **kw)
    got_v = kernels.merge_votes(*vargs, mem, **kw)
    ok_v = same_bits(ref_v, got_v)
    err_v = float_err(ref_v, got_v)
    state = (c["bb"], c["bbw"], c["alen"], c["begin"], c["end"], c["win"],
             c["ovf"])
    wargs = (ref_v[0], ref_v[1]) + state
    # Both M2 variants, each with and without detect.
    recs_w = []
    for detect in (False, True):
        wkw = dict(ins_scale=scale, n_win=n_win, LA=LA, detect=detect)
        ref_w = dm.merge_windows_plain(*wargs, **wkw)
        for variant in (None, "wide"):
            got_w = kernels.merge_windows(*wargs, mem, variant=variant,
                                          **wkw)
            recs_w.append((same_bits(ref_w, got_w), float_err(ref_w, got_w),
                           int(ref_w[6].sum().item()),
                           int(ref_w[7].sum().item())))
            del got_w
        del ref_w
    # The plain chain, eager and warm (medians of 3 in turns): its first
    # call in a process pays one-time costs of its own.
    plain_v_ms, plain_w_ms, plain_wd_ms = time_turns(
        [lambda: dm.merge_votes_plain(*vargs, **kw)] +
        [lambda d=d: dm.merge_windows_plain(
            *wargs, ins_scale=scale, n_win=n_win, LA=LA, detect=d)
         for d in (False, True)], reps=3)
    wkw = dict(ins_scale=scale, n_win=n_win, LA=LA, detect=False)
    m1_ms, m2_ms, m2_wide_ms = time_graph_turns(
        [lambda: kernels.merge_votes(*vargs, mem, **kw),
         lambda: kernels.merge_windows(*wargs, mem, **wkw),
         lambda: kernels.merge_windows(*wargs, mem, variant="wide", **wkw)],
        reps=20, calls=10)
    round_ms, = time_turns([lambda: P._merge_round(
        c["cols"], c["esc_w"], lt, t_off, c["q"], c["qw8"], c["w_read"],
        *state, mem, ins_scale=scale, n_win=n_win, LA=LA)], reps=10)
    plain_round_ms = plain_v_ms + plain_w_ms
    # Bytes each kernel's function must move: M1 reads, of the walk and
    # the queries, the sectors its real jobs need on this data
    # (votes_reads), each real job's row in the order and four scalars,
    # and the starts and counts, and writes the sums and the escape sums.
    # M2 reads, of the sums, the sectors its vote-out needs on this data
    # (vote_needs), the escape sums, the anchors' codes and weights inside
    # each anchor, the lengths, spans, window ids, membership and flags,
    # and writes the next anchors, weights, lengths, spans, coverage and
    # flags.
    votes_b = 4 * n_win * dm.VOTE_CH * (LA + 1)
    w_sec, q_sec, walk_need, q_need = votes_reads(
        c["cols"], c["q"], c["qw8"], lt, t_off, c["win"], n_win, LA)
    jobs = int((c["win"] < n_win).sum().item())
    m1_bytes = (32 * (w_sec + q_sec) + 20 * jobs + 8 * n_win + votes_b +
                4 * n_win)
    # M1's count is whole if what lies outside it changes nothing: the
    # plain version over a walk and queries poisoned there gives the same
    # bits.
    for i in range(2):
        pc, pq, pw = votes_poisoned(c["cols"], c["q"], c["qw8"], walk_need,
                                    q_need, i)
        if not same_bits(ref_v, dm.merge_votes_plain(
                pc, pq, pw, *vargs[3:], **kw)):
            fail(f"merge_votes' byte count misses walk entries or query "
                 f"bytes it reads (poison {i} outside it changes its "
                 f"output)")
        del pc, pq, pw
    del walk_need, q_need
    sectors, need = vote_needs(ref_v[0], c["bb"], c["bbw"], c["alen"],
                               scale)
    # The count is whole if the sums outside it change nothing: the plain
    # vote-out over sums whose other entries are poisoned gives the same
    # bits.
    wkw0 = dict(ins_scale=scale, n_win=n_win, LA=LA)
    ref_w = dm.merge_windows_plain(*wargs, **wkw0)
    for fill in (float("nan"), 1e30):
        pois = ref_v[0].masked_fill(~need, fill)
        if not same_bits(ref_w, dm.merge_windows_plain(
                pois, *wargs[1:], **wkw0)):
            fail(f"merge_windows' byte count misses sums it reads (entries "
                 f"outside it set to {fill} change its output)")
    del ref_w, pois
    m2_bytes = (32 * sectors + 4 * n_win +
                5 * int(c["alen"][:-1].sum().item()) + 4 * (n_win + 1) +
                16 * B + 8 * n_win + n_win +
                5 * (n_win + 1) * LA + 4 * (n_win + 1) + 8 * B +
                4 * n_win * LA + 2 * n_win)
    m1_bound, m1_by = bound(m1_bytes, 0)
    m2_bound, m2_by = bound(m2_bytes, 0)
    occ_v = kernels.merge_occupancy("votes", LA, n_win=n_win)
    occ_w = kernels.merge_occupancy("windows", LA, n_win=n_win)
    occ_wide = kernels.merge_occupancy("windows", LA, "wide", n_win=n_win)
    keys = ("regs", "spills", "blocks_per_sm", "threads", "smem", "waves")
    shape = [B, Lq, LA, n_win]
    rec_v = dict(shape=shape, max_abs_err=err_v, bitwise=ok_v, ms=m1_ms,
                 plain_ms=plain_v_ms, bound_ms=m1_bound, bound_by=m1_by,
                 library_ms=None, bytes=m1_bytes,
                 walk_bytes_read=32 * w_sec, query_bytes_read=32 * q_sec,
                 tiles=occ_v["tiles"],
                 gaps=occ_v["gaps"], **{k: occ_v[k] for k in keys})
    rec_w = dict(shape=shape, max_abs_err=max(r[1] for r in recs_w),
                 bitwise=all(r[0] for r in recs_w), ms=m2_ms,
                 plain_ms=plain_w_ms, plain_detect_ms=plain_wd_ms,
                 bound_ms=m2_bound, bound_by=m2_by, library_ms=None,
                 bytes=m2_bytes, vote_bytes_read=32 * sectors,
                 vote_bytes=votes_b, variant=occ_w["variant"],
                 wide_ms=m2_wide_ms,
                 wide=dict(scratch=n_win * kernels.merge_windows_scratch(LA),
                           **{k: occ_wide[k] for k in keys}),
                 **{k: occ_w[k] for k in keys})
    emit("merge", windows=plan.n_real_win, jobs=plan.n_jobs,
         band_w=c["band_w"], shape=shape, merge_votes=rec_v,
         merge_windows=rec_w, merge_round_ms=round_ms,
         plain_round_ms=plain_round_ms, ovf_windows=recs_w[0][2],
         conv_windows=recs_w[2][3])
    if not ok_v:
        fail(f"merge_votes disagrees with its plain version (max_abs_err="
             f"{err_v})")
    if not rec_w["bitwise"]:
        fail(f"merge_windows disagrees with its plain version (max_abs_err="
             f"{rec_w['max_abs_err']})")
    rec_s, split = phase_sched_merge(c, scale)
    return {("merge_votes", 0): rec_v, ("merge_windows", 0): rec_w,
            ("merge_windows_sched", 0): rec_s, **split}


def phase_sched_merge(c, scale, scale_final=0.6):
    """Phase 7's M2 sched mode: the chunk of merge_chunk advanced one round
    on the card (round 0's M1 and M2), round 1's forward and walk, then
    M2's sched mode at round 1 with detect (the windows that reached a
    fixed point freeze) and the sticky flag set on two windows, with
    ``last`` off and on, in both variants, bitwise against its plain
    version; timed as CUDA graphs in turns against the base mode on the
    same inputs. Its bound counts the sectors of the sums that the base
    vote-out reads and those that the freezing windows' second vote-out
    at the final scale reads (vote_needs at each scale), and the freezing
    windows' output rows; the count is checked by poisoning the rest."""
    import torch
    from racon_tpu_torch.ops import device_merge as dm
    from racon_tpu_torch.ops import device_poa as P
    from racon_tpu_torch.ops import kernels
    plan = c["plan"]
    B, LA, n_win = plan.B, plan.LA, plan.n_win
    mem = dm.window_members(c["win"], n_win)
    bb, bbw, alen, begin, end, _, ovf, _ = P._merge_round(
        c["cols"], c["esc_w"], c["lt"], c["t_off"], c["q"], c["qw8"],
        c["w_read"], c["bb"], c["bbw"], c["alen"], c["begin"], c["end"],
        c["win"], c["ovf"], mem, ins_scale=scale, n_win=n_win, LA=LA)
    bw1 = P.round_band_width(c["band_w"], 1)
    lq = c["lq"]
    fwd = P._lane_fwd(bb, alen, begin, end, c["q"], lq, c["win"], match=5,
                      mismatch=-4, gap=-8, Lq=plan.Lq, LA=LA, band_w=bw1,
                      nxt_k=c["nxt_k"])
    cols, esc_w = P._lane_walk(*fwd, lq, LA=LA, band_w=bw1)
    votes, wesc = dm.merge_votes_plain(cols, c["q"], c["qw8"], c["w_read"],
                                       fwd[3], fwd[4], esc_w, c["win"],
                                       n_win=n_win, LA=LA)
    ovf = ovf.clone()
    ovf[[3, 7]] = True
    args = (votes, wesc, bb, bbw, alen, begin, end, c["win"], ovf)
    orig = torch.arange(n_win, dtype=torch.int32, device=bb.device)
    fresh = (torch.zeros((n_win + 1, LA), dtype=torch.uint8,
                         device=bb.device),
             torch.zeros((n_win + 1, LA), dtype=torch.int32,
                         device=bb.device),
             torch.ones(n_win + 1, dtype=torch.int32, device=bb.device),
             torch.zeros(n_win + 1, dtype=torch.bool, device=bb.device))
    ok, err, mix = True, 0.0, {}
    for last in (False, True):
        kw = dict(ins_scale=scale, scale_final=scale_final, last=last,
                  n_win=n_win, LA=LA, detect=True)
        ref_out = tuple(t.clone() for t in fresh)
        ref = dm.merge_windows_sched_plain(*args, orig, ref_out, **kw)
        froze = ref[6] | ref[7] | last
        real = torch.arange(n_win, device=bb.device) < plan.n_real_win
        mix["last" if last else "not_last"] = dict(conv=int((ref[7] & real).sum().item()),
                         ovf=int((ref[6] & real).sum().item()),
                         frozen=int((froze & real).sum().item()),
                         padded=n_win - plan.n_real_win)
        for variant in (None, "wide"):
            got_out = tuple(t.clone() for t in fresh)
            got = kernels.merge_windows_sched(*args, mem, orig, got_out,
                                              variant=variant, **kw)
            ok &= same_bits(ref, got) and same_bits(ref_out, got_out)
            err = max(err, float_err(ref, got), float_err(ref_out, got_out))
    # The bound at last = False, the main path's usual mix (a freezing
    # window's second pass reads what vote_needs counts at the final
    # scale).
    kw = dict(ins_scale=scale, scale_final=scale_final, last=False,
              n_win=n_win, LA=LA, detect=True)
    ref_out = tuple(t.clone() for t in fresh)
    ref = dm.merge_windows_sched_plain(*args, orig, ref_out, **kw)
    froze = ref[6] | ref[7]
    _, need0 = vote_needs(votes, bb, bbw, alen, scale)
    _, need_f = vote_needs(votes, bb, bbw, alen, scale_final)
    need = need0 | (need_f & froze[:, None, None])
    sectors = need_sectors(need)
    for fill in (float("nan"), 1e30):
        pout = tuple(t.clone() for t in fresh)
        pres = dm.merge_windows_sched_plain(votes.masked_fill(~need, fill),
                                            *args[1:], orig, pout, **kw)
        if not (same_bits(ref, pres) and same_bits(ref_out, pout)):
            fail(f"merge_windows_sched's byte count misses sums it reads "
                 f"(entries outside it set to {fill} change its output)")
    n_froze = int(froze.sum().item())
    sched_bytes = (32 * sectors + 4 * n_win +
                   5 * int(alen[:-1].sum().item()) + 4 * (n_win + 1) +
                   16 * B + 8 * n_win + n_win + 5 * (n_win + 1) * LA +
                   4 * (n_win + 1) + 8 * B + 4 * n_win * LA + 2 * n_win +
                   4 * n_win + n_froze * (5 * LA + 5))
    mem_g = mem
    base_kw = dict(ins_scale=scale, n_win=n_win, LA=LA, detect=True)
    outs = [tuple(t.clone() for t in fresh) for _ in range(3)]
    base_ms, sched_ms, last_ms, wide_ms = time_graph_turns(
        [lambda: kernels.merge_windows(*args, mem_g, **base_kw),
         lambda: kernels.merge_windows_sched(*args, mem_g, orig, outs[0],
                                             **kw),
         lambda: kernels.merge_windows_sched(*args, mem_g, orig, outs[1],
                                             **dict(kw, last=True)),
         lambda: kernels.merge_windows_sched(*args, mem_g, orig, outs[2],
                                             variant="wide", **kw)],
        reps=20, calls=10)
    plain_ms, = time_turns([lambda: dm.merge_windows_sched_plain(
        *args, orig, tuple(t.clone() for t in fresh), **kw)], reps=3)
    occ = kernels.merge_occupancy("windows_sched", LA, n_win=n_win)
    occ_wide = kernels.merge_occupancy("windows_sched", LA, "wide",
                                       n_win=n_win)
    keys = ("regs", "spills", "blocks_per_sm", "threads", "smem", "waves")
    b_ms, b_by = bound(sched_bytes, 0)
    rec = dict(shape=[B, plan.Lq, LA, n_win], max_abs_err=err, bitwise=ok,
               ms=sched_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None, bytes=sched_bytes,
               vote_bytes_read=32 * sectors, last_ms=last_ms,
               base_mode_ms=base_ms, wide_ms=wide_ms,
               variant=occ["variant"], freeze_mix=mix,
               wide={k: occ_wide[k] for k in keys},
               **{k: occ[k] for k in keys})
    emit("merge_sched", round=1, band_w=bw1, **rec)
    if not ok:
        fail(f"merge_windows_sched disagrees with its plain version "
             f"(max_abs_err={err})")
    m = mix["not_last"]
    if not (m["conv"] and m["ovf"] and m["frozen"] < plan.n_real_win):
        fail(f"merge_windows_sched: the freeze mix lacks a reason ({mix})")
    if occ["spills"]:
        fail(f"merge_windows_sched: the narrow kernel spills ({occ})")
    split = phase_split_merge(args, orig, fresh, plan, need0, need_f, sectors,
                              scale, scale_final)
    return rec, split


def phase_split_merge(args, orig, fresh, plan, need0, need_f, sectors,
                      scale, scale_final):
    """Phase 7's M2 halves of a dp mesh's detecting round (phase 13's
    kernels): phase_sched_merge's round-1 inputs with the chunk's lanes
    split into two contiguous shards, as a two-shard mesh holds them. On
    each shard the emit half (merge_windows with ``split``) in both
    variants, bitwise against merge_windows_plain(split=True); the span
    flags summed; the freeze half (merge_windows_freeze) in both variants
    bitwise against its plain version; and the summed ``conv`` and every
    shard's accumulators bitwise the unsharded sched mode's. Timed as
    CUDA graphs in turns (a shard's launch). Bounds: the emit half moves
    M2's bytes at a shard's lanes and the span flags; the freeze half
    the sums the freezing windows' final-scale vote-out reads, their
    anchors, the flags and their output rows."""
    import torch
    from racon_tpu_torch.ops import device_merge as dm
    from racon_tpu_torch.ops import kernels
    votes, wesc, bb, bbw, alen, begin, end, win, ovf = args
    B, LA, n_win = plan.B, plan.LA, plan.n_win
    Bs = B // 2
    sl = [slice(0, Bs), slice(Bs, B)]
    mem = [dm.window_members(win[s], n_win) for s in sl]
    kw = dict(ins_scale=scale, n_win=n_win, LA=LA, detect=True)
    ok, err = True, 0.0
    halves = []
    for k, s in enumerate(sl):
        sargs = (votes, wesc, bb, bbw, alen, begin[s], end[s], win[s], ovf)
        ref = dm.merge_windows_plain(*sargs, split=True, **kw)
        for variant in (None, "wide"):
            got = kernels.merge_windows(*sargs, mem[k], variant=variant,
                                        split=True, **kw)
            ok &= same_bits(ref, got)
            err = max(err, float_err(ref, got))
        halves.append(ref)
    moved = halves[0][8] + halves[1][8]
    conv = [h[7] & (moved == 0) for h in halves]
    fkw = dict(scale_final=scale_final, last=False, n_win=n_win, LA=LA)
    ref_out = tuple(t.clone() for t in fresh)
    whole = dm.merge_windows_sched_plain(*args, orig, ref_out,
                                         **dict(kw, scale_final=scale_final,
                                                last=False))
    for k in range(2):
        ok &= same_bits((conv[k],), (whole[7],))
        fargs = (votes, wesc, bb, bbw, alen, ovf, conv[k], halves[k][6], orig)
        pout = tuple(t.clone() for t in fresh)
        dm.merge_windows_freeze_plain(*fargs, pout, **fkw)
        ok &= same_bits(pout, ref_out)
        for variant in (None, "wide"):
            gout = tuple(t.clone() for t in fresh)
            kernels.merge_windows_freeze(*fargs, gout, variant=variant, **fkw)
            ok &= same_bits(pout, gout)
            err = max(err, float_err(pout, gout))
    straddle = int(((halves[0][8] > 0) & (halves[1][8] == 0) &
                    halves[1][7]).sum().item() +
                   ((halves[1][8] > 0) & (halves[0][8] == 0) &
                    halves[0][7]).sum().item())
    froze = whole[6] | whole[7]
    n_froze = int(froze.sum().item())
    emit_bytes = (32 * sectors + 4 * n_win +
                  5 * int(alen[:-1].sum().item()) + 4 * (n_win + 1) +
                  16 * Bs + 8 * n_win + n_win + 5 * (n_win + 1) * LA +
                  4 * (n_win + 1) + 8 * Bs + 4 * n_win * LA + 2 * n_win +
                  4 * n_win)
    need_fz = (need0 | need_f) & froze[:, None, None]
    freeze_bytes = (32 * need_sectors(need_fz) + 4 * n_win +
                    5 * int(alen[:-1][froze].sum().item()) + 4 * n_win +
                    4 * n_win + n_froze * (5 * LA + 5))
    gout = tuple(t.clone() for t in fresh)
    sargs0 = (votes, wesc, bb, bbw, alen, begin[sl[0]], end[sl[0]],
              win[sl[0]], ovf)
    fargs0 = (votes, wesc, bb, bbw, alen, ovf, conv[0], halves[0][6], orig)
    emit_ms, freeze_ms, emit_wide_ms, freeze_wide_ms = time_graph_turns(
        [lambda: kernels.merge_windows(*sargs0, mem[0], split=True, **kw),
         lambda: kernels.merge_windows_freeze(*fargs0, gout, **fkw),
         lambda: kernels.merge_windows(*sargs0, mem[0], split=True,
                                       variant="wide", **kw),
         lambda: kernels.merge_windows_freeze(*fargs0, gout, variant="wide",
                                              **fkw)], reps=20, calls=10)
    plain_emit_ms, plain_freeze_ms = time_turns(
        [lambda: dm.merge_windows_plain(*sargs0, split=True, **kw),
         lambda: dm.merge_windows_freeze_plain(
             *fargs0, tuple(t.clone() for t in fresh), **fkw)], reps=3)
    keys = ("regs", "spills", "blocks_per_sm", "threads", "smem", "waves")
    recs = {}
    for name, ms, wide_ms, plain_ms, nbytes in (
            ("merge_windows_emit", emit_ms, emit_wide_ms, plain_emit_ms,
             emit_bytes),
            ("merge_windows_freeze", freeze_ms, freeze_wide_ms,
             plain_freeze_ms, freeze_bytes)):
        occ = kernels.merge_occupancy(name[len("merge_"):], LA, n_win=n_win)
        b_ms, b_by = bound(nbytes, 0)
        recs[(name, 0)] = dict(
            shape=[Bs, plan.Lq, LA, n_win], max_abs_err=err, bitwise=ok,
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, bytes=nbytes, wide_ms=wide_ms,
            variant=occ["variant"], **{k: occ[k] for k in keys})
    emit("merge_split", round=1, shards=2, straddling_windows=straddle,
         frozen=n_froze, conv=int(whole[7].sum().item()),
         merge_windows_emit=recs[("merge_windows_emit", 0)],
         merge_windows_freeze=recs[("merge_windows_freeze", 0)])
    if not ok:
        fail(f"the mesh's M2 halves disagree with their plain versions or "
             f"with the unsharded sched mode (max_abs_err={err})")
    return recs


def _http(url, body=None):
    """GET (or POST ``body`` as JSON) on the daemon; returns (status,
    headers, bytes)."""
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _submit(url, tenant, argv, device):
    """POST one job of a CLI case's argv (three paths, then options)."""
    status, _, body = _http(f"{url}/v1/jobs", {
        "tenant": tenant, "sequences": argv[0], "overlaps": argv[1],
        "targets": argv[2], "options": {"backend": device}})
    if status != 202:
        fail(f"serve: submit answered {status}: {body!r}")
    return json.loads(body)["id"]


def _wait_done(url, job_id, timeout_s=600.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        st = json.loads(_http(f"{url}/v1/jobs/{job_id}")[2])
        if st["state"] in ("done", "failed", "cancelled"):
            if st["state"] != "done":
                fail(f"serve: job {job_id} ended {st['state']}: {st}")
            return _http(f"{url}/v1/jobs/{job_id}/stream")[2]
        time.sleep(0.05)
    fail(f"serve: job {job_id} not done after {timeout_s} s")


def _sum_launches(records):
    out = {}
    for r in records:
        for k, n in r.items():
            out[k] = out.get(k, 0) + n
    return out


def _serve_inproc(device, tmp, small, serial):
    """Part 1 of phase 10: jobs A, B, C through an in-process daemon;
    then A again (Tier 1); then B and C one at a time and together."""
    from racon_tpu_torch.obs import metrics
    from racon_tpu_torch.ops import kernels, ovl_align
    from racon_tpu_torch.server.daemon import PolishServer, serve_http
    t0 = time.perf_counter()
    cases = [("A", "acme", serial["argv"], serial["out"]),
             ("B", "umbrella", small["kC"]["argv"], small["kC"]["out"]),
             ("C", "umbrella", small["partial PAF"]["argv"],
              small["partial PAF"]["out"])]
    server = PolishServer(os.path.join(tmp, "serve1"))
    server.session.activate()
    httpd = serve_http(server, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        metrics.reset()
        ovl_align.reset_stats()
        kernels.reset_launches()
        ids = {name: _submit(url, tenant, argv, device)
               for name, tenant, argv, _ in cases}
        outs = {name: _wait_done(url, ids[name]) for name, *_ in cases}
        launches = dict(kernels.LAUNCHES)
        snap = metrics.registry().snapshot()
        dispatches = [d for b in server.batchers() for d in b.dispatches]
        by_batches = _sum_launches(d["launches"] for d in dispatches)
        by_jobs = _sum_launches(server.get(ids[n]).launches
                                for n, *_ in cases)
        untiled = sum(g["groups"] for g in ovl_align.UNTILED_GROUPS)
        res = {k: v for k, v in metrics.resilience_extras().items()
               if not k.startswith("res_ckpt_")}
        identical = {n: outs[n] == out for n, _, _, out in cases}
        mixed = [d for d in dispatches if len(d["jobs"]) > 1]
        # A again: a verified Tier-1 hit replays it with no launch.
        kernels.reset_launches()
        t_hit = time.perf_counter()
        again = _wait_done(url, _submit(url, "acme", serial["argv"],
                                        device))
        hit_s = time.perf_counter() - t_hit
        hit_launches = sum(kernels.LAUNCHES.values())
        hits = metrics.registry().get("cache_hits_total", 0)
        status = json.loads(_http(f"{url}/healthz")[2])
        render = _http(f"{url}/metrics")[2].decode()
    finally:
        httpd.shutdown()
        server.drain(30.0)
    from racon_tpu_torch.obs.export import validate_openmetrics
    rec = dict(part="inproc", seconds=time.perf_counter() - t0,
               identical=identical, dispatches=len(dispatches),
               mixed_dispatches=len(mixed),
               windows=[d["windows"] for d in dispatches],
               launches=launches, batch_launches=by_batches,
               job_launches=by_jobs, untiled_groups=untiled,
               occupancy=snap.get("serve_batch_occupancy"),
               queue_wait=snap.get("serve_queue_wait_s"),
               job_latency=snap.get("serve_job_latency_s"),
               dispatch_round=snap.get("dispatch_round_s"),
               resilience=res, cache_hit_s=hit_s,
               cache_hit_identical=again == serial["out"],
               cache_hit_launches=hit_launches, cache_hits=hits,
               health=status.get("status"),
               openmetrics_errors=validate_openmetrics(render))
    for n, ok in identical.items():
        if not ok:
            fail(f"serve: job {n}'s stream differs from its CLI FASTA")
    for k in ("band_fwd", "col_walk", "merge_votes"):
        if by_batches.get(k, 0) <= 0:
            fail(f"serve: the batches launched no {k} ({by_batches})")
    if by_batches.get("merge_windows", 0) + \
            by_batches.get("merge_windows_sched", 0) <= 0:
        fail(f"serve: the batches launched no M2 ({by_batches})")
    for k, n in launches.items():
        if by_batches.get(k, 0) + by_jobs.get(k, 0) != n:
            fail(f"serve: {k} launched {n} times, not the dispatches' "
                 f"{by_batches.get(k, 0)} + the jobs' {by_jobs.get(k, 0)}")
    if by_jobs.get("band_fwd", 0) != untiled or \
            by_jobs.get("merge_votes", 0) or by_jobs.get("merge_windows", 0):
        fail(f"serve: the jobs' own threads launched {by_jobs}, not only "
             f"their overlap alignment ({untiled} untiled groups)")
    if res:
        fail(f"serve: res_* counters on a clean run: {res}")
    if not rec["cache_hit_identical"] or hit_launches or hits < 1:
        fail(f"serve: the resubmitted job was not a clean Tier-1 hit "
             f"(identical {rec['cache_hit_identical']}, {hit_launches} "
             f"launches, {hits} hits)")
    if rec["openmetrics_errors"] or rec["health"] != "ok":
        fail(f"serve: /metrics or /healthz broken: {rec}")
    # The daemon's render carries the engine's and the aligner's
    # telemetry and the fed transfer histogram.
    t_check = time.perf_counter()
    families = ("racon_tpu_ovl_device_jobs", "racon_tpu_sched_rounds",
                "racon_tpu_h2d_transfer_s_bucket",
                "racon_tpu_device_dispatches")
    missing = [f for f in families if f"\n{f}" not in "\n" + render]
    TELEMETRY["serve"] = dict(
        missing=missing, **{k: snap.get(k) for k in (
            "ovl_device_jobs", "sched_rounds", "device_dispatches")},
        h2d_transfer_s_count=(snap.get("h2d_transfer_s") or {}).get(
            "count"))
    if missing:
        fail(f"serve: /metrics renders no {missing}")
    TELEMETRY["check_s"] += time.perf_counter() - t_check

    # B and C one at a time, then together (no cache, a 3 s batch wait
    # so that the two co-ride whatever their alignment takes).
    occ = {}
    with _environ(RACON_TPU_CACHE="0", RACON_TPU_SERVE_BATCH_WAIT_S="3"):
        for mode in ("solo", "together"):
            server = PolishServer(os.path.join(tmp, f"serve_{mode}"))
            try:
                metrics.reset()
                ovl_align.reset_stats()
                jobs = []
                if mode == "solo":
                    for _, tenant, argv, out in cases[1:]:
                        job = server.submit(tenant, _spec(argv, device))
                        job.finished.wait(600)
                        jobs.append((job, out))
                else:
                    jobs = [(server.submit(tenant, _spec(argv, device)), out)
                            for _, tenant, argv, out in cases[1:]]
                    for job, _ in jobs:
                        job.finished.wait(600)
                for job, out in jobs:
                    if job.state != "done" or job.result_bytes() != out:
                        fail(f"serve ({mode}): job {job.id} {job.state} "
                             f"{job.error} or its bytes differ")
                ds = [d for b in server.batchers() for d in b.dispatches]
                occ[mode] = dict(
                    occupancy=metrics.registry().get(
                        "serve_batch_occupancy"),
                    windows=[d["windows"] for d in ds],
                    jobs=[d["jobs"] for d in ds],
                    aligned_jobs=ovl_counts())
            finally:
                server.drain(30.0)
    rec["seconds"] = time.perf_counter() - t0
    rec["occupancy_solo"] = occ["solo"]
    rec["occupancy_together"] = occ["together"]
    emit("serve", **rec)
    if not occ["together"]["occupancy"] > occ["solo"]["occupancy"]:
        fail(f"serve: occupancy together {occ['together']} not above one "
             f"at a time {occ['solo']}")
    if not any(len(j) > 1 for j in occ["together"]["jobs"]):
        fail("serve: B and C never shared a dispatch")


def _spec(argv, device):
    from racon_tpu_torch.server.engine import JobSpec
    return JobSpec(argv[0], argv[1], argv[2], backend=device)


def _serve_restart(device, tmp, small):
    """Part 2 of phase 10: a daemon subprocess killed at its second
    commit, a standby restart that adopts and finishes the job, then a
    SIGTERM drain."""
    import signal
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    state = os.path.join(tmp, "serve_kill")
    port_file = os.path.join(state, "port")
    case = small["partial PAF"]
    env = dict(os.environ, RACON_TPU_GATE_LEASE_S="2",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("RACON_TPU_FAULTS", None)
    cmd = [sys.executable, "-m", "racon_tpu_torch.server", "--state-dir",
           state, "--port", "0"]
    procs = []

    def start(extra_env, args=()):
        if os.path.exists(port_file):
            os.remove(port_file)
        p = subprocess.Popen(cmd + list(args), env=dict(env, **extra_env),
                             cwd=root, stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE)
        procs.append(p)
        t = time.perf_counter()
        while not os.path.exists(port_file):
            if p.poll() is not None or time.perf_counter() - t > 180:
                fail(f"serve restart: the daemon did not start "
                     f"(rc {p.poll()}): {p.stderr.read().decode()[-2000:]}")
            time.sleep(0.1)
        with open(port_file) as fh:
            return p, f"http://127.0.0.1:{int(fh.read())}"

    try:
        p1, url = start({"RACON_TPU_FAULTS": "serve/commit:1!kill"})
        job_id = _submit(url, "umbrella", case["argv"], device)
        rc1 = p1.wait(timeout=300)
        err1 = p1.stderr.read().decode()
        with open(os.path.join(state, "jobs", job_id, "ckpt",
                               "manifest.jsonl")) as fh:
            committed = sum(1 for ln in fh if '"contig"' in ln)
        p2, url = start({}, ["--standby"])
        out = _wait_done(url, job_id)
        p2.send_signal(signal.SIGTERM)
        rc2 = p2.wait(timeout=120)
        err2 = p2.stderr.read().decode()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rec = dict(part="restart", seconds=time.perf_counter() - t0,
               killed_rc=rc1, committed_before_kill=committed,
               identical=out == case["out"], drain_rc=rc2,
               adopted="adopted state dir" in err2,
               resumed="resumed 1 in-flight" in err2)
    emit("serve", **rec)
    if rc1 != 137 or committed != 1:
        fail(f"serve restart: the kill gave rc {rc1} with {committed} "
             f"commits: {err1[-2000:]}")
    if not (rec["identical"] and rc2 == 0 and rec["resumed"]):
        fail(f"serve restart: {rec}: {err2[-2000:]}")


def _serve_resume(device, tmp, serial):
    """Part 3 of phase 10: phase 4's input through the CLI with
    --checkpoint-dir, killed at its sixth commit, then --resume."""
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    ck = os.path.join(tmp, "ckpt_main")
    argv = serial["argv"] + ["--checkpoint-dir", ck]
    env = dict(os.environ, RACON_TPU_FAULTS="ckpt/commit:5!kill",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    killed = subprocess.run([sys.executable, "-m", "racon_tpu_torch.cli",
                             *argv], env=env, cwd=root,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, timeout=600)
    r = main_run(device, argv + ["--resume"], True)
    k1_main = serial["rec"]["chunk_rounds"]
    rec = dict(part="resume", seconds=time.perf_counter() - t0,
               killed_rc=killed.returncode,
               identical=r["out"] == serial["out"],
               k1_consensus=r["k1_consensus"], k1_consensus_phase4=k1_main,
               resumed=re.findall(r"resuming: (\d+) contig", r["err"]),
               launches=r["launches"], wall_s=r["wall"])
    emit("serve", **rec)
    if killed.returncode != 137:
        fail(f"serve resume: the killed CLI exited {killed.returncode}: "
             f"{killed.stderr.decode()[-2000:]}")
    if not rec["identical"] or rec["resumed"] != ["5"]:
        fail(f"serve resume: {rec}")
    if not 0 < r["k1_consensus"] < k1_main:
        fail(f"serve resume: {r['k1_consensus']} consensus K1 launches, "
             f"not fewer than phase 4's {k1_main}")


def phase_serve(device, tmp, small, serial):
    """Phase 10 (module docstring): the daemon, the restart and the
    resumable CLI on the card."""
    from racon_tpu_torch.pipeline import configure as configure_pipeline
    t0 = time.perf_counter()
    configure_pipeline(0)
    try:
        _serve_inproc(device, tmp, small, serial)
        _serve_restart(device, tmp, small)
        _serve_resume(device, tmp, serial)
    finally:
        configure_pipeline(None)
    emit("serve", part="total", seconds=time.perf_counter() - t0)


# ------------------------------------------------------------ 11. fleet

FLEET_LEASE_S = 12
FLEET_SHARDS = 2
FLEET_KILL_AT = 7


class CardMemory:
    """Samples the card's used memory (all processes: total less
    ``torch.cuda.mem_get_info``'s free bytes) on a thread every 0.2 s; ``peak`` is the largest sample,
    :meth:`take` the largest since the last take."""

    def __init__(self):
        import threading
        import torch
        self.total = torch.cuda.mem_get_info()[1]
        self.peak = self._since = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _sample(self):
        import torch
        free, total = torch.cuda.mem_get_info()
        self.peak = max(self.peak, total - free)
        self._since = max(self._since, total - free)

    def take(self) -> int:
        """The peak since the last take."""
        peak, self._since = self._since, 0
        return peak

    def _run(self):
        while not self._stop.is_set():
            self._sample()
            self._stop.wait(0.2)

    def __enter__(self):
        self._sample()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        return False


def _events(ledger_dir):
    path = os.path.join(ledger_dir, "events.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return [json.loads(ln) for ln in fh if ln.endswith("\n")]


def _manifest_tids(ledger_dir):
    """Every committed contig's target id across the ledger's shard
    stores (split children included)."""
    from racon_tpu_torch.distributed import WorkLedger
    led = WorkLedger.attach(ledger_dir)
    tids = []
    for info in led.all_shards():
        man = os.path.join(led.shard_ckpt_dir(info), "manifest.jsonl")
        if os.path.exists(man):
            with open(man) as fh:
                tids += [json.loads(ln)["tid"] for ln in fh
                         if '"ev": "contig"' in ln]
    return sorted(tids)


def _subprocess_env(**extra):
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ,
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""), **extra)
    for name in ("RACON_TPU_FAULTS", "RACON_TPU_SCHED",
                 "RACON_TPU_METRICS_PORT"):
        if name not in extra:
            env.pop(name, None)
    return root, env


def _fleet_steal(device, tmp, serial):
    """Part 1 of phase 11: workers A (a subprocess, killed at its
    FLEET_KILL_AT + 1-th commit) and B (this process, counted) on one
    ledger over phase 4's input; B steals A's shard after its lease
    expires and merges."""
    t0 = time.perf_counter()
    ld = os.path.join(tmp, "fleet_steal")
    # Two shards of 10 contigs (A publishes the ledger; B adopts it):
    # each shard's polisher plans its own chunks, so B's consensus K1
    # stays below phase 4's only when A's commits save B whole chunks.
    # The partition --workers 2 gives by default (4 shards of 5 contigs)
    # packs less full chunks and costs more consensus K1 launches than
    # a serial run (a thief of 17 contigs launched 72 against phase 4's
    # 64 on the card), so this part does not run it.
    root, env = _subprocess_env(
        RACON_TPU_FAULTS=f"dist/contig:{FLEET_KILL_AT}!kill",
        RACON_TPU_OBS_FLUSH_S="0",
        RACON_TPU_DIST_SHARDS=str(FLEET_SHARDS))
    fleet_argv = ["--ledger-dir", ld, "--workers", "2", "--lease-s",
                  str(FLEET_LEASE_S)]
    log_a = open(os.path.join(tmp, "fleet_worker_A.log"), "wb")
    proc = subprocess.Popen([sys.executable, "-m", "racon_tpu_torch.cli",
                             *serial["argv"], *fleet_argv, "--worker-id",
                             "A"], env=env, cwd=root,
                            stdout=subprocess.DEVNULL, stderr=log_a)
    try:
        # B joins once A holds a shard, so A's shard is the one stolen.
        t_wait = time.perf_counter()
        while not any(e.get("ev") == "claim" and e.get("worker") == "A"
                      for e in _events(ld)):
            if proc.poll() is not None or \
                    time.perf_counter() - t_wait > 180:
                fail(f"fleet: worker A claimed no shard (rc {proc.poll()})")
            time.sleep(0.1)
        a_joined_s = time.perf_counter() - t0
        r = main_run(device, serial["argv"] + fleet_argv +
                     ["--worker-id", "B"], True)
        rc_a = proc.wait(timeout=120)
        from racon_tpu_torch.obs import fleet
        fleet._WRITER = None   # B's writer; later runs here are serial
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log_a.close()
    events = _events(ld)
    steals = [e for e in events if e.get("ev") == "steal"]
    stolen = {e["name"] for e in steals if e.get("victim") == "A"}
    # A renews its lease once a commit (and dies at the next's fault).
    a_renews = [e["name"] for e in events if e.get("ev") == "renew" and
                e.get("worker") == "A"]
    a_commits = sum(1 for name in a_renews if name in stolen)
    n_contigs = len(serial["ds"]["drafts"])
    counters = r["counters"]
    n = r["launches"]
    k1_main = serial["rec"]["chunk_rounds"]
    rec = dict(part="steal", seconds=time.perf_counter() - t0,
               a_joined_s=a_joined_s, a_rc=rc_a,
               identical=r["out"] == serial["out"], steals=len(steals),
               splits=sum(1 for e in events if e.get("ev") == "split"),
               a_commits=len(a_renews), a_commits_on_stolen=a_commits,
               dist={k: v for k, v in counters.items()
                     if k.startswith("dist_")},
               k1_consensus=r["k1_consensus"], k1_consensus_phase4=k1_main,
               chunks=r["host_n"].get("h2d", 0),
               windows=counters.get("poa_windows_total"),
               windows_phase4=serial["n_windows"],
               consensus_walks=r["walks"], launches=n, stage_ms=r["stages"],
               ovl=r["ovl"], peak_b=r["peak"], wall_s=r["wall"],
               resilience=r["resilience"])
    emit("fleet", **rec)
    if rc_a != 137:
        fail(f"fleet: worker A exited {rc_a}, not 137")
    if not rec["identical"]:
        fail("fleet: worker B's merged FASTA differs from phase 4's")
    if not stolen:
        fail(f"fleet: no steal of A's shard in events.jsonl ({steals})")
    if counters.get("dist_contigs_resumed") != a_commits or \
            len(a_renews) != FLEET_KILL_AT:
        fail(f"fleet: B resumed {counters.get('dist_contigs_resumed')} "
             f"contig(s), A committed {a_commits} on the stolen shard and "
             f"{len(a_renews)} in all (killed at its commit "
             f"{FLEET_KILL_AT + 1})")
    if _manifest_tids(ld) != list(range(n_contigs)):
        fail(f"fleet: the shard manifests do not hold each target once: "
             f"{_manifest_tids(ld)}")
    check_launches("fleet worker B", r)
    check_clean("fleet worker B", r)
    m2 = n["merge_windows"] + n["merge_windows_sched"]
    if not (r["k1_consensus"] > 0 and r["walks"] > 0 and
            n["merge_votes"] > 0 and m2 > 0 and n["merge_windows_sched"]):
        fail(f"fleet: worker B did not run the consensus kernels on the "
             f"card ({n})")
    if not r["k1_consensus"] < k1_main or \
            not 0 < rec["windows"] < serial["n_windows"]:
        fail(f"fleet: worker B launched {r['k1_consensus']} consensus K1 "
             f"on {rec['windows']} windows, not fewer than phase 4's "
             f"{k1_main} on {serial['n_windows']}")
    return r


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fleet_autoscale(device, tmp):
    """Part 2 of phase 11: ``--autoscale --workers 2`` as a subprocess on
    a 5-contig input, spawn #0 killed at its second commit, /healthz
    polled while the fleet runs."""
    import urllib.error
    import urllib.request
    from racon_tpu_torch.obs import export, fleet
    t0 = time.perf_counter()
    ds = main_dataset(os.path.join(tmp, "fleet5"), n_contigs=5)
    p = ds["paths"]
    # Workers run on the card by default: --device is never added there.
    argv = [p["reads"], p["overlaps"], p["draft"], "-t",
            str(os.cpu_count() or 1)] + \
        ([] if device == "cuda" else ["--device", device])
    rc, base, err, serial_s = run_cli(argv + ["--device", device])
    if rc != 0:
        fail(f"fleet: the 5-contig serial run failed: {err[-2000:]}")
    ld = os.path.join(tmp, "fleet_auto")
    plan = os.path.join(tmp, "fleet_plan.json")
    with open(plan, "w") as fh:
        json.dump(["dist/contig:1!kill"], fh)
    port = _free_port()
    root, env = _subprocess_env(
        RACON_TPU_AUTOSCALE_FAULT_PLAN=plan,
        RACON_TPU_METRICS_PORT=str(port), RACON_TPU_OBS_FLUSH_S="0",
        RACON_TPU_AUTOSCALE_INTERVAL_S="0.2",
        RACON_TPU_AUTOSCALE_DEADLINE_S="240")
    out_f = open(os.path.join(tmp, "fleet_sup.out"), "wb")
    err_f = open(os.path.join(tmp, "fleet_sup.err"), "wb")
    sup = subprocess.Popen([sys.executable, "-m", "racon_tpu_torch.cli",
                            *argv, "--autoscale", "--workers", "2",
                            "--lease-s", str(FLEET_LEASE_S), "--ledger-dir",
                            ld], env=env, cwd=root, stdout=out_f,
                           stderr=err_f)
    health = []
    try:
        while sup.poll() is None and time.perf_counter() - t0 < 280:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz",
                        timeout=5) as resp:
                    health.append((resp.status, json.loads(resp.read())))
            except urllib.error.HTTPError as exc:
                health.append((exc.code, None))
            except (urllib.error.URLError, OSError, ValueError):
                pass
            time.sleep(0.5)
        rc = sup.wait(timeout=30)
    finally:
        if sup.poll() is None:
            sup.kill()
            sup.wait()
        out_f.close()
        err_f.close()
    with open(os.path.join(tmp, "fleet_sup.out"), "rb") as fh:
        out = fh.read()
    with open(os.path.join(tmp, "fleet_sup.err"), "rb") as fh:
        sup_err = fh.read().decode(errors="replace")
    if rc != 0:
        fail(f"fleet: the supervisor exited {rc}: {sup_err[-3000:]}")
    hb = fleet.load_supervisor(ld) or {}
    model = fleet.aggregate(ld)
    text = export.render_fleet(model)
    ok_views = [h for s, h in health if s == 200 and h and "fleet" in h]
    events = _events(ld)
    polishers = sorted({e["worker"] for e in events
                        if e.get("ev") in ("claim", "steal") and
                        str(e.get("name", "")).startswith("shard_")})
    k1 = {w: model["workers"].get(w, {}).get("metrics", {}).get(
        "kernel_launches_band_fwd_consensus", 0) for w in polishers}
    rec = dict(part="autoscale", seconds=time.perf_counter() - t0,
               serial_s=serial_s, identical=out == base, rc=rc,
               spawned=hb.get("spawned_total"),
               evicted=hb.get("evicted_total"), done=hb.get("done"),
               healthz_polls=len(health), healthz_200=len(ok_views),
               healthz_last=ok_views[-1]["fleet"] if ok_views else None,
               steals=model["steals"], splits=model["splits"],
               workers=sorted(model["workers"]),
               final={w: v["final"] for w, v in model["workers"].items()},
               k1_consensus_by_worker=k1,
               fleet_dist={k: v for k, v in model["fleet"].items()
                           if k.startswith(("dist_", "kernel_"))},
               openmetrics_errors=export.validate_openmetrics(text))
    emit("fleet", **rec)
    if not rec["identical"]:
        fail("fleet: the autoscaled fleet's FASTA differs from the serial "
             "run's")
    if not (hb.get("done") and (hb.get("spawned_total") or 0) >= 3 and
            (hb.get("evicted_total") or 0) >= 1):
        fail(f"fleet: the heartbeat shows no replaced eviction: {hb}")
    if not ok_views:
        fail(f"fleet: /healthz never answered 200 with the fleet's view "
             f"({[s for s, _ in health]})")
    if rec["openmetrics_errors"]:
        fail(f"fleet: render_fleet is not valid OpenMetrics: "
             f"{rec['openmetrics_errors'][:5]}")
    for w in ("as0", "as2"):
        if w not in model["workers"] or f'worker="{w}"' not in text:
            fail(f"fleet: the fleet render lists no worker {w}")
    check_fleet_fold(model)
    if not polishers or any(k1[w] <= 0 for w in polishers):
        fail(f"fleet: a polishing worker launched no consensus K1 on the "
             f"card: {k1}")
    return {"paths": p, "argv": argv, "out": base, "serial_s": serial_s}


def check_fleet_fold(model):
    """The fleet aggregate folds the overlap aligner's counters by sum
    and the scheduler's telemetry by the last worker's value (workers in
    sorted order, obs/fleet.py), as the reference's merge kinds say."""
    from racon_tpu_torch.obs.metrics import SCHED_KEYS
    t0 = time.perf_counter()
    shards = [model["workers"][w]["metrics"] for w in sorted(
        model["workers"])]
    got, want = {}, {}
    for key in ("ovl_device_jobs", "ovl_native_jobs", "ovl_tiles_exec"):
        vals = [m[key] for m in shards if key in m]
        got[key], want[key] = model["fleet"].get(key), sum(vals)
    for key in SCHED_KEYS:
        vals = [m[key] for m in shards if m.get(key) is not None]
        got[key] = model["fleet"].get(key)
        want[key] = vals[-1] if vals else None
    TELEMETRY["fleet"] = dict(workers=len(shards), fleet=got)
    if got != want or not got["ovl_device_jobs"] or \
            got["sched_rounds"] is None:
        fail(f"fleet: the aggregate folds ovl_*/sched_* as {got}, not "
             f"{want}")
    TELEMETRY["check_s"] += time.perf_counter() - t0


def phase_fleet(device, tmp, serial):
    """Phase 11 (module docstring): the ledger fleet on the card."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    with CardMemory() as mem:
        r = _fleet_steal(device, tmp, serial)
        steal_peak = mem.take()
        torch.cuda.empty_cache()
        cut = _fleet_autoscale(device, tmp)
        autoscale_peak = mem.take()
    emit("fleet", part="total", seconds=time.perf_counter() - t0,
         card_memory_peak_b=mem.peak, card_memory_total_b=mem.total,
         steal_peak_b=steal_peak, autoscale_peak_b=autoscale_peak,
         smoke_reserved_at_start_b=reserved)
    return r, cut


# ---------------------------------------------------------- 12. gateway

#: The wrapper's chunk size in bases: two of the cut's 50 kb contigs a
#: chunk, so its 5 contigs make 3 chunks.
WRAPPER_SPLIT = 120000
#: The card's memory that the fleet job, with the smoke's own process,
#: must stay under (bytes).
GATEWAY_MEMORY_LIMIT = 80e9


def _worker_launches(ledger_dir):
    """Each fleet worker's kernel launches from its metric shard."""
    from racon_tpu_torch.obs import fleet
    model = fleet.aggregate(ledger_dir)
    return {w: {k[len("kernel_launches_"):]: n
                for k, n in v.get("metrics", {}).items()
                if k.startswith("kernel_launches_")}
            for w, v in model["workers"].items()}


def _gateway_server(device, tmp, cut):
    """Parts (a)-(c) of phase 12: one in-process PolishServer with the
    fleet gate armed."""
    from racon_tpu_torch.gateway.dispatch import fleet_paths
    from racon_tpu_torch.obs import metrics
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.server.daemon import PolishServer
    import torch
    server = PolishServer(os.path.join(tmp, "gateway"))
    server.session.activate()
    spec = _spec(cut["argv"], device)
    ld = fleet_paths(server.state_dir, spec.fingerprint()).ledger_dir
    recs = []
    try:
        with CardMemory() as mem:
            # (a) routed to the fleet: two worker processes on the card.
            t0 = time.perf_counter()
            metrics.reset()
            kernels.reset_launches()
            job = server.submit("acme", spec)
            job.finished.wait(300)
            own = {k: n for k, n in kernels.launches().items() if n}
            snap = metrics.registry().snapshot()
            workers = _worker_launches(ld)
            total = _sum_launches(workers.values())
            spawns = [e for e in _events(ld) if e.get("ev") == "spawn"]
            recs.append(dict(
                part="fleet", seconds=time.perf_counter() - t0,
                state=job.state, error=job.error,
                identical=job.result_bytes() == cut["out"],
                routed_fleet=snap.get("gate_routed_fleet"),
                routed_local=snap.get("gate_routed_local"),
                fleet_runs=snap.get("gate_fleet_runs"),
                fleet_wall_s=snap.get("gate_fleet_wall_s"),
                fleet_target=snap.get("gate_fleet_target"),
                spawns=len(spawns), worker_launches=workers,
                launches=total, daemon_launches=own,
                job_launches=job.launches,
                card_memory_peak_b=mem.take(),
                card_memory_total_b=mem.total))
            # (b) the same fingerprint again: the finished ledger replays
            # out.fasta; no spawn, no launch.
            t0 = time.perf_counter()
            kernels.reset_launches()
            again = server.submit("acme", spec)
            again.finished.wait(300)
            recs.append(dict(
                part="resubmit", seconds=time.perf_counter() - t0,
                state=again.state,
                identical=again.result_bytes() == cut["out"],
                spawns=sum(1 for e in _events(ld)
                           if e.get("ev") == "spawn"),
                launches={k: n for k, n in kernels.launches().items()
                          if n},
                fleet_runs=metrics.registry().get("gate_fleet_runs")))
            # (c) the size threshold raised: the same job routes local,
            # through this process's batcher.
            t0 = time.perf_counter()
            torch.cuda.empty_cache()
            kernels.reset_launches()
            with _environ(RACON_TPU_GATE_FLEET_MIN_TARGETS="99"):
                local = server.submit("umbrella", spec)
                local.finished.wait(300)
            recs.append(dict(
                part="local", seconds=time.perf_counter() - t0,
                state=local.state, error=local.error,
                identical=local.result_bytes() == cut["out"],
                routed_local=metrics.registry().get("gate_routed_local"),
                dispatches=sum(len(b.dispatches)
                               for b in server.batchers()),
                launches={k: n for k, n in kernels.launches().items()
                          if n},
                card_memory_peak_b=mem.take()))
    finally:
        server.drain(30.0)
    return recs, total


def _run_wrapper(argv, tmp, name):
    """One wrapper subprocess: its stdout, seconds and kernel launches
    (from its metric shard under RACON_TPU_OBS_DIR)."""
    from racon_tpu_torch.obs import fleet
    root = os.path.dirname(os.path.abspath(__file__))
    out_path, err_path, obs = (os.path.join(tmp, f"{name}{ext}")
                               for ext in (".out", ".err", "_obs"))
    t0 = time.perf_counter()
    with open(out_path, "wb") as out, open(err_path, "wb") as err:
        rc = subprocess.run(
            [sys.executable, "-m", "racon_tpu_torch.tools.wrapper", *argv],
            cwd=root, stdout=out, stderr=err, timeout=300,
            env=dict(os.environ, RACON_TPU_OBS_DIR=obs)).returncode
    seconds = time.perf_counter() - t0
    with open(out_path, "rb") as fh:
        blob = fh.read()
    if rc != 0:
        with open(err_path, "rb") as fh:
            fail(f"gateway: the wrapper exited {rc}: "
                 f"{fh.read().decode(errors='replace')[-2000:]}")
    shards = fleet.load_worker_shards(obs)
    if len(shards) != 1 or not shards[0]["records"][-1]["final"]:
        fail(f"gateway: the wrapper left {len(shards)} metric shards, or "
             f"no final snapshot, under {obs}")
    launches = {k[len("kernel_launches_"):]: n for k, n in
                shards[0]["records"][-1]["metrics"].items()
                if k.startswith("kernel_launches_")}
    return blob, seconds, launches


def _gateway_wrapper(device, tmp, cut):
    """Part (d) of phase 12: the wrapper as a subprocess on the card,
    then one chunk deleted and --resume."""
    p = cut["paths"]
    work = os.path.join(tmp, "wrapper_work")
    argv = [p["reads"], p["overlaps"], p["draft"], "--split",
            str(WRAPPER_SPLIT), "--work-directory", work, "--resume",
            "--device", device]
    out, first_s, first_launches = _run_wrapper(argv, tmp, "wrapper")
    chunks = sorted(n for n in os.listdir(work) if n.startswith("chunk_"))
    before = {n: os.stat(os.path.join(work, n)).st_ino for n in chunks}
    os.unlink(os.path.join(work, "chunk_1.fasta"))
    again, resume_s, resume_launches = _run_wrapper(argv, tmp, "wrapper2")
    after = {n: os.stat(os.path.join(work, n)).st_ino for n in chunks
             if os.path.exists(os.path.join(work, n))}
    rewritten = sorted(n for n in chunks if after.get(n) != before[n])
    return dict(part="wrapper", seconds=first_s + resume_s,
                first_s=first_s, resume_s=resume_s, chunks=chunks,
                identical=out == cut["out"],
                resume_identical=again == cut["out"],
                rewritten=rewritten, launches=first_launches,
                resume_launches=resume_launches)


def phase_gateway(device, tmp, cut):
    """Phase 12 (module docstring): the gateway's fleet route and the
    wrapper tools on the card, on phase 11's 5-contig cut."""
    import torch
    from racon_tpu_torch.pipeline import configure as configure_pipeline
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    configure_pipeline(0)
    try:
        with _environ(RACON_TPU_GATE_FLEET="1",
                      RACON_TPU_GATE_FLEET_MIN_TARGETS="2",
                      RACON_TPU_GATE_WORKERS="2", RACON_TPU_CACHE="0",
                      RACON_TPU_AUTOSCALE_INTERVAL_S="0.2",
                      RACON_TPU_OBS_FLUSH_S="0", RACON_TPU_FAULTS=None,
                      RACON_TPU_METRICS_PORT=None, RACON_TPU_SCHED=None,
                      PYTHONPATH=root + os.pathsep +
                      os.environ.get("PYTHONPATH", "")):
            recs, fleet_launches = _gateway_server(device, tmp, cut)
    finally:
        configure_pipeline(None)
    torch.cuda.empty_cache()
    recs.append(_gateway_wrapper(device, tmp, cut))
    for rec in recs:
        emit("gateway", **rec)
    fleet, resub, local, wrap = recs
    if fleet["state"] != "done" or not fleet["identical"]:
        fail(f"gateway: the fleet job ended {fleet['state']} "
             f"({fleet['error']}) or its stream differs from the serial "
             f"bytes")
    if (fleet["routed_fleet"], fleet["fleet_runs"], fleet["routed_local"]) \
            != (1, 1, None):
        fail(f"gateway: the fleet job was not routed to the fleet once: "
             f"{fleet}")
    m2 = fleet_launches.get("merge_windows", 0) + \
        fleet_launches.get("merge_windows_sched", 0)
    for k in ("band_fwd_consensus", "band_tile_fwd", "col_walk",
              "merge_votes"):
        if fleet_launches.get(k, 0) <= 0:
            fail(f"gateway: the fleet's workers launched no {k}: "
                 f"{fleet['worker_launches']}")
    if m2 <= 0:
        fail(f"gateway: the fleet's workers launched no M2: "
             f"{fleet['worker_launches']}")
    # W1 once a consensus round, as in phase 4: the shards' W1 cases
    # add up to W1's count and the consensus walks to K1's.
    walks = {c: fleet_launches.get(f"col_walk_{c}", 0)
             for c in ("tiled", "untiled", "flat", "consensus")}
    if sum(walks.values()) != fleet_launches.get("col_walk", 0) or \
            walks["consensus"] != fleet_launches.get("band_fwd_consensus",
                                                     0):
        fail(f"gateway: the workers' W1 cases {walks} do not add up to "
             f"W1's launches with one walk a consensus K1: "
             f"{fleet['worker_launches']}")
    if fleet["daemon_launches"] or fleet["job_launches"]:
        fail(f"gateway: the daemon's own process launched "
             f"{fleet['daemon_launches']} for the fleet job")
    if not fleet["card_memory_peak_b"] < GATEWAY_MEMORY_LIMIT:
        fail(f"gateway: the card's memory peaked at "
             f"{fleet['card_memory_peak_b']} B")
    if resub["state"] != "done" or not resub["identical"] or \
            resub["spawns"] != fleet["spawns"] or resub["launches"] or \
            resub["fleet_runs"] != 2:
        fail(f"gateway: the resubmitted fingerprint spawned or launched: "
             f"{resub}")
    if local["state"] != "done" or not local["identical"] or \
            local["routed_local"] != 1 or not local["dispatches"] or \
            local["launches"].get("band_fwd", 0) <= 0:
        fail(f"gateway: the local route failed or differs: {local}")
    if not wrap["identical"] or not wrap["resume_identical"] or \
            len(wrap["chunks"]) < 3 or \
            wrap["rewritten"] != ["chunk_1.fasta"]:
        fail(f"gateway: the wrapper's FASTA differs from the serial bytes "
             f"or --resume repolished more than the missing chunk: {wrap}")
    # Each wrapper run polished on the card: K1 and K3 launched in its
    # process, the resumed run's one chunk fewer consensus rounds.
    k1 = [r.get("band_fwd_consensus", 0)
          for r in (wrap["launches"], wrap["resume_launches"])]
    if min(k1) <= 0 or not k1[1] < k1[0] or \
            min(r.get("band_tile_fwd", 0) for r in
                (wrap["launches"], wrap["resume_launches"])) <= 0:
        fail(f"gateway: a wrapper run launched no consensus K1 or no K3 "
             f"on the card, or --resume as many as the first run: "
             f"{wrap['launches']} then {wrap['resume_launches']}")
    emit("gateway", part="total", seconds=time.perf_counter() - t0)
    return fleet_launches


# ---------------------------------------------------------- 13. mesh

#: The scores of the aligner checks.
SCORES = dict(match=5, mismatch=-4, gap=-8)
#: The kernels-line rows split by case (their runs' by-case counts).
CASE_ROWS = ("band_fwd", "col_walk", "monotone_count")


def row_launches(by_case, counts, name, k):
    """One kernels-line row's launches in a run: its by-case count where
    the run splits it (W1's flat layout as what is left after the other
    cases), None where the row is a case and the run does not split it
    (or K5's T1 shape, which no run launches: 0), else the kernel's whole
    count."""
    if (name, k) in by_case:
        return by_case[(name, k)]
    if (name, k) == ("monotone_count", "T1"):
        return 0
    if name in CASE_ROWS:
        if not any(n == name for n, _ in by_case):
            return None
        if k == "flat":
            return counts.get(name, 0) - sum(
                v for (n, _), v in by_case.items() if n == name)
    return counts.get(name, 0)


def check_mesh_launches(name, r, shards):
    """The launch rules of a run on a dp mesh of ``shards`` shards: M1 once
    a shard a consensus round (K1's consensus launches), and M2 once too
    in one of its forms (the base launch, the sched mode, or the emit
    half of a detecting round, which the sched mode's freeze half may
    follow); W1 once a consensus round beside the overlap walks."""
    n = r["launches"]
    k1 = r["k1_consensus"]
    m2 = n["merge_windows"] + n["merge_windows_emit"] + \
        n["merge_windows_sched"]
    if not (n["merge_votes"] == m2 == k1 and k1 > 0 and k1 % shards == 0):
        fail(f"{name}: merge_votes {n['merge_votes']}, M2 {m2}, consensus "
             f"K1 {k1} on {shards} shard(s)")
    if not n["merge_windows_freeze"] <= n["merge_windows_emit"]:
        fail(f"{name}: more freeze halves than emit halves ({n})")
    if r["walks"] != k1:
        fail(f"{name}: {r['walks']} consensus walks, not one a consensus "
             f"K1 ({k1})")


def _fasta_reads(fastq_path, out_path):
    """The FASTQ reads as FASTA (the qualities dropped)."""
    with open(fastq_path, "rb") as fh:
        lines = fh.read().split(b"\n")
    with open(out_path, "wb") as fh:
        for i in range(0, len(lines) - 3, 4):
            fh.write(b">" + lines[i][1:] + b"\n" + lines[i + 1] + b"\n")
    return out_path


def _mesh_polish(paths, reads, mesh):
    """The library polisher on ``mesh`` (None: unsharded) over the cut:
    (FASTA bytes, each window's consensus, launches, polish seconds)."""
    import torch
    from racon_tpu_torch.models.polisher import PolisherType, create_polisher
    from racon_tpu_torch.ops import kernels
    kernels.reset_launches()
    pol = create_polisher(reads, paths["overlaps"], paths["draft"],
                          PolisherType.kC, 500, 10.0, 0.3, 5, -4, -8,
                          device="cuda", threads=os.cpu_count() or 1,
                          mesh=mesh)
    pol.initialize()
    wins = list(pol.windows)
    t0 = time.perf_counter()
    recs = pol.polish()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    blob = b"".join(b">" + r.name.encode() + b"\n" + r.data + b"\n"
                    for r in recs)
    return blob, [w.consensus for w in wins], dict(kernels.LAUNCHES), secs


def _cut_ed(blob, truth_path):
    from racon_tpu_torch.utils.synth import edit_distance
    with open(truth_path, "rb") as fh:
        truth = fasta_records(fh.read())
    recs = fasta_records(blob)
    return sum(edit_distance(recs[c], t) for c, t in truth.items())


def phase_mesh(device, tmp, serial, cut):
    """Phase 13 (module docstring): the dp mesh on the card."""
    import torch
    from racon_tpu_torch.ops import kernels
    from racon_tpu_torch.ops.align import nw_align_batch
    from racon_tpu_torch.parallel import dispatch as par
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    by_case = {}
    # (a) --dp 1 through the CLI on phase 4's input.
    par.CHECK_REPLICAS = True
    try:
        r = main_run(device, serial["argv"] + ["--dp", "1"], True)
    finally:
        par.CHECK_REPLICAS = False
    rec = main_record(r, serial["ds"], serial["n_windows"])
    emit("mesh", part="dp1", seconds=r["wall"],
         identical=r["out"] == serial["out"],
         consensus_k1=r["k1_consensus"],
         phase4_consensus_k1=serial["rec"]["chunk_rounds"],
         consensus_s=rec["consensus_s"], launches=r["launches"],
         ed_draft=rec["ed_draft"], ed_polished=rec["ed_polished"],
         stage_ms=r["stages"], resilience=r["resilience"])
    if r["out"] != serial["out"]:
        fail("mesh: --dp 1's FASTA differs from phase 4's")
    if r["k1_consensus"] != serial["rec"]["chunk_rounds"]:
        fail(f"mesh: --dp 1 launched {r['k1_consensus']} consensus K1, "
             f"phase 4 {serial['rec']['chunk_rounds']}")
    if not rec["ed_polished"] * 3 <= rec["ed_draft"]:
        fail(f"mesh: --dp 1's polished ED {rec['ed_polished']} > draft ED "
             f"{rec['ed_draft']} / 3")
    check_mesh_launches("mesh --dp 1", r, 1)
    # One shard sees every lane: M2 runs fused, as without a mesh.
    m2 = ("merge_windows", "merge_windows_sched", "merge_windows_emit",
          "merge_windows_freeze")
    if any(r["launches"][k] != serial["launches"][k] for k in m2):
        fail(f"mesh: --dp 1's M2 launches "
             f"{ {k: r['launches'][k] for k in m2} } differ from phase 4's "
             f"{ {k: serial['launches'][k] for k in m2} }")
    check_clean("mesh --dp 1", r)
    by_case["dp1"] = (launches_by_case(r), r["launches"])
    # (b) the library polisher on a two-shard mesh over the card.
    p = cut["paths"]
    t0 = time.perf_counter()
    mesh2 = par.make_mesh(devices=["cuda:0", "cuda:0"])
    fasta = _fasta_reads(p["reads"], os.path.join(tmp, "cut_reads.fasta"))
    runs = {}
    par.CHECK_REPLICAS = True
    try:
        for kind, reads in (("fasta", fasta), ("fastq", p["reads"])):
            for name, mesh in (("one", None), ("two", mesh2)):
                runs[kind, name] = _mesh_polish(p, reads, mesh)
    finally:
        par.CHECK_REPLICAS = False
    same_w = sum(a == b for a, b in zip(runs["fastq", "one"][1],
                                         runs["fastq", "two"][1]))
    n_w = len(runs["fastq", "one"][1])
    eds = {k: _cut_ed(v[0], p["truth"]) for k, v in runs.items()}
    with open(p["draft"], "rb") as fh:
        drafts = fasta_records(fh.read())
    with open(p["truth"], "rb") as fh:
        from racon_tpu_torch.utils.synth import edit_distance
        ed_draft = sum(edit_distance(drafts[c], t) for c, t in
                       fasta_records(fh.read()).items())
    l2 = runs["fasta", "two"][2]
    emit("mesh", part="two_shards", seconds=time.perf_counter() - t0,
         fasta_identical=runs["fasta", "one"][0] == runs["fasta", "two"][0],
         fastq_windows_identical=same_w, windows=n_w,
         fastq_identical_share=same_w / max(n_w, 1),
         fastq_bytes_identical=runs["fastq", "one"][0] ==
         runs["fastq", "two"][0],
         polish_s={f"{k}_{n}": v[3] for (k, n), v in runs.items()},
         ed_draft=ed_draft, ed_polished={f"{k}_{n}": v for (k, n), v
                                         in eds.items()},
         launches={f"{k}_{n}": v[2] for (k, n), v in runs.items()})
    if runs["fasta", "one"][0] != runs["fasta", "two"][0]:
        fail("mesh: the two-shard run on FASTA reads differs from the "
             "unsharded run")
    if same_w < 0.9 * n_w:
        fail(f"mesh: only {same_w} of {n_w} windows identical on FASTQ "
             f"reads")
    for k, e in eds.items():
        if not e * 3 <= ed_draft:
            fail(f"mesh: {k} polished ED {e} > draft ED {ed_draft} / 3")
    one_k1 = runs["fasta", "one"][2]["merge_votes"]
    if not (l2["merge_votes"] == 2 * one_k1 and l2["merge_votes"] > 0 and
            l2["merge_windows_emit"] > 0 and
            l2["merge_windows_freeze"] > 0):
        fail(f"mesh: the two-shard run did not launch M1 once a shard a "
             f"round ({l2['merge_votes']} against {one_k1}) or no M2 half "
             f"({l2})")
    by_case["dp2"] = ({}, l2)
    # (c) --distributed as one NCCL rank on the cut: the CLI in a process
    # of its own, which prints its launches (and the overlap aligner's
    # groups, to split K1 and W1 by case) on its last stderr line.
    root, env = _subprocess_env(
        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
        WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    code = ("import json, sys\n"
            "from racon_tpu_torch import cli\n"
            "from racon_tpu_torch.ops import kernels, ovl_align\n"
            "rc = cli.main(sys.argv[1:])\n"
            "sys.stdout.flush()\n"
            "print(json.dumps(dict(launches=kernels.launches(),\n"
            "    tiled=ovl_align.tiled_groups(),\n"
            "    untiled=ovl_align.untiled_groups())), file=sys.stderr)\n"
            "sys.exit(rc)\n")
    t0 = time.perf_counter()
    dist = subprocess.run(
        [sys.executable, "-c", code, *cut["argv"], "--device", device,
         "--distributed"], cwd=root, env=env, capture_output=True,
        timeout=300)
    dist_s = time.perf_counter() - t0
    if dist.returncode != 0:
        fail(f"mesh: --distributed exited {dist.returncode}: "
             f"{dist.stderr.decode(errors='replace')[-2000:]}")
    got = json.loads(dist.stderr.decode().strip().splitlines()[-1])
    dist_l = got["launches"]
    untiled = got["untiled"]
    cons = dist_l.get("band_fwd", 0) - untiled
    emit("mesh", part="distributed", seconds=dist_s,
         identical=dist.stdout == cut["out"], launches=dist_l,
         consensus_k1=cons)
    if dist.stdout != cut["out"]:
        fail("mesh: --distributed's FASTA differs from the serial run's")
    if cons <= 0 or dist_l.get("merge_votes", 0) != cons:
        fail(f"mesh: --distributed launched no consensus kernel, or M1 "
             f"not once a consensus K1: {dist_l}")
    by_case["dist"] = ({
        ("band_fwd", 4): cons, ("band_fwd", "untiled"): untiled,
        ("col_walk", 0): got["tiled"], ("col_walk", "untiled"): untiled,
        ("col_walk", "consensus"): dist_l.get("col_walk", 0) -
        got["tiled"] - untiled - dist_l.get("flat_fwd", 0)}, dist_l)
    # (d) the sharded aligners on two shards of the card.
    rng = np.random.default_rng(31)
    B, L = 4096, 512
    truth = rng.integers(0, 4, (B, L)).astype(np.uint8)
    q = truth.copy()
    t = truth.copy()
    t[rng.random((B, L)) < 0.08] = 3
    lq = rng.integers(L - 64, L + 1, B).astype(np.int32)
    lt = rng.integers(L - 64, L + 1, B).astype(np.int32)
    dev = [torch.from_numpy(a).to(device) for a in (q, t, lq, lt)]
    ref = [x.cpu().numpy() for x in nw_align_batch(*dev, **SCORES)]
    mesh_sp = par.make_mesh(devices=["cuda:0", "cuda:0"], axes=("dp", "sp"),
                            shape=(1, 2))
    n0 = dict(kernels.LAUNCHES)
    dp_out, dp_ms = timed_once(lambda: par.nw_align_batch_sharded(
        mesh2, q, t, lq, lt, **SCORES))
    dp_launch = {k: kernels.LAUNCHES[k] - n0[k]
                 for k in ("nw_fwd", "nw_traceback")}
    sp_out, sp_ms = timed_once(lambda: par.sp_nw_align(
        mesh_sp, q, t, lq, lt, **SCORES))
    one_ms = time_ms(lambda: [x.cpu() for x in nw_align_batch(
        *[torch.from_numpy(a).to(device) for a in (q, t, lq, lt)],
        **SCORES)], reps=3)
    ok = all(np.array_equal(a, b) for a, b in zip(ref, dp_out)) and \
        all(np.array_equal(a, b) for a, b in zip(ref, sp_out))
    emit("mesh", part="aligners", shape=[B, L, L], bitwise=ok,
         dp_ms=dp_ms, sp_ms=sp_ms, one_ms=one_ms, dp_launches=dp_launch)
    if not ok:
        fail("mesh: a sharded aligner differs from nw_align_batch")
    if dp_launch != {"nw_fwd": 2, "nw_traceback": 2}:
        fail(f"mesh: nw_align_batch_sharded launched {dp_launch}, not K4 "
             f"and T1 once a shard")
    by_case["align"] = ({}, dp_launch)
    secs = time.perf_counter() - t_phase
    emit("mesh", part="total", seconds=secs)
    if secs > 120:
        fail(f"mesh: phase 13 took {secs:.1f} s (limit 120 s)")
    return by_case



def main() -> int:
    global CARD
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    try:
        from racon_tpu_torch.native.build import shared_library_path
        from racon_tpu_torch.ops import kernels
    except ImportError as exc:
        fail(f"racon_tpu_torch is not importable here ({exc})")
    CARD = card()
    t0 = time.perf_counter()
    kernels.build()
    shared_library_path()
    build_s = time.perf_counter() - t0
    emit("build", seconds=build_s, band_kernels=phase_build_occupancy())

    recs = phase_kernels("cuda")
    recs.update({(n, 0): r for n, r in phase_overlap_kernels("cuda").items()})
    recs.update(phase_untiled_overlap_kernels("cuda"))
    recs.update(phase_op_string_kernels("cuda"))
    with tempfile.TemporaryDirectory(
            dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        small = phase_small("cuda", tmp)
        main_launches, main_by_case, main_paths, serial = phase_main(
            "cuda", tmp)
        flat_launches = phase_flat("cuda", tmp)
        op_launches = phase_op_strings("cuda", main_paths)
        recs.update(phase_merge_kernels("cuda", main_paths))
        pipe_runs = phase_pipeline("cuda", serial)
        phase_faults("cuda", tmp, small, serial)
        phase_serve("cuda", tmp, small, serial)
        fleet_run, cut = phase_fleet("cuda", tmp, serial)
        gateway_launches = phase_gateway("cuda", tmp, cut)
        mesh_launches = phase_mesh("cuda", tmp, serial, cut)

    rows = []
    for (name, k), r in recs.items():
        if (name, k) == ("band_fwd", 2):
            continue
        # Each kernel's launches on the path that runs it: the band-off
        # path for K2 and the flat walk, the op-string route for K4 (each
        # variant its own count), T1 and K5 (at the merge's shape; the
        # T1 op-string shape is not one the route launches), the main
        # path for the rest; K1's and W1's by case.
        if k == "flat":
            launches = flat_launches["col_walk_flat"]
        elif name in ("merge_windows_emit", "merge_windows_freeze"):
            # The main path of this slice is the mesh: the halves'
            # launches in the two-shard run.
            launches = mesh_launches["dp2"][1][name]
        elif (name, k) in main_by_case:
            launches = main_by_case[(name, k)]
        elif (name, k) == ("monotone_count", "T1"):
            launches = 0
        else:
            launches = (flat_launches if name == "flat_fwd" else
                        op_launches if name in ("nw_fwd", "nw_fwd_wide",
                                                "nw_traceback",
                                                "monotone_count")
                        else main_launches)[name]
        label = {"flat": "flat layout", "untiled": "untiled overlap group",
                 "consensus": "consensus", 4: "consensus",
                 0: "tiled overlap group", "merge": "route merge shape",
                 "T1": "T1 op strings"}
        # The same row's launches in phase 8's streamed runs (scheduler,
        # RACON_TPU_SCHED=0) and phase 11's worker B: by case where the
        # row is a case, W1's flat
        # layout as what is left of that run's col_walk count after its
        # other cases, else the kernel's whole count in that run (K5's
        # two shape rows share it: the counter does not split by shape).
        pipe = [by_case[(name, k)] if (name, k) in by_case else
                counts[name] - sum(v for (n, _), v in by_case.items()
                                   if n == name) if k == "flat" else
                counts[name]
                for by_case, counts in pipe_runs +
                [(launches_by_case(fleet_run), fleet_run["launches"])]]
        # Phase 12's fleet workers, from their metric shards, which
        # split K1 into consensus and overlap launches and W1 into its
        # four cases; K5's T1 row is 0, as in the main path's column.
        cons = gateway_launches.get("band_fwd_consensus", 0)
        gateway = (cons if (name, k) == ("band_fwd", 4) else
                   gateway_launches.get(name, 0) - cons
                   if name == "band_fwd" else
                   gateway_launches.get(
                       f"col_walk_{'tiled' if k == 0 else k}", 0)
                   if name == "col_walk" else
                   0 if (name, k) == ("monotone_count", "T1") else
                   gateway_launches.get(name, 0))
        # Phase 13's runs on a dp mesh: --dp 1 by case, the two-shard
        # library run and the --distributed rank by kernel, and the
        # sharded aligners' K4 and T1.
        dp = {f"dp_{run}_launches": row_launches(*mesh_launches[run],
                                                 name, k)
              for run in ("dp1", "dp2", "dist", "align")}
        rows.append({
            "name": (f"{name} ({label[k]})"
                     if name in ("col_walk", "band_fwd", "monotone_count")
                     else name),
            "route": "cuda",
            "source": f"racon_tpu_torch/csrc/{SOURCE[name]}",
            "replaces": REPLACES[name], "launches": launches,
            "pipeline_launches": pipe[0], "pipeline_fixed_launches": pipe[1],
            "fleet_launches": pipe[2], "gateway_launches": gateway, **dp,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            **{n: r[n] for n in ("shape", "bucket_ms", "chunks_ms", "G",
                                 "chain_floor_ms", "serial_floor_ms",
                                 "windows_per_lane", "misses_per_lane",
                                 "wide_ms", "eager_ms", "eager_library_ms",
                                 "sector_bound_ms", "bytes_bound_ms",
                                 "C", "regs", "spills", "blocks_per_sm",
                                 "smem_per_block", "shapes", "threads",
                                 "smem", "bytes", "tiles", "gaps", "waves",
                                 "variant", "wide", "last_ms",
                                 "base_mode_ms", "freeze_mix")
               if n in r}})
    print(json.dumps({"telemetry": TELEMETRY}))
    print(json.dumps({"kernels": rows}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


CARD = ""

if __name__ == "__main__":
    sys.exit(main())
