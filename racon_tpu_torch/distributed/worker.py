"""The distributed worker loop: claim → polish → split → complete → merge
(port of the JAX package's ``distributed/worker.py``).

One ``python -m racon_tpu_torch.cli --ledger-dir`` invocation is one
worker. Workers share nothing but the ledger directory; each runs the
service core's polish loop (server/engine.py::polish_job) on its device
— the card unless ``--device cpu`` — restricted to its claimed shard's
target range, committing every finished contig into that shard's
checkpoint store before renewing the lease. A device error ends the
worker (the CLI exits 1, or 75 on a terminal watchdog breach); the
fleet recovers through the ledger, never through the host path.
Eviction at any instruction is recoverable:

- mid-contig: the store's committed prefix survives; the thief resumes
  it (``CheckpointStore.resume`` + ``skip_targets``) and recomputes
  only the in-flight contig;
- mid-commit: crash-consistency ordering (shard bytes fsync'd before
  the manifest record, torn manifest tails dropped on resume) means
  the thief sees either the whole contig or none of it;
- mid-merge: the merge is a lease-fenced pseudo-shard writing through
  tmp+rename — a dead merger's thief redoes the cheap read-only pass.

Dynamic splitting: a worker
holding a long-running shard while the rest of the fleet is starved —
idle live workers and nothing claimable — carves the uncommitted tail
past its in-flight contig into a child shard any idle worker claims at
its next poll. The trigger is evaluated when a shard is (re)claimed
(BEFORE the polisher is built, so the donated range's consensus is
never computed here at all) and again after every commit (frees the
tail mid-shard in pipeline mode). ``RACON_TPU_SPLIT=0`` disables;
``RACON_TPU_SPLIT_AFTER_S`` sets how long a shard must have been held
first (default: one lease term; 0 splits at the first starved poll).

Fault sites: ``dist/shard`` fires once per claimed shard (before any
polishing), ``dist/contig`` once per retired contig (before its
commit), ``dist/claim`` per claim attempt, ``dist/split`` inside the
split publication, ``dist/merge`` before the merge pass (and
``dist/merge_write`` per merged contig) — so eviction drills can target
any phase deterministically.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional

from racon_tpu_torch.distributed import ledger as dledger
from racon_tpu_torch.distributed.ledger import Claim, LeaseLost, WorkLedger
from racon_tpu_torch.obs import fleet
from racon_tpu_torch.obs import metrics as obs_metrics
from racon_tpu_torch.obs.metrics import record_dist, set_dist
from racon_tpu_torch.obs.trace import get_tracer
from racon_tpu_torch.resilience import checkpoint as ckpt
from racon_tpu_torch.resilience.faults import maybe_fault
from racon_tpu_torch.server.engine import JobHooks, polish_job
from racon_tpu_torch.utils import env

ENV_POLL = env.DIST_POLL
ENV_AVOID = env.DIST_AVOID
ENV_SPLIT_AFTER = env.SPLIT_AFTER_S


def default_worker_id() -> str:
    import socket
    return f"{socket.gethostname()}-{os.getpid()}"


def _poll_interval(lease_s: float) -> float:
    raw = env.read(ENV_POLL)
    if raw:
        return max(0.01, float(raw))
    # Often enough to steal promptly after expiry, rare enough that an
    # idle fleet doesn't hammer the shared filesystem.
    return min(1.0, max(0.05, lease_s / 10.0))


def _avoid_shards() -> list:
    """Shard names this worker should claim LAST (never excluded) —
    seeded by the autoscaler when replacing a self-evicted worker, so
    the replacement doesn't immediately re-claim the assignment that
    wedged its predecessor."""
    raw = env.read(ENV_AVOID)
    return [s for s in (p.strip() for p in raw.split(",")) if s]


def _split_after_s(lease_s: float) -> float:
    raw = env.read(ENV_SPLIT_AFTER).strip()
    if raw:
        try:
            return max(0.0, float(raw))
        except ValueError:
            pass
    # One lease term of evidence that the shard is long before
    # fragmenting it; a floor keeps tiny test leases from splitting
    # every run.
    return max(5.0, lease_s)


def _live_workers(ledger_dir: str) -> int:
    """Workers whose latest metric snapshot is not final — the best
    coordinator-free liveness proxy. A kill -9 victim counts as live
    until its lease expires and a steal resolves it, which at worst
    delays a split by one trigger evaluation."""
    try:
        shards = fleet.load_worker_shards(fleet.obs_dir_for(ledger_dir))
    except OSError:
        return 0
    return sum(1 for sh in shards
               if sh["records"] and not sh["records"][-1].get("final"))


def record_kernel_launches(reg: Optional[obs_metrics.Registry] = None
                           ) -> None:
    """This process's CUDA kernel launches (ops/kernels.LAUNCHES) as the
    counters ``kernel_launches_<name>``, the consensus band forward's
    (K1's launches less the overlap aligner's untiled groups) as
    ``kernel_launches_band_fwd_consensus``, and the walk's (W1's) by
    case as ``kernel_launches_col_walk_{tiled,untiled,flat,consensus}``:
    one walk an overlap group of either route, one in the flat layout
    after each full-width forward (K2), and the consensus engine's
    band-layout walks as what is left. A worker publishes them before
    each metric flush, so its shard shows that it ran its shards
    through the kernels on the card; on the CPU nothing launches and
    nothing is recorded."""
    from racon_tpu_torch.ops import kernels, ovl_align
    reg = reg if reg is not None else obs_metrics.registry()
    launches = kernels.launches()
    untiled = ovl_align.untiled_groups()
    tiled = ovl_align.tiled_groups()

    def _mutate(v):
        for name, n in launches.items():
            if n:
                v[f"kernel_launches_{name}"] = int(n)
        if launches.get("band_fwd"):
            v["kernel_launches_band_fwd_consensus"] = \
                int(launches["band_fwd"]) - int(untiled)
        if launches.get("col_walk"):
            flat = int(launches.get("flat_fwd", 0))
            for case, n in (("tiled", tiled), ("untiled", untiled),
                            ("flat", flat),
                            ("consensus", launches["col_walk"] - tiled -
                             untiled - flat)):
                v[f"kernel_launches_col_walk_{case}"] = int(n)

    reg.apply(_mutate)


def _maybe_split(ledger: WorkLedger, claim: Claim, next_tid: int,
                 t_shard: float, log) -> bool:
    """Evaluate the split trigger and, when the fleet is starved, carve
    ``[next_tid + 1, end)`` off the held shard (keep the in-flight
    contig, donate everything behind it). Returns True when a child
    was published; ``claim.info.end`` has shrunk then. Raises
    LeaseLost if the lease was stolen inside the split protocol — the
    caller's abandon path handles it like any other steal."""
    info = claim.info
    if info is None or not dledger.split_enabled():
        return False
    if dledger.split_depth(info.name) >= dledger.max_split_depth():
        return False  # re-splitting children cascades into handoff thrash
    if info.end - next_tid < 2:
        return False  # nothing to donate beyond the in-flight contig
    if time.monotonic() - t_shard < _split_after_s(ledger.lease_s):
        return False
    stats = ledger.open_shard_stats()
    if stats["claimable"] > 0:
        return False  # idle workers already have work to take
    if _live_workers(ledger.directory) <= stats["leased"]:
        return False  # nobody is idle — a split would only fragment
    child = ledger.split(claim, next_tid + 1)
    if child is None:
        return False
    print(f"[racon_tpu_torch::dist] worker {claim.worker}: split "
          f"{info.name} at {next_tid + 1} — child {child.name} "
          f"[{child.start}, {child.end}) now stealable", file=log)
    return True


def _open_store(ledger: WorkLedger, shard,
                seg_targets: int = 0) -> ckpt.CheckpointStore:
    d = ledger.shard_ckpt_dir(shard)
    fp = ledger.shard_fp(shard)
    if os.path.exists(os.path.join(d, ckpt.META_NAME)):
        # Resume reads the manifest flavor from its own header — the
        # seg_targets this worker was launched with never rewrites an
        # existing store's mode.
        return ckpt.CheckpointStore.resume(d, fp)
    return ckpt.CheckpointStore.create(d, fp,
                                       segment_targets=seg_targets)


def _shard_cache():
    """The fleet-shared shard CAS (cache/), or None when unarmed. Point
    ``RACON_TPU_CACHE_DIR`` at one directory and every worker of every
    run shares one Tier-1 store keyed by shard fingerprint — a
    resubmitted run replays its shards without polishing a window.
    Plain ledger runs leave it unset; ``RACON_TPU_CACHE=0`` turns it off
    here too."""
    from racon_tpu_torch.cache import ENV_CACHE_DIR, cache_enabled
    cache_dir = env.read(ENV_CACHE_DIR).strip()
    if not cache_dir or not cache_enabled():
        return None
    from racon_tpu_torch.cache import ResultCache
    try:
        return ResultCache(cache_dir)
    except Exception as exc:
        print(f"[racon_tpu_torch::dist] shard cache disabled ({exc})",
              file=sys.stderr)
        return None


def _polish_shard(ledger: WorkLedger, claim: Claim,
                  make_polisher: Callable, drop_unpolished: bool, log,
                  t_shard: float, seg_targets: int = 0) -> int:
    """Polish one claimed shard to completion; returns the number of
    committed targets in the shard's final effective range. Raises
    LeaseLost the moment the lease is observed stolen.

    The loop itself is the service core's ``polish_job``
    (server/engine.py) — this frontend contributes only the
    ledger-specific hooks: lease renewal per contig, the ``dist/*``
    fault drills, dist accounting, and the dynamic split protocol
    (``claim.info.end`` shrinks mid-run when a starved fleet steals
    the uncommitted tail, which the hooks surface as the loop's live
    range end).
    """
    info = claim.info
    store = _open_store(ledger, info, seg_targets)
    cache = _shard_cache()
    try:
        start = info.start
        if cache is not None and not store.committed:
            # Fleet-shared Tier-1 probe: a verified hit replays the
            # whole shard's committed records into this store — the
            # polish loop below then sees a fully-resumed shard and
            # computes nothing. Probes only on a fresh store: a
            # partially-committed (stolen) shard already resumes from
            # its own prefix.
            hit = cache.load(ledger.shard_fp(info))
            if hit is not None:
                from racon_tpu_torch.cache import replay_records
                replay_records(hit, store=store)
                record_dist("contigs_replayed", claim.shard,
                            claim.worker, value=len(store.committed))
                print(f"[racon_tpu_torch::dist] worker {claim.worker}: "
                      f"shard {info.name} replayed from the shared "
                      f"cache ({len(store.committed)} contig(s))",
                      file=log)
        if store.committed:
            # A stolen (or re-claimed) shard: everything the victim
            # committed re-emits from its store, zero recompute.
            record_dist("contigs_resumed", claim.shard, claim.worker,
                        value=len(store.committed))
            print(f"[racon_tpu_torch::dist] worker {claim.worker}: shard "
                  f"{info.name} resumes {len(store.committed)}/"
                  f"{info.end - start} committed contig(s) from "
                  "previous holder", file=log)

        def _before_build(first_tid: int) -> None:
            # Claim-time trigger: splitting BEFORE the polisher is
            # built means the donated range's windows are never
            # constructed here — in serial engine mode all consensus
            # compute runs up-front, so this is the evaluation that
            # actually shortens the tail.
            _maybe_split(ledger, claim, first_tid, t_shard, log)

        def _before_commit(tid: int, rec) -> None:
            maybe_fault("dist/contig")
            ledger.renew(claim)
            # Per-contig cadence: cheap (interval-gated) and tied to
            # the same heartbeat the lease renewal proves, so a live
            # worker's metric shard is never staler than its lease. The
            # shard's consensus launched before its first commit, so the
            # snapshot carries this worker's kernel launches.
            record_kernel_launches()
            fleet.maybe_flush()

        def _after_commit(tid: int, rec) -> None:
            record_dist("contigs_polished", claim.shard, claim.worker,
                        tid=tid)
            if claim.stolen:
                record_dist("contigs_repolished", claim.shard,
                            claim.worker, tid=tid)
            if tid + 1 < claim.info.end:
                _maybe_split(ledger, claim, tid + 1, t_shard, log)

        n = polish_job(
            make_polisher, drop_unpolished=drop_unpolished,
            store=store, tid_range=(start, info.end), fill_drops=True,
            hooks=JobHooks(
                range_end=lambda default: claim.info.end,
                before_build=_before_build,
                before_commit=_before_commit,
                after_commit=_after_commit,
                before_fill=lambda tid: ledger.renew(claim)))
        if cache is not None:
            # Publish the finished shard for the next run of this
            # fingerprint; cache trouble never fails a polished shard.
            from racon_tpu_torch.cache import records_from_store
            try:
                cache.store(ledger.shard_fp(info),
                            records_from_store(store))
            except OSError:
                pass
        return n
    finally:
        store.close()


def _merge_phase(ledger: WorkLedger, worker: str, out, log,
                 poll: float) -> Optional[int]:
    """Every worker races for the merge pseudo-shard; exactly one wins
    and emits the merged FASTA. Losers wait for the done marker so the
    process exit means the run's output exists. Returns None — back to
    the shard loop — when a shard turns out to be pending after all: a
    split child published inside the parent's completion race window
    lands as new work, and the merge must wait for it."""
    import shutil
    while True:
        if ledger.merge_done():
            print(f"[racon_tpu_torch::dist] worker {worker}: merged output "
                  f"already published by another worker "
                  f"({ledger.out_path})", file=log)
            return 0
        claim = ledger.claim_merge(worker)
        if claim is None:
            if not ledger.shards_done():
                return None  # late split child — resume polishing
            time.sleep(poll)
            continue
        if not ledger.shards_done():
            ledger.release(claim)
            return None
        maybe_fault("dist/merge")
        try:
            nbytes, emitted = ledger.merge()
            ledger.complete(claim, n_bytes=nbytes,
                            contigs_emitted=emitted)
        except LeaseLost:
            print(f"[racon_tpu_torch::dist] worker {worker}: lost the merge "
                  "lease mid-pass — retrying against the thief's "
                  "result", file=log)
            continue
        record_dist("merges", -1, worker, bytes=nbytes)
        with open(ledger.out_path, "rb") as fh:
            shutil.copyfileobj(fh, out)
        out.flush()
        print(f"[racon_tpu_torch::dist] worker {worker}: merged "
              f"{emitted} contig(s), {nbytes} bytes, from "
              f"{len(ledger.all_shards())} shard(s)", file=log)
        return 0


def run_worker(*, ledger_dir: str, fingerprint: str,
               worker_id: Optional[str], workers: int, lease_s: float,
               make_polisher: Callable, drop_unpolished: bool,
               n_targets: Optional[int] = None, scan_targets=None,
               fragment_correction: bool = False,
               seg_targets: Optional[int] = None,
               window_length: int = 500,
               out=None, log=None) -> int:
    """Drive one worker from fleet join to merged output.

    ``make_polisher`` builds a fresh (uninitialized) Polisher — one per
    claimed shard, since windows are pruned destructively. Returns a
    process exit code; crashes (injected or real) propagate so the
    process dies exactly as a preempted worker would.

    Pass ``scan_targets`` (io.parsers.scan_sequence_index, deferred)
    instead of an eager ``n_targets`` so only the meta-publishing
    worker pays the target-file pass — every later joiner adopts the
    published count (WorkLedger.open docstring).

    Ingest: workers ride the same RACON_TPU_INGEST data plane as the
    serial CLI — ``scan_targets`` routes to the mmap structural scan
    and every per-shard Polisher's initialize() uses the parallel
    inflate / index-first readers. The gauge below puts the gate state
    in every fleet metric shard.

    Ava: ``fragment_correction`` selects the v2
    segmented checkpoint manifest for fresh shard stores
    (``seg_targets`` overrides the ``ava.seg_targets_for`` default)
    and, when the ledger published per-target offsets, runs the shape
    planner once at join time — publishing the run's bucket plan
    against ``RACON_TPU_AVA_COMPILE_BUDGET`` before any shard is
    claimed.
    """
    out = out if out is not None else sys.stdout.buffer
    log = log if log is not None else sys.stderr
    worker = worker_id or default_worker_id()
    ledger = WorkLedger.open(ledger_dir, fingerprint,
                             n_targets=n_targets, workers=workers,
                             lease_s=lease_s, scan_targets=scan_targets,
                             weighted=bool(fragment_correction))
    from racon_tpu_torch.io.ingest import ingest_enabled
    from racon_tpu_torch.obs.metrics import registry as _registry
    _registry().set("ingest_enabled", int(ingest_enabled()))
    set_dist("workers", int(workers))
    set_dist("shards", ledger.n_shards)
    set_dist("n_targets", ledger.n_targets)
    from racon_tpu_torch.ava import seg_targets_for
    if seg_targets is None:
        seg_targets = seg_targets_for(fragment_correction)
    if fragment_correction and ledger.target_offsets:
        # Shape-bucket plan for the whole run, from the published
        # offsets (no file I/O): every worker computes the identical
        # plan, so the published gauges agree fleet-wide.
        from racon_tpu_torch.ava.planner import (lengths_from_offsets,
                                                 plan_buckets)
        from racon_tpu_torch.obs.metrics import record_ava_plan
        plan = plan_buckets(lengths_from_offsets(ledger.target_offsets),
                            window_length=window_length)
        record_ava_plan(plan)
        print(f"[racon_tpu_torch::ava] worker: {plan.n_targets} target(s) "
              f"in {plan.n_buckets} shape bucket(s) "
              f"(quantum {plan.quantum}, "
              f"{len(plan.compile_keys)} geometry key(s) vs budget "
              f"{plan.budget}, pad {plan.pad_frac:.2%})", file=log)
    # Fleet observability plane (obs/fleet.py): publish this
    # worker's metric shard at join time, tag every span with the
    # worker identity, and keep the shard fresh per contig. The CLI's
    # teardown paths call fleet.flush_final() so SIGTERM evictions
    # leave a final snapshot.
    fleet.install_writer(os.path.join(ledger_dir, fleet.OBS_SUBDIR),
                         worker, fingerprint)
    get_tracer().set_context(worker_id=worker, run_fp=fingerprint)
    # Trace adoption: RACON_TPU_TRACE_CTX first (set by the spawning
    # autoscaler/smoke), else the context the meta publisher stamped
    # into the ledger — so every worker span joins the submitting
    # process's trace without any live channel between them. Malformed
    # or absent contexts degrade to a fresh root trace, never an error.
    from racon_tpu_torch.obs.trace import adopt_trace_context
    if adopt_trace_context() is None:
        meta_ctx = str(ledger.meta.get("trace_ctx", ""))
        if meta_ctx:
            adopt_trace_context(meta_ctx)
    poll = _poll_interval(ledger.lease_s)
    avoid = _avoid_shards()
    print(f"[racon_tpu_torch::dist] worker {worker}: joined ledger "
          f"{ledger_dir} ({ledger.n_targets} target(s) in "
          f"{ledger.n_shards} shard(s), lease {ledger.lease_s:g}s)",
          file=log)

    while True:
        while not ledger.shards_done():
            claim = ledger.claim_shard(worker, avoid=avoid)
            if claim is None:
                # Everything is live-leased elsewhere: wait for a
                # completion, an expiry to steal, or a split child.
                time.sleep(poll)
                continue
            maybe_fault("dist/shard")
            get_tracer().set_context(shard=claim.shard)
            t0 = time.perf_counter()
            try:
                n = _polish_shard(ledger, claim, make_polisher,
                                  drop_unpolished, log,
                                  time.monotonic(), seg_targets)
                ledger.complete(claim, n_committed=n)
            except LeaseLost:
                # The shard was stolen while we held it (our own lease
                # expired — e.g. a long pause). The thief owns the work
                # now; our commits so far are still valid prefix for it.
                print(f"[racon_tpu_torch::dist] worker {worker}: abandoning "
                      f"shard {claim.name} — lease stolen while "
                      "working", file=log)
                continue
            except BaseException as exc:  # noqa: BLE001 — terminal check only
                if getattr(exc, "signum", None) is not None:
                    # Supervisor-driven retirement (SIGTERM routed
                    # through the CLI's signal handler): hand the lease
                    # back explicitly so the shard is claimable at the
                    # fleet's next poll, then let the signal path finish
                    # teardown (final snapshot, exit 128+signum).
                    ledger.release(claim)
                    record_dist("retires", claim.shard, worker)
                    print(f"[racon_tpu_torch::dist] worker {worker}: retiring"
                          f" from shard {claim.name} on signal "
                          f"{exc.signum} (lease released)", file=log)
                    raise
                # Fail-slow self-eviction: this host has crossed its
                # terminal watchdog breach budget, so it hands the shard
                # back EXPLICITLY (lease release — thieves claim it at
                # the next poll instead of waiting out the lease term)
                # and exits with a distinct code. Committed prefix work
                # survives in the shard store; the successor resumes it
                # byte-identically. Every other exception propagates so
                # the process dies exactly as a preempted worker would.
                from racon_tpu_torch.resilience.watchdog import (
                    EXIT_SELF_EVICT, is_terminal)
                if not is_terminal(exc):
                    raise
                ledger.release(claim)
                record_dist("self_evictions", claim.shard, worker)
                print(f"[racon_tpu_torch::dist] worker {worker}: "
                      f"self-evicting from shard {claim.shard} — {exc} "
                      f"(lease released; exit {EXIT_SELF_EVICT})",
                      file=log)
                # The CLI tail handles fleet.flush_final() +
                # tracer.finish on this return value, so the eviction
                # leaves a final obs snapshot like any clean exit.
                return EXIT_SELF_EVICT
            finally:
                get_tracer().set_context(shard=None)
                record_kernel_launches()
                fleet.maybe_flush()
            record_dist("shards_completed", claim.shard, worker)
            if claim.stolen:
                record_dist("recovery_wall_s", claim.shard, worker,
                            value=time.perf_counter() - t0)
            print(f"[racon_tpu_torch::dist] worker {worker}: shard "
                  f"{claim.name} complete ({n} target(s))"
                  f"{' [stolen]' if claim.stolen else ''}", file=log)

        rc = _merge_phase(ledger, worker, out, log, poll)
        if rc is not None:
            return rc
