"""Command-line interface of the PyTorch/CUDA port, mirroring the
reference ``racon`` CLI (src/main.cpp:14-160): polished sequences go to
stdout as FASTA, diagnostics to stderr.

    python -m racon_tpu_torch.cli [options] <sequences> <overlaps> <target>

The consensus engine runs on the GPU (``--device cuda``, the default) or,
when asked, on the CPU (``--device cpu``). Without a usable GPU and
without ``--device cpu`` the command fails; it never carries on quietly
on the CPU.

``--trace PATH`` (or ``RACON_TPU_TRACE``) writes the JSONL run trace
(obs/trace.py), ending with a snapshot of the counters. A chunk whose
transfer or dispatch exhausts its retries is polished on the host path;
any other device error ends the run with exit code 1, and a terminal
watchdog breach with exit code 75.

The run goes through the service core's one polish loop
(server/engine.py::polish_job). ``--checkpoint-dir DIR`` commits each
polished contig durably into DIR (the JAX package's store format,
resilience/checkpoint.py); ``--resume`` continues a killed run from DIR,
re-emitting committed contigs byte for byte from the store and polishing
only the rest — a store either package's CLI wrote resumes under the
other's. ``--cache-dir DIR`` arms the job-level result cache (cache/): a
run whose inputs and options fingerprint matches a stored entry
re-emits it with no kernel launch.

``--ledger-dir DIR`` makes the process one worker of a ledger fleet
(distributed/): it claims shards of the targets under leases, polishes
them on its device into per-shard checkpoint stores, steals shards
whose lease expired, and the worker that wins the merge writes the
FASTA — the serial run's bytes. ``--autoscale`` instead supervises such
a fleet (distributed/autoscaler.py): it spawns workers running this
command, builds no polisher and never touches the GPU, and prints the
merged FASTA. ``RACON_TPU_METRICS_PORT`` serves the registry as
OpenMetrics and ``/healthz`` (a ledger member answers with the fleet's
view); ``RACON_TPU_OBS_DIR`` gives a serial run a fleet metric shard.

SIGINT and SIGTERM end a run in order: the store closes (its commits are
durable), a ledger worker releases its lease, the final metric snapshot
and the trace are written, and the exit code is 128 + the signal.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from racon_tpu_torch import __version__

_USAGE = ("racon_tpu_torch [options ...] <sequences> <overlaps> "
          "<target sequences>")


class _Interrupted(Exception):
    """SIGINT or SIGTERM raised as an exception, so teardown runs in
    order (the pipeline's generators close, the store closes, a ledger
    worker releases its lease, the final snapshot and the trace are
    written) and the exit code is 128 + the signal, not a traceback."""

    def __init__(self, signum: int):
        super().__init__(f"signal {signum}")
        self.signum = signum

_DESCRIPTION = """\
    <sequences>
        input file in FASTA/FASTQ format (can be compressed with gzip)
        containing sequences used for correction
    <overlaps>
        input file in MHAP/PAF/SAM format (can be compressed with gzip)
        containing overlaps between sequences and target sequences
    <target sequences>
        input file in FASTA/FASTQ format (can be compressed with gzip)
        containing sequences which will be corrected
"""


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="racon_tpu_torch", usage=_USAGE, description=_DESCRIPTION,
        formatter_class=argparse.RawDescriptionHelpFormatter, add_help=False)
    ap.add_argument("paths", nargs="*", metavar="<file>")
    ap.add_argument("-u", "--include-unpolished", action="store_true",
                    help="output unpolished target sequences")
    ap.add_argument("-f", "--fragment-correction", action="store_true",
                    help="perform fragment correction instead of contig "
                         "polishing (overlaps file should contain dual/self "
                         "overlaps!)")
    ap.add_argument("-w", "--window-length", type=int, default=500,
                    help="default: 500; size of window on which POA is "
                         "performed")
    ap.add_argument("-q", "--quality-threshold", type=float, default=10.0,
                    help="default: 10.0; threshold for average base quality "
                         "of windows used in POA")
    ap.add_argument("-e", "--error-threshold", type=float, default=0.3,
                    help="default: 0.3; maximum allowed error rate used for "
                         "filtering overlaps")
    ap.add_argument("-m", "--match", type=int, default=5,
                    help="default: 5; score for matching bases")
    ap.add_argument("-x", "--mismatch", type=int, default=-4,
                    help="default: -4; score for mismatching bases")
    ap.add_argument("-g", "--gap", type=int, default=-8,
                    help="default: -8; gap penalty (must be negative)")
    ap.add_argument("-t", "--threads", type=int, default=1,
                    help="default: 1; OS threads for the native host "
                         "aligner (<=0 uses all cores)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="default: cuda; where the consensus engine runs")
    ap.add_argument("--pipeline-depth", type=int, default=None,
                    metavar="N",
                    help="default: unset (RACON_TPU_PIPELINE decides); "
                         "N>0 runs the consensus through the streaming "
                         "pipeline with N chunks in flight a stage (2 = "
                         "double buffering), 0 forces the serial path")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a structured JSONL run trace to PATH "
                         "(same as RACON_TPU_TRACE=PATH)")
    ap.add_argument("--checkpoint-dir", metavar="DIR", default=None,
                    help="checkpoint each polished contig into DIR "
                         "(FASTA shard + manifest, fsync'd per commit) "
                         "so a killed run can continue with --resume")
    ap.add_argument("--resume", action="store_true",
                    help="continue from --checkpoint-dir: committed "
                         "contigs re-emit byte-identically from the "
                         "shard, only the rest recompute; refuses if "
                         "inputs or output-affecting options changed")
    ap.add_argument("--cache-dir", metavar="DIR", default=None,
                    help="arm the content-addressed result cache in "
                         "DIR: a run whose inputs + options fingerprint "
                         "matches a stored entry re-emits it "
                         "byte-identically with zero consensus "
                         "dispatches (verify-on-hit; RACON_TPU_CACHE=0 "
                         "disables)")
    ap.add_argument("--ledger-dir", metavar="DIR", default=None,
                    help="join (or start) the contig work ledger in "
                         "DIR as one worker of a preemptible fleet: "
                         "targets are sharded, leased, checkpointed "
                         "per shard, and stolen from evicted workers; "
                         "exactly one worker emits the merged FASTA")
    ap.add_argument("--workers", type=int, default=1, metavar="N",
                    help="default: 1; fleet size hint for the ledger's "
                         "shard partition (~2 shards per worker); only "
                         "the first worker to publish the ledger "
                         "decides")
    ap.add_argument("--worker-id", metavar="ID", default=None,
                    help="default: <hostname>-<pid>; stable identity "
                         "for lease ownership and the events audit "
                         "log")
    ap.add_argument("--lease-s", type=float, default=30.0, metavar="S",
                    help="default: 30.0; shard lease duration — an "
                         "evicted worker's shard becomes stealable S "
                         "seconds after its last renewal (each "
                         "committed contig renews)")
    ap.add_argument("--autoscale", action="store_true",
                    help="supervise an elastic fleet against "
                         "--ledger-dir instead of polishing: spawn "
                         "worker subprocesses (this same command minus "
                         "--autoscale) up to --workers, replace sick "
                         "ones, retire surplus, and emit the merged "
                         "FASTA on stdout (RACON_TPU_AUTOSCALE_* "
                         "tunes the policy)")
    ap.add_argument("--version", action="store_true",
                    help="prints the version number")
    ap.add_argument("-h", "--help", action="store_true",
                    help="prints the usage")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    # The autoscaler re-executes this command line for each worker it
    # spawns, so keep the unparsed form.
    raw_argv = list(argv) if argv is not None else sys.argv[1:]
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.version:
        print(f"v{__version__}")
        return 0
    if args.help:
        ap.print_help()
        return 0
    if len(args.paths) < 3:
        print("[racon_tpu_torch::] error: missing input file(s)!",
              file=sys.stderr)
        ap.print_help(sys.stderr)
        return 1

    from racon_tpu_torch.io.parsers import ParseError
    from racon_tpu_torch.models.overlap import PolisherError
    from racon_tpu_torch.obs import fleet
    from racon_tpu_torch.obs.metrics import registry
    from racon_tpu_torch.obs.trace import configure as configure_trace
    from racon_tpu_torch.ops.kernels import KernelError
    from racon_tpu_torch.pipeline import StageError
    from racon_tpu_torch.pipeline import configure as configure_pipeline
    from racon_tpu_torch.resilience.retry import RetryExhausted
    from racon_tpu_torch.resilience.watchdog import is_terminal
    from racon_tpu_torch.server.engine import JobSpec, build_polisher
    from racon_tpu_torch.utils import env
    from racon_tpu_torch.utils.device import DeviceError, resolve_device
    from racon_tpu_torch.utils.logger import Logger

    try:
        configure_pipeline(args.pipeline_depth)
    except ValueError as exc:
        print(str(exc), file=sys.stderr)
        return 1

    import torch
    tracer = configure_trace(args.trace)
    metrics_port = env.read(env.METRICS_PORT)
    if metrics_port:
        # The pull endpoint (a daemon thread, it dies with the process)
        # serves this process's registry; a ledger member (the
        # supervisor too) answers /healthz with the fleet's view, so a
        # dead supervisor turns the probe 503.
        from racon_tpu_torch.obs.export import (fleet_health,
                                                render_registry,
                                                serve_metrics)
        from racon_tpu_torch.resilience.watchdog import health_snapshot
        if args.ledger_dir:
            _ld = args.ledger_dir
            health = lambda: fleet_health(  # noqa: E731
                _ld, base=health_snapshot)
        else:
            health = health_snapshot
        try:
            serve_metrics(int(metrics_port),
                          lambda: render_registry(registry().snapshot()),
                          health=health)
        except (ValueError, OSError) as exc:
            print(f"[racon_tpu_torch::] error: cannot serve metrics on "
                  f"port {metrics_port!r}: {exc}", file=sys.stderr)
            return 1

    out = sys.stdout.buffer
    logger = Logger()
    if args.resume and not args.checkpoint_dir:
        print("[racon_tpu_torch::] error: --resume requires "
              "--checkpoint-dir!", file=sys.stderr)
        return 1
    if args.ledger_dir and (args.checkpoint_dir or args.resume):
        print("[racon_tpu_torch::] error: --ledger-dir manages per-shard "
              "checkpoints itself; drop --checkpoint-dir/--resume!",
              file=sys.stderr)
        return 1
    if args.ledger_dir and args.cache_dir:
        print("[racon_tpu_torch::] error: --cache-dir is a whole-run "
              "store; it does not compose with --ledger-dir's per-shard "
              "leases!", file=sys.stderr)
        return 1
    if args.ledger_dir and args.workers < 1:
        print(f"[racon_tpu_torch::] error: invalid --workers "
              f"{args.workers}!", file=sys.stderr)
        return 1
    if args.ledger_dir and args.lease_s <= 0:
        print(f"[racon_tpu_torch::] error: invalid --lease-s "
              f"{args.lease_s}!", file=sys.stderr)
        return 1
    if args.autoscale:
        if not args.ledger_dir:
            print("[racon_tpu_torch::] error: --autoscale requires "
                  "--ledger-dir!", file=sys.stderr)
            return 1
        # Supervisor: no polisher, no device in this process — it spawns
        # and shepherds workers (this command minus --autoscale) until
        # the merged FASTA lands, then prints it. It branches off before
        # the device is resolved, so it never holds a CUDA context.
        from racon_tpu_torch.distributed.autoscaler import run_supervisor
        from racon_tpu_torch.distributed.ledger import LedgerError
        try:
            return run_supervisor(ledger_dir=args.ledger_dir,
                                  raw_argv=raw_argv,
                                  default_max=args.workers, out=out)
        except LedgerError as exc:
            print(str(exc), file=sys.stderr)
            return 1
        finally:
            tracer.finish()
    # Everything that changes emitted bytes goes into the run
    # fingerprint (checkpoint store and ledger alike): JobSpec.identity(),
    # the JAX package's dict key for key. The device and threads are
    # execution knobs, not identity.
    spec = JobSpec(
        args.paths[0], args.paths[1], args.paths[2],
        include_unpolished=args.include_unpolished,
        fragment_correction=args.fragment_correction,
        window_length=args.window_length,
        quality_threshold=args.quality_threshold,
        error_threshold=args.error_threshold, match=args.match,
        mismatch=args.mismatch, gap=args.gap, backend=args.device,
        threads=args.threads)
    store = None
    if args.checkpoint_dir:
        from racon_tpu_torch.ava import seg_targets_for
        from racon_tpu_torch.resilience.checkpoint import (CheckpointError,
                                                           CheckpointStore)
        try:
            fp = spec.fingerprint()
            store = (CheckpointStore.resume(args.checkpoint_dir, fp)
                     if args.resume else
                     CheckpointStore.create(
                         args.checkpoint_dir, fp,
                         segment_targets=seg_targets_for(
                             args.fragment_correction)))
        except (CheckpointError, OSError) as exc:
            print(str(exc), file=sys.stderr)
            return 1
        if args.resume and store.committed:
            print(f"[racon_tpu_torch::] resuming: {len(store.committed)} "
                  f"contig(s) already committed in {args.checkpoint_dir}",
                  file=sys.stderr)

    # The CLI's Tier-1 cache: armed only by --cache-dir (the daemon arms
    # by default), turned off everywhere by RACON_TPU_CACHE=0.
    result_cache = None
    if args.cache_dir:
        from racon_tpu_torch.cache import ResultCache, cache_enabled
        if cache_enabled():
            try:
                result_cache = ResultCache(args.cache_dir)
            except Exception as exc:
                print(str(exc), file=sys.stderr)
                if store is not None:
                    store.close()
                return 1

    import os
    import signal
    import threading
    old_handlers = {}
    if threading.current_thread() is threading.main_thread():
        def _on_signal(signum, frame):
            raise _Interrupted(signum)
        for sig in (signal.SIGINT, signal.SIGTERM):
            old_handlers[sig] = signal.signal(sig, _on_signal)

    obs_dir = env.read(fleet.ENV_OBS_DIR)
    if obs_dir and not args.ledger_dir:
        # A serial run joins the fleet plane on request: the metric
        # shard a ledger worker writes (workers install theirs under
        # <ledger-dir>/obs at join time).
        wid = args.worker_id or f"serial-{os.getpid()}"
        fleet.install_writer(obs_dir, wid, spec.fingerprint())
        tracer.set_context(worker_id=wid, run_fp=spec.fingerprint())
    if not args.ledger_dir:
        # A serial run spawned by another process adopts its trace
        # context from RACON_TPU_TRACE_CTX; ledger workers adopt inside
        # run_worker (the environment first, then the ledger's meta).
        from racon_tpu_torch.obs.trace import adopt_trace_context
        adopt_trace_context(tracer=tracer)

    def make_polisher():
        return build_polisher(spec, logger=logger)

    def _resume_log(n_committed: int, n_skip: int) -> None:
        if n_skip:
            print("[racon_tpu_torch::] resume: skipping recompute of "
                  f"{n_skip} window(s)", file=sys.stderr)

    rc = 0
    try:
        with tracer.span("run", "racon_tpu_torch"):
            resolve_device(args.device)
            if args.ledger_dir:
                from racon_tpu_torch.distributed.worker import run_worker
                from racon_tpu_torch.io.parsers import scan_sequence_index
                # Only the worker that publishes the ledger scans the
                # target file; later joiners adopt its count and offsets.
                rc = run_worker(
                    ledger_dir=args.ledger_dir,
                    fingerprint=spec.fingerprint(),
                    scan_targets=lambda: scan_sequence_index(args.paths[2]),
                    worker_id=args.worker_id, workers=args.workers,
                    lease_s=args.lease_s, make_polisher=make_polisher,
                    drop_unpolished=not args.include_unpolished,
                    fragment_correction=args.fragment_correction,
                    window_length=args.window_length, out=out)
            else:
                _polish_serial(args, spec, store, result_cache, out,
                               make_polisher, _resume_log)
    except _Interrupted as exc:
        out.flush()
        if args.ledger_dir:
            print(f"[racon_tpu_torch::] interrupted (signal {exc.signum}); "
                  f"committed contigs are safe in {args.ledger_dir} — "
                  "this worker's lease will expire and a survivor (or "
                  "a rerun) will steal its shard", file=sys.stderr)
        elif store is not None:
            print(f"[racon_tpu_torch::] interrupted (signal {exc.signum}); "
                  f"{len(store.committed)} contig(s) committed in "
                  f"{args.checkpoint_dir} — rerun with --resume",
                  file=sys.stderr)
        else:
            print(f"[racon_tpu_torch::] interrupted (signal {exc.signum})",
                  file=sys.stderr)
        # The eviction contract: a SIGTERM'd worker leaves a final metric
        # snapshot (and a flight-recorder dump) before it dies.
        fleet.flush_final(reason=f"signal-{exc.signum}")
        tracer.finish(metrics=registry().snapshot())
        return 128 + exc.signum
    except (DeviceError, PolisherError, ParseError, StageError, KernelError,
            RetryExhausted, ValueError,
            getattr(torch, "AcceleratorError", ())) as exc:
        # A kernel's error, an exhaustion that may not degrade, or a
        # pipeline stage's failure ends the run: past the retry
        # envelope's degradation and the stall recovery, nothing falls
        # back to the host path.
        if is_terminal(exc):
            return _terminal(exc, tracer, out)
        print(str(exc), file=sys.stderr)
        tracer.finish(metrics=registry().snapshot())
        return 1
    except Exception as exc:
        if not is_terminal(exc):
            raise
        return _terminal(exc, tracer, out)
    finally:
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)
        if store is not None:
            store.close()
    out.flush()
    logger.total("[racon_tpu_torch::Polisher::] total =")
    fleet.flush_final()
    tracer.finish(metrics=registry().snapshot())
    return rc


def _polish_serial(args, spec, store, result_cache, out, make_polisher,
                   resume_log) -> None:
    """The serial run: a cache hit re-emits the stored records; else the
    service core's polish loop, committing into ``store`` and capturing
    the records for the cache."""
    from racon_tpu_torch.server.engine import JobHooks, polish_job
    # The cache applies only to runs starting from scratch: a resumed
    # run's committed prefix owns the output order.
    fresh = store is None or not store.committed
    hit = None
    if result_cache is not None and fresh:
        hit = result_cache.load(spec.fingerprint())
    if hit is not None:
        from racon_tpu_torch.cache import replay_records
        n = replay_records(hit, emit=out.write, store=store)
        print(f"[racon_tpu_torch::] cache: re-emitted {n} contig(s) from "
              f"{args.cache_dir} (zero consensus dispatches)",
              file=sys.stderr)
        return
    captured = [] if (result_cache is not None and fresh) else None

    def _capture(tid, rec):
        if rec is None:
            captured.append((tid, None, b""))
        else:
            captured.append((tid, rec.name.encode(), rec.data))

    polish_job(make_polisher, drop_unpolished=not args.include_unpolished,
               store=store, emit=out.write,
               hooks=JobHooks(on_resume=resume_log,
                              after_commit=_capture
                              if captured is not None else None))
    if captured is not None:
        result_cache.store(spec.fingerprint(), captured)


def _terminal(exc, tracer, out) -> int:
    """A terminal watchdog breach: this host is wedged; flush what was
    written, leave the final metric snapshot and exit with the distinct
    code, so a supervisor reschedules the run elsewhere instead of
    retrying here."""
    from racon_tpu_torch.obs import fleet
    from racon_tpu_torch.obs.metrics import registry
    from racon_tpu_torch.resilience.watchdog import EXIT_SELF_EVICT
    out.flush()
    print(f"[racon_tpu_torch::] terminal watchdog breach — {exc}",
          file=sys.stderr)
    fleet.flush_final(reason="watchdog-terminal")
    tracer.finish(metrics=registry().snapshot())
    return EXIT_SELF_EVICT


if __name__ == "__main__":
    sys.exit(main())
