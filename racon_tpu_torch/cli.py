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
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from racon_tpu_torch import __version__

_USAGE = ("racon_tpu_torch [options ...] <sequences> <overlaps> "
          "<target sequences>")

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
    ap.add_argument("--version", action="store_true",
                    help="prints the version number")
    ap.add_argument("-h", "--help", action="store_true",
                    help="prints the usage")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
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
    from racon_tpu_torch.obs.metrics import registry
    from racon_tpu_torch.obs.trace import configure as configure_trace
    from racon_tpu_torch.ops.kernels import KernelError
    from racon_tpu_torch.pipeline import StageError
    from racon_tpu_torch.pipeline import configure as configure_pipeline
    from racon_tpu_torch.resilience.retry import RetryExhausted
    from racon_tpu_torch.resilience.watchdog import is_terminal
    from racon_tpu_torch.server.engine import (JobHooks, JobSpec,
                                               build_polisher, polish_job)
    from racon_tpu_torch.utils.device import DeviceError, resolve_device
    from racon_tpu_torch.utils.logger import Logger

    try:
        configure_pipeline(args.pipeline_depth)
    except ValueError as exc:
        print(str(exc), file=sys.stderr)
        return 1

    import torch
    tracer = configure_trace(args.trace)
    out = sys.stdout.buffer
    logger = Logger()
    if args.resume and not args.checkpoint_dir:
        print("[racon_tpu_torch::] error: --resume requires "
              "--checkpoint-dir!", file=sys.stderr)
        return 1
    # Everything that changes emitted bytes goes into the run
    # fingerprint: JobSpec.identity(), the JAX package's dict key for
    # key. The device and threads are execution knobs, not identity.
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

    def make_polisher():
        return build_polisher(spec, logger=logger)

    def _resume_log(n_committed: int, n_skip: int) -> None:
        if n_skip:
            print("[racon_tpu_torch::] resume: skipping recompute of "
                  f"{n_skip} window(s)", file=sys.stderr)

    try:
        with tracer.span("run", "racon_tpu_torch"):
            resolve_device(args.device)
            # The cache applies only to runs starting from scratch: a
            # resumed run's committed prefix owns the output order.
            fresh = store is None or not store.committed
            hit = None
            if result_cache is not None and fresh:
                hit = result_cache.load(spec.fingerprint())
            if hit is not None:
                from racon_tpu_torch.cache import replay_records
                n = replay_records(hit, emit=out.write, store=store)
                print(f"[racon_tpu_torch::] cache: re-emitted {n} "
                      f"contig(s) from {args.cache_dir} (zero consensus "
                      f"dispatches)", file=sys.stderr)
            else:
                captured = [] if (result_cache is not None and
                                  fresh) else None

                def _capture(tid, rec):
                    if rec is None:
                        captured.append((tid, None, b""))
                    else:
                        captured.append((tid, rec.name.encode(),
                                         rec.data))

                polish_job(
                    make_polisher,
                    drop_unpolished=not args.include_unpolished,
                    store=store, emit=out.write,
                    hooks=JobHooks(on_resume=_resume_log,
                                   after_commit=_capture
                                   if captured is not None else None))
                if captured is not None:
                    result_cache.store(spec.fingerprint(), captured)
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
        if store is not None:
            store.close()
    out.flush()
    logger.total("[racon_tpu_torch::Polisher::] total =")
    tracer.finish(metrics=registry().snapshot())
    return 0


def _terminal(exc, tracer, out) -> int:
    """A terminal watchdog breach: this host is wedged; flush what was
    written and exit with the distinct code, so a supervisor reschedules
    the run elsewhere instead of retrying here."""
    from racon_tpu_torch.obs.metrics import registry
    from racon_tpu_torch.resilience.watchdog import EXIT_SELF_EVICT
    out.flush()
    print(f"[racon_tpu_torch::] terminal watchdog breach — {exc}",
          file=sys.stderr)
    tracer.finish(metrics=registry().snapshot())
    return EXIT_SELF_EVICT


if __name__ == "__main__":
    sys.exit(main())
