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
any other device error ends the run with exit code 1 and no FASTA, and a
terminal watchdog breach with exit code 75.
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
    from racon_tpu_torch.models.polisher import PolisherType, create_polisher
    from racon_tpu_torch.obs.trace import configure as configure_trace
    from racon_tpu_torch.pipeline import StageError
    from racon_tpu_torch.pipeline import configure as configure_pipeline
    from racon_tpu_torch.ops.kernels import KernelError
    from racon_tpu_torch.pipeline.metrics import registry
    from racon_tpu_torch.resilience.retry import RetryExhausted
    from racon_tpu_torch.resilience.watchdog import is_terminal
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
    try:
        with tracer.span("run", "racon_tpu_torch"):
            device = resolve_device(args.device)
            polisher = create_polisher(
                args.paths[0], args.paths[1], args.paths[2],
                PolisherType.kF if args.fragment_correction
                else PolisherType.kC,
                args.window_length, args.quality_threshold,
                args.error_threshold, args.match, args.mismatch, args.gap,
                device=device, logger=logger, threads=args.threads)
            polisher.initialize()
            for _tid, rec in polisher.polish_records(
                    not args.include_unpolished):
                if rec is not None:
                    out.write(b">" + rec.name.encode() + b"\n" + rec.data +
                              b"\n")
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
    out.flush()
    logger.total("[racon_tpu_torch::Polisher::] total =")
    tracer.finish(metrics=registry().snapshot())
    return 0


def _terminal(exc, tracer, out) -> int:
    """A terminal watchdog breach: this host is wedged; flush what was
    written and exit with the distinct code, so a supervisor reschedules
    the run elsewhere instead of retrying here."""
    from racon_tpu_torch.pipeline.metrics import registry
    from racon_tpu_torch.resilience.watchdog import EXIT_SELF_EVICT
    out.flush()
    print(f"[racon_tpu_torch::] terminal watchdog breach — {exc}",
          file=sys.stderr)
    tracer.finish(metrics=registry().snapshot())
    return EXIT_SELF_EVICT


if __name__ == "__main__":
    sys.exit(main())
