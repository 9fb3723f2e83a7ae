"""racon_wrapper equivalent: subsample the reads, split the targets,
polish chunk by chunk (port of the JAX package's ``tools/wrapper.py``).

    python -m racon_tpu_torch.tools.wrapper <reads> <overlaps> <targets>
        [--split CHUNK_SIZE] [--subsample REF_LEN COVERAGE]
        [--work-directory DIR] [--resume] [--num-shards N --shard-id I]
        [--device cuda|cpu] [racon options]

It optionally subsamples the reads (rampler subsample), optionally splits
the targets into chunks of about CHUNK_SIZE bases (rampler split), then
polishes each chunk in turn with the same options and writes the
combined FASTA to stdout. Each chunk's output goes to
``<workdir>/chunk_<i>.fasta`` first (written to a temporary file, then
``os.replace``d), and ``--resume`` reuses chunks whose output already
exists, so an interrupted run continues where it stopped. Several hosts
can each take a disjoint slice of the chunks (``--num-shards``,
``--shard-id``) with no communication between them.

Each chunk runs the CLI's main path on ``--device`` (``cuda`` by
default: its overlaps aligned and its windows polished by the CUDA
kernels); a CUDA request on a host without a GPU fails with the
``DeviceError`` message and exit 1, as the CLI does. ``--device cpu``
runs the plain PyTorch versions. With ``RACON_TPU_OBS_DIR`` set, the
wrapper keeps a metric shard there, as a serial CLI run does, carrying
this process's kernel launches (``kernel_launches_*``), republished
after each chunk it polishes.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time
from typing import List, Optional

from racon_tpu_torch.tools import rampler

#: The options that change the polished bytes (the job's identity).
POLISH_OPTS = ("include_unpolished", "fragment_correction",
               "window_length", "quality_threshold", "error_threshold",
               "match", "mismatch", "gap")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m racon_tpu_torch.tools.wrapper")
    ap.add_argument("sequences")
    ap.add_argument("overlaps")
    ap.add_argument("target_sequences")
    ap.add_argument("--split", type=int, metavar="CHUNK_SIZE",
                    help="split target sequences into chunks of the given "
                         "size in bytes")
    ap.add_argument("--subsample", type=int, nargs=2,
                    metavar=("REF_LEN", "COVERAGE"),
                    help="subsample sequences to the given coverage of the "
                         "given reference length")
    ap.add_argument("--work-directory", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="reuse chunk outputs already present in the work "
                         "directory")
    ap.add_argument("--num-shards", type=int, default=1,
                    help="total hosts polishing disjoint chunk slices")
    ap.add_argument("--shard-id", type=int, default=0)
    # Polishing options forwarded to the Polisher (the reference wrapper
    # forwards the same set).
    ap.add_argument("-u", "--include-unpolished", action="store_true")
    ap.add_argument("-f", "--fragment-correction", action="store_true")
    ap.add_argument("-w", "--window-length", type=int, default=500)
    ap.add_argument("-q", "--quality-threshold", type=float, default=10.0)
    ap.add_argument("-e", "--error-threshold", type=float, default=0.3)
    ap.add_argument("-m", "--match", type=int, default=5)
    ap.add_argument("-x", "--mismatch", type=int, default=-4)
    ap.add_argument("-g", "--gap", type=int, default=-8)
    ap.add_argument("-t", "--threads", type=int, default=1)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where each chunk is polished (default: cuda)")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    from racon_tpu_torch.io.parsers import ParseError
    from racon_tpu_torch.models.overlap import PolisherError
    from racon_tpu_torch.models.polisher import PolisherType, create_polisher
    from racon_tpu_torch.obs import fleet
    from racon_tpu_torch.ops.kernels import KernelError
    from racon_tpu_torch.utils import env
    from racon_tpu_torch.utils.device import DeviceError, resolve_device

    work = args.work_directory or \
        f"racon_tpu_work_directory_{int(time.time())}"
    own_workdir = args.work_directory is None
    os.makedirs(work, exist_ok=True)
    try:
        resolve_device(args.device)
        obs_dir = env.read(env.OBS_DIR)
        if obs_dir:
            from racon_tpu_torch.distributed.worker import \
                record_kernel_launches
            from racon_tpu_torch.server.engine import JobSpec
            spec = JobSpec(args.sequences, args.overlaps,
                           args.target_sequences,
                           **{k: getattr(args, k) for k in POLISH_OPTS})
            fleet.install_writer(obs_dir, f"wrapper-{os.getpid()}",
                                 spec.fingerprint())
        sequences = args.sequences
        if args.subsample:
            sequences = rampler.subsample(
                sequences, args.subsample[0], args.subsample[1], work)

        if args.split:
            targets = rampler.split(args.target_sequences, args.split, work)
        else:
            targets = [args.target_sequences]

        my_chunks = [(i, t) for i, t in enumerate(targets)
                     if i % args.num_shards == args.shard_id]

        out = sys.stdout.buffer
        for i, target in my_chunks:
            chunk_out = os.path.join(work, f"chunk_{i}.fasta")
            if not (args.resume and os.path.isfile(chunk_out)):
                polisher = create_polisher(
                    sequences, args.overlaps, target,
                    PolisherType.kF if args.fragment_correction
                    else PolisherType.kC,
                    args.window_length, args.quality_threshold,
                    args.error_threshold, args.match, args.mismatch,
                    args.gap, device=args.device, threads=args.threads)
                polisher.initialize()
                polished = polisher.polish(not args.include_unpolished)
                tmp = chunk_out + ".tmp"
                with open(tmp, "wb") as f:
                    for seq in polished:
                        f.write(b">" + seq.name.encode() + b"\n" +
                                seq.data + b"\n")
                os.replace(tmp, chunk_out)  # atomic checkpoint
                if obs_dir:
                    record_kernel_launches()
                    fleet.maybe_flush()
            with open(chunk_out, "rb") as f:
                shutil.copyfileobj(f, out)
        out.flush()
        fleet.flush_final()
    except (DeviceError, PolisherError, ParseError, KernelError,
            ValueError) as exc:
        print(str(exc), file=sys.stderr)
        return 1
    finally:
        if own_workdir:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
