"""rampler equivalent: subsample and split sequence files (port of the
JAX package's ``tools/rampler.py``).

The command line follows the reference wrapper's use of the vendored
rampler:

  python -m racon_tpu_torch.tools.rampler -o <outdir> subsample \\
      <sequences> <reference_length> <coverage> ...
      -> <base>_<coverage>x.fasta[.fastq] per requested coverage
  python -m racon_tpu_torch.tools.rampler -o <outdir> split \\
      <sequences> <chunk_size_bytes>
      -> <base>_<i>.fasta[.fastq], i = 0..

Both stream records (bounded memory) and keep the FASTA/FASTQ flavour.
Subsampling keeps each read with probability ref_length * coverage /
total_bases, one draw of ``np.random.default_rng(seed)`` a record (seed
1623), so it keeps the same reads as the JAX package's rampler, byte for
byte. No device is used.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from racon_tpu_torch.io.parsers import (_FASTQ_EXTS, ParseError,
                                        create_sequence_parser)


def _base_and_flavour(path: str):
    base = os.path.basename(path)
    for ext in (".fasta.gz", ".fastq.gz", ".fa.gz", ".fq.gz", ".fasta",
                ".fastq", ".fa", ".fq", ".gz"):
        if base.endswith(ext):
            base = base[:-len(ext)]
            break
    fastq = path.endswith(_FASTQ_EXTS)
    return base, fastq


def _write_record(f, seq, fastq: bool) -> None:
    name = seq.name.encode()
    if fastq and seq.quality is not None:
        f.write(b"@" + name + b"\n" + seq.data + b"\n+\n" + seq.quality
                + b"\n")
    else:
        f.write(b">" + name + b"\n" + seq.data + b"\n")


_STREAM_CHUNK = 64 * 1024 * 1024  # bounded-memory streaming budget


def _stream(parser):
    """Iterate records with bounded memory (parse in 64 MiB chunks)."""
    parser.reset()
    while True:
        chunk, more = parser.parse(_STREAM_CHUNK)
        yield from chunk
        if not more:
            return


def subsample(sequences_path: str, reference_length: int, coverage: int,
              out_dir: str, seed: int = 1623) -> str:
    """Randomly subsample to about coverage x reference_length bases."""
    parser = create_sequence_parser(sequences_path)
    total = 0
    for seq in _stream(parser):
        total += len(seq.data)
    if total == 0:
        raise ParseError(
            f"[racon_tpu_torch::rampler] error: empty sequences file "
            f"{sequences_path}")
    p_keep = min(1.0, reference_length * coverage / total)

    base, fastq = _base_and_flavour(sequences_path)
    ext = ".fastq" if fastq else ".fasta"
    out_path = os.path.join(out_dir, f"{base}_{coverage}x{ext}")
    rng = np.random.default_rng(seed)
    with open(out_path, "wb") as f:
        for seq in _stream(parser):
            if rng.random() <= p_keep:
                _write_record(f, seq, fastq)
    return out_path


def split(sequences_path: str, chunk_size: int, out_dir: str) -> List[str]:
    """Split into chunks of about chunk_size bases (the sum of sequence
    lengths); a record longer than the budget gets a chunk of its own."""
    if chunk_size <= 0:
        raise ParseError(
            "[racon_tpu_torch::rampler] error: invalid chunk size!")
    base, fastq = _base_and_flavour(sequences_path)
    ext = ".fastq" if fastq else ".fasta"
    parser = create_sequence_parser(sequences_path)
    paths: List[str] = []
    f = None
    used = 0
    try:
        for seq in _stream(parser):
            if f is None or (used and used + len(seq.data) > chunk_size):
                if f is not None:
                    f.close()
                path = os.path.join(out_dir, f"{base}_{len(paths)}{ext}")
                paths.append(path)
                f = open(path, "wb")
                used = 0
            _write_record(f, seq, fastq)
            used += len(seq.data)
    finally:
        if f is not None:
            f.close()
    return paths


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m racon_tpu_torch.tools.rampler")
    ap.add_argument("-o", "--out-directory", default=".")
    sub = ap.add_subparsers(dest="mode", required=True)
    ss = sub.add_parser("subsample")
    ss.add_argument("sequences")
    ss.add_argument("reference_length", type=int)
    ss.add_argument("coverage", type=int, nargs="+")
    sp = sub.add_parser("split")
    sp.add_argument("sequences")
    sp.add_argument("chunk_size", type=int)
    args = ap.parse_args(argv)

    os.makedirs(args.out_directory, exist_ok=True)
    try:
        if args.mode == "subsample":
            for cov in args.coverage:
                subsample(args.sequences, args.reference_length, cov,
                          args.out_directory)
        else:
            split(args.sequences, args.chunk_size, args.out_directory)
    except ParseError as exc:
        print(str(exc), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
