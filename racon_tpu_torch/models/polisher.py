"""Polisher: end-to-end orchestration from input files to polished contigs.

Port of the JAX package's Polisher (src/polisher.{hpp,cpp} re-design).
The preprocessing pipeline keeps the reference's semantics step for step
(citations inline); the execution model changes where the reference uses a
thread pool:

- per-overlap edlib alignments (src/polisher.cpp:351-364) become
  batched banded NW on the card (racon_tpu_torch/ops/ovl_align.py) on a
  CUDA engine, and one batched native banded-NW call
  (racon_tpu_torch/native) for the rest and on the CPU;
- per-window spoa tasks (src/polisher.cpp:457-469) become PoaEngine
  batches on the device, windows as the batch dimension
  (racon_tpu_torch/ops/poa.py).
"""

from __future__ import annotations

import enum
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from racon_tpu_torch.io import parsers as iop
from racon_tpu_torch.models.overlap import Overlap, PolisherError
from racon_tpu_torch.models.sequence import Sequence
from racon_tpu_torch.models.window import Window, WindowType
from racon_tpu_torch.ops.poa import PoaEngine
from racon_tpu_torch.utils.logger import Logger, NullLogger

# Streaming chunk size for reads/overlaps (src/polisher.cpp:22) — single
# source of truth lives with the parsers.
CHUNK_SIZE = iop.CHUNK_SIZE


class PolisherType(enum.Enum):
    kC = 0  # contig polishing (default)
    kF = 1  # fragment error-correction (-f)


class PolishedSequence:
    """Output record: polished contig with its FASTA header tags."""
    __slots__ = ("name", "data")

    def __init__(self, name: str, data: bytes):
        self.name = name
        self.data = data


def create_polisher(sequences_path: str, overlaps_path: str,
                    target_path: str, type_: PolisherType = PolisherType.kC,
                    window_length: int = 500, quality_threshold: float = 10.0,
                    error_threshold: float = 0.3, match: int = 5,
                    mismatch: int = -4, gap: int = -8,
                    device="cuda", logger: Optional[Logger] = None,
                    threads: int = 1) -> "Polisher":
    """Validate options and dispatch parsers (src/polisher.cpp:51-130).
    ``device``: where the consensus engine runs ("cuda" or "cpu")."""
    if not isinstance(type_, PolisherType):
        raise PolisherError(
            "[racon_tpu_torch::create_polisher] error: invalid polisher type!")
    if window_length <= 0:
        raise PolisherError(
            "[racon_tpu_torch::create_polisher] error: invalid window length!")
    sparser = iop.create_sequence_parser(sequences_path)
    oparser = iop.create_overlap_parser(overlaps_path)
    tparser = iop.create_sequence_parser(target_path)
    return Polisher(sparser, oparser, tparser, type_, window_length,
                    quality_threshold, error_threshold, match, mismatch,
                    gap, device=device, logger=logger, threads=threads)


class Polisher:
    def __init__(self, sparser, oparser, tparser, type_: PolisherType,
                 window_length: int, quality_threshold: float,
                 error_threshold: float, match: int, mismatch: int,
                 gap: int, device="cuda",
                 logger: Optional[Logger] = None,
                 window_chunk: int = 8192, threads: int = 1):
        self.sparser = sparser
        self.oparser = oparser
        self.tparser = tparser
        self.type = type_
        self.window_length = window_length
        self.quality_threshold = quality_threshold
        self.error_threshold = error_threshold
        # Host-side OS-thread fan-out for the native aligner (reference
        # -t, src/polisher.cpp:341-364); device batching is unaffected.
        self.threads = threads
        self.engine = PoaEngine(match, mismatch, gap, device=device,
                                threads=threads)
        self.logger = logger if logger is not None else NullLogger()
        self.window_chunk = window_chunk

        self.sequences: List[Sequence] = []
        self.windows: List[Window] = []
        self.targets_coverages: List[int] = []
        self._targets_size = 0
        self._window_type = WindowType.TGS

    # ------------------------------------------------------------ initialize

    def initialize(self) -> None:
        """Preprocess inputs into windows (src/polisher.cpp:162-449)."""
        if self.windows:
            print("[racon_tpu_torch::Polisher::initialize] warning: "
                  "object already initialized!", file=sys.stderr)
            return
        log = self.logger
        log.begin()

        # The ingest plane (RACON_TPU_INGEST, default on): the three input
        # files parse on prefetch threads at once, so phases 1-3 wait on
        # the slowest file instead of the sum; the chunk protocol and the
        # errors are the serial loops'.
        from racon_tpu_torch.io.ingest import prefetch_ok
        from racon_tpu_torch.pipeline.streaming import (IngestPrefetcher,
                                                        serial_chunks)
        # kF single-parse: a fragment-correction invocation passes the
        # SAME file as reads and targets, so phase 2 replays the loaded
        # targets instead of parsing the file twice (byte-identical).
        s_path = getattr(self.sparser, "path", None)
        t_path = getattr(self.tparser, "path", None)
        shared = (s_path is not None and t_path is not None
                  and os.path.realpath(s_path)
                  == os.path.realpath(t_path))
        prefetchers: List[IngestPrefetcher] = []
        src_s = None
        if prefetch_ok():
            pf_t = IngestPrefetcher(self.tparser, CHUNK_SIZE, "targets")
            pf_o = IngestPrefetcher(self.oparser, CHUNK_SIZE, "overlaps")
            prefetchers = [pf_t, pf_o]
            if not shared:
                pf_s = IngestPrefetcher(self.sparser, CHUNK_SIZE, "reads")
                prefetchers.append(pf_s)
                src_s = pf_s.chunks()
            src_t = pf_t.chunks()
            src_o = pf_o.chunks()
        else:
            src_t = serial_chunks(self.tparser, CHUNK_SIZE)
            if not shared:
                src_s = serial_chunks(self.sparser, CHUNK_SIZE)
            src_o = serial_chunks(self.oparser, CHUNK_SIZE)
        try:
            self._load_inputs(src_t, src_s, src_o, log)
        finally:
            for pf in prefetchers:
                pf.close()

    def _load_inputs(self, src_t, src_s, src_o, log) -> None:
        """Phases 1-7 of initialize(), consuming the three ingest chunk
        streams (prefetched or serial: the same protocol). ``src_s`` may
        be None — the reads ARE the targets (kF single-parse above) —
        and phase 2 then replays the loaded target records through the
        identical dedup/bookkeeping path without touching the file."""
        # 1. Targets (src/polisher.cpp:172-187).
        self.sequences = []
        for chunk, _more in src_t:
            self.sequences.extend(chunk)
        targets_size = len(self.sequences)
        if targets_size == 0:
            raise PolisherError(
                "[racon_tpu_torch::Polisher::initialize] error: "
                "empty target sequences set!")
        self._targets_size = targets_size

        name_to_id: Dict[str, int] = {}
        id_to_id: Dict[int, int] = {}
        for i, seq in enumerate(self.sequences):
            name_to_id[seq.name + "t"] = i
            id_to_id[i << 1 | 1] = i

        has_name = [True] * targets_size
        has_data = [True] * targets_size
        has_reverse = [False] * targets_size

        log.phase("[racon_tpu_torch::Polisher::initialize] loaded target sequences")
        log.begin()

        # 2. Reads, streamed and deduplicated against targets
        # (src/polisher.cpp:196-234).
        if src_s is None:
            # The slice is a copy, so the loop below never iterates a
            # list it is appending to (it won't append here — every
            # "read" dedups against itself — but the invariant should
            # not depend on that).
            src_s = [(self.sequences[:targets_size], False)]
        sequences_size = 0
        total_len = 0
        for chunk, _more in src_s:
            for seq in chunk:
                total_len += len(seq.data)
                tid = name_to_id.get(seq.name + "t")
                if tid is not None:
                    tgt = self.sequences[tid]
                    if len(seq.data) != len(tgt.data) or \
                            len(seq.quality or b"") != len(tgt.quality or b""):
                        raise PolisherError(
                            "[racon_tpu_torch::Polisher::initialize] error: "
                            f"duplicate sequence {seq.name} with unequal data")
                    name_to_id[seq.name + "q"] = tid
                    id_to_id[sequences_size << 1 | 0] = tid
                else:
                    idx = len(self.sequences)
                    self.sequences.append(seq)
                    name_to_id[seq.name + "q"] = idx
                    id_to_id[sequences_size << 1 | 0] = idx
                sequences_size += 1
        if sequences_size == 0:
            raise PolisherError(
                "[racon_tpu_torch::Polisher::initialize] error: "
                "empty sequences set!")

        n_seqs = len(self.sequences)
        has_name += [False] * (n_seqs - targets_size)
        has_data += [False] * (n_seqs - targets_size)
        has_reverse += [False] * (n_seqs - targets_size)

        # NGS/TGS heuristic: mean read length (src/polisher.cpp:246-247).
        self._window_type = WindowType.NGS \
            if total_len / sequences_size <= 1000 else WindowType.TGS

        log.phase("[racon_tpu_torch::Polisher::initialize] loaded sequences")
        log.begin()

        # 3. Overlaps, streamed; per-q_id-group filtering
        # (src/polisher.cpp:252-325).
        overlaps: List[Overlap] = []
        group: List[Overlap] = []

        def flush_group():
            kept = _filter_overlap_group(group, self.error_threshold,
                                         self.type)
            for o in kept:
                if o.strand:
                    has_reverse[o.q_id] = True
                else:
                    has_data[o.q_id] = True
            overlaps.extend(kept)
            group.clear()

        for chunk, _more in src_o:
            for o in chunk:
                o.transmute(self.sequences, name_to_id, id_to_id)
                if not o.is_valid:
                    continue
                if group and group[-1].q_id != o.q_id:
                    flush_group()
                group.append(o)
        flush_group()
        del name_to_id, id_to_id

        if not overlaps:
            raise PolisherError(
                "[racon_tpu_torch::Polisher::initialize] error: "
                "empty overlap set!")

        log.phase("[racon_tpu_torch::Polisher::initialize] loaded overlaps")
        log.begin()

        # 4. Sequence transmute: build reverse complements where some
        # overlap needs them, free what nothing references
        # (src/polisher.cpp:339-348).
        for i, seq in enumerate(self.sequences):
            seq.transmute(has_name[i], has_data[i], has_reverse[i])

        # 5. Breaking points; PAF/MHAP overlaps need a global alignment
        # first. On a CUDA engine they run as batched banded NW on the
        # card with the breaking points reduced there
        # (racon_tpu_torch/ops/ovl_align.py); jobs it does not admit or
        # certify, and every job on the CPU engine, take the batched
        # native aligner (src/polisher.cpp:351-364, overlap.cpp:194-213).
        pending = [o for o in overlaps if len(o.cigar) == 0]
        if pending and self.engine.device.type == "cuda":
            from racon_tpu_torch.ops.ovl_align import device_breaking_points
            # Edit-distance scoring (0, -1, -1), like edlib
            # (src/overlap.cpp:198-200) and the native aligner below, so
            # every route picks the same alignments.
            pending = device_breaking_points(
                pending, self.sequences, self.window_length, match=0,
                mismatch=-1, gap=-1, device=self.engine.device,
                log=sys.stderr)
        if pending:
            from racon_tpu_torch.native.aligner import NativeAligner
            from racon_tpu_torch.ops.cigar import ops_to_cigar
            from racon_tpu_torch.ops.encode import encode_bases
            # Edit-distance scoring, like edlib (src/overlap.cpp:198-200).
            aligner = NativeAligner(threads=self.threads)
            pairs = []
            for o in pending:
                q, t = o.alignment_operands(self.sequences)
                pairs.append((encode_bases(bytes(q)), encode_bases(bytes(t))))
            for o, ops in zip(pending, aligner.align_batch(pairs)):
                o.cigar = ops_to_cigar(ops)
        step = len(overlaps) // 20
        for i, o in enumerate(overlaps):
            o.find_breaking_points(self.sequences, self.window_length)
            # 20-tick cap as in the reference (src/polisher.cpp:359-364).
            if step and (i + 1) % step == 0 and (i + 1) // step <= 20:
                log.tick("[racon_tpu_torch::Polisher::initialize] aligning overlaps")
        log.phase("[racon_tpu_torch::Polisher::initialize] aligned overlaps")
        log.begin()

        # 6. Cut targets into windows (src/polisher.cpp:373-388).
        w_len = self.window_length
        id_to_first_window = [0] * (targets_size + 1)
        for i in range(targets_size):
            tgt = self.sequences[i]
            data = memoryview(tgt.data)
            qual = memoryview(tgt.quality) if tgt.quality is not None else None
            k = 0
            for j in range(0, len(tgt.data), w_len):
                e = min(j + w_len, len(tgt.data))
                self.windows.append(Window(
                    i, k, self._window_type, data[j:e],
                    qual[j:e] if qual is not None else None))
                k += 1
            id_to_first_window[i + 1] = id_to_first_window[i] + k

        # 7. Route overlap segments into windows with the 2%-span and
        # mean-quality filters (src/polisher.cpp:390-446). Filters and
        # window arithmetic run vectorized over each overlap's breaking-
        # point rows (at genome scale this loop sees tens of millions of
        # rows — the per-row Python of earlier rounds dominated
        # initialize); only surviving rows pay Python list appends.
        self.targets_coverages = [0] * targets_size
        min_span = 0.02 * w_len
        for o in overlaps:
            self.targets_coverages[o.t_id] += 1
            seq = self.sequences[o.q_id]
            bps = o.breaking_points
            if bps is None or len(bps) == 0:
                o.breaking_points = None
                continue
            data = seq.reverse_complement if o.strand else seq.data
            qual = seq.reverse_quality if o.strand else seq.quality
            dmv = memoryview(data) if data is not None else None
            qmv = memoryview(qual) if qual is not None else None
            first_t = bps[:, 0]
            first_q = bps[:, 1]
            last_q1 = bps[:, 3]
            ok = (last_q1 - first_q) >= min_span
            if qual is not None:
                pref = seq.quality_prefix(o.strand)
                if pref is not None:
                    n_b = last_q1 - first_q
                    avg = (pref[last_q1] - pref[first_q]) / \
                        np.maximum(n_b, 1)
                    ok &= ~((avg < self.quality_threshold) & (n_b > 0))
            wslot = first_t // w_len
            wid = id_to_first_window[o.t_id] + wslot
            wstart = wslot * w_len
            b = first_t - wstart
            e = bps[:, 2] - wstart - 1
            for r in np.flatnonzero(ok):
                self.windows[wid[r]].add_layer(
                    dmv[first_q[r]:last_q1[r]],
                    qmv[first_q[r]:last_q1[r]] if qmv is not None
                    else None,
                    int(b[r]), int(e[r]))
            o.breaking_points = None  # freed (src/polisher.cpp:445)

        log.phase("[racon_tpu_torch::Polisher::initialize] "
                  "transformed data into windows")

    # ----------------------------------------------------------------- polish

    def skip_targets(self, committed) -> int:
        """Drop every window of the given target ids before polishing —
        the checkpoint-resume path (resilience/checkpoint.py): committed
        contigs re-emit from the shard, so their windows must not
        recompute. Pruning whole targets is safe for the assembler: each
        contig's windows restart at rank 0, so the remaining boundary
        structure is unchanged. Returns #windows dropped."""
        committed = set(committed)
        if not committed:
            return 0
        keep = [w for w in self.windows if w.id not in committed]
        n = len(self.windows) - len(keep)
        self.windows = keep
        return n

    def restrict_targets(self, keep) -> int:
        """Drop every window NOT belonging to the given target ids — the
        shard path of a distributed work ledger (a worker polishes only
        its shard's contigs). Safe for the assembler by the same argument
        as :meth:`skip_targets`. Returns #windows dropped."""
        keep = set(keep)
        kept = [w for w in self.windows if w.id in keep]
        n = len(self.windows) - len(kept)
        self.windows = kept
        return n

    def polish_records(self, drop_unpolished_sequences: bool = True):
        """The polishing loop: yield ``(target_id, record-or-None)`` as
        each target's last window finalizes, in target input order
        (``record`` is None for a target dropped as unpolished). With the
        streaming pipeline on (RACON_TPU_PIPELINE / --pipeline-depth;
        pipeline/) the windows go through stream_consensus, and records
        come out as their windows finalize; the serial and streamed paths
        feed the same assembler and give the same records."""
        from racon_tpu_torch.pipeline import pipeline_depth, pipeline_enabled
        log = self.logger
        log.begin()
        asm = _ContigAssembler(self, drop_unpolished_sequences)

        if pipeline_enabled():
            from racon_tpu_torch.pipeline.streaming import stream_consensus

            def _tick():
                log.tick(
                    "[racon_tpu_torch::Polisher::polish] generating consensus")

            for s, e in stream_consensus(self.engine, self.windows,
                                         chunk=self.window_chunk,
                                         depth=pipeline_depth(), tick=_tick):
                for i in range(s, e):
                    done = asm.feed(i, self.windows[i])
                    if done is not None:
                        yield done
            self._log_sched_summary()
        else:
            n_windows = len(self.windows)
            for s in range(0, n_windows, self.window_chunk):
                self.engine.consensus_windows(
                    self.windows[s:s + self.window_chunk])
                log.tick(
                    "[racon_tpu_torch::Polisher::polish] generating consensus")
            self._log_sched_summary()
            for i, w in enumerate(self.windows):
                done = asm.feed(i, w)
                if done is not None:
                    yield done

        log.phase("[racon_tpu_torch::Polisher::polish] generated consensus")
        self.windows = []

    def _log_sched_summary(self) -> None:
        """The convergence scheduler's one stderr line, from its
        telemetry (sched/telemetry.py), when it ran."""
        telem = self.engine.sched_telemetry
        if telem is not None and telem.windows:
            self.logger.line("[racon_tpu_torch::Polisher::polish] "
                             "scheduler " + telem.summary())

    def polish(self, drop_unpolished_sequences: bool = True
               ) -> List[PolishedSequence]:
        """Batch windows through the engine, stitch contigs in order, tag
        and emit (src/polisher.cpp:451-513)."""
        return [rec for _tid, rec
                in self.polish_records(drop_unpolished_sequences)
                if rec is not None]

    def polish_stream(self, drop_unpolished_sequences: bool = True):
        """Yield each PolishedSequence as soon as all of its windows
        finalize, in the order polish() lists them (under the streaming
        pipeline, while later windows are still being packed and
        computed)."""
        for _tid, rec in self.polish_records(drop_unpolished_sequences):
            if rec is not None:
                yield rec

class _ContigAssembler:
    """Incremental contig stitching: feed finalized windows in input
    order; the last window of each target returns ``(target_id,
    PolishedSequence-or-None)`` — None when the target is dropped as
    unpolished, so completion is still observable (the checkpoint store
    commits drops too). One implementation serves every polish path so
    the record format cannot drift between the serial and streaming
    executors (src/polisher.cpp:478-508)."""

    __slots__ = ("p", "drop", "n_windows", "_data", "_num_polished")

    def __init__(self, polisher: Polisher, drop_unpolished: bool):
        self.p = polisher
        self.drop = drop_unpolished
        self.n_windows = len(polisher.windows)
        self._data: List[bytes] = []
        self._num_polished = 0

    def feed(self, i: int, w: Window
             ) -> Optional[Tuple[int, Optional[PolishedSequence]]]:
        p = self.p
        self._num_polished += 1 if w.polished else 0
        self._data.append(w.consensus or b"")
        last = (i == self.n_windows - 1) or (p.windows[i + 1].rank == 0)
        if not last:
            return None
        ratio = self._num_polished / (w.rank + 1)
        rec: Optional[PolishedSequence] = None
        if not self.drop or ratio > 0:
            data = b"".join(self._data)
            tags = "r" if p.type == PolisherType.kF else ""
            tags += f" LN:i:{len(data)}"
            tags += f" RC:i:{p.targets_coverages[w.id]}"
            tags += f" XC:f:{ratio:.6f}"
            rec = PolishedSequence(p.sequences[w.id].name + tags, data)
        self._num_polished = 0
        self._data = []
        return (w.id, rec)


def _filter_overlap_group(group: List[Overlap], error_threshold: float,
                          type_: PolisherType) -> List[Overlap]:
    """Drop high-error and self overlaps; in kC keep only the longest
    overlap per query (src/polisher.cpp:254-278 — the reference's pairwise
    elimination keeps the last occurrence of the maximum length)."""
    kept = [o for o in group
            if o.error <= error_threshold and o.q_id != o.t_id]
    if not kept or type_ != PolisherType.kC:
        return kept
    best = kept[0]
    for o in kept[1:]:
        if o.length >= best.length:
            best = o
    return [best]

