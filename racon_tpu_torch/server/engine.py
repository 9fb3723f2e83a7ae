"""The embeddable polishing engine: one library, thin frontends (port of
the JAX package's ``server/engine.py``).

The serial CLI (cli.py), the ledger worker (distributed/worker.py) and
the resident daemon (server/daemon.py) run the same sequence — build a Polisher from option values, initialize,
skip committed targets, drive ``Polisher.polish_records``, interleave
checkpoint re-emission with fresh records, commit each record durably.
:func:`polish_job` is the one implementation; frontends differ only in
the hooks they install.

:meth:`JobSpec.identity` is the single source of the output-affecting
config dict that feeds ``run_fingerprint``: the CLI's checkpoint store,
the daemon's job journal and the result cache all fingerprint through
it, key for key the JAX package's, so the same inputs and options give
the same fingerprint in both packages and a store either CLI wrote
resumes under the other's.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from racon_tpu_torch import __version__


class JobSpec:
    """Everything that defines one polishing job: the three input paths
    plus every output-affecting option, with the CLI's defaults.

    Execution knobs are deliberately NOT identity: ``backend`` (the
    device the job runs on, "cuda" or "cpu"; the JAX package's key, so
    journals and submit options keep their shape) and ``threads`` (the
    host aligner's). Both devices give the same bytes by design, so two
    runs differing only in how they execute share a fingerprint. A job
    runs on the card unless it asks for the CPU.
    """

    __slots__ = ("sequences", "overlaps", "targets", "include_unpolished",
                 "fragment_correction", "window_length",
                 "quality_threshold", "error_threshold", "match",
                 "mismatch", "gap", "backend", "threads")

    def __init__(self, sequences: str, overlaps: str, targets: str, *,
                 include_unpolished: bool = False,
                 fragment_correction: bool = False,
                 window_length: int = 500,
                 quality_threshold: float = 10.0,
                 error_threshold: float = 0.3, match: int = 5,
                 mismatch: int = -4, gap: int = -8,
                 backend: str = "cuda", threads: int = 1):
        self.sequences = sequences
        self.overlaps = overlaps
        self.targets = targets
        self.include_unpolished = bool(include_unpolished)
        self.fragment_correction = bool(fragment_correction)
        self.window_length = int(window_length)
        self.quality_threshold = float(quality_threshold)
        self.error_threshold = float(error_threshold)
        self.match = int(match)
        self.mismatch = int(mismatch)
        self.gap = int(gap)
        self.backend = backend
        self.threads = int(threads)

    @property
    def paths(self) -> List[str]:
        return [self.sequences, self.overlaps, self.targets]

    def identity(self) -> Dict[str, object]:
        """The output-affecting config dict, key for key the JAX
        package's."""
        return {
            "version": __version__,
            "include_unpolished": self.include_unpolished,
            "fragment_correction": self.fragment_correction,
            "window_length": self.window_length,
            "quality_threshold": self.quality_threshold,
            "error_threshold": self.error_threshold,
            "match": self.match,
            "mismatch": self.mismatch,
            "gap": self.gap,
        }

    def fingerprint(self) -> str:
        from racon_tpu_torch.resilience.checkpoint import run_fingerprint
        return run_fingerprint(self.identity(), self.paths)

    def scoring_key(self) -> tuple:
        """The key a warm engine, a batcher and a window memo are shared
        under: windows only share a dispatch with windows of the same
        scores on the same device."""
        return (self.match, self.mismatch, self.gap, self.backend,
                self.threads)

    # ------------------------------------------------------- serialization

    def as_dict(self) -> Dict[str, object]:
        """JSON-safe form for the daemon's job journal."""
        d = {"sequences": self.sequences, "overlaps": self.overlaps,
             "targets": self.targets}
        d.update({k: getattr(self, k) for k in self.__slots__[3:]})
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "JobSpec":
        kwargs = {k: d[k] for k in cls.__slots__[3:] if k in d}
        return cls(str(d["sequences"]), str(d["overlaps"]),
                   str(d["targets"]), **kwargs)


def build_polisher(spec: JobSpec, logger=None, engine=None):
    """Construct an (uninitialized) Polisher from a :class:`JobSpec` on
    the device ``spec.backend`` names (a CUDA request on a host without a
    GPU raises ``DeviceError``).

    ``engine``: optionally substitute a shared warm :class:`PoaEngine`
    (or the daemon's batching proxy) for the one the Polisher would
    build — the resident-process path.
    """
    from racon_tpu_torch.models.polisher import (PolisherType,
                                                 create_polisher)
    polisher = create_polisher(
        spec.sequences, spec.overlaps, spec.targets,
        PolisherType.kF if spec.fragment_correction else PolisherType.kC,
        spec.window_length, spec.quality_threshold, spec.error_threshold,
        spec.match, spec.mismatch, spec.gap, device=spec.backend,
        logger=logger, threads=spec.threads)
    if engine is not None:
        polisher.engine = engine
    return polisher


class JobHooks:
    """Per-record side-effect hooks threaded through :func:`polish_job`
    (no-op defaults). The CLI and the daemon use the middle three; the
    ledger worker (distributed/worker.py) installs lease renewal, its
    fault drills and the shard-split protocol through all six:

    - ``range_end(default)`` — the loop's current exclusive end; the
      worker returns its claim's end, which shrinks when a split donates
      the tail mid-run;
    - ``before_build(first_tid)`` — with the first uncommitted tid, just
      before the Polisher is built (the worker's claim-time split, before
      any window exists);
    - ``on_resume(n_committed, n_windows_skipped)`` — after committed
      targets were pruned (the CLI's resume stderr line);
    - ``before_commit(tid, rec)`` — before the record is emitted and
      committed (worker: ``dist/contig``, lease renewal, metric flush;
      daemon: cancellation check + ``serve/commit`` site);
    - ``after_commit(tid, rec)`` — after the durable commit (worker:
      dist accounting, the post-commit split);
    - ``before_fill(tid)`` — before each zero-window drop commit
      (worker: lease renewal).
    """

    def __init__(self, *, range_end: Optional[Callable] = None,
                 before_build: Optional[Callable] = None,
                 on_resume: Optional[Callable] = None,
                 before_commit: Optional[Callable] = None,
                 after_commit: Optional[Callable] = None,
                 before_fill: Optional[Callable] = None):
        self.range_end = range_end or (lambda default: default)
        self.before_build = before_build or (lambda first_tid: None)
        self.on_resume = on_resume or (lambda n_committed, n_skip: None)
        self.before_commit = before_commit or (lambda tid, rec: None)
        self.after_commit = after_commit or (lambda tid, rec: None)
        self.before_fill = before_fill or (lambda tid: None)


def polish_job(make_polisher: Callable, *, drop_unpolished: bool = True,
               store=None, tid_range: Optional[Tuple[int, int]] = None,
               emit: Optional[Callable[[bytes], None]] = None,
               fill_drops: bool = False,
               hooks: Optional[JobHooks] = None) -> int:
    """The one polish/commit/emit loop. Returns the number of targets in
    the job's final range.

    - ``store``: optional CheckpointStore; committed targets are
      pruned from compute and (when ``emit`` is set) re-emitted
      byte-identically from the shard, interleaved in input order with
      freshly polished records.
    - ``tid_range``: only the targets ``[start, end)`` (a ledger shard);
      None polishes them all. When every target of the range is
      committed, no Polisher is built.
    - ``emit``: byte sink for the FASTA stream (stdout for the CLI, the
      job's result spool for the daemon; the ledger worker passes None,
      its merge emits).
    - ``fill_drops``: commit targets that never reach the assembler
      (zero windows) as drops, so "every tid committed" is the
      completion invariant (the worker's and daemon's contract; the CLI
      keeps the JAX package CLI's manifests, which omit them).
    """
    from racon_tpu_torch.obs.metrics import record_ckpt

    hooks = hooks if hooks is not None else JobHooks()
    committed = store.committed if store is not None else {}
    if tid_range is not None:
        start, end = int(tid_range[0]), int(tid_range[1])
    else:
        start, end = 0, None
    next_tid = start

    def emit_stored(limit: int) -> None:
        # Re-emit committed contigs (exact shard bytes) for every target
        # slot before `limit`, so resumed output interleaves stored and
        # fresh targets in input order.
        nonlocal next_tid
        while next_tid < limit:
            if emit is not None and store is not None \
                    and next_tid in committed:
                blob = store.read_emitted(next_tid)
                if blob is not None:
                    emit(blob)
                record_ckpt("skip", next_tid,
                            len(blob) if blob else 0)
            next_tid += 1

    if end is None or any(tid not in committed
                          for tid in range(start, end)):
        first = start
        while first in committed:
            first += 1
        hooks.before_build(first)
        polisher = make_polisher()
        polisher.initialize()
        if end is None:
            end = polisher._targets_size
        if tid_range is not None:
            polisher.restrict_targets(range(start, end))
        n_skip = polisher.skip_targets(committed) if committed else 0
        hooks.on_resume(len(committed), n_skip)
        # Each contig is handled the moment its last window retires,
        # then durably committed before the next one.
        for tid, rec in polisher.polish_records(drop_unpolished):
            if tid >= hooks.range_end(end):
                break  # the range shrank under us (a split's donation)
            hooks.before_commit(tid, rec)
            emit_stored(tid)
            if emit is not None and rec is not None:
                emit(b">" + rec.name.encode() + b"\n" + rec.data + b"\n")
            if store is not None:
                if rec is not None:
                    store.commit(tid, rec.name.encode(), rec.data)
                else:
                    store.commit_dropped(tid)
            hooks.after_commit(tid, rec)
            next_tid = tid + 1
    else:
        hooks.on_resume(len(committed), 0)

    end = hooks.range_end(end)
    if fill_drops and store is not None:
        # Targets with zero windows never reach the assembler, so they
        # yield nothing above — commit them as drops explicitly, so a
        # done marker means every tid of the range is accounted for.
        for tid in range(start, end):
            if tid not in committed:
                hooks.before_fill(tid)
                store.commit_dropped(tid)
    emit_stored(end)
    return end - start


class EngineSession:
    """A resident process's warm state: the CUDA kernel library, built
    and loaded once (:meth:`activate`), and a pool of :class:`PoaEngine`
    instances keyed by :meth:`JobSpec.scoring_key`, shared across jobs.

    Window consensus is per-window deterministic and independent of
    batch composition, so sharing one engine — and mixing jobs' windows
    in its batches — cannot change any job's bytes.
    """

    def __init__(self):
        self._engines: Dict[tuple, object] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._activated = False  # guarded-by: _lock

    def activate(self) -> None:
        """Idempotently build and load the kernels (ops/kernels.py, one
        nvcc a source on first use) and the host aligner, so no job pays
        a compile inside a ``serve/dispatch`` deadline. On a host without
        a GPU only the host aligner loads; jobs that ask for the card
        then fail on their own."""
        with self._lock:
            if self._activated:
                return
            self._activated = True
        import torch
        from racon_tpu_torch.native.aligner import _load
        _load()
        if torch.cuda.is_available():
            from racon_tpu_torch.ops import kernels
            kernels._lib()

    def engine_for(self, spec: JobSpec):
        """The session's shared engine for this spec's scoring tuple (a
        CUDA request without a GPU raises ``DeviceError``)."""
        from racon_tpu_torch.ops.poa import PoaEngine
        key = spec.scoring_key()
        with self._lock:
            eng = self._engines.get(key)
            if eng is None:
                eng = PoaEngine(spec.match, spec.mismatch, spec.gap,
                                device=spec.backend, threads=spec.threads)
                self._engines[key] = eng
            return eng
