"""Journaled job lifecycle for the resident daemon (port of the JAX
package's ``server/jobs.py``; same journal).

Every submitted job owns one directory under ``<state-dir>/jobs/``:

- ``job.json`` — the journal record (schema, id, tenant, the full
  :class:`~racon_tpu_torch.server.engine.JobSpec`, current state, error),
  rewritten atomically at every state transition;
- ``ckpt/``    — a standard checkpoint-ledger store
  (resilience/checkpoint.py) holding every durably committed contig.

Together they make the daemon restartable by construction: after a
SIGKILL the journal says which jobs were in flight, and re-running each
through the engine's ``polish_job`` loop against its resumed store
re-emits the committed prefix byte-identically and polishes only the
remainder — the CLI's resume contract, reused rather than
reinvented.

Job ids are sequential (``j0001``, ``j0002``, ...), allocated as
max-existing + 1 so a restarted daemon never reuses or reorders ids —
no clocks, no randomness, nothing to collide after recovery.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

from racon_tpu_torch.obs.trace import TraceContext, parse_trace_ctx
from racon_tpu_torch.server.engine import JobSpec
from racon_tpu_torch.utils.atomicio import atomic_write_text

SCHEMA = 1
JOB_FILE = "job.json"
CKPT_DIR = "ckpt"

#: Lifecycle: queued -> running -> done | failed | cancelled.
STATES = ("queued", "running", "done", "failed", "cancelled")
TERMINAL = ("done", "failed", "cancelled")


class JobCancelled(Exception):
    """Raised inside a job's polish loop when its cancel flag is set."""


class Job:
    """One submitted polishing job: journal record + result stream.
    The stream is a :class:`~racon_tpu_torch.ava.emit.RecordSpool` — a plain
    in-memory chunk list for kC-sized results, spilling to a
    job-directory scratch file past ``RACON_TPU_SERVE_SPOOL_MB`` so an
    ava job's millions of records never pin millions of live objects.
    The spool is internally locked; runner appends and HTTP streamer
    reads interleave safely."""

    __slots__ = ("id", "tenant", "spec", "directory", "state", "error",
                 "error_type", "spool", "cancel", "finished",
                 "n_committed", "trace", "t_submit", "launches")

    def __init__(self, job_id: str, tenant: str, spec: JobSpec,
                 directory: str, state: str = "queued",
                 error: Optional[str] = None,
                 trace: Optional[TraceContext] = None):
        from racon_tpu_torch.ava.emit import RecordSpool
        self.id = job_id
        self.tenant = tenant
        self.spec = spec
        self.directory = directory
        self.state = state
        self.error = error
        #: The failing exception's class name (``DeviceError``,
        #: ``ServeError``, ...), or None.
        self.error_type: Optional[str] = None
        self.spool = RecordSpool(directory)
        self.cancel = threading.Event()
        self.finished = threading.Event()
        self.n_committed = 0
        #: Job-scoped trace context (obs/trace.py), minted at submit and
        #: journaled so a restarted daemon keeps the job's trace_id.
        self.trace = trace
        self.t_submit = 0.0
        #: Kernel launches the job's own thread made (its overlap
        #: alignment; its consensus runs in the batcher's dispatches).
        self.launches: Dict[str, int] = {}

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.directory, CKPT_DIR)

    # ------------------------------------------------------- results

    def emit(self, blob: bytes) -> None:
        """The ``polish_job`` byte sink — committed-prefix re-emission
        and fresh records arrive here in target order."""
        self.spool.append(blob)

    def result_bytes(self) -> bytes:
        return self.spool.read_all()

    # ------------------------------------------------------- journal

    def persist(self) -> None:
        """Atomically rewrite the journal record (state transition)."""
        record = {"schema": SCHEMA, "id": self.id,
                  "tenant": self.tenant, "state": self.state,
                  "error": self.error, "error_type": self.error_type,
                  "spec": self.spec.as_dict(),
                  "trace": self.trace.encode() if self.trace else ""}
        atomic_write_text(os.path.join(self.directory, JOB_FILE),
                          json.dumps(record, sort_keys=True) + "\n")

    @classmethod
    def load(cls, directory: str) -> "Job":
        with open(os.path.join(directory, JOB_FILE), "r",
                  encoding="utf-8") as fh:
            record = json.load(fh)
        if record.get("schema") != SCHEMA:
            raise ValueError(
                f"[racon_tpu_torch::serve] {directory}: unknown job journal "
                f"schema {record.get('schema')!r}")
        job = cls(str(record["id"]), str(record["tenant"]),
                  JobSpec.from_dict(record["spec"]), directory,
                  state=str(record["state"]),
                  error=record.get("error"),
                  trace=parse_trace_ctx(str(record.get("trace", ""))))
        job.error_type = record.get("error_type")
        return job

    def status(self) -> Dict[str, object]:
        """JSON-ready view for the HTTP status endpoints."""
        return {"id": self.id, "tenant": self.tenant,
                "state": self.state, "error": self.error,
                "error_type": self.error_type,
                "committed": self.n_committed,
                "bytes": self.spool.total_bytes,
                "trace": self.trace.encode() if self.trace else ""}


# ------------------------------------------------------------ directory

def allocate_id(jobs_root: str) -> str:
    """Next sequential job id under ``jobs_root`` (caller holds the
    server's submit lock)."""
    seq = 0
    if os.path.isdir(jobs_root):
        for name in os.listdir(jobs_root):
            if name.startswith("j") and name[1:].isdigit():
                seq = max(seq, int(name[1:]))
    return f"j{seq + 1:04d}"


def scan(jobs_root: str) -> List[Job]:
    """Load every journaled job, oldest first (restart recovery)."""
    out: List[Job] = []
    if not os.path.isdir(jobs_root):
        return out
    for name in sorted(os.listdir(jobs_root)):
        directory = os.path.join(jobs_root, name)
        if os.path.isfile(os.path.join(directory, JOB_FILE)):
            out.append(Job.load(directory))
    return out


def open_store(job: Job):
    """The job's checkpoint store: resumed when its meta exists (daemon
    restart), created fresh otherwise. Identity runs through
    JobSpec.fingerprint(), so a tampered input or edited spec refuses
    to resume instead of silently mixing outputs. Fresh stores for
    fragment-correction jobs get the v2 segmented manifest
    (ava.seg_targets_for); resumed stores keep whatever flavor their
    header records."""
    from racon_tpu_torch.ava import seg_targets_for
    from racon_tpu_torch.resilience.checkpoint import CheckpointStore
    fingerprint = job.spec.fingerprint()
    probe = CheckpointStore(job.ckpt_dir, fingerprint)
    if os.path.isfile(probe.meta_path):
        return CheckpointStore.resume(job.ckpt_dir, fingerprint)
    return CheckpointStore.create(
        job.ckpt_dir, fingerprint,
        segment_targets=seg_targets_for(job.spec.fragment_correction))


def rebuild_result(job: Job) -> None:
    """Reload a terminal job's emitted bytes from its store (restart
    made the in-memory stream empty). Committed shard slices are the
    exact originally emitted bytes, so the rebuilt stream is identical
    to what the pre-restart daemon served."""
    from racon_tpu_torch.resilience.checkpoint import CheckpointStore
    store = CheckpointStore.resume(job.ckpt_dir,
                                   job.spec.fingerprint())
    try:
        job.spool.reset()
        for tid in sorted(store.committed):
            blob = store.read_emitted(tid)
            if blob is not None:
                job.spool.append(blob)
        job.n_committed = len(store.committed)
    finally:
        store.close()
