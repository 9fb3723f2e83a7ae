"""The job→ledger adapter: one accepted JobSpec becomes one fleet run
(port of the JAX package's ``gateway/dispatch.py``).

Routing happens at the seam the daemon already owns
(``PolishServer._run_job``, after the Tier-1 cache probe): small jobs
stay on the resident in-process batcher, whose cross-request packing
serves them better, and large jobs (or any job arriving under queue
pressure) go to an autoscaled ledger fleet. The decision is pure policy
over two numbers:

- ``n_targets`` — the job's target count (a one-pass index scan of the
  targets file, the scan the ledger partitioner runs);
- ``queue_depth`` — jobs waiting on the daemon's admission semaphore.

``RACON_TPU_GATE_FLEET`` arms the fleet route;
``RACON_TPU_GATE_FLEET_MIN_TARGETS`` is the size threshold and
``RACON_TPU_GATE_QUEUE_PRESSURE`` the overflow override (a deep queue
routes even small jobs out). ``gate/route`` is the decision's fault
site. Fragment-correction jobs (``-f``) size by the targets file's bytes
(``RACON_TPU_GATE_FLEET_MIN_BYTES``) instead of its record count: every
read is a target there. The queue-pressure override applies to both.

A fleet run reuses the distributed plane (distributed/): its run
directory is keyed by the job fingerprint, so a resubmitted or adopted
job attaches to the same ledger and resumes to the same bytes, and a
finished ledger skips the fleet and replays ``out.fasta``. Spawned
workers run ``python -m racon_tpu_torch.cli`` on the device the job
names and inherit two pieces of shared state through the environment:
the job's trace context (``RACON_TPU_TRACE_CTX``) and the fleet-shared
result CAS (``RACON_TPU_CACHE_DIR`` under the gateway root). The JAX
package also hands its workers a shared XLA compile cache, and its
``FleetPaths`` names that pool; on CUDA nothing compiles per shape, and
every worker loads the one kernel library built from ``csrc/`` under the
checkout's ``build/`` directory (built once, under a content-hash name,
by whichever process needs it first), so the layout has no pool and no
variable is set for it.

The merged FASTA is re-committed contig by contig into the job's own
checkpoint store in the emit-then-commit order ``polish_job`` uses, so
``/stream``, the journal, restart recovery and the daemon's cache treat
a fleet job exactly like a local one. No fallback: a fleet run that
cannot produce the job's bytes raises :class:`FleetDispatchError` and
the job fails; it is never served locally.
"""

from __future__ import annotations

import functools
import io
import os
import time
from typing import List, NamedTuple

from racon_tpu_torch.resilience.faults import maybe_fault
from racon_tpu_torch.utils import env

ENV_GATE_FLEET = env.GATE_FLEET
ENV_MIN_TARGETS = env.GATE_FLEET_MIN_TARGETS
ENV_MIN_BYTES = env.GATE_FLEET_MIN_BYTES
ENV_QUEUE_PRESSURE = env.GATE_QUEUE_PRESSURE
ENV_GATE_WORKERS = env.GATE_WORKERS

FLEET_SUBDIR = "fleet"
CAS_SUBDIR = "cas"


class FleetDispatchError(RuntimeError):
    """A fleet run that cannot produce the job's bytes (the supervisor
    failed, or no merged output). The job fails; the ledger keeps
    whatever was committed for the next attempt to resume."""


class RouteDecision(NamedTuple):
    route: str          # "fleet" | "local"
    reason: str         # human-readable policy clause that fired
    n_targets: int
    queue_depth: int
    target_bytes: int = 0  # ava size signal (0 for count-routed jobs)


class FleetPaths(NamedTuple):
    root: str        # <state>/fleet — shared across every fleet job
    run_dir: str     # <root>/<fp16> — one job fingerprint, one run
    ledger_dir: str  # <run>/ledger — the WorkLedger workers attach to
    cas_dir: str     # <root>/cas — fleet-shared result CAS


def fleet_enabled() -> bool:
    return env.read(ENV_GATE_FLEET).strip().lower() \
        not in ("", "0", "false", "off")


def count_targets(targets_path: str) -> int:
    """The job's target count — the routing policy's size signal, from
    the streaming index scan the ledger partitioner uses."""
    from racon_tpu_torch.io.parsers import scan_sequence_index
    n_records, _offsets = scan_sequence_index(targets_path)
    return n_records


def target_stats(targets_path: str) -> "tuple":
    """(target count, targets-file byte size) — the two routing size
    signals. The byte size is a stat, not a scan: it overstates sequence
    bytes by the headers (and qualities), which a threshold tolerates."""
    return count_targets(targets_path), os.path.getsize(targets_path)


def decide_route(spec, n_targets: int, queue_depth: int = 0,
                 target_bytes: int = 0) -> RouteDecision:
    """Pure routing policy. Fleet when armed and (the job is large
    enough, or the daemon's queue is deep enough that shipping even a
    small job out beats waiting). Fragment-correction jobs measure
    "large enough" in target bytes, every other job in target count.
    ``gate/route`` fires before the decision is read."""
    maybe_fault("gate/route")
    ava = bool(getattr(spec, "fragment_correction", False))
    if not fleet_enabled():
        return RouteDecision("local", "fleet-disabled", n_targets,
                             queue_depth, target_bytes)
    pressure = max(1, int(env.read(ENV_QUEUE_PRESSURE)))
    if ava:
        min_bytes = max(1, int(env.read(ENV_MIN_BYTES)))
        if target_bytes >= min_bytes:
            return RouteDecision(
                "fleet", f"target_bytes {target_bytes} >= {min_bytes}",
                n_targets, queue_depth, target_bytes)
        if queue_depth >= pressure:
            return RouteDecision(
                "fleet", f"queue_depth {queue_depth} >= {pressure}",
                n_targets, queue_depth, target_bytes)
        return RouteDecision(
            "local", f"target_bytes {target_bytes} < {min_bytes}",
            n_targets, queue_depth, target_bytes)
    min_targets = max(1, int(env.read(ENV_MIN_TARGETS)))
    if n_targets >= min_targets:
        return RouteDecision(
            "fleet", f"n_targets {n_targets} >= {min_targets}",
            n_targets, queue_depth, target_bytes)
    if queue_depth >= pressure:
        return RouteDecision(
            "fleet", f"queue_depth {queue_depth} >= {pressure}",
            n_targets, queue_depth, target_bytes)
    return RouteDecision(
        "local", f"n_targets {n_targets} < {min_targets}", n_targets,
        queue_depth, target_bytes)


def fleet_paths(state_dir: str, fingerprint: str) -> FleetPaths:
    """The on-disk layout of one fleet job. The run dir is keyed by the
    job fingerprint (resubmission and standby adoption land on the same
    ledger); the result CAS is shared by every run under this
    gateway."""
    root = os.path.join(state_dir, FLEET_SUBDIR)
    run_dir = os.path.join(root, fingerprint[:16])
    return FleetPaths(
        root=root,
        run_dir=run_dir,
        ledger_dir=os.path.join(run_dir, "ledger"),
        cas_dir=os.path.join(root, CAS_SUBDIR),
    )


def worker_cli_argv(spec, ledger_dir: str, workers: int) -> List[str]:
    """The CLI argv an autoscaled fleet worker runs for ``spec``: the
    identity flags (JobSpec.identity() is the fingerprint contract, so
    the workers' run fingerprint matches the daemon's and the ledger
    refuses nothing), the device (``--device``, the execution knob the
    JAX package passes as ``--backend``; not part of the identity) and
    the shared ledger."""
    argv = list(spec.paths)
    if spec.include_unpolished:
        argv.append("--include-unpolished")
    if spec.fragment_correction:
        argv.append("--fragment-correction")
    argv += ["--window-length", str(spec.window_length),
             "--quality-threshold", str(spec.quality_threshold),
             "--error-threshold", str(spec.error_threshold),
             "--match", str(spec.match),
             "--mismatch", str(spec.mismatch),
             "--gap", str(spec.gap),
             "--threads", str(spec.threads),
             "--device", spec.backend,
             "--ledger-dir", ledger_dir,
             "--workers", str(max(1, int(workers)))]
    return argv


def run_fleet_job(job, state_dir: str, store, *,
                  trace_ctx: str = "", log=None) -> int:
    """Run ``job`` on an autoscaled ledger fleet and stream the merged
    result through the job's own emit/commit path. Returns the number
    of contigs committed. Raises :class:`FleetDispatchError` when no
    merged output can be produced.

    The supervisor runs in the caller's (the job runner's) thread and
    makes no CUDA context: only its worker processes use the card."""
    from racon_tpu_torch.ava.emit import iter_fasta_records
    from racon_tpu_torch.distributed.autoscaler import Autoscaler
    from racon_tpu_torch.gateway.policy import service_target
    from racon_tpu_torch.obs.metrics import record_gate
    from racon_tpu_torch.server.jobs import JobCancelled

    spec = job.spec
    paths = fleet_paths(state_dir, spec.fingerprint())
    out_path = os.path.join(paths.ledger_dir, "out.fasta")
    workers = max(1, int(env.read(ENV_GATE_WORKERS)))
    t0 = time.perf_counter()
    trace_id = job.trace.trace_id if job.trace else "-"
    parent_id = job.trace.parent_id if job.trace else 0

    if not os.path.isfile(out_path):
        for d in (paths.ledger_dir, paths.cas_dir):
            os.makedirs(d, exist_ok=True)
        # Fleet-shared result CAS: workers probe and store per-shard
        # contig records keyed by shard fingerprint, so a re-run of this
        # fingerprint polishes nothing.
        extra_env = {env.CACHE_DIR: paths.cas_dir}
        if trace_ctx:
            extra_env[env.TRACE_CTX] = trace_ctx
        # Size the fleet from service signals (queue depth, queue-wait
        # p95, the fleet's drain rate), not only open shards.
        scaler = Autoscaler(
            paths.ledger_dir,
            worker_cli_argv(spec, paths.ledger_dir, workers),
            default_max=workers, out=io.BytesIO(), log=log,
            extra_env=extra_env,
            target_fn=functools.partial(service_target,
                                        ledger_dir=paths.ledger_dir),
            trace_dir=os.path.join(paths.ledger_dir, "obs"))
        rc = scaler.run()
        if rc != 0:
            raise FleetDispatchError(
                f"[racon_tpu_torch::gate] fleet supervisor for job "
                f"{job.id} exited {rc} (ledger: {paths.ledger_dir})")
    if not os.path.isfile(out_path):
        raise FleetDispatchError(
            f"[racon_tpu_torch::gate] fleet run for job {job.id} finished "
            f"without a merged output at {out_path}")
    # Re-commit the merged result through the job's own store in
    # polish_job's emit-then-commit order. serve/commit keeps its
    # meaning ("one contig became durable in this job's store") whichever
    # path computed it. Records stream off the merged file one at a time.
    n = 0
    committed = len(store.committed)
    for tid, rec in enumerate(iter_fasta_records(out_path)):
        if tid < committed:
            # Adoption or restart: the committed prefix re-emits from
            # the store byte for byte, with no recompute.
            stored = store.read_emitted(tid)
            if stored is not None:
                job.emit(stored)
            n += 1
            continue
        if job.cancel.is_set():
            raise JobCancelled(job.id)
        maybe_fault("serve/commit")
        nl = rec.index(b"\n")
        job.emit(rec)
        store.commit(tid, bytes(rec[1:nl]), bytes(rec[nl + 1:-1]))
        n += 1
    record_gate("fleet_run", job.id, job.tenant, trace_id=trace_id,
                parent_id=parent_id, decision="fleet",
                wall_s=round(time.perf_counter() - t0, 6),
                contigs=n, workers=workers)
    return n
