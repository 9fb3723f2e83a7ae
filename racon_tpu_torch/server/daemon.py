"""Polishing-as-a-service: the resident multi-tenant daemon (port of the
JAX package's ``server/daemon.py``; same HTTP surface, journal and state
dir).

    python -m racon_tpu_torch.server --state-dir DIR [--port 0]

One long-lived process owns the warm state a one-shot CLI pays for on
every invocation — the CUDA kernel library (built and loaded once by
:meth:`EngineSession.activate`) and the shared :class:`PoaEngine` pool —
and serves polishing jobs over a local HTTP API:

- ``POST /v1/jobs``              submit ``{tenant, sequences, overlaps,
  targets, options}`` → ``{id}``; the job is journaled before the
  response leaves (``serve/submit`` fault site). ``options`` are
  :class:`JobSpec`'s keywords; ``backend`` names the device ("cuda",
  the default, or "cpu").
- ``GET  /v1/jobs``              list jobs; ``GET /v1/jobs/<id>`` one
  job's status.
- ``GET  /v1/jobs/<id>/stream``  the job's FASTA bytes so far —
  byte-identical to a solo CLI run of the same inputs.
- ``POST /v1/jobs/<id>/cancel``  cooperative cancel at the next contig
  boundary (committed work is kept).
- ``GET  /healthz``              watchdog liveness + a ``serve`` view
  (job table, active count); anything else serves the OpenMetrics
  registry render.

Every job runs the CLI's engine loop (``polish_job``) against its own
checkpoint store: its overlap alignment on its own thread, on the card
(kernels K1, K3 and W1), and its consensus through the shared
:class:`~racon_tpu_torch.server.batch.CrossRequestBatcher` — many jobs,
one dispatch stream, full batches. Restart recovery is the checkpoint
contract: on startup every non-terminal journaled job is re-queued
(``serve_jobs_resumed``), its committed prefix re-emitted from the shard
byte for byte, and only the remainder polished.

The daemon forces the in-process streaming pipeline off: concurrency
comes from jobs sharing the batcher, not from stages inside one job, so
the dispatcher thread stays the only thread running consensus.

The content-addressed result cache (cache/) is armed by default
(``RACON_TPU_CACHE=0`` disables): a fresh job whose fingerprint hits the
job-level CAS replays its verified contig records straight into its
store and stream — zero kernel launches — and every batcher carries a
window memo.

No fallback hides the card. A job that asks for the card on a host
without one fails with a ``DeviceError`` in its status; a dispatch that
fails with a ``KernelError`` or ``torch.AcceleratorError`` (a sticky
CUDA error: the context is unusable), or with a watchdog breach that no
injected fault caused (the dispatch runs on, abandoned), fails its jobs,
every later job fails without running, the daemon stops admitting and
``main`` exits 1. An ``InjectedFault``, an injected breach or another
``TimeoutError`` at ``serve/dispatch`` fails that batch's jobs only.

With ``RACON_TPU_GATE_FLEET`` armed, a job large enough (or arriving
under queue pressure) runs on an autoscaled ledger fleet instead
(gateway/dispatch.py): its worker processes run the CLI on the job's
device, and the merged FASTA is committed into the job's store like a
local result. A fleet run that fails fails its job with
``FleetDispatchError``; it is never served locally.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from racon_tpu_torch.cache import (ResultCache, WindowMemo, cache_dir_for,
                                   cache_enabled, records_from_store,
                                   replay_records, window_memo_enabled)
from racon_tpu_torch.server.batch import (BatchedEngineProxy,
                                          CrossRequestBatcher, device_lost)
from racon_tpu_torch.server.engine import (EngineSession, JobHooks,
                                           JobSpec, build_polisher,
                                           polish_job)
from racon_tpu_torch.server.jobs import (TERMINAL, Job, JobCancelled,
                                         allocate_id, open_store,
                                         rebuild_result, scan)
from racon_tpu_torch.utils import env
from racon_tpu_torch.utils.atomicio import atomic_write_text

ENV_MAX_JOBS = env.SERVE_MAX_JOBS
ENV_GRACE = env.SERVE_GRACE_S

PORT_FILE = "port"


class PolishServer:
    """Job table + engine session + per-scoring-key batchers. All HTTP
    handlers and runner threads converge here; ``_lock`` guards the
    table and batcher pool, never held across polishing work.

    ``stopped`` is set when the device is lost (:attr:`fatal`); the
    daemon's ``main`` waits on it beside its signals."""

    def __init__(self, state_dir: str):
        self.state_dir = state_dir
        self.jobs_root = os.path.join(state_dir, "jobs")
        os.makedirs(self.jobs_root, exist_ok=True)
        self.session = EngineSession()
        self._jobs: Dict[str, Job] = {}            # guarded-by: _lock
        # guarded-by: _lock
        self._batchers: Dict[Tuple, CrossRequestBatcher] = {}
        self._threads: List[threading.Thread] = []  # guarded-by: _lock
        self._n_done = 0                            # guarded-by: _lock
        self._queued = 0                            # guarded-by: _lock
        self._draining = False                      # guarded-by: _lock
        #: The sticky device error that ended serving, or None.
        self.fatal: Optional[BaseException] = None  # guarded-by: _lock
        self.stopped = threading.Event()
        self._lock = threading.Lock()
        self._sem = threading.BoundedSemaphore(
            max(1, int(env.read(ENV_MAX_JOBS))))
        self._t0 = time.perf_counter()
        # Tier-1 CAS, on by default for the daemon; the constructor
        # reloads the atomically-published index.
        self.cache: Optional[ResultCache] = None
        if cache_enabled():
            self.cache = ResultCache(cache_dir_for(state_dir))

    # ------------------------------------------------------- lifecycle

    def recover(self) -> int:
        """Re-queue every journaled non-terminal job (daemon restart).
        Terminal jobs rejoin the table read-only, their result streams
        rebuilt from their stores so /stream keeps serving the exact
        pre-restart bytes. Returns the number of jobs resumed."""
        from racon_tpu_torch.obs.metrics import record_serve_job
        from racon_tpu_torch.obs.trace import mint_trace_context
        resumed = 0
        for job in scan(self.jobs_root):
            with self._lock:
                self._jobs[job.id] = job
            if job.state in TERMINAL:
                job.finished.set()
                if job.state == "done":
                    rebuild_result(job)
                continue
            job.state = "queued"
            job.t_submit = time.perf_counter()
            sid = record_serve_job(
                "resumed", job.id, job.tenant,
                trace_id=job.trace.trace_id if job.trace
                else mint_trace_context(job.spec.fingerprint()).trace_id,
                parent_id=job.trace.parent_id if job.trace else 0)
            if job.trace is None:
                job.trace = mint_trace_context(job.spec.fingerprint(),
                                               parent_id=sid)
            job.persist()
            resumed += 1
            self._launch(job)
        self._update_gauges()
        return resumed

    def drain(self, grace_s: Optional[float] = None) -> bool:
        """Stop admitting, let in-flight jobs finish within the grace
        window, then stop the batchers. Returns True when every runner
        exited in time (the clean-SIGTERM contract)."""
        grace = float(env.read(ENV_GRACE)) if grace_s is None \
            else float(grace_s)
        with self._lock:
            self._draining = True
            threads = list(self._threads)
            batchers = list(self._batchers.values())
        deadline = time.perf_counter() + grace
        clean = True
        for t in threads:
            t.join(max(0.0, deadline - time.perf_counter()))
            clean = clean and not t.is_alive()
        for b in batchers:
            b.close()
        return clean

    def _on_fatal(self, exc: BaseException) -> None:
        """The device is lost (a sticky CUDA error or a terminal breach):
        stop admitting and wake ``main``, which exits non-zero."""
        with self._lock:
            if self.fatal is None:
                self.fatal = exc
            self._draining = True
        print(f"[racon_tpu_torch::serve] device lost, no longer serving: "
              f"{exc}", file=sys.stderr)
        self.stopped.set()

    # ---------------------------------------------------------- job API

    def submit(self, tenant: str, spec: JobSpec) -> Job:
        from racon_tpu_torch.obs.metrics import record_serve_job
        from racon_tpu_torch.obs.trace import mint_trace_context
        from racon_tpu_torch.resilience.faults import maybe_fault
        maybe_fault("serve/submit")
        with self._lock:
            if self.fatal is not None:
                raise RuntimeError(
                    "[racon_tpu_torch::serve] the device was lost; "
                    "not accepting jobs")
            if self._draining:
                raise RuntimeError(
                    "[racon_tpu_torch::serve] daemon is draining; "
                    "not accepting jobs")
            job_id = allocate_id(self.jobs_root)
            directory = os.path.join(self.jobs_root, job_id)
            os.makedirs(directory, exist_ok=True)
            job = Job(job_id, str(tenant), spec, directory)
            self._jobs[job_id] = job
        # The "submitted" point is the job's root span.
        ctx = mint_trace_context(spec.fingerprint())
        sid = record_serve_job("submitted", job.id, job.tenant,
                               trace_id=ctx.trace_id)
        job.trace = mint_trace_context(spec.fingerprint(), parent_id=sid)
        job.t_submit = time.perf_counter()
        # Journaled BEFORE the submit response: a daemon killed right
        # after replying still knows about the job on restart.
        job.persist()
        self._update_gauges()
        self._launch(job)
        return job

    def cancel(self, job_id: str) -> Job:
        job = self.get(job_id)
        if job.state not in TERMINAL:
            job.cancel.set()
        return job

    def get(self, job_id: str) -> Job:
        with self._lock:
            job = self._jobs.get(job_id)
        if job is None:
            raise KeyError(job_id)
        return job

    def describe(self) -> Dict[str, object]:
        with self._lock:
            jobs = sorted(self._jobs.values(), key=lambda j: j.id)
            draining = self._draining
            fatal = self.fatal
        active = sum(1 for j in jobs if j.state not in TERMINAL)
        return {"jobs": [j.status() for j in jobs], "active": active,
                "draining": draining,
                "device_lost": None if fatal is None else str(fatal)}

    def batchers(self) -> List[CrossRequestBatcher]:
        with self._lock:
            return list(self._batchers.values())

    # ----------------------------------------------------------- runner

    def _launch(self, job: Job) -> None:
        t = threading.Thread(target=self._run_job, args=(job,),
                             name=f"serve-{job.id}", daemon=True)
        with self._lock:
            self._threads.append(t)
        t.start()

    def _batcher_for(self, spec: JobSpec) -> CrossRequestBatcher:
        # One batcher per scoring key: windows only ever share a
        # dispatch with windows of the same scores on the same device.
        key = spec.scoring_key()
        with self._lock:
            b = self._batchers.get(key)
            if b is None:
                engine = self.session.engine_for(spec)
                memo = None
                if self.cache is not None and window_memo_enabled():
                    memo = WindowMemo(
                        key,
                        spill_dir=self.cache.window_spill_dir(key))
                b = self._batchers[key] = CrossRequestBatcher(
                    engine, memo=memo, on_fatal=self._on_fatal).start()
            return b

    def _route(self, job: Job, store):
        """The gateway routing decision for one admitted job: in-process
        batcher or autoscaled ledger fleet, from the job's target count
        (or, for ``-f`` jobs, the targets file's bytes) and the current
        admission queue depth. Recorded as a ``gate`` span and counter,
        so the job's timeline shows the decision between submit and
        run."""
        from racon_tpu_torch.gateway.dispatch import (decide_route,
                                                      fleet_enabled,
                                                      fleet_paths,
                                                      target_stats)
        from racon_tpu_torch.obs.metrics import record_gate
        n_targets = target_bytes = 0
        if fleet_enabled():
            try:
                n_targets, target_bytes = target_stats(job.spec.targets)
            except Exception:
                n_targets = target_bytes = 0  # unreadable inputs fail
                #                               later, locally
        with self._lock:
            depth = self._queued
        decision = decide_route(job.spec, n_targets, depth,
                                target_bytes=target_bytes)
        if decision.route == "fleet" and store.committed:
            # A job that started locally (a committed prefix but no
            # fleet run dir) finishes locally: a local store numbers
            # every target (dropped ones included), the fleet replay
            # numbers emitted contigs densely, and mixing the two would
            # corrupt the resume.
            run_dir = fleet_paths(self.state_dir,
                                  job.spec.fingerprint()).run_dir
            if not os.path.isdir(run_dir):
                decision = decision._replace(
                    route="local", reason="resume-local-prefix")
        record_gate("route_fleet" if decision.route == "fleet"
                    else "route_local", job.id, job.tenant,
                    trace_id=job.trace.trace_id if job.trace else "-",
                    parent_id=job.trace.parent_id if job.trace else 0,
                    decision=decision.route, reason=decision.reason,
                    n_targets=decision.n_targets,
                    queue_depth=decision.queue_depth,
                    target_bytes=decision.target_bytes)
        return decision

    def _run_fleet(self, job: Job, store) -> None:
        """Run one fleet-routed job through the gateway's adapter, in
        this runner thread (the supervisor makes no CUDA context; its
        worker processes hold the card). The caller finishes it exactly
        like a local run: the same journal states, the same cache store,
        ``n_committed`` from the store."""
        from racon_tpu_torch.gateway.dispatch import run_fleet_job
        run_fleet_job(job, self.state_dir, store,
                      trace_ctx=job.trace.encode() if job.trace else "",
                      log=sys.stderr)

    def _run_job(self, job: Job) -> None:
        """The job's thread. ``job.launches`` holds its thread's kernel
        counts at the start; :meth:`_finish`, on this thread, turns them
        into the job's own launches (its overlap alignment) before the
        job reads as finished."""
        from racon_tpu_torch.ops import kernels
        job.launches = kernels.thread_launches()
        self._run_job_body(job)

    def _run_job_body(self, job: Job) -> None:
        from racon_tpu_torch.obs.metrics import record_hist
        from racon_tpu_torch.resilience.faults import maybe_fault
        with self._lock:
            self._queued += 1
        with self._sem:
            with self._lock:
                self._queued -= 1
                fatal = self.fatal
            if job.t_submit:
                record_hist("serve_queue_wait_s",
                            time.perf_counter() - job.t_submit)
            if job.cancel.is_set():
                self._finish(job, "cancelled", None)
                return
            if fatal is not None:
                self._finish(job, "failed", RuntimeError(
                    f"[racon_tpu_torch::serve] the device was lost: "
                    f"{fatal}"))
                return
            job.state = "running"
            job.persist()
            try:
                store = open_store(job)
            except Exception as exc:
                self._finish(job, "failed", exc)
                return
            job.n_committed = len(store.committed)
            if self.cache is not None and not store.committed:
                # Tier-1 probe (fresh jobs only): a verified CAS hit
                # replays the whole result through the same
                # emit-then-commit order polish_job uses — zero kernel
                # launches.
                records = self.cache.load(job.spec.fingerprint())
                if records is not None:
                    try:
                        replay_records(records, emit=job.emit,
                                       store=store)
                    except Exception as exc:
                        job.n_committed = len(store.committed)
                        store.close()
                        self._finish(job, "failed", exc)
                        return
                    job.n_committed = len(store.committed)
                    store.close()
                    self._finish(job, "done", None)
                    return

            def before_commit(tid, rec):
                if job.cancel.is_set():
                    raise JobCancelled(job.id)
                maybe_fault("serve/commit")

            def after_commit(tid, rec):
                job.n_committed += 1

            state, error = "done", None
            try:
                if self._route(job, store).route == "fleet":
                    self._run_fleet(job, store)
                else:
                    proxy = BatchedEngineProxy(
                        self._batcher_for(job.spec), job.id, job.tenant,
                        trace=job.trace)

                    def make_polisher():
                        return build_polisher(job.spec, engine=proxy)

                    polish_job(
                        make_polisher,
                        drop_unpolished=not job.spec.include_unpolished,
                        store=store, emit=job.emit, fill_drops=True,
                        hooks=JobHooks(before_commit=before_commit,
                                       after_commit=after_commit))
            except JobCancelled:
                state = "cancelled"
            except Exception as exc:
                state, error = "failed", exc
                if device_lost(exc):
                    self._on_fatal(exc)
            else:
                if self.cache is not None:
                    # The job outcome is never coupled to cache health.
                    try:
                        self.cache.store(job.spec.fingerprint(),
                                         records_from_store(store))
                    except Exception as exc:
                        print(f"[racon_tpu_torch::serve] cache store "
                              f"failed for job {job.id}: {exc}",
                              file=sys.stderr)
            finally:
                job.n_committed = len(store.committed)
                store.close()
            self._finish(job, state, error)

    def _finish(self, job: Job, state: str,
                error: Optional[BaseException]) -> None:
        from racon_tpu_torch.obs.metrics import (record_hist,
                                                 record_serve_job)
        from racon_tpu_torch.ops import kernels
        after, base = kernels.thread_launches(), job.launches
        job.launches = {k: n - base.get(k, 0) for k, n in after.items()
                        if n != base.get(k, 0)}
        job.state = state
        job.error = None if error is None else str(error)
        job.error_type = None if error is None else type(error).__name__
        job.persist()
        if state == "done":
            with self._lock:
                self._n_done += 1
        if job.t_submit:
            record_hist("serve_job_latency_s",
                        time.perf_counter() - job.t_submit)
        record_serve_job("completed" if state == "done" else state,
                         job.id, job.tenant,
                         trace_id=job.trace.trace_id if job.trace else "-",
                         parent_id=job.trace.parent_id if job.trace else 0)
        self._update_gauges()
        # Last: anyone woken by the event sees the journal, metrics,
        # and gauges already final.
        job.finished.set()

    def _update_gauges(self) -> None:
        from racon_tpu_torch.obs.metrics import (set_serve_active,
                                                 set_serve_rate)
        with self._lock:
            active = sum(1 for j in self._jobs.values()
                         if j.state not in TERMINAL)
            n_done = self._n_done
        set_serve_active(active)
        minutes = max((time.perf_counter() - self._t0) / 60.0, 1e-9)
        set_serve_rate(n_done / minutes)


# --------------------------------------------------------------- HTTP

def serve_http(server: PolishServer, host: str, port: int):
    """Bind the daemon's HTTP front end (daemon thread): the job API as
    routes of obs/export.serve_metrics, which serves ``/healthz`` (the
    watchdog's health with the daemon's jobs) and the metrics at every
    other GET path. Returns the stdlib server; its ``server_address``
    carries the bound port."""
    from racon_tpu_torch.obs.export import render_registry, serve_metrics
    from racon_tpu_torch.obs.metrics import registry
    from racon_tpu_torch.resilience.watchdog import health_snapshot

    def _json(code: int, obj) -> tuple:
        return (code, (json.dumps(obj, sort_keys=True) + "\n").encode(),
                "application/json", ())

    def _health() -> dict:
        snap = dict(health_snapshot())
        snap["serve"] = server.describe()
        if server.fatal is not None and snap.get("status") == "ok":
            snap["status"] = "device-lost"
        return snap

    def _get(path: str):
        if path == "/v1/jobs":
            return _json(200, server.describe())
        if path.startswith("/v1/jobs/") and path.endswith("/stream"):
            job = server.get(path.split("/")[3])
            return (200, job.result_bytes(), "application/octet-stream",
                    [("X-Racon-State", job.state)])
        if path.startswith("/v1/jobs/"):
            return _json(200, server.get(path.split("/")[3]).status())
        return None

    def _post(path: str, body: bytes):
        if path == "/v1/jobs":
            req = json.loads(body or b"{}")
            spec = JobSpec(str(req["sequences"]), str(req["overlaps"]),
                           str(req["targets"]), **req.get("options", {}))
            job = server.submit(req.get("tenant", "default"), spec)
            return _json(202, {"id": job.id, "state": job.state})
        if path.startswith("/v1/jobs/") and path.endswith("/cancel"):
            return _json(200, server.cancel(path.split("/")[3]).status())
        return None

    def routes(method: str, path: str, body: bytes):
        try:
            return _get(path) if method == "GET" else _post(path, body)
        except KeyError:
            return _json(404, {"error": "no such job"})
        except (ValueError, RuntimeError, TypeError) as exc:
            if method == "GET":
                raise
            return _json(400, {"error": str(exc)})

    return serve_metrics(port, lambda: render_registry(
        registry().snapshot()), host=host, health=_health, routes=routes,
        name="serve-http")


# --------------------------------------------------------------- entry

def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import signal

    parser = argparse.ArgumentParser(
        prog="python -m racon_tpu_torch.server",
        description="racon_tpu_torch resident polishing daemon")
    parser.add_argument("--state-dir", required=True,
                        help="job journal + checkpoint root")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0,
                        help="HTTP port (0 = ephemeral; the bound port "
                             "is published to <state-dir>/port)")
    parser.add_argument("--standby", action="store_true",
                        help="block until the gateway lease over "
                             "state-dir can be acquired (adopting a "
                             "dead primary's in-flight jobs), instead "
                             "of failing when one is held")
    args = parser.parse_args(argv)

    from racon_tpu_torch.obs.metrics import record_gate, registry
    from racon_tpu_torch.obs.trace import configure as configure_trace
    from racon_tpu_torch.pipeline import configure as configure_pipeline
    tracer = configure_trace()
    # Jobs share the card through the batcher, not through in-job
    # pipeline stages — the dispatcher stays the only consensus thread.
    configure_pipeline(0)

    # Gateway lease (gateway/ha.py): exactly one daemon owns a state dir
    # at a time; a --standby replica blocks until the primary dies or
    # hands off, then adopts its journaled in-flight jobs (recover()).
    from racon_tpu_torch.gateway.ha import GatewayLease, GatewayLeaseLost
    os.makedirs(args.state_dir, exist_ok=True)
    lease = GatewayLease(args.state_dir, owner=f"gw{os.getpid()}")
    if args.standby:
        lease.acquire()
    elif not lease.try_acquire():
        print(f"[racon_tpu_torch::serve] another gateway holds the lease "
              f"on {args.state_dir} (use --standby to wait and adopt)",
              file=sys.stderr)
        return 1
    if lease.adopted:
        print(f"[racon_tpu_torch::serve] adopted state dir "
              f"{args.state_dir} from a dead primary (lease epoch "
              f"{lease.epoch})", file=sys.stderr)

    server = PolishServer(args.state_dir)
    server.session.activate()
    resumed = server.recover()
    if lease.adopted:
        adopted_jobs = [j for j in server.describe()["jobs"]
                        if j["state"] in ("queued", "running")]
        if adopted_jobs:
            for st in adopted_jobs:
                job = server.get(st["id"])
                record_gate("adopt", job.id, job.tenant,
                            trace_id=job.trace.trace_id if job.trace
                            else "-",
                            parent_id=job.trace.parent_id if job.trace
                            else 0, epoch=lease.epoch)
        else:
            record_gate("adopt", "-", "-", epoch=lease.epoch)
    if resumed:
        print(f"[racon_tpu_torch::serve] resumed {resumed} in-flight "
              f"job(s)", file=sys.stderr)

    # Renewal loop: the moment our nonce is gone (a standby fenced us)
    # the only safe reaction is a hard exit.
    lease_stop = threading.Event()

    def _renew_loop():
        while not lease_stop.wait(max(0.05, lease.lease_s / 3.0)):
            try:
                lease.renew()
            except GatewayLeaseLost as exc:
                print(str(exc), file=sys.stderr)
                os._exit(75)

    threading.Thread(target=_renew_loop, name="gateway-lease",
                     daemon=True).start()

    try:
        httpd = serve_http(server, args.host, args.port)
    except OSError as exc:
        print(f"[racon_tpu_torch::serve] cannot bind {args.host}:"
              f"{args.port}: {exc}", file=sys.stderr)
        return 1
    port = httpd.server_address[1]
    atomic_write_text(os.path.join(args.state_dir, PORT_FILE),
                      f"{port}\n")
    print(f"[racon_tpu_torch::serve] listening on {args.host}:{port} "
          f"(state: {args.state_dir})", file=sys.stderr)

    def _on_signal(signum, frame):
        server.stopped.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    server.stopped.wait()

    print("[racon_tpu_torch::serve] draining...", file=sys.stderr)
    httpd.shutdown()
    clean = server.drain()
    lease_stop.set()
    try:
        lease.release()
    except OSError:
        pass
    # Flight recorder dump (obs/flightrec.py): lands in
    # RACON_TPU_OBS_DIR when set, else a silent no-op.
    from racon_tpu_torch.obs import flightrec
    flightrec.dump(reason="daemon-drain")
    tracer.finish(metrics=registry().snapshot())
    if server.fatal is not None:
        print(f"[racon_tpu_torch::serve] exiting: the device was lost "
              f"({server.fatal})", file=sys.stderr)
        return 1
    if not clean:
        print("[racon_tpu_torch::serve] drain grace expired with jobs "
              "still running", file=sys.stderr)
        return 1
    print("[racon_tpu_torch::serve] drained clean", file=sys.stderr)
    return 0
