"""Elastic fleet supervisor: spawn, retire and replace ledger workers
(port of the JAX package's ``distributed/autoscaler.py``).

The fleet model (obs/fleet.py) measures the workers, the ledger supports
stealing and explicit release, and self-eviction (exit 75) tells a sick
worker from a finished one; this module closes the loop. The supervisor
is stateless on disk:

- each control tick it reaps exited workers, attaches to the ledger
  read-only and sets ``target = clamp(open shards + unfinished merge,
  min, max)``;
- it holds the fleet at target by spawning worker processes
  (``python -m racon_tpu_torch.cli`` with the run's own argv and a
  unique ``--worker-id``) against the same ``--ledger-dir``, and retires
  surplus workers with SIGTERM — the worker's signal path releases its
  lease, leaves a final metric snapshot and exits 128+15;
- an exit-75 self-eviction is replaced at once, outside the target
  policy, with ``RACON_TPU_DIST_AVOID`` naming the shard the sick worker
  released;
- any other nonzero exit is an eviction: the next tick's target refills
  the slot (spawns are budgeted, so a crash-looping input cannot fork
  without bound);
- every tick writes an atomic heartbeat (``obs/autoscaler.json``) with
  the decision counters; ``/healthz``'s fleet view
  (obs/export.py::fleet_health) turns a stale heartbeat into a 503.

The supervisor holds no lease, builds no polisher and never touches the
GPU: only its workers hold the card. Killing it loses nothing — workers
finish on their own, and a new supervisor can attach. When the merge
lands it copies ``out.fasta`` to its stdout, so ``--autoscale`` keeps
the serial CLI's contract (the same bytes on stdout).

Policy knobs (``RACON_TPU_AUTOSCALE_*``): ``MIN`` / ``MAX`` (defaults 1
/ ``--workers``), ``INTERVAL_S`` (0.5), ``MAX_SPAWNS`` (max(8, 4 x
MAX)), ``DEADLINE_S`` (0 = none), and ``FAULT_PLAN``: a JSON list of
fault specs by spawn ordinal — worker #i runs with ``RACON_TPU_FAULTS``
set to entry i (missing or empty entries run clean); the supervisor
itself never injects.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

from racon_tpu_torch.distributed import ledger as dledger
from racon_tpu_torch.distributed.ledger import LedgerError, WorkLedger
from racon_tpu_torch.obs import fleet
from racon_tpu_torch.obs.trace import (ENV_TRACE, ENV_TRACE_CTX,
                                       env_trace_ctx, parse_trace_ctx)
from racon_tpu_torch.resilience.faults import ENV_FAULTS
from racon_tpu_torch.resilience.watchdog import EXIT_SELF_EVICT
from racon_tpu_torch.utils import env
from racon_tpu_torch.utils.atomicio import atomic_write_bytes

ENV_MIN = env.AUTOSCALE_MIN
ENV_MAX = env.AUTOSCALE_MAX
ENV_INTERVAL = env.AUTOSCALE_INTERVAL_S
ENV_MAX_SPAWNS = env.AUTOSCALE_MAX_SPAWNS
ENV_DEADLINE = env.AUTOSCALE_DEADLINE_S
ENV_FAULT_PLAN = env.AUTOSCALE_FAULT_PLAN

#: The module every spawned worker runs: the port's CLI.
WORKER_MODULE = "racon_tpu_torch.cli"

#: How long after merge_done lingering workers (merge losers mid-poll,
#: injected stall sleepers) get before the supervisor SIGTERMs them —
#: the output is already published by then, so the nudge is benign.
DRAIN_GRACE_S = 5.0


def _env_float(name: str, default: float) -> float:
    raw = env.read(name).strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        raise LedgerError(
            f"[racon_tpu_torch::autoscale] {name}={raw!r} is not a number")


class AutoscalePolicy:
    """The clamp and cadence knobs, resolved once at start."""

    __slots__ = ("min_workers", "max_workers", "interval_s",
                 "max_spawns", "deadline_s")

    def __init__(self, min_workers: int, max_workers: int,
                 interval_s: float, max_spawns: int,
                 deadline_s: float):
        self.min_workers = max(0, int(min_workers))
        self.max_workers = max(1, int(max_workers))
        if self.min_workers > self.max_workers:
            raise LedgerError(
                f"[racon_tpu_torch::autoscale] MIN {self.min_workers} > MAX "
                f"{self.max_workers}")
        self.interval_s = max(0.05, float(interval_s))
        self.max_spawns = max(1, int(max_spawns))
        self.deadline_s = max(0.0, float(deadline_s))

    @classmethod
    def from_env(cls, default_max: int) -> "AutoscalePolicy":
        max_w = int(_env_float(ENV_MAX, max(1, int(default_max))))
        return cls(
            min_workers=int(_env_float(ENV_MIN, 1)),
            max_workers=max_w,
            interval_s=_env_float(ENV_INTERVAL, 0.5),
            max_spawns=int(_env_float(ENV_MAX_SPAWNS,
                                      max(8, 4 * max_w))),
            deadline_s=_env_float(ENV_DEADLINE, 0.0),
        )


def decide(open_work: Optional[int], policy: AutoscalePolicy) -> int:
    """Target worker count for one tick. ``open_work`` counts pending
    shards plus an unfinished merge pseudo-shard; None means the
    ledger meta is not published yet — spawn at MAX optimistically
    (the first worker up publishes the partition and the next tick
    sees real numbers)."""
    if open_work is None:
        return policy.max_workers
    return max(policy.min_workers,
               min(policy.max_workers, open_work))


def worker_argv(raw_argv: List[str]) -> List[str]:
    """The CLI arguments a spawned worker runs with: the supervisor's own
    argv minus ``--autoscale`` and any ``--worker-id`` (each worker gets a
    unique one appended at spawn). ``--device`` passes through as given:
    a supervisor run with ``--device cpu`` spawns CPU workers, and none
    is added otherwise, so workers default to the card."""
    out: List[str] = []
    skip = False
    for arg in raw_argv:
        if skip:
            skip = False
            continue
        if arg == "--autoscale":
            continue
        if arg == "--worker-id":
            skip = True
            continue
        if arg.startswith("--worker-id="):
            continue
        out.append(arg)
    return out


def _load_fault_plan(log) -> List[str]:
    path = env.read(ENV_FAULT_PLAN).strip()
    if not path:
        return []
    try:
        with open(path, "r", encoding="utf-8") as fh:
            plan = json.load(fh)
    except (OSError, ValueError) as exc:
        raise LedgerError(
            f"[racon_tpu_torch::autoscale] unreadable fault plan "
            f"{path!r}: {exc}")
    if not isinstance(plan, list) or \
            not all(isinstance(p, str) for p in plan):
        raise LedgerError(
            f"[racon_tpu_torch::autoscale] fault plan {path!r} must be a "
            "JSON list of RACON_TPU_FAULTS spec strings")
    if any(plan):
        print(f"[racon_tpu_torch::autoscale] fault plan loaded: "
              f"{sum(1 for p in plan if p)} faulted spawn(s) of "
              f"{len(plan)}", file=log)
    return plan


class Autoscaler:
    def __init__(self, ledger_dir: str, raw_argv: List[str], *,
                 policy: Optional[AutoscalePolicy] = None,
                 default_max: int = 1, out=None, log=None,
                 extra_env: Optional[Dict[str, str]] = None,
                 target_fn=None, trace_dir: Optional[str] = None):
        self.ledger_dir = ledger_dir
        self.policy = policy or AutoscalePolicy.from_env(default_max)
        self.out = out if out is not None else sys.stdout.buffer
        self.log = log if log is not None else sys.stderr
        self.argv = worker_argv(raw_argv)
        # The gateway's hooks: extra_env is applied to every spawn's
        # environment last (it wins over the fault-plan, avoid and trace
        # handling: the caller owns those keys when it sets them), except
        # RACON_TPU_METRICS_PORT, which no worker may inherit (_spawn);
        # target_fn, when given, replaces decide() as the sizing policy
        # of a tick (the same (open_work, policy) -> int contract);
        # trace_dir gives every spawn its own trace file, so a fleet
        # run's workers land as separate span streams beside the
        # ledger's metric shards.
        self.extra_env = {k: v for k, v in (extra_env or {}).items()
                          if k != env.METRICS_PORT}
        self.target_fn = target_fn
        self.trace_dir = trace_dir
        self.fault_plan = _load_fault_plan(self.log)
        self.obs_dir = os.path.join(ledger_dir, fleet.OBS_SUBDIR)
        self.logs_dir = os.path.join(ledger_dir, "logs")
        self.procs: List[Dict] = []  # {proc, wid, log_fh, retiring}
        self.spawned = 0
        self.counters = {"scale_up_total": 0, "scale_down_total": 0,
                         "replaced_total": 0, "retired_total": 0,
                         "evicted_total": 0, "self_evicted_total": 0,
                         "done_total": 0}
        self.seq = 0

    def spawn_argv(self, wid: str) -> List[str]:
        """The command line of worker ``wid``."""
        return ([sys.executable, "-m", WORKER_MODULE] + self.argv +
                ["--worker-id", wid])

    # ---------------------------------------------------------- spawn
    def _trace_ctx(self) -> str:
        """The context workers should inherit: the supervisor's own
        validated RACON_TPU_TRACE_CTX, else whatever the ledger meta
        publisher stamped ("" when neither exists)."""
        ctx = env_trace_ctx()
        if ctx:
            return ctx
        try:
            led = WorkLedger.attach(self.ledger_dir)
        except LedgerError:
            return ""
        meta_ctx = str(led.meta.get("trace_ctx", ""))
        return meta_ctx if parse_trace_ctx(meta_ctx) else ""

    def _spawn(self, reason: str,
               avoid: Optional[List[str]] = None) -> bool:
        if self.spawned >= self.policy.max_spawns:
            print(f"[racon_tpu_torch::autoscale] spawn budget "
                  f"({self.policy.max_spawns}) exhausted — not "
                  f"spawning ({reason})", file=self.log)
            return False
        wid = f"as{self.spawned}"
        child_env = dict(os.environ)
        # Workers run clean unless the fault plan targets this spawn
        # ordinal — the supervisor's own env must never leak faults.
        spec = self.fault_plan[self.spawned] \
            if self.spawned < len(self.fault_plan) else ""
        if spec:
            child_env[ENV_FAULTS] = spec
        else:
            child_env.pop(ENV_FAULTS, None)
        if avoid:
            child_env[env.DIST_AVOID] = ",".join(avoid)
        else:
            child_env.pop(env.DIST_AVOID, None)
        # The supervisor owns RACON_TPU_METRICS_PORT (its /healthz is the
        # fleet's view): a worker inheriting it would fail to bind the
        # same port and exit 1, so workers run without it.
        child_env.pop(env.METRICS_PORT, None)
        # Trace handoff: supervisor-spawned workers inherit this
        # process's trace context (own env, else the ledger meta's),
        # so autoscaled replacements land in the same job timeline.
        ctx = self._trace_ctx()
        if ctx:
            child_env[ENV_TRACE_CTX] = ctx
        else:
            child_env.pop(ENV_TRACE_CTX, None)
        if self.trace_dir:
            # One trace file a spawn: worker span streams must not
            # clobber each other (or the supervisor's own trace).
            child_env[ENV_TRACE] = os.path.join(self.trace_dir,
                                                f"worker_{wid}.jsonl")
        child_env.update(self.extra_env)
        argv = self.spawn_argv(wid)
        os.makedirs(self.logs_dir, exist_ok=True)
        log_fh = open(os.path.join(self.logs_dir, f"{wid}.log"), "ab")
        try:
            # Worker stdout goes to its log too: only the supervisor
            # emits the merged FASTA (copied from out.fasta), so the
            # merge winner's stdout copy is just a duplicate record.
            proc = subprocess.Popen(argv, stdout=log_fh,
                                    stderr=subprocess.STDOUT,
                                    env=child_env)
        except OSError as exc:
            log_fh.close()
            print(f"[racon_tpu_torch::autoscale] spawn failed: {exc}",
                  file=self.log)
            return False
        self.spawned += 1
        self.procs.append({"proc": proc, "wid": wid, "log_fh": log_fh,
                           "retiring": False})
        dledger.append_event(self.ledger_dir, {
            "ev": "spawn", "worker": wid, "reason": reason,
            "pid": proc.pid, **({"faults": spec} if spec else {}),
            **({"avoid": avoid} if avoid else {}),
            **({"trace_ctx": ctx} if ctx else {})})
        print(f"[racon_tpu_torch::autoscale] spawned worker {wid} "
              f"(pid {proc.pid}, {reason})"
              f"{' faults=' + spec if spec else ''}", file=self.log)
        return True

    # ----------------------------------------------------------- reap
    def _released_shards(self, wid: str) -> List[str]:
        """The shard(s) a worker explicitly released before dying —
        the wedged assignment its replacement should claim last."""
        try:
            led = WorkLedger.attach(self.ledger_dir)
        except LedgerError:
            return []
        return sorted({e["name"] for e in led.events()
                       if e.get("ev") == "release" and
                       e.get("worker") == wid and
                       isinstance(e.get("name"), str)})

    def _reap(self) -> None:
        still: List[Dict] = []
        for w in self.procs:
            rc = w["proc"].poll()
            if rc is None:
                still.append(w)
                continue
            w["log_fh"].close()
            if rc == EXIT_SELF_EVICT:
                # Sick, not done: the worker judged its own host wedged
                # and released its lease. Replace immediately — outside
                # the target policy — steering the replacement away
                # from the assignment that wedged its predecessor.
                self.counters["self_evicted_total"] += 1
                avoid = self._released_shards(w["wid"])
                print(f"[racon_tpu_torch::autoscale] worker {w['wid']} "
                      f"self-evicted (exit {rc}); replacing"
                      f"{' avoiding ' + ','.join(avoid) if avoid else ''}",
                      file=self.log)
                if self._spawn("replace-self-evict", avoid=avoid):
                    self.counters["replaced_total"] += 1
            elif rc == 0:
                self.counters["done_total"] += 1
            elif w["retiring"]:
                self.counters["retired_total"] += 1
            else:
                self.counters["evicted_total"] += 1
                print(f"[racon_tpu_torch::autoscale] worker {w['wid']} "
                      f"evicted (exit {rc}); target policy refills "
                      "next tick", file=self.log)
        self.procs = still

    # --------------------------------------------------------- retire
    def _lease_holders(self, led: WorkLedger) -> set:
        holders = set()
        now = led._now()
        for info in led.all_shards():
            cur = led._read_lease(info.name)
            if cur and not cur.get("released") and \
                    float(cur.get("deadline", 0.0)) > now:
                holders.add(str(cur.get("worker")))
        cur = led._read_lease(dledger.MERGE_NAME)
        if cur and not cur.get("released") and \
                float(cur.get("deadline", 0.0)) > now:
            holders.add(str(cur.get("worker")))
        return holders

    def _retire(self, n: int, led: Optional[WorkLedger],
                reason: str) -> None:
        """SIGTERM ``n`` workers, idle (non-lease-holding) ones first,
        youngest first — a retiring holder releases its lease on the
        signal path, so retiring a holder costs one shard handoff, not
        a lease-expiry wait."""
        holders = self._lease_holders(led) if led is not None else set()
        active = [w for w in self.procs if not w["retiring"]]
        victims = ([w for w in reversed(active)
                    if w["wid"] not in holders] +
                   [w for w in reversed(active) if w["wid"] in holders])
        for w in victims[:n]:
            w["retiring"] = True
            try:
                w["proc"].send_signal(signal.SIGTERM)
            except OSError:
                continue
            dledger.append_event(self.ledger_dir, {
                "ev": "retire", "worker": w["wid"], "reason": reason})
            print(f"[racon_tpu_torch::autoscale] retiring worker {w['wid']} "
                  f"({reason})", file=self.log)

    # ------------------------------------------------------ heartbeat
    def _heartbeat(self, target: int, open_work: Optional[int],
                   done: bool) -> None:
        live = sum(1 for w in self.procs if not w["retiring"])
        rec = {
            "schema": 1,
            "unix_time": round(time.time(), 3),
            "interval_s": self.policy.interval_s,
            "target_workers": target,
            "live_workers": live,
            "open_shards": open_work,
            "spawned_total": self.spawned,
            "done": bool(done),
            "seq": self.seq,
            "workers_live": live,
            "workers_retired": self.counters["retired_total"],
            "workers_evicted": self.counters["evicted_total"] +
            self.counters["self_evicted_total"],
            "workers_done": self.counters["done_total"],
            **self.counters,
            "metrics": {
                "dist_scale_up_total":
                    self.counters["scale_up_total"],
                "dist_scale_down_total":
                    self.counters["scale_down_total"],
                "fleet_target_workers": target,
            },
        }
        self.seq += 1
        os.makedirs(self.obs_dir, exist_ok=True)
        try:
            atomic_write_bytes(
                os.path.join(self.obs_dir, fleet.SUPERVISOR_NAME),
                (json.dumps(rec, sort_keys=True) + "\n").encode())
        except OSError:
            pass  # heartbeat is advisory; the fleet runs without it

    # ------------------------------------------------------------ run
    def run(self) -> int:
        import shutil
        pol = self.policy
        os.makedirs(self.ledger_dir, exist_ok=True)
        print(f"[racon_tpu_torch::autoscale] supervising {self.ledger_dir}: "
              f"workers [{pol.min_workers}, {pol.max_workers}], tick "
              f"{pol.interval_s:g}s, spawn budget {pol.max_spawns}",
              file=self.log)
        t0 = time.monotonic()
        drain_since: Optional[float] = None
        try:
            while True:
                self._reap()
                try:
                    led: Optional[WorkLedger] = \
                        WorkLedger.attach(self.ledger_dir)
                except LedgerError:
                    led = None  # meta not yet published
                done = led is not None and led.merge_done()
                open_work: Optional[int] = None
                if led is not None:
                    open_work = len(led.pending_shards()) + \
                        (0 if done else 1)
                if done:
                    target = 0
                    if not self.procs:
                        self._heartbeat(target, open_work, True)
                        break
                    if drain_since is None:
                        drain_since = time.monotonic()
                    elif time.monotonic() - drain_since > \
                            DRAIN_GRACE_S:
                        # Output is published; lingering merge losers
                        # or injected stall sleepers just need a nudge.
                        self._retire(len(self.procs), led, "drain")
                        drain_since = time.monotonic()
                else:
                    target = self.target_fn(open_work, pol) \
                        if self.target_fn is not None \
                        else decide(open_work, pol)
                    live = sum(1 for w in self.procs
                               if not w["retiring"])
                    while live < target:
                        if not self._spawn("scale-up"):
                            break
                        self.counters["scale_up_total"] += 1
                        live += 1
                    if live > target:
                        self.counters["scale_down_total"] += \
                            live - target
                        self._retire(live - target, led, "scale-down")
                    if not self.procs and \
                            self.spawned >= pol.max_spawns:
                        self._heartbeat(target, open_work, False)
                        print("[racon_tpu_torch::autoscale] error: spawn "
                              "budget exhausted with the run "
                              "unfinished — giving up", file=self.log)
                        return 1
                self._heartbeat(target, open_work, done)
                if pol.deadline_s and \
                        time.monotonic() - t0 > pol.deadline_s:
                    print(f"[racon_tpu_torch::autoscale] error: deadline "
                          f"{pol.deadline_s:g}s exceeded — killing "
                          "the fleet", file=self.log)
                    return 1
                time.sleep(pol.interval_s)
        finally:
            # Whatever path exits the loop (success, budget, deadline,
            # signal): never leave orphan workers running.
            for w in self.procs:
                try:
                    w["proc"].kill()
                    w["proc"].wait(timeout=10)
                except (OSError, subprocess.TimeoutExpired):
                    pass
                w["log_fh"].close()
        led = WorkLedger.attach(self.ledger_dir)
        with open(led.out_path, "rb") as fh:
            shutil.copyfileobj(fh, self.out)
        self.out.flush()
        wall = time.monotonic() - t0
        print(f"[racon_tpu_torch::autoscale] fleet finished in {wall:.1f}s: "
              f"{self.spawned} spawn(s), "
              f"{self.counters['done_total']} done, "
              f"{self.counters['evicted_total']} evicted, "
              f"{self.counters['self_evicted_total']} self-evicted, "
              f"{self.counters['retired_total']} retired "
              f"({led.out_path} -> stdout)", file=self.log)
        return 0


def run_supervisor(*, ledger_dir: str, raw_argv: List[str],
                   default_max: int = 1, out=None, log=None) -> int:
    """CLI entry (``--autoscale``): supervise a fleet against
    ``ledger_dir`` until the merged output exists, then emit it on
    stdout. Returns a process exit code."""
    scaler = Autoscaler(ledger_dir, raw_argv, default_max=default_max,
                        out=out, log=log)
    return scaler.run()
