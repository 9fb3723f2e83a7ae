"""Contig work ledger: shards, leases, stealing, splitting, ordered merge
(port of the JAX package's ``distributed/ledger.py``; the on-disk format
is the reference's, byte for byte, so a ledger either package started
can be finished by the other's workers).

The ledger is a directory on a filesystem every worker can reach::

    <ledger-dir>/
      meta.json          run identity + shard partition (published once,
                         atomically — publish_exclusive)
      events.jsonl       append-only audit log (claims/steals/completes/
                         splits, plus the autoscaler's spawn/retire)
      shard_<k>.lease    {"name", "worker", "epoch", "nonce", "deadline"}
      shard_<k>.done     completion marker (lease-fenced write)
      shard_<k>/         that shard's CheckpointStore (meta.json,
                         contigs.fasta, manifest.jsonl)
      shard_<k>s<e>_<i>.range
                         a child shard carved off shard_<k> by a dynamic
                         split: {"parent", "start", "end", ...} published
                         atomically (publish_exclusive). The child has
                         its own lease/done/store files under its own
                         name and is itself splittable, so lineages nest.
      merge.lease        the merge phase is itself a stealable
      merge.done         pseudo-shard, so a worker evicted mid-merge
      out.fasta          doesn't strand the run

There is no coordinator. Liveness is a **time-bounded lease**: a worker
claims a shard by publishing its lease file, renews the deadline as it
polishes, and any survivor may rewrite an *expired* lease to steal the
shard. Mutual exclusion is best-effort (two workers can transiently
hold the same shard across a steal race or a paused-then-resumed
victim); correctness never depends on it:

- compute is deterministic, and commits land in the shard's own
  append-only checkpoint store — a duplicate commit re-appends the
  same bytes and the manifest's last record wins, so the merged output
  is unchanged;
- the **nonce is the fence**: every renew/complete re-reads the lease
  and raises :class:`LeaseLost` when its nonce is gone, so a stale
  worker stops promptly instead of finishing a stolen shard;
- ``meta.json`` is immutable after publication and carries the run
  fingerprint, so two differently-configured runs can never share a
  ledger (same refusal discipline as resilience/checkpoint.py).

Steals verify their write won by re-reading the lease and comparing
nonces — with rename-atomic lease files, the last writer wins and every
loser observes a foreign nonce. Lease clocks honor ``clock_skew()``
(the ``skew=`` fault clause), so expiry is provable in tier-1 without
wall-clock waits.

The published partition is only the *initial* one: a worker stuck on a
long shard can :meth:`WorkLedger.split` it at a committed-contig
boundary, carving the tail into a new instantly-stealable child shard.
:meth:`all_shards` is the
single source of truth for what is claimable: base shards with every
child's carve applied, effective ranges tiling [0, n_targets) exactly.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, Iterator, List, Optional, Tuple, Union

from racon_tpu_torch.obs.metrics import record_dist
from racon_tpu_torch.resilience import checkpoint as ckpt
from racon_tpu_torch.resilience.faults import (clock_skew, hard_exit,
                                               maybe_fault, maybe_torn)
from racon_tpu_torch.utils import env
from racon_tpu_torch.utils.atomicio import (append_fsync,
                                            atomic_write_bytes,
                                            atomic_writer,
                                            load_jsonl_prefix,
                                            publish_exclusive)

SCHEMA = 1
META_NAME = "meta.json"
EVENTS_NAME = "events.jsonl"
MERGE_NAME = "merge"
OUT_NAME = "out.fasta"
RANGE_SUFFIX = ".range"
ENV_SHARDS = env.DIST_SHARDS
ENV_SPLIT = env.SPLIT


def split_enabled() -> bool:
    """Dynamic shard splitting is on unless RACON_TPU_SPLIT is 0, false,
    no or off."""
    return env.read(ENV_SPLIT).strip().lower() not in (
        "0", "false", "no", "off")


ENV_SPLIT_DEPTH = env.SPLIT_DEPTH

_SPLIT_SEG = re.compile(r"s\d+_\d+")


def split_depth(name: str) -> int:
    """How many split generations deep a shard name is (0 for a seed
    shard): every :meth:`WorkLedger.split` appends one
    ``s<epoch>_<seq>`` segment to the parent's name."""
    return len(_SPLIT_SEG.findall(name))


def max_split_depth() -> int:
    """Depth cap for dynamic splitting (RACON_TPU_SPLIT_DEPTH,
    default 1: seed shards split, children don't). Every handoff costs
    the new holder a fresh polisher build, so without a cap two
    workers trading a shrinking tail back and forth — each donating
    its remainder to the other the moment the other goes idle — turn
    one shard into a cascade of one-contig claims that is strictly
    slower than never splitting at all."""
    raw = env.read(ENV_SPLIT_DEPTH).strip()
    if raw:
        try:
            return max(0, int(raw))
        except ValueError:
            pass
    return 1


def append_event(directory: str, rec: Dict) -> None:
    """Append one record to the ledger's events.jsonl. O_APPEND:
    concurrent single-write appends from multiple processes interleave
    whole records. The log is advisory (the fleet timeline), so
    failures are swallowed — module-level so the autoscaler can log
    spawn/retire decisions without holding a ledger."""
    rec = dict(rec, t=round(time.time(), 3))
    data = (json.dumps(rec, sort_keys=True) + "\n").encode()
    try:
        with open(os.path.join(directory, EVENTS_NAME), "ab") as fh:
            append_fsync(fh, data)
    except OSError:
        pass


class LedgerError(ValueError):
    """Unusable ledger: fingerprint/schema mismatch, corrupt metadata,
    or a done shard whose store doesn't cover its target range. A hard
    error — silently recomputing would mask operator mistakes."""


class LeaseLost(RuntimeError):
    """This worker's lease was stolen (its nonce is gone). The holder
    must abandon the shard immediately; the thief owns it now."""

    def __init__(self, name: str, worker: str):
        super().__init__(
            f"[racon_tpu_torch::dist] worker {worker} lost its lease on "
            f"{name} — shard was stolen after lease expiry")
        self.name = name


class ShardInfo:
    """One claimable unit of work: a base shard of the published
    partition, or a child carved off a parent by a dynamic split.

    ``end`` is the *effective* end — the published end minus every
    child carved off this shard's tail — so effective ranges always
    tile [0, n_targets). ``root`` is the base-partition index the
    lineage descends from (the int metrics/trace tag); ``key`` seeds
    the checkpoint fingerprint, so a parent store and a child store are
    mutually unspliceable even though they cover adjacent targets.
    """

    __slots__ = ("name", "key", "start", "end", "parent", "root")

    def __init__(self, name: str, key: Union[int, str], start: int,
                 end: int, parent: Optional[str] = None, root: int = 0):
        self.name = name
        self.key = key
        self.start = int(start)
        self.end = int(end)
        self.parent = parent
        self.root = int(root)

    @property
    def n_targets(self) -> int:
        return self.end - self.start

    def __repr__(self) -> str:  # debugging/log aid only
        return (f"ShardInfo({self.name}, [{self.start}, {self.end})"
                f"{', child of ' + self.parent if self.parent else ''})")


class Claim:
    """A held lease. ``shard`` is the lineage-root shard index (-1 for
    the merge pseudo-shard); ``info`` carries the claimed shard's
    effective range (None for merge); ``stolen`` records whether this
    claim evicted a previous holder (its committed prefix will be
    resumed)."""

    __slots__ = ("name", "shard", "worker", "epoch", "nonce", "stolen",
                 "deadline", "info")

    def __init__(self, name: str, shard: int, worker: str, epoch: int,
                 nonce: str, stolen: bool, deadline: float,
                 info: Optional[ShardInfo] = None):
        self.name = name
        self.shard = shard
        self.worker = worker
        self.epoch = epoch
        self.nonce = nonce
        self.stolen = stolen
        self.deadline = deadline
        self.info = info


def _partition(n_targets: int, n_shards: int) -> List[int]:
    """Contiguous balanced partition bounds: shard k owns targets
    [bounds[k], bounds[k+1]). Contiguity keeps each shard's checkpoint
    manifest a prefix of an input-order walk — the same invariant the
    serial resume path relies on."""
    base, extra = divmod(n_targets, n_shards)
    bounds = [0]
    for k in range(n_shards):
        bounds.append(bounds[-1] + base + (1 if k < extra else 0))
    return bounds


class WorkLedger:
    def __init__(self, directory: str, meta: Dict):
        self.directory = directory
        self.meta = meta
        self.fingerprint: str = meta["fingerprint"]
        self.bounds: List[int] = [int(b) for b in meta["bounds"]]
        self.n_shards: int = len(self.bounds) - 1
        self.n_targets: int = int(meta["n_targets"])
        self.lease_s: float = float(meta["lease_s"])
        # Optional per-target byte offsets into the target file (from
        # io.parsers.scan_sequence_index, published by the winner).
        # They drive the weighted partition above, feed the ava shape
        # planner (every worker derives per-target lengths from them
        # without re-scanning), and remain the seek-to-shard hook.
        off = meta.get("target_offsets")
        self.target_offsets: Optional[List[int]] = \
            None if off is None else [int(o) for o in off]

    # ------------------------------------------------------- open
    @classmethod
    def open(cls, directory: str, fingerprint: str, *,
             n_targets: Optional[int] = None, workers: int = 1,
             lease_s: float = 30.0, n_shards: Optional[int] = None,
             scan_targets=None, weighted: bool = False) -> "WorkLedger":
        """Open (publishing if first) the ledger for this run.

        Every worker calls this with its own view of the run identity;
        whoever gets here first publishes ``meta.json`` atomically and
        everyone else adopts the published partition — so all workers
        agree on shard bounds and lease duration even if their CLI
        flags disagree.

        ``n_targets`` may be None when ``scan_targets`` (a callable
        returning ``(count, per-target byte offsets)``, typically
        io.parsers.scan_sequence_index on the target file) is given: a
        worker joining an ALREADY-PUBLISHED ledger then adopts the
        published count without touching the target file at all — the
        fingerprint check still guards against mismatched inputs, so
        a per-worker recount would be duplicated I/O. Only the
        publishing worker pays the scan, and it publishes the offsets
        alongside the count so nobody ever scans twice.
        """
        path = os.path.join(directory, META_NAME)
        published: Optional[Dict] = None
        if os.path.isfile(path):
            published = cls._read_meta(path, directory)
        offsets = None
        if published is None:
            if n_targets is None:
                if scan_targets is None:
                    raise LedgerError(
                        "[racon_tpu_torch::dist] opening an unpublished "
                        "ledger needs n_targets or scan_targets")
                n_targets, offsets = scan_targets()
            if n_targets < 1:
                raise LedgerError(
                    "[racon_tpu_torch::dist] refusing to open a ledger for "
                    "an empty target set")
            if n_shards is None:
                raw = env.read(ENV_SHARDS)
                if raw:
                    n_shards = int(raw)
                else:
                    # Over-partition ~2x the fleet so a steal transfers
                    # a shard's worth of work, not half the run.
                    n_shards = max(1, int(workers) * 2)
            n_shards = max(1, min(int(n_shards), n_targets))
            os.makedirs(directory, exist_ok=True)
            bounds = _partition(n_targets, n_shards)
            if weighted and offsets is not None:
                # Length-weighted bounds for read-scale target sets:
                # the ava regime's targets span orders of magnitude in
                # size, so equal-count shards can differ 10x in work.
                # Opt-in per open (the kF worker passes weighted=True)
                # so contig-polish runs keep the count partition their
                # fault-index drills are written against. Only the
                # publishing worker computes this (from the offsets it
                # just scanned); joiners adopt the published bounds
                # like any other partition.
                from racon_tpu_torch.ava.partition import weighted_bounds
                wb = weighted_bounds(n_targets, n_shards, offsets)
                if wb is not None:
                    bounds = wb
            meta = {
                "schema": SCHEMA,
                "fingerprint": fingerprint,
                "n_targets": int(n_targets),
                "bounds": bounds,
                "lease_s": float(lease_s),
                "workers": int(workers),
            }
            if offsets is not None:
                meta["target_offsets"] = [int(o) for o in offsets]
            # Publish the submitting process's trace context (if any)
            # so late joiners with no RACON_TPU_TRACE_CTX of their own
            # still adopt the job's trace_id. Published once with the
            # meta, immutable like everything else in it.
            from racon_tpu_torch.obs.trace import env_trace_ctx
            ctx = env_trace_ctx()
            if ctx:
                meta["trace_ctx"] = ctx
            blob = (json.dumps(meta, sort_keys=True) + "\n").encode()
            publish_exclusive(path, blob)
            # Winner or not, the published file is the contract.
            published = cls._read_meta(path, directory)
        if published.get("schema") != SCHEMA:
            raise LedgerError(
                f"[racon_tpu_torch::dist] ledger schema "
                f"{published.get('schema')!r} != {SCHEMA}")
        if published.get("fingerprint") != fingerprint:
            raise LedgerError(
                "[racon_tpu_torch::dist] refusing to join ledger "
                f"{directory!r}: its fingerprint does not match this "
                "run — inputs or output-affecting options changed")
        if n_targets is not None and \
                published.get("n_targets") != n_targets:
            raise LedgerError(
                f"[racon_tpu_torch::dist] ledger target count "
                f"{published.get('n_targets')!r} != {n_targets} seen "
                "by this worker")
        return cls(directory, published)

    @classmethod
    def attach(cls, directory: str) -> "WorkLedger":
        """Read-mostly attach for tooling — the autoscaler, the
        /healthz fleet view — which observes shard/lease
        state but never polishes or merges: it adopts whatever
        fingerprint the published meta carries instead of proving its
        own inputs match."""
        meta = cls._read_meta(os.path.join(directory, META_NAME),
                              directory)
        if meta.get("schema") != SCHEMA:
            raise LedgerError(
                f"[racon_tpu_torch::dist] ledger schema "
                f"{meta.get('schema')!r} != {SCHEMA}")
        return cls(directory, meta)

    @staticmethod
    def _read_meta(path: str, directory: str) -> Dict:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                return json.load(fh)
        except (OSError, ValueError) as exc:
            raise LedgerError(
                f"[racon_tpu_torch::dist] unreadable ledger {META_NAME} in "
                f"{directory!r} ({exc})") from exc

    # ------------------------------------------------------ layout
    def shard_range(self, k: int) -> Tuple[int, int]:
        return self.bounds[k], self.bounds[k + 1]

    def shard_ckpt_dir(self, k: Union[int, str, ShardInfo]) -> str:
        if isinstance(k, ShardInfo):
            name = k.name
        elif isinstance(k, str):
            name = k
        else:
            name = f"shard_{k}"
        return os.path.join(self.directory, name)

    def shard_fp(self, k: Union[int, str, ShardInfo]) -> str:
        key = k.key if isinstance(k, ShardInfo) else k
        return ckpt.shard_fingerprint(self.fingerprint, key)

    @property
    def out_path(self) -> str:
        return os.path.join(self.directory, OUT_NAME)

    def _lease_path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.lease")

    def _done_path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.done")

    def _range_path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}{RANGE_SUFFIX}")

    def _now(self) -> float:
        return time.time() + clock_skew()

    # ------------------------------------------------------ events
    def _event(self, rec: Dict) -> None:
        append_event(self.directory, rec)

    def events(self) -> List[Dict]:
        path = os.path.join(self.directory, EVENTS_NAME)
        if not os.path.exists(path):
            return []
        records, _ = load_jsonl_prefix(path)
        return records

    # ------------------------------------------------------ shards
    def _read_range(self, path: str) -> Optional[Dict]:
        """A child shard's published .range record, or None when the
        file is torn, foreign, or structurally invalid — an invalid
        .range means the split never happened (the dist/split torn
        drill's contract: a half-published child is invisible)."""
        try:
            with open(path, "rb") as fh:
                rec = json.loads(fh.read())
        except (OSError, ValueError):
            return None
        if not isinstance(rec, dict):
            return None
        try:
            name = rec["name"]
            parent = rec["parent"]
            start, end = int(rec["start"]), int(rec["end"])
            root = int(rec["root"])
        except (KeyError, TypeError, ValueError):
            return None
        if rec.get("fingerprint") != self.fingerprint:
            return None
        if not (isinstance(name, str) and isinstance(parent, str)):
            return None
        if not 0 <= start < end <= self.n_targets:
            return None
        return {"name": name, "parent": parent, "start": start,
                "end": end, "root": root}

    def all_shards(self) -> List[ShardInfo]:
        """Every claimable shard — the published base partition plus
        all dynamically split children — with carving applied: each
        child shrinks its parent's effective end to the child's start,
        so the effective ranges tile [0, n_targets) exactly, in start
        order. Rescans the directory: a split published by another
        worker is visible at this worker's next claim poll."""
        infos: Dict[str, ShardInfo] = {}
        for k in range(self.n_shards):
            s, e = self.bounds[k], self.bounds[k + 1]
            infos[f"shard_{k}"] = ShardInfo(f"shard_{k}", k, s, e,
                                            None, k)
        try:
            entries = sorted(os.listdir(self.directory))
        except OSError:
            entries = []
        for fn in entries:
            if not fn.endswith(RANGE_SUFFIX):
                continue
            rec = self._read_range(os.path.join(self.directory, fn))
            if rec is None or rec["name"] != fn[:-len(RANGE_SUFFIX)]:
                continue
            # A child's name extends its parent's ("<parent>s<e>_<i>"),
            # so the sorted scan inserts parents before their children
            # and nested lineages resolve in one pass.
            if rec["parent"] not in infos:
                continue
            infos[rec["name"]] = ShardInfo(
                rec["name"], rec["name"][len("shard_"):],
                rec["start"], rec["end"], rec["parent"], rec["root"])
        for info in infos.values():
            if info.parent is not None:
                parent = infos[info.parent]
                if info.start < parent.end:
                    parent.end = info.start
        return sorted(infos.values(), key=lambda i: (i.start, i.end))

    def open_shard_stats(self) -> Dict[str, int]:
        """One pass over live shard state: ``open`` (not done),
        ``claimable`` (open with no live lease — a steal or first
        claim would succeed right now), ``leased`` (open under a live
        lease). Feeds the worker's split trigger and the autoscaler's
        target policy."""
        now = self._now()
        stats = {"open": 0, "claimable": 0, "leased": 0}
        for info in self.all_shards():
            if info.start >= info.end or self.is_done(info.name):
                continue
            stats["open"] += 1
            cur = self._read_lease(info.name)
            if cur is not None and float(cur.get("deadline", 0.0)) > now:
                stats["leased"] += 1
            else:
                stats["claimable"] += 1
        return stats

    # ------------------------------------------------------ leases
    def _read_lease(self, name: str) -> Optional[Dict]:
        """None when absent, unreadable, or torn — an unreadable lease
        is treated as expired (its writer crashed mid-publish; nothing
        can renew it)."""
        try:
            with open(self._lease_path(name), "rb") as fh:
                rec = json.loads(fh.read())
            if not isinstance(rec, dict):
                return None
            return rec
        except (OSError, ValueError):
            return None

    def is_done(self, name: str) -> bool:
        return os.path.exists(self._done_path(name))

    def _try_claim(self, name: str, shard: int, worker: str,
                   info: Optional[ShardInfo] = None) -> Optional[Claim]:
        """Claim ``name`` if unclaimed, or steal it if its lease
        expired. Returns None when someone else holds a live lease (or
        won the race)."""
        if self.is_done(name):
            return None
        maybe_fault("dist/claim")
        path = self._lease_path(name)
        nonce = os.urandom(8).hex()
        now = self._now()
        lease = {"name": name, "worker": worker, "epoch": 1,
                 "nonce": nonce, "deadline": now + self.lease_s}
        if not os.path.exists(path):
            blob = (json.dumps(lease, sort_keys=True) + "\n").encode()
            if publish_exclusive(path, blob):
                self._event({"ev": "claim", "name": name,
                             "worker": worker, "epoch": 1})
                record_dist("claims" if shard >= 0 else "merge_claims",
                            shard, worker)
                return Claim(name, shard, worker, 1, nonce, False,
                             lease["deadline"], info)
            # Lost the first-claim race; fall through and look at what
            # the winner published.
        cur = self._read_lease(name)
        if cur is not None and float(cur.get("deadline", 0.0)) > now:
            return None  # live lease — not ours to touch
        # Expired, explicitly released, or torn lease: take it by
        # rewriting, then verify our write survived — concurrent takers
        # race on the rename and every loser sees a foreign nonce on
        # re-read.
        released = bool(cur.get("released")) if cur else False
        epoch = int(cur.get("epoch", 0)) + 1 if cur else 1
        expired_for = max(0.0, now - float(cur.get("deadline", now))) \
            if cur else 0.0
        victim = cur.get("worker", "?") if cur else "?"
        lease["epoch"] = epoch
        lease["deadline"] = self._now() + self.lease_s
        atomic_write_bytes(path, (json.dumps(
            lease, sort_keys=True) + "\n").encode())
        back = self._read_lease(name)
        if back is None or back.get("nonce") != nonce:
            return None  # another taker's rename landed after ours
        if released:
            # A released marker is a cooperative handoff, not an
            # eviction: count it as a claim, and ``stolen`` stays False
            # (the committed prefix still resumes — resume keys off the
            # store, not the flag).
            self._event({"ev": "claim", "name": name, "worker": worker,
                         "epoch": epoch, "released_by": victim})
            record_dist("claims" if shard >= 0 else "merge_claims",
                        shard, worker)
            return Claim(name, shard, worker, epoch, nonce, False,
                         lease["deadline"], info)
        if shard >= 0:
            record_dist("leases_expired", shard, worker)
            record_dist("shards_stolen", shard, worker, epoch=epoch)
            record_dist("steal_latency_s", shard, worker,
                        value=expired_for)
        else:
            record_dist("merge_steals", shard, worker, epoch=epoch)
        self._event({"ev": "steal", "name": name, "worker": worker,
                     "victim": victim, "epoch": epoch,
                     "expired_for_s": round(expired_for, 3)})
        return Claim(name, shard, worker, epoch, nonce, True,
                     lease["deadline"], info)

    def claim_shard(self, worker: str,
                    avoid: Optional[List[str]] = None) -> \
            Optional[Claim]:
        """The next shard this worker can own, scanning effective
        shards (base partition plus split children) in target order —
        earliest incomplete work first, which also keeps the merge's
        wait roughly FIFO. ``avoid`` deprioritizes named shards (the
        autoscaler hands a replacement worker the shard its sick
        predecessor released) without ever excluding them: a wedged
        shard is still claimed when nothing else is left. None when
        every shard is done or live-leased elsewhere."""
        avoided = set(avoid or ())
        shards = self.all_shards()
        ordered = [i for i in shards if i.name not in avoided] + \
                  [i for i in shards if i.name in avoided]
        for info in ordered:
            if info.start >= info.end:
                continue
            claim = self._try_claim(info.name, info.root, worker,
                                    info=info)
            if claim is not None:
                return claim
        return None

    def claim_merge(self, worker: str) -> Optional[Claim]:
        return self._try_claim(MERGE_NAME, -1, worker)

    def verify(self, claim: Claim) -> None:
        """Fencing check: raise LeaseLost unless ``claim``'s nonce is
        still the one on disk."""
        cur = self._read_lease(claim.name)
        if cur is None or cur.get("nonce") != claim.nonce:
            record_dist("leases_lost", claim.shard, claim.worker)
            raise LeaseLost(claim.name, claim.worker)

    def renew(self, claim: Claim) -> None:
        """Push the deadline out; raises LeaseLost if stolen. Renewing
        an expired-but-unstolen lease succeeds — expiry only matters
        if a thief acted on it."""
        self.verify(claim)
        lease = {"name": claim.name, "worker": claim.worker,
                 "epoch": claim.epoch, "nonce": claim.nonce,
                 "deadline": self._now() + self.lease_s}
        atomic_write_bytes(self._lease_path(claim.name), (json.dumps(
            lease, sort_keys=True) + "\n").encode())
        claim.deadline = lease["deadline"]
        record_dist("lease_renewals", claim.shard, claim.worker)
        self._event({"ev": "renew", "name": claim.name,
                     "worker": claim.worker, "epoch": claim.epoch})

    def release(self, claim: Claim) -> None:
        """Hand a held lease back WITHOUT completing it — self-eviction
        (resilience/watchdog.py) and supervisor-driven retirement: the
        shard becomes claimable at any worker's next poll instead of
        waiting out the lease term. Committed prefix work stays in the
        shard's checkpoint store; the successor resumes it
        byte-identically.

        The release is published as a *marker lease* (``released``,
        deadline 0) via the same atomic rename every steal uses — never
        an unlink. Check-then-unlink had a race window: a thief's
        steal-rewrite landing between our nonce read and our remove
        would be deleted, silently revoking the thief's freshly won
        claim. Renames serialize instead — whichever lands last wins,
        and the other side's nonce re-read refuses (the two-thief
        release/split race).

        A foreign nonce on disk means the lease was already stolen —
        benign (nonce fencing protects completion), so the release is
        a silent no-op rather than an error on a worker that is
        already giving up.
        """
        cur = self._read_lease(claim.name)
        if cur is None or cur.get("nonce") != claim.nonce:
            return
        marker = {"name": claim.name, "worker": claim.worker,
                  "epoch": claim.epoch, "nonce": os.urandom(8).hex(),
                  "deadline": 0.0, "released": True}
        atomic_write_bytes(self._lease_path(claim.name), (json.dumps(
            marker, sort_keys=True) + "\n").encode())
        record_dist("releases", claim.shard, claim.worker)
        self._event({"ev": "release", "name": claim.name,
                     "worker": claim.worker, "epoch": claim.epoch})

    def complete(self, claim: Claim, **info) -> None:
        """Publish the done marker, fenced by a final verify so a stale
        worker can't mark a shard done with a thief mid-recompute."""
        self.verify(claim)
        rec = {"name": claim.name, "worker": claim.worker,
               "epoch": claim.epoch}
        rec.update(info)
        atomic_write_bytes(self._done_path(claim.name), (json.dumps(
            rec, sort_keys=True) + "\n").encode())
        self._event(dict(rec, ev="complete"))

    # ------------------------------------------------------- split
    def split(self, claim: Claim, cut: int) -> Optional[ShardInfo]:
        """Carve ``[cut, end)`` off a held shard into a new child shard
        that any idle worker can claim immediately — the dynamic
        re-sharding that kills the long-contig tail.

        Protocol (nonce-fenced both sides of the publish):

        1. verify the lease — only the live holder may split;
        2. publish the child's ``.range`` file with publish_exclusive
           (``dist/split`` is the torn-write drill site: a split that
           dies mid-publish must be invisible, so readers drop
           unparseable .range files);
        3. re-verify — if the lease was stolen inside the publish
           window, the thief claimed the *full* parent range, so the
           child is retracted (unlinked) and LeaseLost raised; without
           the retraction the fleet could polish [cut, end) twice under
           two names and the tiling check would refuse the merge.

        The child gets its own lease/done/checkpoint files under its
        own name and a checkpoint fingerprint derived from that name,
        so parent and child stores are mutually unspliceable; its
        ``.range`` record carries the parent name, making lineage
        reconstructable (the fleet model's ``lineage``). Returns
        the child's ShardInfo, or None when the publish lost a name
        race (the caller may simply retry later). ``claim.info.end``
        shrinks to ``cut`` on success.
        """
        info = claim.info
        if info is None:
            raise LedgerError(
                "[racon_tpu_torch::dist] only shard claims can split")
        if not info.start < cut < info.end:
            raise LedgerError(
                f"[racon_tpu_torch::dist] split cut {cut} outside the held "
                f"range [{info.start}, {info.end}) of {info.name}")
        self.verify(claim)
        try:
            n_prior = sum(
                1 for fn in os.listdir(self.directory)
                if fn.startswith(info.name + "s") and
                fn.endswith(RANGE_SUFFIX))
        except OSError:
            n_prior = 0
        child = f"{info.name}s{claim.epoch}_{n_prior + 1}"
        rec = {"schema": SCHEMA, "name": child, "parent": info.name,
               "root": info.root, "start": int(cut),
               "end": int(info.end), "fingerprint": self.fingerprint}
        blob = (json.dumps(rec, sort_keys=True) + "\n").encode()
        path = self._range_path(child)
        if maybe_torn("dist/split"):
            # The drill: die mid-publish leaving a truncated .range at
            # the final path (publish_exclusive's tmp+link can't tear,
            # so the drill bypasses it), durable, then hard-exit —
            # readers must treat the torn child as "no split happened".
            with open(path, "wb") as fh:
                fh.write(blob[:max(1, len(blob) - 9)])
                fh.flush()
                os.fsync(fh.fileno())
            hard_exit(137)
        if not publish_exclusive(path, blob):
            return None
        try:
            self.verify(claim)
        except LeaseLost:
            try:
                os.remove(path)
            except OSError:
                pass
            raise
        old_end, info.end = info.end, int(cut)
        record_dist("splits_total", info.root, claim.worker,
                    child=child)
        self._event({"ev": "split", "name": info.name, "child": child,
                     "worker": claim.worker, "epoch": claim.epoch,
                     "start": int(cut), "end": int(old_end)})
        return ShardInfo(child, child[len("shard_"):], cut, old_end,
                         info.name, info.root)

    # ----------------------------------------------------- progress
    def shards_done(self) -> bool:
        return all(self.is_done(i.name) for i in self.all_shards()
                   if i.start < i.end)

    def pending_shards(self) -> List[str]:
        return [i.name for i in self.all_shards()
                if i.start < i.end and not self.is_done(i.name)]

    def merge_done(self) -> bool:
        return self.is_done(MERGE_NAME) and os.path.exists(
            self.out_path)

    # ------------------------------------------------------- merge
    def iter_merged(self) -> Iterator[Tuple[int, Optional[bytes]]]:
        """Yield ``(tid, blob-or-None)`` in target input order across
        all shard stores — base shards and split children stitched by
        their effective ranges — the exact bytes each shard committed,
        so concatenation is byte-identical to the serial path. Requires
        every shard done; refuses when the split lineage does not tile
        the target range (a corrupt .range escaped the readers'
        validation)."""
        pos = 0
        for info in self.all_shards():
            if info.start >= info.end:
                continue
            if info.start != pos:
                raise LedgerError(
                    f"[racon_tpu_torch::dist] split lineage does not tile "
                    f"the target range: expected a shard starting at "
                    f"{pos}, found {info.name} at {info.start} — "
                    "ledger corrupt")
            pos = info.end
            store = ckpt.CheckpointStore.resume(
                self.shard_ckpt_dir(info), self.shard_fp(info))
            try:
                for tid in range(info.start, info.end):
                    if tid not in store.committed:
                        raise LedgerError(
                            f"[racon_tpu_torch::dist] shard {info.name} is "
                            f"marked done but target {tid} has no "
                            "committed record — ledger corrupt")
                    yield tid, store.read_emitted(tid)
            finally:
                store.close()
        if pos != self.n_targets:
            raise LedgerError(
                f"[racon_tpu_torch::dist] split lineage does not tile the "
                f"target range: coverage ends at {pos}, expected "
                f"{self.n_targets} — ledger corrupt")

    def merge(self) -> Tuple[int, int]:
        """Assemble ``out.fasta`` from the shard stores (caller holds
        the merge claim). Returns ``(bytes, contigs_emitted)``. Written
        via tmp + fsync + atomic finalize, so a worker evicted
        mid-merge leaves no partial output and its thief redoes the
        whole (cheap, read-only) pass."""
        if not self.shards_done():
            raise LedgerError(
                "[racon_tpu_torch::dist] merge requested with shards still "
                f"pending: {self.pending_shards()}")
        total = emitted = 0
        with atomic_writer(self.out_path) as fh:
            for _tid, blob in self.iter_merged():
                if blob is None:
                    continue
                # Per-blob drill point: a term/kill/raise here proves a
                # death mid-merge never leaves a torn out.fasta (the
                # writer unlinks its tmp; the thief redoes the pass).
                maybe_fault("dist/merge_write")
                fh.write(blob)
                total += len(blob)
                emitted += 1
        return total, emitted
