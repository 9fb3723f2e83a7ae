"""Gateway fail-over: a nonce-fenced lease over the daemon state dir
(port of the JAX package's ``gateway/ha.py``; same lease file).

The job journal (server/jobs.py) plus the checkpoint ledger already
make any daemon replica able to ``recover()`` a dead primary's work —
what was missing is mutual exclusion: two daemons recovering the same
state dir would double-run every in-flight job. The gateway lease is
the JAX package's shard-ledger fencing discipline applied to the daemon
itself:

- first claim publishes ``<state-dir>/gateway.lease`` exclusively
  (tmp + ``os.link``; losing the race is detected, never overwritten);
- a standby polls the lease and **steals** it only once the deadline
  passes: rewrite with a fresh nonce, re-read, and only proceed when
  its own nonce survived — concurrent standbys race on the rename and
  every loser sees a foreign nonce;
- the holder renews ahead of the deadline and verifies its nonce on
  every renewal; a fenced (stolen-from) gateway must stop journaling
  immediately (:class:`GatewayLeaseLost`);
- release rewrites a ``released`` marker (never unlink — deleting
  would re-arm the first-claim race for a slot that was cooperatively
  handed off).

Clock skew injection (``RACON_TPU_FAULTS='skew=...'``) shifts
:meth:`GatewayLease._now`, so a standby in a kill drill adopts at once
instead of waiting out a real lease term. The adoption point itself
is the ``gate/adopt`` fault site.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from racon_tpu_torch.resilience.faults import clock_skew, maybe_fault
from racon_tpu_torch.utils import env
from racon_tpu_torch.utils.atomicio import (atomic_write_bytes,
                                            publish_exclusive)

ENV_LEASE_S = env.GATE_LEASE_S
ENV_STANDBY_POLL_S = env.GATE_STANDBY_POLL_S

LEASE_NAME = "gateway.lease"


class GatewayLeaseLost(RuntimeError):
    """This gateway's nonce is no longer the one on disk: a standby
    fenced us off. The only correct reaction is to stop touching the
    journal and exit — the adopter owns every in-flight job now."""

    def __init__(self, owner: str):
        super().__init__(
            f"[racon_tpu_torch::gate] gateway lease lost by {owner!r} — a "
            "standby adopted this state dir; refusing to keep running")
        self.owner = owner


class GatewayLease:
    """One daemon replica's claim over a state dir. Not thread-safe by
    design: exactly one thread (the renewal loop, between HTTP turns)
    owns the lease object."""

    def __init__(self, state_dir: str, owner: str,
                 lease_s: Optional[float] = None):
        self.state_dir = state_dir
        self.owner = str(owner)
        self.lease_s = float(env.read(ENV_LEASE_S)) \
            if lease_s is None else float(lease_s)
        self.path = os.path.join(state_dir, LEASE_NAME)
        self.epoch = 0
        self.nonce = ""
        self.deadline = 0.0
        self.adopted = False

    def _now(self) -> float:
        return time.time() + clock_skew()

    def _read(self) -> Optional[Dict]:
        """None when absent, unreadable, or torn — an unreadable lease
        cannot be renewed by anyone, so it counts as expired."""
        try:
            with open(self.path, "rb") as fh:
                rec = json.loads(fh.read())
            if not isinstance(rec, dict):
                return None
            return rec
        except (OSError, ValueError):
            return None

    def try_acquire(self) -> bool:
        """One claim attempt: first-claim if no lease file exists,
        steal if the current lease is expired, released, or torn.
        Returns False while another replica holds a live lease (or won
        the race) — the standby's poll loop just tries again."""
        nonce = os.urandom(8).hex()
        now = self._now()
        lease = {"name": "gateway", "worker": self.owner, "epoch": 1,
                 "nonce": nonce, "deadline": now + self.lease_s}
        if not os.path.exists(self.path):
            blob = (json.dumps(lease, sort_keys=True) + "\n").encode()
            if publish_exclusive(self.path, blob):
                self.epoch, self.nonce = 1, nonce
                self.deadline = lease["deadline"]
                self.adopted = False
                return True
            # Lost the first-claim race; look at what the winner wrote.
        cur = self._read()
        if cur is not None and float(cur.get("deadline", 0.0)) > now:
            return False  # live lease — not ours to touch
        # Expired, released, or torn: take it by rewriting, then verify
        # our write survived — concurrent standbys race on the rename
        # and every loser sees a foreign nonce on re-read.
        released = bool(cur.get("released")) if cur else False
        lease["epoch"] = int(cur.get("epoch", 0)) + 1 if cur else 1
        lease["deadline"] = self._now() + self.lease_s
        atomic_write_bytes(self.path, (json.dumps(
            lease, sort_keys=True) + "\n").encode())
        back = self._read()
        if back is None or back.get("nonce") != nonce:
            return False  # another standby's rename landed after ours
        self.epoch, self.nonce = int(lease["epoch"]), nonce
        self.deadline = lease["deadline"]
        # A steal of a non-released lease is an adoption: the previous
        # holder died without handing off, and its in-flight jobs are
        # now ours to recover. The ``gate/adopt`` fault site sits on
        # exactly this edge so the drill can break an adopting standby.
        self.adopted = not released and cur is not None
        if self.adopted:
            maybe_fault("gate/adopt")
        return True

    def acquire(self, poll_s: Optional[float] = None,
                deadline_s: float = 0.0) -> bool:
        """Block until the lease is ours (the standby loop). Polls at
        ``RACON_TPU_GATE_STANDBY_POLL_S``; with ``deadline_s`` > 0 the
        wait gives up (False) after that many seconds."""
        poll = float(env.read(ENV_STANDBY_POLL_S)) \
            if poll_s is None else float(poll_s)
        t0 = time.monotonic()
        while not self.try_acquire():
            if deadline_s and time.monotonic() - t0 > deadline_s:
                return False
            time.sleep(max(0.01, poll))
        return True

    def verify(self) -> None:
        """Fencing check: raise :class:`GatewayLeaseLost` unless our
        nonce is still the one on disk."""
        cur = self._read()
        if cur is None or cur.get("nonce") != self.nonce:
            raise GatewayLeaseLost(self.owner)

    def renew(self) -> None:
        """Push the deadline out; raises if we were fenced. Verify
        FIRST: renewing over a thief's lease would resurrect a fenced
        gateway."""
        self.verify()
        self.deadline = self._now() + self.lease_s
        lease = {"name": "gateway", "worker": self.owner,
                 "epoch": self.epoch, "nonce": self.nonce,
                 "deadline": self.deadline}
        atomic_write_bytes(self.path, (json.dumps(
            lease, sort_keys=True) + "\n").encode())

    def release(self) -> None:
        """Cooperative handoff marker (clean drain): the next standby
        may claim instantly, and ``adopted`` stays False for it — a
        released gateway's jobs were drained, not orphaned. Never
        unlinks; rewriting keeps the first-claim race armed exactly
        once per state dir lifetime."""
        marker = {"name": "gateway", "worker": self.owner,
                  "epoch": self.epoch, "released": True,
                  "nonce": os.urandom(8).hex(), "deadline": 0.0}
        atomic_write_bytes(self.path, (json.dumps(
            marker, sort_keys=True) + "\n").encode())
        self.nonce = ""
