"""Two-tier content-addressed result cache (port of the JAX package's
``cache/``; its docs/CACHE.md).

A polishing service sees the same inputs repeatedly — re-polish after
an upstream tweak, shared reference datasets across tenants, retried or
resubmitted jobs — yet without this package every submission
redispatches every window. The identity machinery that makes caching
safe already exists and is trusted: :meth:`JobSpec.fingerprint`
(config + content digests of all three inputs, resilience/checkpoint.py
``run_fingerprint``) names a whole job's output, and window consensus
is a pure function of (window content, scoring config) — the
per-window determinism invariant the serial/streaming/serve
differential tests pin.

Two tiers, both keyed purely by content:

- **Tier 1 — job-level CAS**
  (:class:`~racon_tpu_torch.cache.cas.ResultCache`):
  an on-disk store of committed contig records keyed by the job
  fingerprint, verify-on-hit (a corrupt or torn entry demotes to a
  miss and is quarantined — it can never change output bytes),
  size-bounded LRU eviction over an atomically-published index, and
  journal-aware recovery (a daemon restart reloads the index without
  re-hashing payloads; verification happens per hit, where it pays).
- **Tier 2 — window memoization**
  (:class:`~racon_tpu_torch.cache.memo.WindowMemo`): consensus memoization
  inside the cross-request batcher — each window is probed by its
  content digest before it is packed into a dispatch; hits skip the
  device entirely and splice into ordered retirement, so
  partially-overlapping jobs dispatch only the delta.

Gates: the cache is ON by default for the resident daemon and OFF for
the serial CLI unless ``--cache-dir`` is given; ``RACON_TPU_CACHE=0``
disables both tiers everywhere, falling back byte-identically to the
uncached path. Fault sites ``cache/load`` / ``cache/store`` drill the
poisoning and store-failure paths; ``cache_*`` registry metrics and
``cache`` trace points carry the accounting (docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import os

from racon_tpu_torch.cache.cas import (CacheError, ResultCache,
                                 records_from_store, replay_records)
from racon_tpu_torch.cache.memo import WindowMemo, window_digest
from racon_tpu_torch.utils import env

ENV_CACHE = env.CACHE
ENV_CACHE_DIR = env.CACHE_DIR
ENV_CACHE_WINDOWS = env.CACHE_WINDOWS

__all__ = ["CacheError", "ResultCache", "WindowMemo", "cache_enabled",
           "cache_dir_for", "records_from_store", "replay_records",
           "window_digest", "window_memo_enabled", "ENV_CACHE",
           "ENV_CACHE_DIR", "ENV_CACHE_WINDOWS"]


def cache_enabled() -> bool:
    """The global cache gate: on unless ``RACON_TPU_CACHE`` is
    explicitly 0/false. Frontends add their own arming condition on
    top (the daemon arms by default; the serial CLI only with
    ``--cache-dir``)."""
    return env.read(ENV_CACHE) not in ("0", "false")


def window_memo_enabled() -> bool:
    """Tier-2 gate: window memoization rides the main gate and can be
    turned off alone with ``RACON_TPU_CACHE_WINDOWS=0`` (Tier 1 keeps
    serving whole-job hits)."""
    return cache_enabled() and \
        env.read(ENV_CACHE_WINDOWS) not in ("0", "false")


def cache_dir_for(state_dir: str) -> str:
    """The daemon's cache root: ``RACON_TPU_CACHE_DIR`` when set, else
    ``<state-dir>/cache`` — co-located with the job journal so one
    volume carries the daemon's whole durable state."""
    return env.read(ENV_CACHE_DIR) or os.path.join(state_dir,
                                                       "cache")
