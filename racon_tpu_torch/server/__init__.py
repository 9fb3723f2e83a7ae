"""Polishing-as-a-service: the resident daemon and its engine library
(port of the JAX package's ``server/``).

- :mod:`racon_tpu_torch.server.engine` — the embeddable engine API every
  frontend shares: ``JobSpec`` (the single source of a run's
  output-affecting identity, the checkpoint fingerprint config),
  ``polish_job`` (the one resume-aware polish/commit/emit loop) and
  ``EngineSession`` (the warm kernel library and engine pool).
- :mod:`racon_tpu_torch.server.batch` — the admission queue and the
  cross-request batcher: windows from several in-flight jobs pack into
  one consensus dispatch on the card; per-tenant round-robin keeps one
  tenant from starving the rest.
- :mod:`racon_tpu_torch.server.daemon` — the HTTP daemon: journaled job
  lifecycle (submit/status/stream/cancel) persisted through the
  checkpoint store, so a restart resumes every in-flight job byte for
  byte.
"""

from racon_tpu_torch.server.engine import (EngineSession, JobHooks,
                                           JobSpec, build_polisher,
                                           polish_job)

__all__ = ["EngineSession", "JobHooks", "JobSpec", "build_polisher",
           "polish_job"]
