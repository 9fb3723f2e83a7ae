"""Observability (port of part of the JAX package's ``obs/``): the JSONL
span tracer (:mod:`racon_tpu_torch.obs.trace`), the one metrics registry
with its histograms and the service core's recorders
(:mod:`racon_tpu_torch.obs.metrics`; the pipeline's and fault plane's
recorders in :mod:`racon_tpu_torch.pipeline.metrics` write to it), the
flight recorder (:mod:`racon_tpu_torch.obs.flightrec`), the fleet plane
(:mod:`racon_tpu_torch.obs.fleet`: worker metric shards and their
aggregate) and the OpenMetrics renders, fleet health and pull endpoint
(:mod:`racon_tpu_torch.obs.export`)."""

from racon_tpu_torch.obs.trace import (NullTracer, Tracer, configure,
                                       get_tracer)

__all__ = ["Tracer", "NullTracer", "get_tracer", "configure"]
