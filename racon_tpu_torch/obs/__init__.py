"""Observability: the JSONL span tracer (:mod:`racon_tpu_torch.obs.trace`),
port of the JAX package's ``obs/trace.py``. The counters live in
:mod:`racon_tpu_torch.pipeline.metrics`, the port's one registry."""

from racon_tpu_torch.obs.trace import (NullTracer, Tracer, configure,
                                       get_tracer)

__all__ = ["Tracer", "NullTracer", "get_tracer", "configure"]
