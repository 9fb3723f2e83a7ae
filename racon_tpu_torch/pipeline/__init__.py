"""Streaming execution pipeline — port of the JAX package's ``pipeline/``:
overlapped pack -> h2d -> compute -> walk stages with bounded queues.

- :mod:`racon_tpu_torch.pipeline.queues` — bounded queues with
  backpressure, depth gauges and blocked-time accounting;
- :mod:`racon_tpu_torch.pipeline.stages` — single-thread stages wired by
  queues, with clean shutdown and exception propagation (a stage failure
  aborts every queue and re-raises at the consumer), and the stall
  detector;
- :mod:`racon_tpu_torch.pipeline.streaming` — the polish executor
  (stream_consensus) and the ingest prefetcher;
- :mod:`racon_tpu_torch.pipeline.metrics` — their counters.

Gating (the JAX package's truth table): the pipeline is OFF by default.
``RACON_TPU_PIPELINE=1`` (or the CLI's ``--pipeline-depth N`` with N > 0)
turns it on; ``RACON_TPU_PIPELINE=0`` forces the serial path whatever the
CLI says. ``RACON_TPU_PIPELINE_DEPTH`` (default 2) bounds the chunks in
flight a queue; ``RACON_TPU_WALK_ASYNC`` (default on) lets the pipeline's
fixed-round path walk each chunk's final round in a stage of its own. The
serial and streamed paths give the same bytes.
"""

from __future__ import annotations

from typing import Optional

from racon_tpu_torch.utils import env

ENV_PIPELINE = env.PIPELINE
ENV_DEPTH = env.PIPELINE_DEPTH
ENV_WALK_ASYNC = env.WALK_ASYNC

#: Default bound on in-flight chunks per queue: depth 2 = double buffering
#: (chunk N computes while chunk N+1's buffers sit on the card).
DEFAULT_DEPTH = 2

# The CLI's --pipeline-depth (configure()); None = the environment decides.
_cli_depth: Optional[int] = None


def configure(depth: Optional[int]) -> None:
    """Install the CLI's --pipeline-depth for this process.

    ``depth > 0`` enables the pipeline with that bound; ``depth == 0``
    disables it; ``None`` leaves the decision to the environment.
    ``RACON_TPU_PIPELINE=0`` always wins.
    """
    global _cli_depth
    if depth is not None and depth < 0:
        raise ValueError(
            f"[racon_tpu_torch::pipeline] invalid pipeline depth {depth}")
    _cli_depth = depth


def pipeline_enabled() -> bool:
    """Streaming pipeline gate (module docstring has the truth table)."""
    val = env.read(ENV_PIPELINE)
    if val in ("0", "false"):
        return False
    if _cli_depth is not None:
        return _cli_depth > 0
    return val != ""


def walk_async_enabled() -> bool:
    """Decoupled-walk gate (default on). The executor also keeps the fused
    path where no overlap is possible: pipeline off, the scheduler, the
    last chunk, an over-budget walk queue (pipeline/streaming.py)."""
    return env.read(ENV_WALK_ASYNC) not in ("0", "false")


def pipeline_depth() -> int:
    """Bounded-queue capacity (in-flight chunks per stage edge)."""
    if _cli_depth is not None and _cli_depth > 0:
        return _cli_depth
    val = env.read(ENV_DEPTH)
    if val:
        try:
            d = int(val)
        except ValueError as exc:
            raise ValueError(
                f"[racon_tpu_torch::pipeline] invalid {ENV_DEPTH}={val!r}"
            ) from exc
        if d > 0:
            return d
    return DEFAULT_DEPTH


from racon_tpu_torch.pipeline.queues import (BoundedQueue,  # noqa: E402
                                             PipelineAborted, QueueClosed,
                                             QueueTimeout)
from racon_tpu_torch.pipeline.stages import (ENV_STALL,  # noqa: E402
                                             Pipeline, PipelineStalled,
                                             StageError, stall_window_s)

__all__ = [
    "BoundedQueue", "DEFAULT_DEPTH", "ENV_DEPTH", "ENV_PIPELINE",
    "ENV_STALL", "ENV_WALK_ASYNC", "Pipeline", "PipelineAborted",
    "PipelineStalled", "QueueClosed", "QueueTimeout", "StageError",
    "configure", "pipeline_depth", "pipeline_enabled", "stall_window_s",
    "walk_async_enabled",
]
