"""Bounded queues with backpressure and blocked-time accounting.

The pipeline's queues are its flow control: a full queue blocks the
producer (backpressure — a slow FASTA writer eventually stalls the
parser instead of buffering the whole genome in RAM), an empty one
blocks the consumer. Both blocked durations are accounted per queue
(``put_wait_s`` / ``get_wait_s``) along with the peak depth, so the
pipeline's counters (pipeline/metrics.py) say *which* stage starves and
which one chokes. A port of the JAX package's ``pipeline/queues.py``.

Shutdown protocol:

- ``close()`` — no more puts; getters drain the remaining items, then
  :class:`QueueClosed` tells them the stream ended. This is the normal
  end-of-stream path, cascaded stage by stage.
- ``abort()`` — a failure elsewhere; every blocked or future put/get
  raises :class:`PipelineAborted` immediately, remaining items are
  dropped. The pipeline aborts every queue when any stage fails,
  so no thread can hang on a peer that died.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional


class QueueClosed(Exception):
    """End of stream: the queue was closed and fully drained."""


class QueueTimeout(Exception):
    """``get(timeout=...)`` expired with the queue still empty and
    open — the caller's cue to act on what it already holds."""


class PipelineAborted(RuntimeError):
    """The pipeline failed elsewhere; this queue was torn down."""


class BoundedQueue:
    """FIFO with a hard capacity, blocking put/get, and stall metrics."""

    def __init__(self, name: str, capacity: int):
        if capacity < 1:
            raise ValueError(
                f"[racon_tpu_torch::pipeline] queue {name!r}: capacity "
                f"must be >= 1, got {capacity}")
        self.name = name
        self.capacity = capacity
        self._items: deque = deque()
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self._aborted = False
        self.peak_depth = 0
        self.put_wait_s = 0.0
        self.get_wait_s = 0.0
        self.n_items = 0

    # ------------------------------------------------------------- data path

    def put(self, item) -> None:
        """Enqueue; blocks while the queue is at capacity."""
        t0 = time.perf_counter()
        with self._not_full:
            while (len(self._items) >= self.capacity
                   and not self._aborted and not self._closed):
                self._not_full.wait(0.1)
            self.put_wait_s += time.perf_counter() - t0
            if self._aborted:
                raise PipelineAborted(self.name)
            if self._closed:
                raise RuntimeError(
                    "[racon_tpu_torch::pipeline] put on closed queue "
                    f"{self.name!r}")
            self._items.append(item)
            self.n_items += 1
            if len(self._items) > self.peak_depth:
                self.peak_depth = len(self._items)
            self._not_empty.notify()

    def get(self, timeout: Optional[float] = None):
        """Dequeue; blocks while empty. Raises QueueClosed at end of
        stream, PipelineAborted on teardown (pending items dropped),
        QueueTimeout when ``timeout`` seconds pass with the queue
        still empty and open (``timeout=None`` waits forever)."""
        t0 = time.perf_counter()
        deadline = None if timeout is None else t0 + max(timeout, 0.0)
        with self._not_empty:
            while (not self._items and not self._closed
                   and not self._aborted):
                if deadline is not None:
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    self._not_empty.wait(min(0.1, left))
                else:
                    self._not_empty.wait(0.1)
            self.get_wait_s += time.perf_counter() - t0
            if self._aborted:
                raise PipelineAborted(self.name)
            if self._items:
                item = self._items.popleft()
                self._not_full.notify()
                return item
            if self._closed:
                raise QueueClosed(self.name)
            raise QueueTimeout(self.name)

    # ------------------------------------------------------------- lifecycle

    def close(self) -> None:
        """End of stream: getters drain, then see QueueClosed."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def abort(self) -> None:
        """Failure teardown: wake and fail every blocked put/get."""
        with self._lock:
            self._aborted = True
            self._items.clear()
            self._not_empty.notify_all()
            self._not_full.notify_all()

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    def metrics(self) -> Dict[str, object]:
        """Gauge snapshot for the pipeline's counters."""
        with self._lock:
            return {
                "peak": self.peak_depth,
                "capacity": self.capacity,
                "items": self.n_items,
                "put_wait_s": round(self.put_wait_s, 6),
                "get_wait_s": round(self.get_wait_s, 6),
            }
