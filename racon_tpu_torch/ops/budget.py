"""Device-path element budget and walk depth.

The column walk (ops/colwalk.py) addresses the forward kernels' cell
planes through a flattened index, and the chunk planner sizes chunks so
one plane of B * Lq * W cells stays under :func:`max_dir_elems`. The cap
is the JAX package's, unchanged: it fixes chunk sizes and the walk depth,
so the port packs the same chunks and emits the same bytes.

1. **int32 flat index**: the element count stays below 2^31.
2. **single-buffer ceiling**: element count times cell width below 2^31
   bytes — so the u16 ``nxt2`` plane of the k=4 walk halves the cap.

A 10% margin is kept below both.
"""

from __future__ import annotations

from racon_tpu_torch.utils import env

INT32_INDEX_ELEMS = 2 ** 31
BUFFER_BYTES = 2 ** 31
_MARGIN_NUM, _MARGIN_DEN = 9, 10


def max_dir_elems(cell_bytes: int = 1) -> int:
    """Element cap for ONE forward cell plane of ``cell_bytes``-wide
    cells."""
    if cell_bytes < 1:
        raise ValueError("[racon_tpu_torch::budget] cell_bytes must be >= 1")
    cap = min(INT32_INDEX_ELEMS, BUFFER_BYTES // cell_bytes)
    return cap * _MARGIN_NUM // _MARGIN_DEN


def walk_k_env() -> int:
    """The requested walk depth from ``RACON_TPU_WALK_K``: 4 (default),
    2 or 1. Anything else is an error."""
    raw = env.read(env.WALK_K).strip()
    if not raw:
        return 4
    try:
        k = int(raw)
    except ValueError:
        k = -1
    if k not in (1, 2, 4):
        raise ValueError(
            f"[racon_tpu_torch::budget] {env.WALK_K}={raw!r} invalid — "
            "supported walk depths are 1, 2 and 4")
    return k


def walk_k_for(elems: int, env_k=None) -> int:
    """Admissible walk depth for ``elems`` cells per plane: the requested
    k, degraded to 2 when the u16 ``nxt2`` plane would breach
    ``max_dir_elems(2)``."""
    k = walk_k_env() if env_k is None else int(env_k)
    if k >= 4 and elems > max_dir_elems(2):
        return 2
    return k
