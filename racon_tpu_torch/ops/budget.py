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

The overlap aligner (ops/ovl_align.py) also takes the JAX package's
**admission rules** verbatim: ``VMEM_BUDGET``/:func:`vmem_est` and the
tiled route's ``TILE_TIERS``/:func:`tile_plan`. They model a TPU core's
fast memory, not this card: they decide which overlaps go to the device,
at which band width W, lane count and walk depth, so that every lane's
certificate and every host fallback is the reference's.

These rules size a **chunk**. What a **launch** carries is the group
planner's (ovl_align.plan_groups): consecutive tiled chunks of one bucket
run as one launch of as many lanes as fill one wave of the card, with
their planes held under ``GROUP_MEM_FRACTION`` of the card's memory. The
port's kernels index the planes in 64 bits, so a group's planes may pass
the 2^31 elements that cap one chunk. The CUDA kernels' own limits (W/4
<= 1024 threads a block; shared memory of about W + T bytes plus the
score rows) are checked in the wrappers (ops/kernels.py).
"""

from __future__ import annotations

from racon_tpu_torch.utils import env

INT32_INDEX_ELEMS = 2 ** 31
BUFFER_BYTES = 2 ** 31
_MARGIN_NUM, _MARGIN_DEN = 9, 10


def round_up(n: int, mult: int) -> int:
    """``n`` (at least 1) rounded up to a multiple of ``mult``."""
    return ((max(n, 1) + mult - 1) // mult) * mult


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


# Ceiling on one tiled launch group's planes, as a fraction of the
# card's memory (the group planner's, not an admission rule).
GROUP_MEM_FRACTION = 0.25


# ------------------------------------- decoupled-walk in-flight queue

# The JAX package's aggregate budget for the final-round planes that
# decoupled chunks park between their forward and their walk
# (pipeline/streaming.py): one XLA buffer's worth, with the 9/10 margin.
WALK_QUEUE_BYTES = BUFFER_BYTES * _MARGIN_NUM // _MARGIN_DEN


def walk_queue_bytes(device_type: str, total_bytes: int = 0) -> int:
    """The walk queue's byte budget on a device: on ``cuda``,
    GROUP_MEM_FRACTION of the card's ``total_bytes`` (the share a launch
    group's planes may take); elsewhere the JAX package's
    WALK_QUEUE_BYTES.

    The reference caps the queue at one XLA buffer (2^31 bytes less the
    margin), which at the main chunk's final round (B = 4096, Lq = 640,
    band 192, k = 4: 2.01 GB of planes) admits no chunk, so every chunk
    would take the fused path. A card's memory is the real limit here:
    on an 80 GB card the budget is 20 GB, and three parked chunks take 6.
    The budget decides only which chunks walk decoupled; either way the
    output bytes are the same. The CPU keeps the reference's constant,
    so the CPU runs admit exactly the chunks the reference admits."""
    if device_type == "cuda":
        return int(GROUP_MEM_FRACTION * int(total_bytes))
    return WALK_QUEUE_BYTES


def walk_plane_bytes(B: int, Lq: int, W: int, nxt_k: int) -> int:
    """Device bytes of ONE chunk's walk-input planes at lanes B, query
    padding Lq, (band or anchor) width W and walk depth nxt_k: the u8
    cell plane, the u8 ``nxt`` plane at k >= 2 and the u16 ``nxt2`` plane
    at k >= 4. The per-lane scalars and the carried round state are small
    beside them and are not counted."""
    per = 1 + (1 if nxt_k >= 2 else 0) + (2 if nxt_k >= 4 else 0)
    return int(B) * int(Lq) * int(W) * per


def walk_queue_depth(plane_bytes: int, want: int,
                     budget: int = WALK_QUEUE_BYTES) -> int:
    """Admissible in-flight walk-queue depth: ``want`` clamped so that
    ``depth * plane_bytes <= budget`` (walk_queue_bytes). 0 means the
    decoupled path is off; a chunk too large for even one queued plane
    set clamps to 0."""
    if want <= 0:
        return 0
    if plane_bytes <= 0:
        return int(want)
    return min(int(want), int(budget) // int(plane_bytes))


def walk_queue_env(default: int) -> int:
    """The requested walk-queue depth from ``RACON_TPU_WALK_QUEUE`` (empty:
    ``default``, the pipeline depth). Non-integers and negatives are
    errors."""
    raw = env.read(env.WALK_QUEUE).strip()
    if not raw:
        return int(default)
    try:
        d = int(raw)
    except ValueError:
        d = -1
    if d < 0:
        raise ValueError(
            f"[racon_tpu_torch::budget] {env.WALK_QUEUE}={raw!r} invalid — "
            "expected a non-negative integer queue depth")
    return d

# Usable fraction of the reference's per-core VMEM scoped limit
# (admission rule, see the module docstring).
VMEM_BUDGET = 12 * 1024 * 1024


def vmem_est(W: int, Lq: int, ch: int, nxt_k: int = 2) -> int:
    """The reference's band-kernel VMEM block-byte model: the (W+Lq, 128)
    int32 target window, the double-buffered (ch, W, 128) u8 cell and nxt
    blocks (plus the u16 nxt2 block at ``nxt_k >= 4``) and four W-tall
    128-lane int32 rows."""
    planes = 8 * ch if nxt_k >= 4 else 4 * ch
    return 128 * (4 * (W + Lq) + W * (planes + 16))


# Tiers (lanes, W, T, ch) of the tiled overlap route, preferred first.
# With the 1.93e9 u8 cap they admit reads up to about 18 kb, 57 kb and
# 114 kb.
TILE_TIERS = (
    (64, 1536, 2048, 4),
    (16, 2048, 2048, 4),
    (8, 2048, 4096, 4),
)


class TilePlan:
    """Admission result for one tiled overlap job: chunk geometry plus
    the padded query length / tile count the dispatch will use.
    ``nxt_k`` is the tier's walk depth."""

    __slots__ = ("lanes", "W", "T", "ch", "Lq", "n_tiles", "nxt_k")

    def __init__(self, lanes, W, T, ch, Lq, n_tiles, nxt_k=2):
        self.lanes = lanes
        self.W = W
        self.T = T
        self.ch = ch
        self.Lq = Lq
        self.n_tiles = n_tiles
        self.nxt_k = nxt_k

    def key(self):
        return (self.lanes, self.W, self.T, self.ch, self.nxt_k)

    def __repr__(self):  # pragma: no cover - debugging aid
        return ("TilePlan(lanes=%d, W=%d, T=%d, ch=%d, Lq=%d, "
                "n_tiles=%d, nxt_k=%d)"
                % (self.lanes, self.W, self.T, self.ch, self.Lq,
                   self.n_tiles, self.nxt_k))


def tile_plan(lq: int, lt: int, tiers=None):
    """The first tier that admits an (lq, lt) overlap job, or None (the
    job takes the host aligner). A tier admits when ``|lt - lq| <= W //
    2``, ``lanes * round_up(lq, T) * W <= max_dir_elems(1)`` and
    ``vmem_est(W, T, ch) <= VMEM_BUDGET``; its ``nxt_k`` is 4 only when
    the u16 nxt2 plane also fits both budgets."""
    if tiers is None:
        tiers = TILE_TIERS
    lq = max(int(lq), 1)
    lt = max(int(lt), 1)
    cap = max_dir_elems(1)
    for lanes, W, T, ch in tiers:
        if abs(lt - lq) > W // 2:
            continue
        Lq = -(-lq // T) * T
        if lanes * Lq * W > cap:
            continue
        if vmem_est(W, T, ch) > VMEM_BUDGET:
            continue
        nxt_k = walk_k_for(lanes * Lq * W)
        if nxt_k >= 4 and vmem_est(W, T, ch, 4) > VMEM_BUDGET:
            nxt_k = 2
        return TilePlan(lanes, W, T, ch, Lq, Lq // T, max(nxt_k, 1))
    return None
