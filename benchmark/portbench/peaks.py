"""The card's peaks that the rooflines are read against.

NVIDIA's H100 SXM data sheet: HBM3 at 3.35 TB/s, at the full power limit
of 700 W. The data sheet gives no int32 rate, so it is derived: 132 SMs
x 64 INT32 lanes an SM x 1.98 GHz boost clock = 16.7 TOP/s (the sheet's
67 TFLOP/s of FP32 is 128 lanes x 2 operations of an FMA at that clock).
A card set below 700 W (``nvidia-smi --query-gpu=power.limit``) runs
slower under load; the run reports the limit beside the shares.
"""

HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the int32 rate and the bytes over HBM's."""
    return max(ops / INT32_OPS_S, nbytes / HBM_BYTES_S)
