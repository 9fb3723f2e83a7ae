"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``. A CUDA
request on a host without a usable GPU raises: the port never carries on
quietly on the CPU.
"""

from __future__ import annotations

import torch


class DeviceError(RuntimeError):
    pass


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceError(
            "[racon_tpu_torch::] error: no CUDA device is available; pass "
            "--device cpu (library: device='cpu') to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise DeviceError(
            f"[racon_tpu_torch::] error: unsupported device {device!r}")
    if dev.type == "cuda":
        # Vote sums must stay exact f32 (ops/device_merge.py): no TF32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
