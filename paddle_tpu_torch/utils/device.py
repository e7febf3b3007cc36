"""The device an entry point runs on: CUDA unless the caller asks for
another, and never a silent move to the CPU."""

from __future__ import annotations

from typing import Union

import torch

from paddle_tpu_torch.utils.error import Error


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise Error(f"device {device} requested but no CUDA device is "
                    "available; pass device='cpu' to run on the CPU")
    return device
