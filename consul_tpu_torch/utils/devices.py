"""Device choice for the port's entry points: the card unless the caller
names another device.  With no card and no device given they raise, so
a run never lands on the CPU without the caller asking for it."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
