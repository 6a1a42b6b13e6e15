"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. With no device given and no CUDA device present this raises;
    it never falls back to the CPU quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card "
                "unless the caller passes device='cpu'")
        return torch.device("cuda")
    return torch.device(device)


def f32_on(v, device) -> torch.Tensor:
    """``v`` as an f32 tensor on ``device``. A Python number is filled on
    the device, so a hot loop makes no host-to-device copy for it."""
    if isinstance(v, torch.Tensor):
        return v.to(device, torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)
