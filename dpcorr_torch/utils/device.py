"""Device resolution for the port's entry points, the device kind the
measuring layer keys on, and what the measuring scripts
(``chip_smoke.py``'s kernel table, ``dpcorr_torch.perf_fused``) read
from the card."""

from __future__ import annotations

import re
import subprocess

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


def device_kind(device=None) -> str:
    """The one name of a device's kind that the geometry cache keys, the
    roofline's peaks and a measurement's ``device_kind`` stamp use (the
    trajectory's series): ``"cpu"``, or ``"cuda-"``
    and the card's model from ``torch.cuda.get_device_name``
    (``"NVIDIA H100 80GB HBM3"`` → ``"cuda-h100"``). ``device`` resolves
    as the entry points' does: the card unless the caller names another."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev.type
    name = torch.cuda.get_device_name(dev).lower()
    m = re.search(r"[a-z]+\d+[a-z]*", name.replace("nvidia", ""))
    return "cuda-" + (m.group(0) if m else re.sub(r"\W+", "-", name)
                      .strip("-"))


def f32_on(v, device) -> torch.Tensor:
    """``v`` as an f32 tensor on ``device``. A Python number is filled on
    the device, so a hot loop makes no host-to-device copy for it."""
    if isinstance(v, torch.Tensor):
        return v.to(device, torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def per_rep(v, ndim: int):
    """A tensor over the leading (replication) axes with singleton axes
    appended up to ``ndim``, so it broadcasts against a tensor whose
    trailing axes hold the observations; a number passes through."""
    if not isinstance(v, torch.Tensor):
        return v
    return v.reshape(tuple(v.shape) + (1,) * (ndim - v.dim()))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_cuda(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` on the card, by CUDA events over
    ``reps`` calls after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
