"""The port's "mesh": the list of torch devices replications shard over.

Counterpart of ``dpcorr/parallel/mesh.py``. JAX shards over a 1-D
``Mesh`` with a ``rep`` axis; here the axis is a plain list of devices.
On the card it is ``cuda:0 … cuda:k-1`` (one entry on one H100); with
``device="cpu"`` it is ``n_devices`` entries of the CPU, the counterpart
of the JAX tests' virtual CPU devices (the shards then run one after
another on the same device, with the same per-replication results).
"""

from __future__ import annotations

import torch

from dpcorr_torch.utils.device import resolve_device


def local_device_count(device=None) -> int:
    """Devices this process can shard over: the visible cards, or one for
    the CPU. Raises without a card unless ``device="cpu"``."""
    if resolve_device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def rep_devices(n_devices: int | None = None,
                device=None) -> list[torch.device]:
    """The first ``n_devices`` cards (default: all visible), or with
    ``device="cpu"`` ``n_devices`` CPU entries (default 1). Raises without
    a card unless the CPU is asked for, and when more cards are asked for
    than are visible."""
    dev = resolve_device(device)
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if dev.type != "cuda":
        return [dev] * (n_devices or 1)
    count = torch.cuda.device_count()
    if not count:
        raise RuntimeError("no CUDA device is available; the port runs on "
                           "the card unless the caller passes device='cpu'")
    if n_devices is not None and n_devices > count:
        raise ValueError(f"{n_devices} devices asked for, {count} visible")
    return [torch.device("cuda", i) for i in range(n_devices or count)]


def rep_mesh(n_devices: int | None = None, device=None) -> list[torch.device]:
    """The port's name for ``dpcorr.parallel.mesh.rep_mesh``: the 1-D
    ``rep`` axis, here :func:`rep_devices`'s list of devices (the first
    ``n_devices`` cards, or CPU entries with ``device="cpu"``)."""
    return rep_devices(n_devices, device=device)
