"""State carried across between the JAX package and the port.

The system has no weights: its state is the key-tree. This module turns
``jax.random.key_data`` words (numpy uint32, shape ``(..., 2)``) into port
keys and back, so both packages can be handed the same key and draw the
same noise. It imports neither JAX nor the JAX package: callers pass
numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from dpcorr_torch.utils import rng


def keys_from_jax_data(words, device=None) -> torch.Tensor:
    """uint32 key words ``(..., 2)`` (e.g. ``np.asarray(jax.random.key_data
    (k))``) → port keys on ``device`` (the CPU if None)."""
    arr = np.asarray(words)
    if arr.dtype != np.uint32:
        raise TypeError(f"key words must be uint32, got {arr.dtype}")
    return rng.keys_from_data(arr).to(device or "cpu")


def keys_to_jax_data(keys: torch.Tensor) -> np.ndarray:
    """Port keys → uint32 words ``(..., 2)`` for ``jax.random.wrap_key_data``."""
    return rng.key_data(keys).cpu().numpy().astype(np.uint32)
