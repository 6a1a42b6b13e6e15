"""Laplace noise and clipping.

Counterpart of ``dpcorr/ops/noise.py``: one Laplace sampler on top of the
key-tree (:mod:`dpcorr_torch.utils.rng`), drawing the same uniforms as
``jax.random.laplace`` and applying the same transform, so a draw agrees
with JAX's to the last ulp or two of ``log1p``.

Clipping is the reference's ubiquitous ``pmax(pmin(x, λ), -λ)``.
"""

from __future__ import annotations

import numpy as np
import torch

from dpcorr_torch.utils.device import per_rep
from dpcorr_torch.utils.rng import uniform

#: the lower end of jax's Laplace uniform: −1 + epsneg(f32)
_LAPLACE_LO = -1.0 + float(np.finfo(np.float32).epsneg)


def laplace(key: torch.Tensor, shape=(), scale=1.0) -> torch.Tensor:
    """Laplace(0, scale) draws, shape ``key.shape[:-1] + shape``:
    u ~ U(−1+epsneg, 1), then sign(u)·log1p(−|u|)·scale (jax's
    ``_laplace``). Equivalent in distribution to ``rLap(n, scale)``
    (vert-cor.R:106, real-data-sims.R:58-61). A tensor ``scale`` carries
    the key's leading axes (one scale per replication)."""
    u = uniform(key, shape, _LAPLACE_LO, 1.0)
    return torch.sign(u) * torch.log1p(-torch.abs(u)) * per_rep(scale,
                                                                u.dim())


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``pmin(pmax(x, lo), hi)`` (e.g. real-data-sims.R:67)."""
    return torch.clamp(x, lo, hi)


def clip_sym(x: torch.Tensor, lam) -> torch.Tensor:
    """Symmetric clip to [-λ, λ] (e.g. ver-cor-subG.R:33-34). A tensor λ
    carries the leading axes of ``x`` (one λ per replication)."""
    if isinstance(lam, torch.Tensor):
        lam = per_rep(lam.to(x.dtype), x.dim())
        return torch.maximum(torch.minimum(x, lam), -lam)
    return torch.clamp(x, -lam, lam)
