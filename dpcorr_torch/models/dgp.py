"""Synthetic data-generating process (reference layer L0), Gaussian only.

Counterpart of ``dpcorr/models/dgp.py``'s ``_bvn``/``gen_gaussian``: the
closed-form 2×2 Cholesky factor on the key-tree's normals.

Normals are jax's construction, √2·erfinv(u) with u ~ U(nextafter(−1, 0),
1) drawn bit-exactly from the key-tree, but through ``torch.erfinv``,
which is not XLA's f32 polynomial. The port holds them to a tolerance
rather than porting XLA's polynomial: over 2²⁰ draws the relative error
was at most 5.7e-6 with no sign flips, and every estimator here consumes
only signs of centered values, so outputs agree except where a centered
value sits within ~1e-5 of 0 (``tests/test_torch_estimators.py`` counts
those cases).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dpcorr_torch.utils.device import f32_on
from dpcorr_torch.utils.rng import uniform

_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(math.sqrt(2.0)))


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """Standard normal f32 draws, shape ``key.shape[:-1] + shape``."""
    return _SQRT2 * torch.erfinv(uniform(key, shape, _NORMAL_LO, 1.0))


def _bvn(key, n, rho, mu, sigma):
    """Bivariate normal via 2×2 Cholesky: X = μ₁+σ₁Z₁,
    Y = μ₂+σ₂(ρZ₁+√(1−ρ²)Z₂). ``rho`` is a float or a tensor broadcasting
    against the key's leading axes. Returns (..., n, 2)."""
    z = normal(key, (n, 2))
    rho = f32_on(rho, z.device)
    rho = rho.reshape(*rho.shape, *([1] * (z.dim() - 1 - rho.dim())))
    mu = [float(np.float32(v)) for v in mu]
    sigma = [float(np.float32(v)) for v in sigma]
    x = mu[0] + sigma[0] * z[..., 0]
    y = mu[1] + sigma[1] * (rho * z[..., 0]
                            + torch.sqrt(1.0 - rho * rho) * z[..., 1])
    return torch.stack([x, y], dim=-1)


def gen_gaussian(key: torch.Tensor, n: int, rho, mu=(0.0, 0.0),
                 sigma=(1.0, 1.0)) -> torch.Tensor:
    """Bivariate Gaussian with corr ρ and per-coordinate (μ, σ)
    (vert-cor.R:64-73, 389-394)."""
    return _bvn(key, n, rho, mu, sigma)
