"""A. Non-interactive sign-batch estimator + CI (Gaussian).

Counterpart of ``dpcorr/models/estimators/ni_sign.py``: reference
``correlation_NI_signbatch`` (vert-cor.R:118-156) and ``ci_NI_signbatch``
(vert-cor.R:204-255), with the same stream names
(``ni_sign/std_x|std_y|lap_x|lap_y``). Observations sit on the last axis;
``key`` carries the same leading replication axes.
"""

from __future__ import annotations

import math

import torch
from torch.special import ndtri

from dpcorr_torch.models.estimators.common import (
    CorrResult,
    batch_geometry,
    batch_means,
    sample_sd,
)
from dpcorr_torch.ops.noise import laplace
from dpcorr_torch.ops.standardize import priv_center
from dpcorr_torch.utils.rng import stream

_HALF_PI = math.pi / 2.0


def l_clip_for(n: int, device=None) -> torch.Tensor:
    """The centering clip √(2·log n), evaluated in f32 as the JAX
    estimators do."""
    nf = torch.full((), float(n), dtype=torch.float32, device=device)
    return torch.sqrt(2.0 * torch.log(nf))


def crit_value(alpha: float, device=None) -> torch.Tensor:
    """z_{1−α/2} in f32."""
    return ndtri(torch.full((), 1.0 - alpha / 2.0, dtype=torch.float32,
                            device=device))


def _noisy_batch_products(key, x, y, eps1, eps2, m, k):
    """Sign batch means + Laplace (sensitivity 2/m), returning X̃, Ỹ."""
    xbar = batch_means(torch.sign(x), k, m)
    ybar = batch_means(torch.sign(y), k, m)
    xt = xbar + laplace(stream(key, "ni_sign/lap_x"), (k,), 2.0 / (m * eps1))
    yt = ybar + laplace(stream(key, "ni_sign/lap_y"), (k,), 2.0 / (m * eps2))
    return xt, yt


def correlation_ni_signbatch(key: torch.Tensor, x: torch.Tensor,
                             y: torch.Tensor, eps1: float,
                             eps2: float) -> torch.Tensor:
    """Point estimator ρ̂ (vert-cor.R:118-156). Inputs pre-standardized."""
    n = x.shape[-1]
    m, k = batch_geometry(n, eps1, eps2)
    xt, yt = _noisy_batch_products(key, x, y, eps1, eps2, m, k)
    eta_hat = (m / k) * (xt * yt).sum(-1)
    return torch.sin(math.pi * eta_hat / 2.0)


def ci_ni_signbatch(key: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    eps1: float, eps2: float, alpha: float = 0.05,
                    normalise: bool = True) -> CorrResult:
    """Estimate + CI (vert-cor.R:204-255): with ``normalise`` the raw
    values are privately centered (clip √(2·log n)) first; the CI is built
    in η-space from T_j = m·X̃_j·Ỹ_j, clamped there, then sine-mapped."""
    n = x.shape[-1]
    m, k = batch_geometry(n, eps1, eps2)
    if normalise:
        l_clip = l_clip_for(n, x.device)
        x = priv_center(stream(key, "ni_sign/std_x"), x, eps1, l_clip)
        y = priv_center(stream(key, "ni_sign/std_y"), y, eps2, l_clip)

    xt, yt = _noisy_batch_products(key, x, y, eps1, eps2, m, k)
    tj = m * xt * yt  # vert-cor.R:233
    eta_hat = tj.sum(-1) / k
    rho_hat = torch.sin(math.pi * eta_hat / 2.0)
    half = crit_value(alpha, x.device) * sample_sd(tj) / math.sqrt(k)
    lo = torch.sin(_HALF_PI * torch.clamp_min(eta_hat - half, -1.0))
    hi = torch.sin(_HALF_PI * torch.clamp_max(eta_hat + half, 1.0))
    return CorrResult(rho_hat, lo, hi)
