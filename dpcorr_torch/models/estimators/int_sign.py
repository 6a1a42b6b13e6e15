"""B. One-round interactive sign-flip (randomized response) estimator + CI.

Counterpart of ``dpcorr/models/estimators/int_sign.py``: reference
``correlation_INT_signflip`` (vert-cor.R:164-195) and ``ci_INT_signflip``
(vert-cor.R:260-317), deterministic mixquant only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dpcorr_torch.models.estimators.common import CorrResult
from dpcorr_torch.models.estimators.ni_sign import l_clip_for
from dpcorr_torch.ops.mixquant import mixquant
from dpcorr_torch.ops.noise import laplace
from dpcorr_torch.ops.standardize import priv_center
from dpcorr_torch.utils.rng import stream, uniform

_HALF_PI = math.pi / 2.0


def int_constants(n: int, eps1: float, eps2: float):
    """(ε_s, ε_r, p_keep, c_η, scale_z): sender = larger ε
    (vert-cor.R:170-191)."""
    eps_s, eps_r = max(eps1, eps2), min(eps1, eps2)
    e_s = math.exp(eps_s)
    p_keep = e_s / (e_s + 1.0)
    c_eta = (e_s + 1.0) / (n * (e_s - 1.0))
    scale_z = 2.0 * (e_s + 1.0) / (n * (e_s - 1.0) * eps_r)
    return eps_s, eps_r, p_keep, c_eta, scale_z


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli``: f32 uniform < p (p rounded to f32)."""
    return uniform(key, shape) < float(np.float32(p))


def correlation_int_signflip(key: torch.Tensor, x: torch.Tensor,
                             y: torch.Tensor, eps1: float,
                             eps2: float) -> torch.Tensor:
    """Point estimator ρ̂ (vert-cor.R:164-195). Inputs pre-standardized."""
    n = x.shape[-1]
    _, _, p_keep, c_eta, scale_z = int_constants(n, eps1, eps2)
    s = bernoulli(stream(key, "int_sign/flips"), p_keep, (n,))
    core = (2.0 * s.to(torch.float32) - 1.0) * torch.sign(x) * torch.sign(y)
    z = laplace(stream(key, "int_sign/lap_z"), (), scale_z)
    eta_hat = c_eta * core.sum(-1) + z
    return torch.sin(math.pi * eta_hat / 2.0)


def interval_from_rho(rho_hat: torch.Tensor, n: int, eps_s: float,
                      eps_r: float, alpha: float,
                      mode: str = "auto") -> CorrResult:
    """CI construction given ρ̂ (vert-cor.R:281-317), det mixquant.
    ``mode`` "auto" switches normal/laplace at √n·ε_r > 0.5."""
    e_s = math.exp(eps_s)
    ratio = (e_s + 1.0) / (e_s - 1.0)
    eta_hat = 1.0 - torch.arccos(rho_hat) * 2.0 / math.pi
    sigma_eta2 = 1.0 - (1.0 / ratio) ** 2 * eta_hat**2
    sqrt_n = torch.sqrt(torch.full((), float(n), dtype=torch.float32,
                                   device=rho_hat.device))
    se_norm_eta = torch.sqrt(sigma_eta2) * ratio / sqrt_n

    if mode == "auto":
        mode = "normal" if math.sqrt(n) * eps_r > 0.5 else "laplace"
    if mode == "normal":
        cstar = 2.0 / (torch.sqrt(n * sigma_eta2) * eps_r)
        width_eta = mixquant(cstar, 1.0 - alpha / 2.0) * se_norm_eta
    elif mode == "laplace":
        width_eta = torch.full_like(
            eta_hat, (2.0 / (n * eps_r)) * ratio * math.log(1.0 / alpha))
    else:
        raise ValueError(f"mode must be auto|normal|laplace, got {mode!r}")

    lo = torch.sin(_HALF_PI * torch.clamp_min(eta_hat - width_eta, -1.0))
    hi = torch.sin(_HALF_PI * torch.clamp_max(eta_hat + width_eta, 1.0))
    return CorrResult(rho_hat, lo, hi)


def ci_int_signflip(key: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    eps1: float, eps2: float, alpha: float = 0.05,
                    mode: str = "auto",
                    normalise: bool = True) -> CorrResult:
    """Estimate + CI (vert-cor.R:260-317)."""
    n = x.shape[-1]
    if normalise:
        l_clip = l_clip_for(n, x.device)
        x = priv_center(stream(key, "int_sign/std_x"), x, eps1, l_clip)
        y = priv_center(stream(key, "int_sign/std_y"), y, eps2, l_clip)
    eps_s, eps_r = max(eps1, eps2), min(eps1, eps2)
    rho_hat = correlation_int_signflip(stream(key, "int_sign/est"), x, y,
                                       eps1, eps2)
    return interval_from_rho(rho_hat, n, eps_s, eps_r, alpha, mode)
