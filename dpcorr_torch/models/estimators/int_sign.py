"""B. One-round interactive sign-flip (randomized response) estimator + CI.

Counterpart of ``dpcorr/models/estimators/int_sign.py``: reference
``correlation_INT_signflip`` (vert-cor.R:164-195) and ``ci_INT_signflip``
(vert-cor.R:260-317), with the deterministic or the Monte-Carlo mixture
quantile.
"""

from __future__ import annotations

import math

import torch

from dpcorr_torch.models.estimators.common import CorrResult
from dpcorr_torch.models.estimators.ni_sign import l_clip_for
from dpcorr_torch.ops.mixquant import mixquant, mixquant_mc
from dpcorr_torch.ops.noise import laplace
from dpcorr_torch.ops.standardize import priv_center
from dpcorr_torch.utils.rng import bernoulli, stream

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


def interval_from_rho(key: torch.Tensor | None, rho_hat: torch.Tensor,
                      n: int, eps_s: float, eps_r: float, alpha: float,
                      mode: str = "auto",
                      mixquant_mode: str = "det") -> CorrResult:
    """CI construction given ρ̂ (vert-cor.R:281-317), shared by the
    materialized and streaming estimators. ``mode`` "auto" switches
    normal/laplace at √n·ε_r > 0.5. ``key`` is the CI-level key, from
    which ``mixquant_mode="mc"`` draws (stream ``"int_sign/mixquant"``);
    the deterministic quantile needs none."""
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
        if mixquant_mode == "mc":
            q = mixquant_mc(stream(key, "int_sign/mixquant"), cstar,
                            1.0 - alpha / 2.0)
        else:
            q = mixquant(cstar, 1.0 - alpha / 2.0)
        width_eta = q * se_norm_eta
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
                    mode: str = "auto", normalise: bool = True,
                    mixquant_mode: str = "det") -> CorrResult:
    """Estimate + CI (vert-cor.R:260-317). ``mixquant_mode`` "mc" is the
    reference's per-CI 1000-draw order statistic (vert-cor.R:302)."""
    n = x.shape[-1]
    if normalise:
        l_clip = l_clip_for(n, x.device)
        x = priv_center(stream(key, "int_sign/std_x"), x, eps1, l_clip)
        y = priv_center(stream(key, "int_sign/std_y"), y, eps2, l_clip)
    eps_s, eps_r = max(eps1, eps2), min(eps1, eps2)
    rho_hat = correlation_int_signflip(stream(key, "int_sign/est"), x, y,
                                       eps1, eps2)
    return interval_from_rho(key, rho_hat, n, eps_s, eps_r, alpha, mode,
                             mixquant_mode)
