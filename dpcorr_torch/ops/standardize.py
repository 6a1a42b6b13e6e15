"""DP standardization primitives (reference layer L1).

Counterpart of ``dpcorr/ops/standardize.py``, both families:

- the simulation side, ``priv_standardize`` and its parts
  (vert-cor.R:322-348): symmetric clip, ε split in half between the DP
  mean and the DP second moment, the stream addresses
  ``"priv_standardize/mu"`` and ``"priv_standardize/m2"``;
- the real-data building blocks ``dp_mean``, ``dp_second_moment``,
  ``dp_sd`` and ``standardize_dp`` with asymmetric [lo, hi] bounds
  (real-data-sims.R:64-100), streams ``"dp_sd/mean"`` and ``"dp_sd/m2"``.

Inputs carry the observations on their last axis and any number of
leading replication axes; ``key`` has the matching leading axes. NA
handling is the caller's, before any of these runs.
"""

from __future__ import annotations

import torch

from dpcorr_torch.ops.noise import clip, clip_sym, laplace
from dpcorr_torch.utils.device import f32_on, per_rep
from dpcorr_torch.utils.rng import stream


def priv_mean_from_sum(key: torch.Tensor, s1, n: int, eps_norm, l_raw):
    """DP mean from Σ clip(x): ε/2 of the standardization budget,
    sensitivity 2L/n (vert-cor.R:337-339)."""
    eps_half = eps_norm / 2.0
    return s1 / n + laplace(stream(key, "priv_standardize/mu"), (),
                            2.0 * l_raw / (n * eps_half))


def priv_moments_from_sums(key: torch.Tensor, s1, s2, n: int, eps_norm,
                           l_raw, var_floor=1e-12):
    """(μ_priv, var_priv) from Σ clip(x) and Σ clip(x)² (vert-cor.R:337-343),
    variance floored at ``var_floor``. Shares the ``mu`` address with
    :func:`priv_mean_from_sum`."""
    eps_half = eps_norm / 2.0
    mu_priv = priv_mean_from_sum(key, s1, n, eps_norm, l_raw)
    m2_priv = s2 / n + laplace(stream(key, "priv_standardize/m2"), (),
                               2.0 * l_raw * l_raw / (n * eps_half))
    return mu_priv, torch.clamp_min(m2_priv - mu_priv * mu_priv, var_floor)


def priv_standardize(key: torch.Tensor, vec: torch.Tensor, eps_norm,
                     l_raw=6.0, var_floor=1e-12) -> torch.Tensor:
    """DP center–scale with a single pre-clip (vert-cor.R:322-348)."""
    n = vec.shape[-1]
    x = clip_sym(vec, l_raw)
    mu_priv, var_priv = priv_moments_from_sums(
        key, x.sum(-1), (x * x).sum(-1), n, eps_norm, l_raw, var_floor)
    return (x - mu_priv[..., None]) / torch.sqrt(var_priv)[..., None]


def priv_center(key: torch.Tensor, vec: torch.Tensor, eps_norm,
                l_raw=6.0) -> torch.Tensor:
    """Center-only ``priv_standardize`` for sign-only consumers: σ_priv > 0,
    so sign((x−μ)/σ) ≡ sign(x−μ) and the second moment (whose ε/2 the
    budget still spends, vert-cor.R:340-343) is never materialized."""
    n = vec.shape[-1]
    x = clip_sym(vec, l_raw)
    return x - priv_mean_from_sum(key, x.sum(-1), n, eps_norm,
                                  l_raw)[..., None]


def dp_mean(key: torch.Tensor, x: torch.Tensor, lo: float, hi: float,
            eps: float) -> torch.Tensor:
    """Clipped DP mean, sensitivity (hi−lo)/n (real-data-sims.R:64-70)."""
    n = x.shape[-1]
    return clip(x, lo, hi).mean(-1) + laplace(key, (), (hi - lo) / (n * eps))


def dp_second_moment(key: torch.Tensor, x: torch.Tensor, lo: float,
                     hi: float, eps: float) -> torch.Tensor:
    """Clipped DP E[x²] with the range of x² over [lo, hi] as sensitivity:
    max(lo², hi²) when the bounds straddle 0, else |hi² − lo²|, the
    reference's (hi² − lo²)/n on its domain 0 ≤ lo < hi
    (real-data-sims.R:80). The range is an f32 value divided by n·ε in
    f32, as the JAX package computes it."""
    n = x.shape[-1]
    xc = clip(x, lo, hi)
    lo2, hi2 = lo * lo, hi * hi
    sens = max(lo2, hi2) if lo < 0.0 < hi else abs(hi2 - lo2)
    return (xc * xc).mean(-1) + laplace(key, (),
                                        f32_on(sens, x.device) / (n * eps))


def dp_sd(key: torch.Tensor, x: torch.Tensor, lo: float, hi: float,
          eps1: float, eps2: float):
    """Private (mean, sd) via the clipped second moment
    (real-data-sims.R:73-84): sd = √max(m2 − μ², 0), floored at exactly 0
    as the reference does (:82)."""
    mu = dp_mean(stream(key, "dp_sd/mean"), x, lo, hi, eps1)
    m2 = dp_second_moment(stream(key, "dp_sd/m2"), x, lo, hi, eps2)
    return mu, torch.sqrt(torch.clamp_min(m2 - mu * mu, 0.0))


def standardize_dp(x: torch.Tensor, priv_mean, priv_sd, lo: float, hi: float,
                   eps: float = 1e-8) -> torch.Tensor:
    """Clip to [lo, hi], then standardize by the private moments with an
    sd floor of ``eps`` (real-data-sims.R:87-100)."""
    nd, dev = x.dim(), x.device
    return ((clip(x, lo, hi) - per_rep(f32_on(priv_mean, dev), nd))
            / per_rep(torch.clamp_min(f32_on(priv_sd, dev), eps), nd))
