"""DP standardization primitives (reference layer L1), simulation side.

Counterpart of ``dpcorr/ops/standardize.py``'s ``priv_standardize``
family (vert-cor.R:322-348): symmetric clip, ε split in half between the
DP mean and the DP second moment, the same stream addresses
(``"priv_standardize/mu"``, ``"priv_standardize/m2"``). Inputs carry the
observations on their last axis and any number of leading replication
axes; ``key`` has the matching leading axes.
"""

from __future__ import annotations

import torch

from dpcorr_torch.ops.noise import clip_sym, laplace
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
