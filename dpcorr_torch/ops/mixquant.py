"""Quantiles of the Gaussian + scaled-Laplace mixture X = Z + c·L.

Counterpart of ``dpcorr/ops/mixquant.py``: the deterministic quantile
and the reference's Monte-Carlo order statistic (``mixquant_mc``). The
CDF has the closed form

    F(x) = Φ(x) + ½·[ e^{1/(2b²) + x/b}·Φ(−x − 1/b)
                    − e^{1/(2b²) − x/b}·Φ( x − 1/b) ]

evaluated in log-space through ``log_ndtr`` and inverted by a fixed 32
bisection steps, elementwise over any batch shape, in f32 as the JAX
package does.
"""

from __future__ import annotations

import math

import torch
from torch.special import log_ndtr, ndtr, ndtri

from dpcorr_torch.utils.rng import bernoulli, exponential, normal, split


def _f32(v, like=None) -> torch.Tensor:
    device = None if like is None else like.device
    if isinstance(v, torch.Tensor):
        return v.to(device or v.device, torch.float32)
    # a Python number is made on the device: no host-to-device copy
    return torch.full((), float(v), dtype=torch.float32, device=device)


def mix_cdf(x, c) -> torch.Tensor:
    """P(Z + c·L ≤ x), elementwise; below c = 0.01 the Laplace part is
    negligible and the f32 exponent cancels, so Φ(x) is used there."""
    x = _f32(x)
    c = torch.abs(_f32(c, x))
    b = torch.clamp_min(c, 0.01)
    inv_b = 1.0 / b
    base = 0.5 * inv_b * inv_b
    t_plus = torch.exp(base + x * inv_b + log_ndtr(-x - inv_b))
    t_minus = torch.exp(base - x * inv_b + log_ndtr(x - inv_b))
    mix = ndtr(x) + 0.5 * (t_plus - t_minus)
    cdf = torch.where(c < 0.01, ndtr(x), mix)
    return torch.clamp(cdf, 0.0, 1.0)


def mixquant(c, p) -> torch.Tensor:
    """Deterministic p-quantile of Z + c·L by bisection on :func:`mix_cdf`
    (the reference's ``mixquant(c, p)`` without its MC noise,
    vert-cor.R:44-56). Broadcasts over ``c`` and ``p``."""
    c = torch.abs(_f32(c))
    p = _f32(p, c)
    c, p = torch.broadcast_tensors(c, p)
    zq = torch.abs(ndtri(torch.clamp(p, 1e-7, 1.0 - 1e-7)))
    lapq = 16.2  # |Laplace(1) quantile| at p = 1e-7
    hi = zq + torch.clamp_min(c, 0.0) * lapq + 1.0
    lo = -hi
    for _ in range(32):
        mid = 0.5 * (lo + hi)
        below = mix_cdf(mid, c) < p
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def mixquant_mc(key: torch.Tensor, c, p: float,
                nsim: int = 1000) -> torch.Tensor:
    """The reference's MC order statistic, faithfully:
    ``sort(Z + c·E·S)[ceil(p·nsim)]`` with Z ~ N(0, 1), E ~ Exp(1),
    S ~ ±1 (vert-cor.R:45-48; nsim = 2000 in real-data-sims.R:161-164),
    each replication from its own key (``split(key, 3)`` gives the z, e
    and s keys). ``c`` is a number or a tensor over the key's leading
    axes. The order statistic's index is computed on the host in f64, as
    R does; an f32 ``ceil(p·nsim)`` picks the wrong one for ~1% of p."""
    kz, ke, ks = split(key, 3).unbind(-2)
    z = normal(kz, (nsim,))
    e = exponential(ke, (nsim,))
    s = 2.0 * bernoulli(ks, 0.5, (nsim,)).to(torch.float32) - 1.0
    c = _f32(c, z)
    x = z + c.reshape(*c.shape, 1) * e * s
    idx = min(max(math.ceil(float(p) * nsim) - 1, 0), nsim - 1)
    return torch.sort(x, dim=-1).values[..., idx]
