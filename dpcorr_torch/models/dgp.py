"""Synthetic data-generating processes (reference layer L0).

Counterpart of ``dpcorr/models/dgp.py``. Each DGP is
``f(keys, n, rho, ...) -> (..., n, 2)``: the leading axes are the key's
replication axes, and ``rho`` is a float or a tensor over them.

Normals are jax's construction, √2·erfinv(u) with u ~ U(nextafter(−1, 0),
1) drawn bit-exactly from the key-tree (``utils.rng.normal``), but
through ``torch.erfinv``, which is not XLA's f32 polynomial. The port
holds them to a tolerance rather than porting XLA's polynomial: over 2²⁰
draws the relative error was at most 5.7e-6 with no sign flips, and every
sign estimator consumes only signs of centered values, so outputs agree
except where a centered value sits within ~1e-5 of 0
(``tests/test_torch_estimators.py`` counts those cases). The Bernoulli
pair and the bounded factor are uniforms only, so they match JAX bit for
bit (the bounded factor's sum to an ulp where XLA contracts it into a
fused multiply-add); the Gaussian mixture's labels match bit for bit and
its values carry the normals' tolerance.
"""

from __future__ import annotations

import numpy as np
import torch

from dpcorr_torch.ops.noise import clip_sym
from dpcorr_torch.utils.device import f32_on, per_rep
from dpcorr_torch.utils.rng import bernoulli, normal, stream, uniform

__all__ = ["DGPS", "gen_bernoulli", "gen_bounded_factor", "gen_gaussian",
           "gen_mix_gaussian", "normal"]


def _bvn(key, n, rho, mu, sigma):
    """Bivariate normal via 2×2 Cholesky: X = μ₁+σ₁Z₁,
    Y = μ₂+σ₂(ρZ₁+√(1−ρ²)Z₂). ``rho`` is a float or a tensor broadcasting
    against the key's leading axes. Returns (..., n, 2)."""
    z = normal(key, (n, 2))
    rho = per_rep(f32_on(rho, z.device), z.dim() - 1)
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


def gen_bernoulli(key: torch.Tensor, n: int, rho) -> torch.Tensor:
    """Correlated Bernoulli(0.5) pair with Corr(X, Y) = ρ by conditional
    inversion: p11 = ¼+ρ/4, p01 = ¼−ρ/4 (vert-cor.R:78-98). A robustness
    probe for the sign estimators, whose arcsine link assumes Gaussian
    data."""
    u = uniform(stream(key, "bernoulli/u"), (n,))
    v = uniform(stream(key, "bernoulli/v"), (n,))
    rho = per_rep(f32_on(rho, u.device), u.dim())
    p11 = 0.25 + rho / 4.0
    p01 = 0.25 - rho / 4.0
    x = (u < 0.5).to(torch.float32)
    thresh = torch.where(x == 1.0, p11 / 0.5, p01 / 0.5)
    y = (v < thresh).to(torch.float32)
    return torch.stack([x, y], dim=-1)


def gen_mix_gaussian(key: torch.Tensor, n: int, rho,
                     mu0=(0.0, 0.0), sigma0=(1.0, 1.0),
                     mu1=(3.0, 3.0), sigma1=(2.0, 0.5),
                     pi_mix=0.5) -> torch.Tensor:
    """Two-component Gaussian mixture, rows i.i.d., hard-clipped to
    [−1, 1] (ver-cor-subG.R:115-136; the clip at :135 makes the realized
    correlation differ from the nominal ρ). A per-row label replaces the
    reference's stacked-and-shuffled blocks (same distribution)."""
    labels = bernoulli(stream(key, "mix_gaussian/labels"), pi_mix, (n,))
    out0 = _bvn(stream(key, "mix_gaussian/comp0"), n, rho, mu0, sigma0)
    out1 = _bvn(stream(key, "mix_gaussian/comp1"), n, rho, mu1, sigma1)
    return clip_sym(torch.where(labels[..., None], out1, out0), 1.0)


def gen_bounded_factor(key: torch.Tensor, n: int, rho) -> torch.Tensor:
    """Bounded common-factor DGP: X = U+E₁, Y = U+E₂ with
    U ~ Unif[±√(3ρ)], Eᵢ ~ Unif[±√(3(1−ρ))], so mean 0, variance 1 and
    correlation ρ (ver-cor-subG.R:141-154)."""
    u = uniform(stream(key, "bounded_factor/U"), (n,), -1.0, 1.0)
    e1 = uniform(stream(key, "bounded_factor/E1"), (n,), -1.0, 1.0)
    e2 = uniform(stream(key, "bounded_factor/E2"), (n,), -1.0, 1.0)
    rho = per_rep(f32_on(rho, u.device), u.dim())
    c_u = torch.sqrt(3.0 * rho)
    c_e = torch.sqrt(3.0 * (1.0 - rho))
    u = u * c_u
    return torch.stack([u + e1 * c_e, u + e2 * c_e], dim=-1)


DGPS = {
    "gaussian": gen_gaussian,
    "bernoulli": gen_bernoulli,
    "mix_gaussian": gen_mix_gaussian,
    "bounded_factor": gen_bounded_factor,
}
