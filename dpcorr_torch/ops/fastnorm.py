"""Box–Muller Gaussian sampler with polynomial sincos.

Counterpart of ``dpcorr/ops/fastnorm.py``, on the port's key-tree: the
same uniforms (``rng.uniform``, bit-equal to ``jax.random.uniform``),
the same Cephes single-precision coefficients and the same exact range
reduction, in plain torch ops (the JAX module is plain XLA ops; there is
no kernel to port).

- radius: ``sqrt(-2·log(u1))``;
- angle: ``sincos_2pi(u2)`` evaluates sin/cos of ``θ = 2π·u2`` with
  degree-7/8 minimax polynomials after an *exact* range reduction:
  ``t = 4·u2`` is exact in f32 (a power-of-two scale of a [0, 1) value),
  the quarter-turn index ``k = round(t)`` and remainder
  ``r = (t−k)·π/2`` then select the quadrant — no Payne–Hanek machinery,
  because the argument is constructed, not arbitrary.

Accuracy: max |error| against f64 sin/cos is ~4.2e-7 (≈4 ulp at 1.0) on
[0, 1). Distributionally an *exact* Gaussian sampler (Box–Muller is
exact; the polynomial perturbs each draw by ≲1e-6 relative), but NOT
the stream of ``rng.normal``'s inverse-CDF draws: acceptance is
statistical, and results drawn here are their own path (the JAX
package's ``xla_bm`` bench line), never mixed with ``rng.normal``'s.
"""

from __future__ import annotations

import math

import torch

from dpcorr_torch.utils.rng import uniform

__all__ = ["sincos_2pi", "normal_pairs", "gen_gaussian_bm"]

#: Cephes single-precision minimax coefficients on [-π/4, π/4].
_SIN_C = (-1.6666654611e-1, 8.3321608736e-3, -1.9515295891e-4)
_COS_C = (4.166664568298827e-2, -1.388731625493765e-3,
          2.443315711809948e-5)
_TINY = torch.finfo(torch.float32).tiny


def sincos_2pi(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sin(2πu), cos(2πu))`` for ``u ∈ [0, 1)``, f32, elementwise.

    Range reduction is exact: ``t = 4u`` only scales the exponent, so
    the quarter-turn remainder ``r = (t − round(t))·π/2 ∈ [−π/4, π/4]``
    carries no cancellation error beyond the one rounding in the final
    multiply. Quadrant selection rotates (sin, cos) by k·90°.
    """
    u = torch.as_tensor(u, dtype=torch.float32)
    t4 = 4.0 * u
    k = torch.round(t4)
    r = (t4 - k) * torch.tensor(math.pi / 2, dtype=torch.float32,
                                device=u.device)
    r2 = r * r
    s = r * (1.0 + r2 * (_SIN_C[0] + r2 * (_SIN_C[1] + r2 * _SIN_C[2])))
    c = 1.0 + r2 * (-0.5 + r2 * (_COS_C[0]
                                 + r2 * (_COS_C[1] + r2 * _COS_C[2])))
    km = k.to(torch.int32) & 3
    sin = torch.where(km == 0, s, torch.where(
        km == 1, c, torch.where(km == 2, -s, -c)))
    cos = torch.where(km == 0, c, torch.where(
        km == 1, -s, torch.where(km == 2, -c, s)))
    return sin, cos


def normal_pairs(key: torch.Tensor, n: int,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two independent N(0,1) f32 vectors of length ``n`` from one key
    (Box–Muller: each uniform pair yields a full Gaussian pair — half
    the random bits of two inverse-CDF draws). Leading key axes carry
    through: shape ``key.shape[:-1] + (n,)`` each."""
    u = uniform(key, (n, 2))
    # u1 = 0 would send the radius to +inf; clamp to the smallest
    # positive normal (probability 2⁻³² per draw)
    u1 = torch.clamp_min(u[..., 0], _TINY)
    rad = torch.sqrt(-2.0 * torch.log(u1))
    s, c = sincos_2pi(u[..., 1])
    return rad * c, rad * s


def gen_gaussian_bm(key: torch.Tensor, n: int, rho, mu: float = 0.0,
                    sigma: float = 1.0) -> torch.Tensor:
    """``dpcorr_torch.models.dgp.gen_gaussian``'s law on the Box–Muller
    sampler: (n, 2) correlated Gaussians via the same 2×2 Cholesky
    ``y = ρ·z₁ + √(1−ρ²)·z₂``. The same law, a different stream from
    ``gen_gaussian``'s; the simulator's replay contract stays there."""
    z1, z2 = normal_pairs(key, n)
    rho = torch.as_tensor(rho, dtype=torch.float32, device=z1.device)
    y = rho * z1 + torch.sqrt(torch.clamp_min(1.0 - rho * rho, 0.0)) * z2
    return mu + sigma * torch.stack([z1, y], dim=-1)
