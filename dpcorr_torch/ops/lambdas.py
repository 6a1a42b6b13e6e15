"""Clipping-threshold (λ) rules.

Counterpart of ``dpcorr/ops/lambdas.py``. The JAX package evaluates these
in f32 (``jnp`` with a weakly typed Python ``n``), and the estimates are
sensitive to λ's last bits through the clip, so the port computes them in
f32 too, in the same order of operations: each rule returns an f32
tensor. Arguments may be numbers or tensors over the replication axes;
``device`` places a rule whose arguments are all numbers.
"""

from __future__ import annotations

import torch

from dpcorr_torch.utils.device import f32_on


def _device(device, *vals):
    for v in vals:
        if isinstance(v, torch.Tensor):
            return v.device
    return device


def lambda_n(n, eta=1.0, device=None) -> torch.Tensor:
    """NI clip threshold ``min(2η√log n, 2√3)`` (ver-cor-subG.R:1,
    real-data-sims.R:109)."""
    dev = _device(device, n, eta)
    lam = 2.0 * f32_on(eta, dev) * torch.sqrt(torch.log(f32_on(n * 1.0,
                                                                 dev)))
    return torch.clamp_max(lam, 2.0 * torch.sqrt(f32_on(3.0, dev)))


def lambda_int_n(n, eta_s=1.0, eta_r=1.0, eps_s=1.0, device=None):
    """INT clip pair ``(λ_s, λ_r)``: λ_s as :func:`lambda_n`;
    λ_r = 5·max(η_r, 1)·min(log n, 6)/min(ε_s, 1), the reference's
    deliberate deviation from the paper (ver-cor-subG.R:3-7,
    real-data-sims.R:154-158)."""
    dev = _device(device, n, eta_s, eta_r, eps_s)
    lam_s = lambda_n(n, eta_s, dev)
    lam_r = (5.0 * torch.clamp_min(f32_on(eta_r, dev), 1.0)
             * torch.clamp_max(torch.log(f32_on(n * 1.0, dev)), 6.0)
             / torch.clamp_max(f32_on(eps_s, dev), 1.0))
    return lam_s, lam_r


def lambda_from_priv(lo, hi, priv_mean, priv_sd, eps_sd=1e-8,
                     device=None) -> torch.Tensor:
    """Symmetric bound of a standardized variable from its raw bounds and
    private mean and sd: ``max(|lo−μ|, |hi−μ|)/max(sd, eps)``
    (real-data-sims.R:103-106)."""
    dev = _device(device, lo, hi, priv_mean, priv_sd)
    mu = f32_on(priv_mean, dev)
    sig = torch.clamp_min(f32_on(priv_sd, dev), eps_sd)
    return torch.maximum(torch.abs((f32_on(lo, dev) - mu) / sig),
                         torch.abs((f32_on(hi, dev) - mu) / sig))


def lambda_receiver_from_noise(lambda_sender, lambda_other, eps_sender,
                               delta_per_sample,
                               device=None) -> torch.Tensor:
    """Receiver product bound accounting for the sender's local-DP noise:
    with the sender releasing clip(X, ±λ_s) + Lap(b_s), b_s = 2λ_s/ε_s,
    and the receiver's variable clipped to ±λ_o, per sample with
    probability ≥ 1−δ, |U| ≤ (λ_s + b_s·log(1/δ))·λ_o
    (real-data-sims.R:170-174)."""
    dev = _device(device, lambda_sender, lambda_other, eps_sender,
                  delta_per_sample)
    lam_s = f32_on(lambda_sender, dev)
    b_s = 2.0 * lam_s / f32_on(eps_sender, dev)
    inv_delta = (1.0 / delta_per_sample
                 if not isinstance(delta_per_sample, torch.Tensor)
                 else 1.0 / f32_on(delta_per_sample, dev))
    return ((lam_s + b_s * torch.log(f32_on(inv_delta, dev)))
            * f32_on(lambda_other, dev))
