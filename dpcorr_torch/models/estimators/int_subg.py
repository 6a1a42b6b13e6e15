"""D. Interactive clipped estimator + CI (sub-Gaussian).

Counterpart of ``dpcorr/models/estimators/int_subg.py``: reference
``ci_INT_subG``, grid variant ver-cor-subG.R:67-108, real-data variant
real-data-sims.R:176-252. The sender clips at λ_s and releases
clip(X) + Lap(2λ_s/ε_s) per sample (local DP); the receiver multiplies by
its own variable, clips the product at λ_r, and releases the mean plus
one central Laplace draw Lap(2λ_r/(n·ε_r)).

- ``"grid"``: λ pair from ``lambda_int_n``; the receiver's own variable is
  not clipped; se includes the Laplace term √(sd(Uc)² + 2(2λ_r/(nε_r))²);
  c* = 2/(√n·sd(Uc)·ε_r).
- ``"real"``: λ_sender/λ_other/λ_receiver overrides, the receiver's λ from
  the sender's noise at per-sample tail δ (default 1/n); the other
  variable clipped to ±λ_other; sampling-only se = sd(Uc)/√n;
  c* = 2λ_r/(√n·sd(Uc)·ε_r); the degenerate sd(Uc) = 0 branch
  (real-data-sims.R:237-238) as a ``where``.
"""

from __future__ import annotations

import torch
from torch.special import ndtri

from dpcorr_torch.models.estimators.common import CorrResult, sample_sd
from dpcorr_torch.ops.lambdas import (
    lambda_int_n,
    lambda_n,
    lambda_receiver_from_noise,
)
from dpcorr_torch.ops.mixquant import mixquant, mixquant_mc
from dpcorr_torch.ops.noise import clip_sym, laplace
from dpcorr_torch.utils.device import f32_on
from dpcorr_torch.utils.rng import stream

_CSTAR_MAX = 1e6  # sd(Uc)→0 sends c*→∞; a huge finite c* gives a ±1 CI


def _sqrt_n(n: int, device) -> torch.Tensor:
    return torch.sqrt(f32_on(float(n), device))


def _quantile(key, cstar, p: float, mixquant_mode: str,
              mixquant_nsim: int) -> torch.Tensor:
    if mixquant_mode == "mc":
        return mixquant_mc(stream(key, "int_subg/mixquant"), cstar, p,
                           nsim=mixquant_nsim)
    return mixquant(cstar, p)


def grid_interval(key: torch.Tensor, rho_hat: torch.Tensor,
                  sd_uc: torch.Tensor, n: int, eps_r, central_scale,
                  alpha: float, mixquant_mode: str,
                  mixquant_nsim: int = 1000) -> CorrResult:
    """Grid-variant CI given ρ̂ and sd(Uc) (ver-cor-subG.R:99-104), shared
    by the materialized and streaming estimators: se includes the central
    noise's variance; ρ-space clamp."""
    dev = rho_hat.device
    sd_safe = torch.clamp_min(sd_uc, 1e-30)
    p = 1.0 - alpha / 2.0
    se_norm = torch.sqrt(sd_uc**2 + 2.0 * central_scale**2)
    cstar = torch.clamp_max(2.0 / (_sqrt_n(n, dev) * sd_safe * eps_r),
                            _CSTAR_MAX)
    q = _quantile(key, cstar, p, mixquant_mode, mixquant_nsim)
    width = q * se_norm / _sqrt_n(n, dev)
    lo = torch.clamp_min(rho_hat - width, -1.0)
    hi = torch.clamp_max(rho_hat + width, 1.0)
    return CorrResult(rho_hat, lo, hi)


def ci_int_subg(key: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                eps1, eps2, eta1: float = 1.0, eta2: float = 1.0,
                alpha: float = 0.05, variant: str = "grid",
                lambda_sender=None, lambda_other=None, lambda_receiver=None,
                delta_clip: float | None = None,
                mixquant_mode: str = "det",
                mixquant_nsim: int | None = None,
                sender: str | None = None) -> CorrResult:
    """One-round interactive clipped DP correlation estimate + mixture CI.

    ``mixquant_nsim`` defaults per variant as the reference does: 1000
    draws for the grid script (ver-cor-subG.R:10), 2000 for the real-data
    script (real-data-sims.R:161-164). ``sender`` names the protocol
    direction (``"x"`` or ``"y"``); ``None`` keeps the larger-ε rule
    (ver-cor-subG.R:76-81), which needs ε as numbers: ε given as tensors
    over the replication axes need an explicit sender."""
    if variant not in ("grid", "real"):
        raise ValueError(f"variant must be 'grid' or 'real', got {variant!r}")
    if sender not in (None, "x", "y"):
        raise ValueError(f"sender must be None, 'x' or 'y', got {sender!r}")
    if sender is None and any(isinstance(e, torch.Tensor)
                              for e in (eps1, eps2)):
        raise ValueError("ε given as tensors need an explicit sender: the "
                         "larger-ε rule would read them on the host")
    if mixquant_nsim is None:
        mixquant_nsim = 2000 if variant == "real" else 1000
    n = x.shape[-1]
    dev = x.device

    sender_is_x = (sender == "x") if sender else bool(eps1 >= eps2)
    eps_s, eps_r = (eps1, eps2) if sender_is_x else (eps2, eps1)
    eta_s, eta_r = (eta1, eta2) if sender_is_x else (eta2, eta1)
    xs, xo = (x, y) if sender_is_x else (y, x)  # sender var, other var

    if variant == "grid":
        lam_s, lam_r = lambda_int_n(n, eta_s=eta_s, eta_r=eta_r,
                                    eps_s=eps_s, device=dev)
        if lambda_sender is not None:
            lam_s = lambda_sender
        if lambda_receiver is not None:
            lam_r = lambda_receiver
        other = xo  # the grid variant does not clip the receiver's own
    else:
        if delta_clip is None:
            delta_clip = 1.0 / n  # real-data-sims.R:199
        lam_s, lam_o = lambda_sender, lambda_other
        if lam_s is None:
            lam_s = lambda_int_n(n, eta_s=eta_s, eta_r=eta_r, eps_s=eps_s,
                                 device=dev)[0]
        if lam_o is None:
            lam_o = lambda_n(n, eta2 if sender_is_x else eta1, dev)
        lam_r = lambda_receiver
        if lam_r is None:
            lam_r = lambda_receiver_from_noise(lam_s, lam_o, eps_s,
                                               delta_clip, dev)
        other = clip_sym(xo, lam_o)

    # sender's local-DP release, receiver's product + clip + one central
    # draw (ver-cor-subG.R:87-97, real-data-sims.R:221-233)
    sc = clip_sym(xs, lam_s)
    u = (sc + laplace(stream(key, "int_subg/lap_sender"), (n,),
                      2.0 * lam_s / eps_s)) * other
    uc = clip_sym(u, lam_r)
    central_scale = 2.0 * lam_r / (n * eps_r)
    rho_hat = uc.mean(-1) + laplace(stream(key, "int_subg/lap_recv"), (),
                                    central_scale)

    sd_uc = sample_sd(uc)
    aux = {"lambda_sender": lam_s, "lambda_receiver": lam_r,
           "eps_sender": eps_s, "eps_receiver": eps_r}
    if variant == "grid":
        return grid_interval(key, rho_hat, sd_uc, n, eps_r, central_scale,
                             alpha, mixquant_mode,
                             mixquant_nsim=mixquant_nsim)._replace(aux=aux)
    aux["lambda_other"] = lam_o
    aux["delta_clip"] = delta_clip
    # sampling-only se and the sd == 0 branch (real-data-sims.R:237-242)
    sd_safe = torch.clamp_min(sd_uc, 1e-30)
    p = 1.0 - alpha / 2.0
    cstar = torch.clamp_max(
        2.0 * lam_r / (_sqrt_n(n, dev) * sd_safe * eps_r), _CSTAR_MAX)
    q = _quantile(key, cstar, p, mixquant_mode, mixquant_nsim)
    width_mix = q * sd_uc / _sqrt_n(n, dev)
    width_deg = (ndtri(f32_on(p, dev)) * torch.sqrt(f32_on(2.0, dev))
                 * central_scale)
    width = torch.where(sd_uc == 0.0, width_deg, width_mix)
    lo = torch.clamp_min(rho_hat - width, -1.0)  # ρ-space clamp
    hi = torch.clamp_max(rho_hat + width, 1.0)
    return CorrResult(rho_hat, lo, hi, aux)

