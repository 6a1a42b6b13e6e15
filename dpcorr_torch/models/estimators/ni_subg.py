"""C. Non-interactive clipped-batch estimator + CI (sub-Gaussian).

Counterpart of ``dpcorr/models/estimators/ni_subg.py``: reference
``correlation_NI_subG``, grid variant ver-cor-subG.R:25-62, real-data
variant real-data-sims.R:115-147. Clip X at ±λ₁ = λ_n(n, η₁), Y at ±λ₂;
the sign estimator's (m, k) batches; Laplace scale 2λ/(m·ε) per batch
mean; ρ̂ = (m/k)·Σ X̃Ỹ with no sine link; a normal CI from sd(T_j)/√k,
clamped in ρ-space to [−1, 1]. The real-data variant is the same
function with ``lambda_x``/``lambda_y``, ``randomize_batches`` (the
permutation stream ``"ni_subg/perm"``) and ``enforce_min_k``.
Observations sit on the last axis; ``key`` carries the same leading
replication axes.
"""

from __future__ import annotations

import torch

from dpcorr_torch.models.estimators.common import (
    CorrResult,
    batch_geometry,
    batch_geometry_dyn,
    batch_means,
    batch_means_dyn,
    sample_sd,
)
from dpcorr_torch.models.estimators.ni_sign import crit_value
from dpcorr_torch.ops.lambdas import lambda_n
from dpcorr_torch.ops.noise import clip_sym, laplace
from dpcorr_torch.utils.device import per_rep
from dpcorr_torch.utils.rng import permutation, stream


def correlation_ni_subg(key: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                        eps1, eps2, eta1: float = 1.0, eta2: float = 1.0,
                        alpha: float = 0.05,
                        lambda_x=None, lambda_y=None,
                        randomize_batches: bool = False,
                        enforce_min_k: bool = False,
                        dynamic_geometry: bool = False,
                        k_pad: int | None = None) -> CorrResult:
    """Clipped-batch DP correlation estimate + normal CI.

    ``dynamic_geometry=True`` takes ε as tensors over the replication
    axes (or numbers): (m, k) become per-replication data and every
    per-batch vector is padded to ``k_pad`` (default n), so replications
    at different ε share one call. Its batch noise is a padded
    ``(k_pad,)`` draw, so it is the same estimator as the static path on
    another stream layout, not bit-equal to it (as in the JAX package)."""
    n = x.shape[-1]
    lam1 = lambda_n(n, eta1, x.device) if lambda_x is None else lambda_x
    lam2 = lambda_n(n, eta2, x.device) if lambda_y is None else lambda_y
    xc = clip_sym(x, lam1)  # ver-cor-subG.R:33-34
    yc = clip_sym(y, lam2)

    if dynamic_geometry:
        return _ni_subg_dyn(key, xc, yc, n, eps1, eps2, lam1, lam2, alpha,
                            randomize_batches, enforce_min_k,
                            n if k_pad is None else k_pad)

    m, k = batch_geometry(n, eps1, eps2, enforce_min_k=enforce_min_k)
    if randomize_batches:
        # sample.int(n, k*m): k·m draws without replacement
        # (real-data-sims.R:132)
        idx = permutation(stream(key, "ni_subg/perm"), n)[..., : k * m]
        xc, yc = torch.gather(xc, -1, idx), torch.gather(yc, -1, idx)

    xbar = batch_means(xc, k, m)
    ybar = batch_means(yc, k, m)
    xt = xbar + laplace(stream(key, "ni_subg/lap_x"), (k,),
                        2.0 * lam1 / (m * eps1))
    yt = ybar + laplace(stream(key, "ni_subg/lap_y"), (k,),
                        2.0 * lam2 / (m * eps2))

    rho_hat = (m / k) * (xt * yt).sum(-1)  # η̂ = ρ̂, no sine link (:51-52)
    tj = m * xt * yt
    se = sample_sd(tj) / torch.sqrt(torch.full((), float(k),
                                               device=x.device))
    crit = crit_value(alpha, x.device)
    lo = torch.clamp_min(rho_hat - crit * se, -1.0)  # ρ-space clamp
    hi = torch.clamp_max(rho_hat + crit * se, 1.0)
    aux = {"k": k, "m": m, "lambda_x": lam1, "lambda_y": lam2}
    return CorrResult(rho_hat, lo, hi, aux)


def _ni_subg_dyn(key, xc, yc, n: int, eps1, eps2, lam1, lam2,
                 alpha: float, randomize_batches: bool,
                 enforce_min_k: bool, k_pad: int) -> CorrResult:
    """Per-replication geometry: the static path's math with (m, k) as
    int tensors and every per-batch vector padded to ``k_pad``. Nothing
    is read back to the host."""
    m, k = batch_geometry_dyn(n, eps1, eps2, enforce_min_k=enforce_min_k,
                              device=xc.device)
    if randomize_batches:
        # full permutation: positions ≥ k·m never reach a live batch, so
        # the first k·m form the static path's randomized batches
        perm = permutation(stream(key, "ni_subg/perm"), n)
        xc, yc = torch.gather(xc, -1, perm), torch.gather(yc, -1, perm)

    mf, kf = m.to(torch.float32), k.to(torch.float32)
    xbar = batch_means_dyn(xc, m, k, k_pad)
    ybar = batch_means_dyn(yc, m, k, k_pad)
    e1 = eps1 if isinstance(eps1, torch.Tensor) else float(eps1)
    e2 = eps2 if isinstance(eps2, torch.Tensor) else float(eps2)
    xt = xbar + laplace(stream(key, "ni_subg/lap_x"), (k_pad,),
                        2.0 * lam1 / (mf * e1))
    yt = ybar + laplace(stream(key, "ni_subg/lap_y"), (k_pad,),
                        2.0 * lam2 / (mf * e2))

    nd = xt.dim()
    valid = torch.arange(k_pad, device=xc.device) < per_rep(k, nd)
    prod = torch.where(valid, xt * yt, 0.0)
    rho_hat = (mf / kf) * prod.sum(-1)
    # pad-bound tripwire: a k beyond the pad would drop live batches, so
    # the estimate is poisoned instead (a where, never a host-side if)
    rho_hat = torch.where(k > k_pad, torch.nan, rho_hat)

    tj = per_rep(mf, nd) * xt * yt
    mean_tj = torch.where(valid, tj, 0.0).sum(-1) / kf
    var_tj = (torch.where(valid, (tj - per_rep(mean_tj, nd)) ** 2, 0.0)
              .sum(-1) / (kf - 1.0))
    se = torch.sqrt(var_tj) / torch.sqrt(kf)
    crit = crit_value(alpha, xc.device)
    lo = torch.clamp_min(rho_hat - crit * se, -1.0)
    hi = torch.clamp_max(rho_hat + crit * se, 1.0)
    aux = {"k": k, "m": m, "lambda_x": lam1, "lambda_y": lam2}
    return CorrResult(rho_hat, lo, hi, aux)
