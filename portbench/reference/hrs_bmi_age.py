"""Plain reference of the HRS study: BMI against age on wave 2 of the
panel (real-data-sims.R:259-448), standardised privately, then NI and
INT replications of a bootstrap.

- standardisation (real-data-sims.R:64-106): per variable a clipped DP
  mean and second moment (Laplace, sensitivities (hi - lo)/n and
  |hi^2 - lo^2|/n, eps 0.1 each), the z-scores and the lambda bound
  max(|lo - mu|, |hi - mu|)/sd;
- the receiver's lambda from the sender's noise at tail delta = 1/n
  (real-data-sims.R:170-174);
- NI (real-data-sims.R:115-147): clip at lambda, randomized batches of
  m = ceil(8/eps^2) (k >= 2), Laplace 2 lambda/(m eps) per batch mean,
  rho_hat = (m/k) sum X~Y~, a normal CI clamped to [-1, 1];
- INT, age sending (real-data-sims.R:176-252): the sender's clipped
  value plus Laplace 2 lambda_s/eps, times the clipped other variable,
  clipped at lambda_r, mean plus one Laplace 2 lambda_r/(n eps); the CI
  from the deterministic quantile of the Gaussian + Laplace mixture.

Keys follow the program's addresses (master(seed) -> named streams), so
the same seed gives the same draws. Draws are made in f32; the rest runs
in ``dtype`` (f32 the reference, a lower precision the control). Nothing
here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.special import log_ndtr, ndtr, ndtri

from portbench.reference import keytree as kt

FIELDS = ("ni_hat", "ni_low", "ni_high", "int_hat", "int_low", "int_high")


def _t(v, dtype, device):
    return torch.as_tensor(v, dtype=torch.float32).to(device, dtype)


class Standardized:
    """Private z-scores and lambda bounds of one study's seed."""

    def __init__(self, cfg: dict, age, bmi, seed: int, device, dtype):
        key = kt.master(seed, device)
        n = age.shape[0]
        self.n = n
        out = []
        for name, x, (lo, hi) in (("age", age, cfg["age_bounds"]),
                                  ("bmi", bmi, cfg["bmi_bounds"])):
            x = torch.as_tensor(x, device=device).to(dtype)
            k = kt.stream(key, f"hrs/std/{name}")
            xc = torch.clamp(x, lo, hi)
            mu = xc.mean() + kt.laplace(kt.stream(k, "dp_sd/mean"), 1,
                                        dtype)[0] * ((hi - lo) / (
                                            n * cfg["eps_mean"]))
            sens = _t(abs(hi * hi - lo * lo), dtype, device)
            m2 = (xc * xc).mean() + kt.laplace(
                kt.stream(k, "dp_sd/m2"), 1, dtype)[0] * (
                    sens / (n * cfg["eps_m2"]))
            sig = torch.clamp_min(torch.sqrt(torch.clamp_min(m2 - mu * mu, 0.0)),
                                  1e-8)
            z = (xc - mu) / sig
            lam = torch.maximum(torch.abs((lo - mu) / sig),
                                torch.abs((hi - mu) / sig))
            out.append((z, lam))
        (self.age_z, self.lam_age), (self.bmi_z, self.lam_bmi) = out

    def lam_recv(self, eps, dtype):
        """The receiver's product bound at the sender's eps."""
        delta = 1.0 / self.n
        b_s = 2.0 * self.lam_age / eps
        return (self.lam_age + b_s * torch.log(
            _t(1.0 / delta, dtype, self.lam_age.device))) * self.lam_bmi


def _clip(x, lam):
    lam = lam.reshape(tuple(lam.shape) + (1,) * (x.dim() - lam.dim()))
    return torch.maximum(torch.minimum(x, lam), -lam)


def _per(v, x):
    """A per-row value (or a scalar) shaped to broadcast over x's rows."""
    if v.dim() == 0:
        return v
    return v.reshape(tuple(v.shape) + (1,) * (x.dim() - v.dim()))


def _crit(alpha, dtype, device):
    return ndtri(torch.tensor(1.0 - alpha / 2.0)).to(device, dtype)


def ni(keys, a, b, eps, eps32, lam_a, lam_b, alpha, k_pad, dtype):
    """NI estimate and CI per row. The batch geometry comes from each
    row's f32 eps (``eps32``, alike in every row), the arithmetic runs at
    ``eps`` in ``dtype``; the batch noise is drawn at length ``k_pad``."""
    n = a.shape[-1]
    dev = a.device
    q = 8.0 / (eps32 * eps32)
    m = torch.clamp(torch.ceil(q * (1.0 - 1e-6)), 1.0, n).long()
    k = n // m
    fall = k < 2
    k = torch.where(fall, 2, k)
    m = torch.where(fall, n // 2, m)
    perm = kt.permutation(kt.stream(keys, "ni_subg/perm"), n)
    xa = torch.gather(_clip(a, lam_a), -1, perm)
    xb = torch.gather(_clip(b, lam_b), -1, perm)
    j = torch.arange(k_pad, device=dev)

    def bmeans(v):
        kk, mm = int(k[0]), int(m[0])
        return v[:, :kk * mm].reshape(-1, kk, mm).mean(-1)

    live = j < k[:, None]
    mf, kf = m.to(dtype), k.to(dtype)
    xt = bmeans(xa) + kt.laplace(kt.stream(keys, "ni_subg/lap_x"), k_pad,
                                 dtype) * (2.0 * lam_a / (mf * eps))[:, None]
    yt = bmeans(xb) + kt.laplace(kt.stream(keys, "ni_subg/lap_y"), k_pad,
                                 dtype) * (2.0 * lam_b / (mf * eps))[:, None]
    prod = torch.where(live, xt * yt, 0.0)
    rho = (mf / kf) * prod.sum(-1)
    tj = mf[:, None] * xt * yt
    mean_tj = torch.where(live, tj, 0.0).sum(-1) / kf
    var = torch.where(live, (tj - mean_tj[:, None]) ** 2, 0.0).sum(-1) \
        / (kf - 1.0)
    half = _crit(alpha, dtype, dev) * torch.sqrt(var) / torch.sqrt(kf)
    return rho, torch.clamp_min(rho - half, -1.0), \
        torch.clamp_max(rho + half, 1.0)


def _special(fn, v):
    """A special function evaluated in f32 and rounded to ``v``'s dtype
    (not every one has a lower-precision kernel)."""
    return fn(v.float()).to(v.dtype)


def mix_cdf(x, c):
    """P(Z + c L <= x), Z standard normal, L unit Laplace."""
    b = torch.clamp_min(c, 0.01)
    inv_b = 1.0 / b
    base = 0.5 * inv_b * inv_b
    t_plus = torch.exp(base + x * inv_b + _special(log_ndtr, -x - inv_b))
    t_minus = torch.exp(base - x * inv_b + _special(log_ndtr, x - inv_b))
    phi = _special(ndtr, x)
    cdf = torch.where(c < 0.01, phi, phi + 0.5 * (t_plus - t_minus))
    return torch.clamp(cdf, 0.0, 1.0)


def mixquant(c, p: float):
    """The p-quantile of Z + c L by 32 bisection steps."""
    c = torch.abs(c)
    pt = torch.full_like(c, p)
    zq = torch.abs(ndtri(torch.clamp(pt.float(), 1e-7, 1 - 1e-7))).to(c.dtype)
    hi = zq + torch.clamp_min(c, 0.0) * 16.2 + 1.0
    lo = -hi
    for _ in range(32):
        mid = 0.5 * (lo + hi)
        below = mix_cdf(mid, c) < pt
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def interactive(keys, a, b, eps, lam_s, lam_o, lam_r, alpha, dtype):
    """INT estimate and CI per row, age sending."""
    n = a.shape[-1]
    dev = a.device
    other = _clip(b, lam_o)
    sc = _clip(a, lam_s)
    u = (sc + kt.laplace(kt.stream(keys, "int_subg/lap_sender"), n, dtype)
         * _per(2.0 * lam_s / eps, a)) * other
    uc = _clip(u, lam_r)
    central = 2.0 * lam_r / (n * eps)
    rho = uc.mean(-1) + kt.laplace(kt.stream(keys, "int_subg/lap_recv"), 1,
                                   dtype)[..., 0] * central
    sd = torch.std(uc, dim=-1, correction=1)
    p = 1.0 - alpha / 2.0
    sqrt_n = torch.sqrt(torch.tensor(float(n))).to(dev, dtype)
    cstar = torch.clamp_max(
        2.0 * lam_r / (sqrt_n * torch.clamp_min(sd, 1e-30) * eps), 1e6)
    width = torch.where(
        sd == 0.0,
        ndtri(torch.tensor(p)).to(dev, dtype) * math.sqrt(2.0) * central,
        mixquant(cstar, p) * sd / sqrt_n)
    return rho, torch.clamp_min(rho - width, -1.0), \
        torch.clamp_max(rho + width, 1.0)


def _rows(std, keys_ni, keys_int, idx, eps, eps32, lam_r, k_pad, alpha,
          dtype):
    a, b = std.age_z[idx], std.bmi_z[idx]
    r_ni = ni(keys_ni, a, b, eps, eps32, std.lam_age, std.lam_bmi, alpha,
              k_pad, dtype)
    r_int = interactive(keys_int, a, b, eps, std.lam_age, std.lam_bmi,
                        lam_r, alpha, dtype)
    return r_ni + r_int


def bootstrap_rows(cfg: dict, age, bmi, seed: int, reps, *, eps: float,
                   device, dtype=torch.float32, batch: int = 64) -> dict:
    """The six outputs of the bootstrap replications ``reps`` of the study
    with this seed: each resamples the rows with replacement
    ("hrs/boot/idx") and runs NI ("hrs/boot/ni") and INT ("hrs/boot/int")
    at ``eps``. f64 numpy arrays, one per field."""
    std = Standardized(cfg, age, bmi, seed, device, dtype)
    n = std.n
    root = kt.stream(kt.master(seed, device), "hrs/boot")
    e = _t(eps, dtype, device)
    lam_r = std.lam_recv(e, dtype)
    # the static geometry of one eps: the batch noise is drawn at length k
    m = min(math.ceil(8.0 / (eps * eps)), n)
    k_pad = max(n // m, 2)
    cols = []
    reps = np.asarray(reps, dtype=np.int64)
    for s in range(0, len(reps), batch):
        keys = kt.rep_keys(root, torch.as_tensor(reps[s:s + batch],
                                                 device=device))
        idx = kt.choice(kt.stream(keys, "hrs/boot/idx"), n, n)
        rows = keys.shape[0]
        out = _rows(std, kt.stream(keys, "hrs/boot/ni"),
                    kt.stream(keys, "hrs/boot/int"), idx, e.expand(rows),
                    torch.full((rows,), float(eps), device=device),
                    lam_r, k_pad, cfg["alpha"], dtype)
        cols.append(torch.stack(out).double().cpu().numpy())
    got = np.concatenate(cols, axis=1) if cols else np.zeros((6, 0))
    return dict(zip(FIELDS, got))
