"""Plain reference of the stress-scale study: one replication of the
sub-Gaussian clipped NI and INT estimators with their CIs on the
bounded-factor pair (ver-cor-subG.R:25-108, the lambda rules :1-7, the
data :141-154), at n = 10^6 in the benchmark.

Given a study's seed and a replication's index, it derives the
replication's key as the program's ``run_sim_one`` addresses it
(master(seed) -> replication index), rebuilds the whole sample from its
chunk keys, holds it materialized, and computes both estimates and CIs
from the published formulas over all n rows at once:

- data: X = U + E1, Y = U + E2 with U ~ Unif[-sqrt(3 rho), sqrt(3 rho)],
  Ei ~ Unif[-sqrt(3 (1 - rho)), sqrt(3 (1 - rho))] (ver-cor-subG.R:141-154);
- NI (ver-cor-subG.R:25-62): clip at lambda_n = min(2 eta sqrt(log n),
  2 sqrt(3)), k = n // m sequential batches of m = ceil(8 / (eps1 eps2)),
  Laplace 2 lambda / (m eps) per batch mean, T_j = m X~_j Y~_j,
  rho_hat = mean T_j, CI rho_hat +- z sd(T_j) / sqrt(k) clamped to
  [-1, 1], no sine link;
- INT, grid variant (ver-cor-subG.R:67-108): the larger-eps party sends
  clip(X, lambda_s) + Laplace 2 lambda_s / eps_s per row, the receiver
  clips the product with its own value at lambda_r, releases the mean
  plus one Laplace 2 lambda_r / (n eps_r); se = sqrt(sd(Uc)^2 +
  2 (2 lambda_r / (n eps_r))^2), c* = 2 / (sqrt(n) sd(Uc) eps_r), width =
  q(c*, 1 - alpha/2) se / sqrt(n) with the deterministic quantile of the
  Gaussian + Laplace mixture.

Departures from ver-cor-subG.R, each the program's own:

- the draws follow the program's chunked key addresses: the data of rows
  [c n_chunk, (c + 1) n_chunk) from fold_in(stream(key, "dgp"), c) (three
  named streams U, E1, E2), the sender's noise of those rows from
  fold_in(stream(stream(key, "int"), "int_subg/lap_sender"), c); the
  last chunk is drawn whole and cut at n. The batch noise and the
  receiver's draw keep their unchunked addresses. R draws one sample of
  n rows from one stream instead (the same distribution);
- lambda_r = 5 max(eta_r, 1) min(log n, 6) / min(eps_s, 1) = 30 at n =
  10^6, the receiver clip of lambda_INT_n (ver-cor-subG.R:3-7) that the
  script flags as not the paper's and the JAX package inherits; it
  biases INT's estimate by about -0.03;
- the mixture quantile is deterministic (32 bisection steps of its
  closed-form CDF) where the script takes a Monte-Carlo order statistic.

The draws (uniforms, Laplace) and the data are f32; the estimator
arithmetic runs in ``dtype``: f32 is the reference, a lower precision the
control. Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.special import ndtri

from portbench.reference import keytree as kt
from portbench.reference.hrs_bmi_age import mixquant

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: the program's detail-table columns, in its order
FIELDS = ("ni_hat", "int_hat", "ni_se2", "int_se2",
          "ni_low", "ni_up", "int_low", "int_up",
          "ni_cover", "int_cover", "ni_ci_len", "int_ci_len")
CSTAR_MAX = 1e6


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def lambdas(n: int, eta1: float, eta2: float, eps_s: float, device):
    """(lambda_1, lambda_2, lambda_s, lambda_r) in f32: the NI clips of X
    and Y, the INT sender's and the receiver's (sender X, eta_s = eta1,
    eta_r = eta2)."""
    log_n = torch.log(_f32(n, device))
    cap = 2.0 * torch.sqrt(_f32(3.0, device))

    def lam(eta):
        return torch.clamp_max(2.0 * _f32(eta, device) * torch.sqrt(log_n),
                               cap)

    lam_r = (5.0 * torch.clamp_min(_f32(eta2, device), 1.0)
             * torch.clamp_max(log_n, 6.0)
             / torch.clamp_max(_f32(eps_s, device), 1.0))
    return lam(eta1), lam(eta2), lam(eta1), lam_r


def replication_keys(study_seeds, idx, device) -> torch.Tensor:
    """(S, 2) keys: fold_in(master(seed), idx) per sample."""
    seeds = torch.tensor([int(s) & kt.M32 for s in study_seeds],
                         dtype=torch.int64, device=device)
    root = torch.stack([torch.zeros_like(seeds), seeds], dim=-1)
    return kt.fold_in(root, torch.as_tensor(np.asarray(idx, np.int64),
                                            device=device))


def _chunk_keys(key: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """(S, n_chunks, 2): fold_in(key, c) for every chunk c."""
    return kt.fold_in(key[:, None, :],
                      torch.arange(n_chunks, device=key.device))


def _rows(draw, keys: torch.Tensor, n_chunk: int, n: int) -> torch.Tensor:
    """(S, n) f32: ``draw(chunk key, n_chunk)`` per chunk, the chunks
    laid end to end and cut at n."""
    return draw(keys, n_chunk).reshape(keys.shape[0], -1)[:, :n]


def sample(keys, n: int, n_chunk: int, rho: float):
    """The (S, n) X and Y of each replication, f32."""
    ck = _chunk_keys(kt.stream(keys, "dgp"), -(-n // n_chunk))

    def unif(name):
        return _rows(lambda k, size: kt.uniform(
            kt.stream(k, f"bounded_factor/{name}"), size, -1.0, 1.0),
            ck, n_chunk, n)

    u, e1, e2 = unif("U"), unif("E1"), unif("E2")
    r = _f32(rho, keys.device)
    c_u = torch.sqrt(3.0 * r)
    c_e = torch.sqrt(3.0 * (1.0 - r))
    u = u * c_u
    return u + e1 * c_e, u + e2 * c_e


def _clip(v, lam):
    return torch.maximum(torch.minimum(v, lam), -lam)


def _crit(alpha: float, dtype, device):
    return ndtri(torch.tensor(1.0 - alpha / 2.0,
                              dtype=torch.float32)).to(device, dtype)


def ni(keys, x, y, lam1, lam2, eps1, eps2, alpha, dtype):
    """NI clipped-batch estimate and CI per row."""
    n = x.shape[-1]
    m = min(math.ceil(8.0 / (eps1 * eps2)), n)
    k = n // m
    kni = kt.stream(keys, "ni")

    def noisy_means(v, lam, eps, name):
        means = _clip(v, lam)[:, :k * m].reshape(-1, k, m).mean(-1)
        lap = kt.laplace(kt.stream(kni, f"ni_subg/lap_{name}"), k, dtype)
        return means + lap * (2.0 * lam / (m * eps))

    xt = noisy_means(x, lam1, eps1, "x")
    yt = noisy_means(y, lam2, eps2, "y")
    tj = m * xt * yt
    rho_hat = tj.mean(-1)
    half = _crit(alpha, dtype, x.device) * torch.std(tj, dim=-1,
                                                     correction=1) \
        / math.sqrt(k)
    return rho_hat, torch.clamp_min(rho_hat - half, -1.0), \
        torch.clamp_max(rho_hat + half, 1.0)


def interactive(keys, x, y, n_chunk, lam_s, lam_r, eps_s, eps_r, alpha,
                dtype):
    """INT clipped estimate and grid-variant CI per row, X sending."""
    n = x.shape[-1]
    dev = x.device
    kint = kt.stream(keys, "int")
    ck = _chunk_keys(kt.stream(kint, "int_subg/lap_sender"), -(-n // n_chunk))
    noise = _rows(lambda k, size: kt.laplace(k, size, dtype), ck, n_chunk, n)
    u = (_clip(x, lam_s) + noise * (2.0 * lam_s / eps_s)) * y
    uc = _clip(u, lam_r)
    central = 2.0 * lam_r / (n * eps_r)
    rho_hat = uc.mean(-1) + kt.laplace(kt.stream(kint, "int_subg/lap_recv"),
                                       1, dtype)[:, 0] * central
    sd = torch.std(uc, dim=-1, correction=1)
    sqrt_n = torch.sqrt(torch.tensor(float(n), dtype=torch.float32)
                        ).to(dev, dtype)
    se = torch.sqrt(sd * sd + 2.0 * central * central)
    cstar = torch.clamp_max(
        2.0 / (sqrt_n * torch.clamp_min(sd, 1e-30) * eps_r), CSTAR_MAX)
    width = mixquant(cstar, 1.0 - alpha / 2.0) * se / sqrt_n
    return rho_hat, torch.clamp_min(rho_hat - width, -1.0), \
        torch.clamp_max(rho_hat + width, 1.0)


def outputs(config: dict, study_seeds, idx, *, device,
            dtype=torch.float32, batch: int = 8) -> dict:
    """Per sample (study seed, replication index): the program's twelve
    detail fields at the configuration's true rho, as f64 numpy arrays
    of shape (S,)."""
    n, n_chunk = int(config["n"]), int(config["stream_n_chunk"])
    rho = float(np.float32(config["rho"]))
    eps1, eps2 = (float(e) for e in config["eps"])
    eta1, eta2 = (float(e) for e in config["eta"])
    alpha = float(config["alpha"])
    if eps1 < eps2:
        raise ValueError("the reference sends X: it needs eps1 >= eps2")
    lam = [v.to(device, dtype) for v in
           lambdas(n, eta1, eta2, eps1, torch.device(device))]
    cols = {f: [] for f in FIELDS}
    for a in range(0, len(idx), batch):
        keys = replication_keys(study_seeds[a:a + batch], idx[a:a + batch],
                                device)
        x, y = (v.to(dtype) for v in sample(keys, n, n_chunk, rho))
        ni_out = ni(keys, x, y, lam[0], lam[1], eps1, eps2, alpha, dtype)
        int_out = interactive(keys, x, y, n_chunk, lam[2], lam[3], eps1,
                              eps2, alpha, dtype)
        del x, y
        r = _f32(rho, device).to(dtype)
        row = {}
        for name, (hat, lo, hi) in (("ni", ni_out), ("int", int_out)):
            row[f"{name}_hat"] = hat
            row[f"{name}_se2"] = (hat - r) ** 2
            row[f"{name}_low"], row[f"{name}_up"] = lo, hi
            row[f"{name}_cover"] = ((r >= lo) & (r <= hi)).to(dtype)
            row[f"{name}_ci_len"] = hi - lo
        for f in FIELDS:
            cols[f].append(row[f].double().cpu().numpy())
    return {f: np.concatenate(v) if v else np.zeros(0)
            for f, v in cols.items()}
