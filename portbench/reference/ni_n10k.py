"""Plain reference of the north star: one replication of the NI
sign-batch estimator with its CI on a Gaussian pair (vert-cor.R:392-419).

Given a study's seed and a replication's index in its block, it derives
the replication's key as the benchmarked pipeline addresses it
(master(seed) -> block 0 -> replication index), draws the data and the
noise, and returns the replication's outputs (se^2, cover, CI length)
with the CI's ends. Two bodies, one per path of the program:

- ``unfused``: threefry draws from the key-tree (streams "dgp" and "ni"),
  normals by the inverse error function, private centering, sign batch
  means with Laplace noise;
- ``fused``: the same estimator on the fused kernel's stream family,
  Philox4x32-10 keyed by the "fused_ni/seed" words, Box-Muller normals,
  in the order the kernel draws them.

The draws are made in f32; the estimator's float work runs in ``dtype``:
f32 is the reference, a lower precision is the control. Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.special import ndtri

from portbench.reference import keytree as kt

M32 = kt.M32
_PM = (0xD2511F53, 0xCD9E8D57)
_PW = (0x9E3779B9, 0xBB67AE85)


def geometry(n: int, eps1: float, eps2: float) -> tuple[int, int]:
    """(m, k): batch size ceil(8 / (eps1 eps2)) capped at n, k = n // m."""
    m = min(math.ceil(8.0 / (eps1 * eps2)), n)
    return m, n // m


def replication_keys(study_seeds, idx, device) -> torch.Tensor:
    """(S, 2) keys: fold_in(fold_in(master(seed), 0), idx) per sample."""
    seeds = torch.tensor([int(s) & M32 for s in study_seeds],
                         dtype=torch.int64, device=device)
    root = torch.stack([torch.zeros_like(seeds), seeds], dim=-1)
    block = kt.fold_in(root, 0)
    return kt.fold_in(block, torch.as_tensor(idx, dtype=torch.int64,
                                             device=device))


def _ci(tj: torch.Tensor, k: int, alpha: float, from_sums: bool):
    """(rho_hat, lo, hi) from the batch products T_j: the eta-space CI
    clamped to [-1, 1], then mapped through sin(pi/2 .). The variance of
    T_j is the sample variance, or with ``from_sums`` the one the fused
    path forms from (sum T_j, sum T_j^2)."""
    eta = tj.sum(-1) / k
    if from_sums:
        var = torch.clamp_min(((tj * tj).sum(-1) - k * eta * eta) / (k - 1),
                              0.0)
    else:
        var = torch.var(tj, dim=-1, correction=1)
    crit = ndtri(torch.tensor(1.0 - alpha / 2.0, dtype=torch.float32)
                 ).to(tj.device, tj.dtype)
    half = crit * torch.sqrt(var) / math.sqrt(k)
    rho_hat = torch.sin(math.pi * eta / 2.0)
    lo = torch.sin(math.pi / 2.0 * torch.clamp_min(eta - half, -1.0))
    hi = torch.sin(math.pi / 2.0 * torch.clamp_max(eta + half, 1.0))
    return rho_hat, lo, hi


def _unfused(keys, n, rho, eps1, eps2, alpha, dtype):
    m, k = geometry(n, eps1, eps2)
    z = kt.normal(kt.stream(keys, "dgp"), 2 * n, dtype).reshape(-1, n, 2)
    r = torch.tensor(rho, dtype=torch.float32).to(keys.device, dtype)
    x = z[..., 0]
    y = r * z[..., 0] + torch.sqrt(1.0 - r * r) * z[..., 1]
    kni = kt.stream(keys, "ni")
    l_clip = torch.sqrt(2.0 * torch.log(
        torch.tensor(float(n), dtype=torch.float32))).to(keys.device, dtype)

    def center(v, name, eps):
        v = torch.maximum(torch.minimum(v, l_clip), -l_clip)
        scale = 2.0 * l_clip / (n * (eps / 2.0))
        lap = kt.laplace(kt.stream(kt.stream(kni, name),
                                   "priv_standardize/mu"), 1, dtype)
        return v - (v.sum(-1, keepdim=True) / n + lap * scale)

    x = center(x, "ni_sign/std_x", eps1)
    y = center(y, "ni_sign/std_y", eps2)
    xb = torch.sign(x)[:, :k * m].reshape(-1, k, m).mean(-1)
    yb = torch.sign(y)[:, :k * m].reshape(-1, k, m).mean(-1)
    xt = xb + kt.laplace(kt.stream(kni, "ni_sign/lap_x"), k, dtype) \
        * (2.0 / (m * eps1))
    yt = yb + kt.laplace(kt.stream(kni, "ni_sign/lap_y"), k, dtype) \
        * (2.0 / (m * eps2))
    return _ci(m * xt * yt, k, alpha, from_sums=False)


def _mulhilo(a: int, b: torch.Tensor):
    hi = a * (b >> 16)
    t = ((hi & 0xFFFF) << 16) + a * (b & 0xFFFF)
    return (hi >> 16) + (t >> 32), t & M32


def philox(seed: torch.Tensor, tag: int, calls: int) -> torch.Tensor:
    """(S, 4 * calls) words of Philox4x32-10 keyed by each (S, 2) seed on
    the counters (i, tag, 0, 0), i < calls, in counter order."""
    dev = seed.device
    c0 = torch.arange(calls, device=dev, dtype=torch.int64)[None]
    c = [c0.expand(seed.shape[0], calls),
         torch.full_like(c0, tag).expand(seed.shape[0], calls),
         torch.zeros(seed.shape[0], calls, dtype=torch.int64, device=dev),
         torch.zeros(seed.shape[0], calls, dtype=torch.int64, device=dev)]
    k0, k1 = seed[:, 0:1] & M32, seed[:, 1:2] & M32
    for _ in range(10):
        h0, l0 = _mulhilo(_PM[0], c[0])
        h1, l1 = _mulhilo(_PM[1], c[2])
        c = [h1 ^ c[1] ^ k0, l1, h0 ^ c[3] ^ k1, l0]
        k0 = (k0 + _PW[0]) & M32
        k1 = (k1 + _PW[1]) & M32
    return torch.stack(c, dim=-1).reshape(seed.shape[0], -1)


def _u23(words: torch.Tensor) -> torch.Tensor:
    """Words -> f32 uniforms in (0, 1): (top 23 bits + 1/2) * 2**-23."""
    return (((words >> 9) & 0x7FFFFF).float() + 0.5) * 2.0**-23


def _lap(u: torch.Tensor) -> torch.Tensor:
    """Unit Laplace by the inverse CDF of u - 1/2."""
    c = u - 0.5
    return -torch.sign(c) * torch.log1p(-2.0 * torch.abs(c))


def _fused(keys, n, rho, eps1, eps2, alpha, dtype):
    m, k = geometry(n, eps1, eps2)
    w = kt.stream(keys, "fused_ni/seed")  # the kernel's two seed words
    obs = philox(w, 0, -(-n // 2)).reshape(-1, 2 * (-(-n // 2)), 2)[:, :n]
    u1, u2 = _u23(obs[..., 0]), _u23(obs[..., 1])
    two_pi = float(np.float32(2.0 * math.pi))
    rad = torch.sqrt(-2.0 * torch.log(u1))  # the draws in f32, then dtype
    z1 = (rad * torch.cos(two_pi * u2)).to(dtype)
    z2 = (rad * torch.sin(two_pi * u2)).to(dtype)
    r = torch.tensor(rho, dtype=torch.float32).to(keys.device, dtype)
    l_clip = math.sqrt(2.0 * math.log(n))
    x = torch.clamp(z1, -l_clip, l_clip)
    y = torch.clamp(r * z1 + torch.sqrt(1.0 - r * r) * z2, -l_clip, l_clip)
    scal = _lap(_u23(philox(w, 3, 1))).to(dtype)
    x = x - (x.sum(-1, keepdim=True) / n
             + scal[:, 0:1] * 2.0 * l_clip / (n * eps1 / 2.0))
    y = y - (y.sum(-1, keepdim=True) / n
             + scal[:, 1:2] * 2.0 * l_clip / (n * eps2 / 2.0))
    xb = torch.sign(x)[:, :k * m].reshape(-1, k, m).sum(-1) / m
    yb = torch.sign(y)[:, :k * m].reshape(-1, k, m).sum(-1) / m
    bw = philox(w, 2, -(-k // 2)).reshape(-1, 2 * (-(-k // 2)), 2)[:, :k]
    xt = xb + _lap(_u23(bw[..., 0])).to(dtype) * (2.0 / (m * eps1))
    yt = yb + _lap(_u23(bw[..., 1])).to(dtype) * (2.0 / (m * eps2))
    return _ci(m * xt * yt, k, alpha, from_sums=True)


BODIES = {"unfused": _unfused, "fused": _fused}


def outputs(config: dict, body: str, study_seeds, idx, *, device,
            dtype=torch.float32, batch: int = 256) -> dict:
    """Per sample (study seed, replication index): the replication's
    se^2, cover and CI length at the configuration's true rho, with the
    CI's ends; f64 numpy arrays of shape (S,)."""
    n, rho = int(config["n"]), float(np.float32(config["rho"]))
    eps1, eps2 = (float(e) for e in config["eps"])
    alpha = float(config["alpha"])
    fn = BODIES[body]
    cols = {f: [] for f in ("se2", "cover", "ci_len", "lo", "hi")}
    for a in range(0, len(idx), batch):
        keys = replication_keys(study_seeds[a:a + batch], idx[a:a + batch],
                                device)
        rho_hat, lo, hi = fn(keys, n, rho, eps1, eps2, alpha, dtype)
        r = torch.tensor(rho, dtype=torch.float32).to(device, dtype)
        vals = {"se2": (rho_hat - r) ** 2,
                "cover": ((r >= lo) & (r <= hi)).to(dtype),
                "ci_len": hi - lo, "lo": lo, "hi": hi}
        for f, v in vals.items():
            cols[f].append(v.double().cpu().numpy())
    return {f: np.concatenate(v) if v else np.zeros(0)
            for f, v in cols.items()}
