"""Shared estimator plumbing: batch geometry, result container, R-compatible
sample sd. Counterpart of ``dpcorr/models/estimators/common.py``."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class CorrResult(NamedTuple):
    """Point estimate + CI, each with the replication axes leading."""

    rho_hat: torch.Tensor
    ci_low: torch.Tensor
    ci_high: torch.Tensor


def batch_geometry(n: int, eps1: float, eps2: float,
                   enforce_min_k: bool = False) -> tuple[int, int]:
    """(m, k): batch size m = ⌈8/(ε₁ε₂)⌉ capped at n, k = ⌊n/m⌋ full batches
    (vert-cor.R:124-126), computed in f64 on the host. ``enforce_min_k``
    adds the real-data fallback k = 2, m = ⌊n/2⌋ (real-data-sims.R:130)."""
    if n < 1:
        raise ValueError(f"Need at least one observation, got n={n}")
    m = min(math.ceil(8.0 / (eps1 * eps2)), n)
    k = n // m
    if enforce_min_k and k < 2:
        k, m = 2, n // 2
    if k < 1:
        raise ValueError(
            f"Need at least one full batch: n={n}, m={m} (vert-cor.R:127)")
    return m, k


def sample_sd(x: torch.Tensor) -> torch.Tensor:
    """R's ``sd`` over the last axis: denominator n−1."""
    return torch.std(x, dim=-1, correction=1)


def batch_means(v: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """Means of k consecutive batches of size m over the first k·m entries
    of the last axis (vert-cor.R:131-140)."""
    return v[..., : k * m].reshape(*v.shape[:-1], k, m).mean(-1)
