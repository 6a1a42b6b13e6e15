"""Shared estimator plumbing: batch geometry, result container, R-compatible
sample sd. Counterpart of ``dpcorr/models/estimators/common.py``."""

from __future__ import annotations

import logging
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from dpcorr_torch.utils.device import f32_on

log = logging.getLogger(__name__)


class CorrResult(NamedTuple):
    """Point estimate + CI, each with the replication axes leading.

    ``aux`` carries the extras the sub-Gaussian estimators return beyond
    the CI: batch geometry (k, m), λ thresholds, δ (real-data-sims.R:141-147,
    244-252), as a dict; ``None`` for the sign family."""

    rho_hat: torch.Tensor
    ci_low: torch.Tensor
    ci_high: torch.Tensor
    aux: Any = None


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


def batch_geometry_dyn(n: int, eps1, eps2, enforce_min_k: bool = False,
                       device=None):
    """(m, k) as int32 tensors for :func:`batch_geometry`'s rule, with ε
    numbers or tensors over the replication axes, so one call serves
    replications at different ε (m and k become data). ``n`` stays a
    number: it is the physical length of the observation axis.

    Two f32 guards, as the JAX package has them: the (1 − 1e-6) factor
    absorbs f32 round-up at integer boundaries (ε = √2 squares to just
    under 2 in f32, so q = 4.0000001 would ceil to 5 where the f64 rule
    gives 4), and q is clipped to [1, n] while still a float, before the
    int cast."""
    if n < 1:
        raise ValueError(f"Need at least one observation, got n={n}")
    dev = next((e.device for e in (eps1, eps2)
                if isinstance(e, torch.Tensor)), device)
    q = 8.0 / (f32_on(eps1, dev) * f32_on(eps2, dev))
    m = torch.clamp(torch.ceil(q * (1.0 - 1e-6)), 1.0, n).to(torch.int32)
    k = n // m
    if enforce_min_k:
        fallback = k < 2
        k = torch.where(fallback, 2, k).to(torch.int32)
        m = torch.where(fallback, n // 2, m).to(torch.int32)
    return m, k


#: entry points that have already warned about the f32 geometry band
_F32_BAND_WARNED: set[str] = set()


def f32_geometry_band(eps_pairs, n: int | None = None) -> list[tuple]:
    """ε pairs where :func:`batch_geometry_dyn`'s f32 rule picks another
    batch size m than the static f64 rule (:func:`batch_geometry`):
    ``[(eps1, eps2, m_static, m_dyn), ...]``, empty when none. A pair whose
    q = 8/(ε₁ε₂) sits within ~1e-6 of an integer can fall on either side
    under the snap-down guard; both designs are valid, but moving such a
    design between the static and the per-replication paths changes
    (m, k). ``n`` applies the m ≤ n cap when known."""
    hits = []
    for eps1, eps2 in eps_pairs:
        m64 = math.ceil(8.0 / (float(eps1) * float(eps2)))
        q32 = np.float32(8.0) / (np.float32(eps1) * np.float32(eps2))
        m32 = int(math.ceil(float(np.float32(q32 * np.float32(1.0 - 1e-6)))))
        if n is not None:
            m64, m32 = min(m64, n), min(m32, n)
        if m64 != m32:
            hits.append((float(eps1), float(eps2), m64, m32))
    return hits


def warn_f32_geometry_band_once(eps_pairs, n: int | None = None,
                                where: str = "eps-sweep") -> list[tuple]:
    """Log-once guard for :func:`f32_geometry_band` at an entry point that
    mixes the two geometry rules; returns the band hits."""
    hits = f32_geometry_band(eps_pairs, n=n)
    if hits and where not in _F32_BAND_WARNED:
        _F32_BAND_WARNED.add(where)
        log.warning(
            "%s: %d ε pair(s) sit in the ~1e-6 f32/f64 batch-geometry "
            "band — the per-replication (f32) rule picks a different m "
            "than the static (f64) rule, e.g. eps=(%.6g,%.6g): "
            "m_static=%d vs m_dyn=%d. Estimates from the two paths will "
            "differ for these pairs (adjacent batch design, both valid).",
            where, len(hits), hits[0][0], hits[0][1], hits[0][2],
            hits[0][3])
    return hits


def k_pad_for(n: int, eps_products) -> int:
    """Static upper bound on k = ⌊n/m⌋ over a known set of ε₁·ε₂ products:
    the padded length of :func:`batch_means_dyn`'s per-batch vectors. The
    largest product gives the smallest m. The bound holds against the f32
    m of :func:`batch_geometry_dyn`, which can land one below the f64
    ceil, hence the lower envelope ⌈q·(1−2e-6)⌉; the floor of 2 covers
    the ``enforce_min_k`` fallback."""
    q_max = 8.0 / max(eps_products)
    m_lower = min(n, max(1, math.ceil(q_max * (1.0 - 2e-6))))
    return max(2, n // m_lower)


def batch_means_dyn(v: torch.Tensor, m, k,
                    out_len: int | None = None) -> torch.Tensor:
    """Means of the k consecutive batches of size m over the first k·m
    entries of the last axis, for (m, k) that may differ per replication
    (int tensors over the leading axes, or numbers), padded to
    ``out_len`` (default n; :func:`k_pad_for`'s bound when the ε set is
    known). Entry j is meaningful only for j < k. Batch sums are
    differences of the prefix sum at the batch boundaries: a cumsum and
    two gathers, no per-replication loop and no host sync. Differencing
    re-rounds each batch sum at the prefix's magnitude (~n·ulp absolute),
    far below the batch noise added next."""
    n = v.shape[-1]
    lead = v.shape[:-1]
    csum = torch.cumsum(v, dim=-1)
    j = torch.arange(n if out_len is None else int(out_len),
                     device=v.device)
    m = torch.as_tensor(m, device=v.device).to(torch.int64)
    m = m.reshape(*m.shape, 1)
    hi = torch.clamp((j + 1) * m - 1, 0, n - 1).expand(*lead, j.shape[0])
    lo = (j * m - 1).expand(*lead, j.shape[0])
    lo_val = torch.where(lo < 0, 0.0,
                         torch.gather(csum, -1, torch.clamp(lo, 0, n - 1)))
    return (torch.gather(csum, -1, hi) - lo_val) / m


def sample_sd(x: torch.Tensor) -> torch.Tensor:
    """R's ``sd`` over the last axis: denominator n−1."""
    return torch.std(x, dim=-1, correction=1)


def batch_means(v: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """Means of k consecutive batches of size m over the first k·m entries
    of the last axis (vert-cor.R:131-140)."""
    return v[..., : k * m].reshape(*v.shape[:-1], k, m).mean(-1)
