"""Streaming (n-blocked) estimators for stress-scale sample sizes.

Counterpart of ``dpcorr/models/estimators/streaming.py``. The
materialized estimators hold the (..., n) sample; at n = 10⁶ (BASELINE.md
config 5) and a few hundred resident replications that no longer fits a
card's memory comfortably. These variants loop over n-chunks, regenerate
each chunk of data from a folded key (``rng.chunk_key``), and accumulate
sufficient statistics, so per replication only O(n_chunk + k) values are
live. JAX's ``lax.map`` over chunks is a Python loop over chunk indices
here: each chunk is ``(C, n_chunk, 2)`` for the C resident replications,
and the per-chunk partial sums are added in chunk order.

- NI sign-batch / NI sub-Gaussian: per-batch means over m consecutive
  rows. The batch noise is drawn as one ``(k,)`` vector at the
  materialized key address and sliced per chunk, so on identical data the
  streaming estimate equals the materialized one up to summation order.
- INT sign-flip: Σ of randomized-response cores, flips per chunk from
  folded keys; the receiver's draw keeps its materialized address.
- INT sub-Gaussian (grid variant): Σ Uc, Σ Uc² of the clipped products,
  sender noise per chunk.

DP standardization (``normalise=True``) needs the global clipped moments
first, so the sign estimators make two passes: pass A sums clip(x) and
clip(x)², pass B regenerates the same chunks (same keys) and streams the
batches.

Chunk protocol: ``chunk_fn(c) -> (..., n_chunk, 2)`` returns rows
[c·n_chunk, (c+1)·n_chunk) of the sample; rows past n are masked out of
every sum. ``n_chunk`` must be a multiple of the batch size m
(:func:`choose_n_chunk`) so no batch straddles two chunks.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from dpcorr_torch.models.estimators.common import CorrResult, batch_geometry
from dpcorr_torch.models.estimators.int_sign import interval_from_rho
from dpcorr_torch.models.estimators.int_subg import grid_interval
from dpcorr_torch.models.estimators.ni_sign import crit_value
from dpcorr_torch.ops.lambdas import lambda_int_n, lambda_n
from dpcorr_torch.ops.noise import clip_sym, laplace
from dpcorr_torch.ops.standardize import priv_moments_from_sums
from dpcorr_torch.utils.device import f32_on, per_rep
from dpcorr_torch.utils.rng import bernoulli, chunk_key, stream

ChunkFn = Callable[[int], torch.Tensor]  # c -> (..., n_chunk, 2)

_HALF_PI = math.pi / 2.0


def choose_n_chunk(n: int, m: int, target: int = 65536) -> int:
    """Largest multiple of m that is ≤ max(target, m): the rows resident
    per replication, aligned so batches never straddle chunks."""
    return max(m, (min(target, n + m - 1) // m) * m)


def _check_aligned(n_chunk: int, m: int) -> None:
    if n_chunk % m:
        raise ValueError(
            f"n_chunk={n_chunk} must be a multiple of the batch size m={m} "
            f"(use choose_n_chunk(n, m, target))")


def array_chunk_fn(xy: torch.Tensor, n_chunk: int) -> ChunkFn:
    """Chunk view of a materialized (..., n, 2) sample, the tail padded
    with zeros (which the row mask removes)."""
    n = xy.shape[-2]
    n_chunks = -(-n // n_chunk)
    padded = F.pad(xy, (0, 0, 0, n_chunks * n_chunk - n))

    def chunk_fn(c: int) -> torch.Tensor:
        return padded[..., c * n_chunk:(c + 1) * n_chunk, :]

    return chunk_fn


def dgp_chunk_fn(dgp_fn: Callable, key: torch.Tensor, n_chunk: int,
                 rho) -> ChunkFn:
    """Chunkwise DGP: chunk c is ``dgp_fn(chunk_key(key, c), n_chunk,
    rho)``. Rows are i.i.d., so the chunked sample has the distribution
    of one ``dgp_fn(key, n, rho)`` call (not its draws)."""

    def chunk_fn(c: int) -> torch.Tensor:
        return dgp_fn(chunk_key(key, c), n_chunk, rho)

    return chunk_fn


def _row_mask(c: int, n_chunk: int, n: int, device) -> torch.Tensor:
    return (c * n_chunk + torch.arange(n_chunk, device=device)) < n


def _chunk_sums(stats: Callable, n_chunks: int) -> tuple:
    """``stats(c)`` for every chunk, each output summed over the chunks
    (stacked in chunk order, as JAX sums the ``lax.map`` partials)."""
    parts = [stats(c) for c in range(n_chunks)]
    return tuple(torch.stack(col).sum(0) for col in zip(*parts, strict=True))


# ------------------------------------------------------------ pass A ----
def clipped_moment_sums(chunk_fn: ChunkFn, n: int, n_chunk: int,
                        l_raw=None):
    """Pass A: (Σ clip, Σ clip²) per column, each ``(..., 2)``, the sums
    both sign estimators standardize from (compute once per replication
    and hand to both via ``moment_sums=``; each still draws its own
    standardization noise). Default clip L = √(2·log n)
    (vert-cor.R:212, 269)."""
    if l_raw is None:
        l_raw = math.sqrt(2.0 * math.log(n))
    return _clipped_moment_sums(chunk_fn, n, n_chunk, l_raw)


def _clipped_moment_sums(chunk_fn: ChunkFn, n: int, n_chunk: int, l_raw):
    def stats(c):
        xy = clip_sym(chunk_fn(c), l_raw)
        w = _row_mask(c, n_chunk, n, xy.device).to(xy.dtype)[:, None]
        return (xy * w).sum(-2), (xy * xy * w).sum(-2)

    return _chunk_sums(stats, -(-n // n_chunk))


def _priv_moments(std_key, s1, s2, n: int, eps_norm, l_raw):
    """(μ_priv, 1/σ_priv) from streamed sums, through the same core (noise
    scales and key addresses) as ``priv_standardize``."""
    mu, var = priv_moments_from_sums(std_key, s1, s2, n, eps_norm, l_raw)
    return mu, 1.0 / torch.sqrt(var)


def _standardizers(key, chunk_fn: ChunkFn, n: int, n_chunk: int, eps1,
                   eps2, ns: str, sums=None):
    """Pass A and the per-column transforms clip → center → scale, as
    ``priv_standardize`` with clip L = √(2·log n)."""
    l_clip = math.sqrt(2.0 * math.log(n))
    s1, s2 = (_clipped_moment_sums(chunk_fn, n, n_chunk, l_clip)
              if sums is None else sums)
    mu_x, inv_x = _priv_moments(stream(key, f"{ns}/std_x"), s1[..., 0],
                                s2[..., 0], n, eps1, l_clip)
    mu_y, inv_y = _priv_moments(stream(key, f"{ns}/std_y"), s1[..., 1],
                                s2[..., 1], n, eps2, l_clip)

    def tx(v):
        return ((clip_sym(v, l_clip) - per_rep(mu_x, v.dim()))
                * per_rep(inv_x, v.dim()))

    def ty(v):
        return ((clip_sym(v, l_clip) - per_rep(mu_y, v.dim()))
                * per_rep(inv_y, v.dim()))

    return tx, ty


# ------------------------------------------------------------ NI core ----
def _ni_batch_noise(key_x, key_y, k: int, scale_x, scale_y, pad_to: int):
    """The materialized ``(k,)`` batch-noise draws, zero-padded to the
    chunk grid: one source for the separate and the paired estimators."""
    lap_x = F.pad(laplace(key_x, (k,), scale_x), (0, pad_to - k))
    lap_y = F.pad(laplace(key_y, (k,), scale_y), (0, pad_to - k))
    return lap_x, lap_y


def _ni_chunk_stats(xy, c: int, tx: Callable, ty: Callable, m: int,
                    kc: int, k: int, lap_x, lap_y):
    """One chunk's NI contribution (vert-cor.R:131-153,
    ver-cor-subG.R:40-52): kc batch means plus the sliced batch noise;
    batches past k contribute exact zeros."""
    lead = xy.shape[:-2]
    xb = tx(xy[..., 0]).reshape(*lead, kc, m).mean(-1)
    yb = ty(xy[..., 1]).reshape(*lead, kc, m).mean(-1)
    b0 = c * kc
    xt = xb + lap_x[..., b0:b0 + kc]
    yt = yb + lap_y[..., b0:b0 + kc]
    live = b0 + torch.arange(kc, device=xy.device) < k
    t = torch.where(live, m * xt * yt, 0.0)
    return t.sum(-1), (t * t).sum(-1)


def _ni_from_sums(st, st2, k: int):
    """(η̂, sd(T_j)) from Σ T_j and Σ T_j² (denominator k−1, as R's sd)."""
    eta_hat = st / k
    var_t = torch.clamp_min((st2 - k * eta_hat * eta_hat) / max(k - 1, 1),
                            0.0)
    return eta_hat, torch.sqrt(var_t)


def _ni_stream(key_x, key_y, chunk_fn: ChunkFn, tx: Callable, ty: Callable,
               m: int, k: int, scale_x, scale_y, n_chunk: int):
    """The streamed batch pipeline; returns (η̂, sd(T_j))."""
    kc = n_chunk // m
    n_chunks = -(-k // kc)
    lap_x, lap_y = _ni_batch_noise(key_x, key_y, k, scale_x, scale_y,
                                   n_chunks * kc)
    st, st2 = _chunk_sums(lambda c: _ni_chunk_stats(
        chunk_fn(c), c, tx, ty, m, kc, k, lap_x, lap_y), n_chunks)
    return _ni_from_sums(st, st2, k)


def _ni_subg_interval(eta_hat, s_t, k: int, m: int, lam1, lam2,
                      alpha: float) -> CorrResult:
    """NI subG normal CI (ver-cor-subG.R:51-59): no sine link, ρ-space
    clamp."""
    dev = eta_hat.device
    se = s_t / torch.sqrt(f32_on(float(k), dev))
    crit = crit_value(alpha, dev)
    lo = torch.clamp_min(eta_hat - crit * se, -1.0)
    hi = torch.clamp_max(eta_hat + crit * se, 1.0)
    aux = {"k": k, "m": m, "lambda_x": lam1, "lambda_y": lam2}
    return CorrResult(eta_hat, lo, hi, aux)


def ci_ni_signbatch_stream(key: torch.Tensor, chunk_fn: ChunkFn, n: int,
                           eps1: float, eps2: float, alpha: float = 0.05,
                           normalise: bool = True, n_chunk: int = 65536,
                           moment_sums=None) -> CorrResult:
    """Streaming NI sign-batch estimate + CI, ≡ ``ci_ni_signbatch``
    (vert-cor.R:204-255) without materializing the sample."""
    m, k = batch_geometry(n, eps1, eps2)
    _check_aligned(n_chunk, m)
    if normalise:
        sx, sy = _standardizers(key, chunk_fn, n, n_chunk, eps1, eps2,
                                "ni_sign", sums=moment_sums)

        def tx(v):
            return torch.sign(sx(v))

        def ty(v):
            return torch.sign(sy(v))
    else:
        tx = ty = torch.sign
    eta_hat, s_eta = _ni_stream(
        stream(key, "ni_sign/lap_x"), stream(key, "ni_sign/lap_y"),
        chunk_fn, tx, ty, m, k, 2.0 / (m * eps1), 2.0 / (m * eps2), n_chunk)
    rho_hat = torch.sin(math.pi * eta_hat / 2.0)
    dev = eta_hat.device
    half = crit_value(alpha, dev) * s_eta / torch.sqrt(f32_on(float(k),
                                                              dev))
    # η-space clamp, then the sine map (vert-cor.R:249-254)
    lo = torch.sin(_HALF_PI * torch.clamp_min(eta_hat - half, -1.0))
    hi = torch.sin(_HALF_PI * torch.clamp_max(eta_hat + half, 1.0))
    return CorrResult(rho_hat, lo, hi)


def correlation_ni_subg_stream(key: torch.Tensor, chunk_fn: ChunkFn, n: int,
                               eps1: float, eps2: float,
                               eta1: float = 1.0, eta2: float = 1.0,
                               alpha: float = 0.05,
                               n_chunk: int = 65536) -> CorrResult:
    """Streaming NI clipped-batch, ≡ the grid variant of
    ``correlation_ni_subg`` (ver-cor-subG.R:25-62): sequential batches,
    λ from ``lambda_n``. Randomized batches need a permutation of all n
    rows and stay on the materialized path."""
    m, k = batch_geometry(n, eps1, eps2)
    _check_aligned(n_chunk, m)
    lam1 = lambda_n(n, eta1, key.device)
    lam2 = lambda_n(n, eta2, key.device)
    eta_hat, s_t = _ni_stream(
        stream(key, "ni_subg/lap_x"), stream(key, "ni_subg/lap_y"),
        chunk_fn, lambda v: clip_sym(v, lam1), lambda v: clip_sym(v, lam2),
        m, k, 2.0 * lam1 / (m * eps1), 2.0 * lam2 / (m * eps2), n_chunk)
    return _ni_subg_interval(eta_hat, s_t, k, m, lam1, lam2, alpha)


# ----------------------------------------------------------- INT sign ----
def ci_int_signflip_stream(key: torch.Tensor, chunk_fn: ChunkFn, n: int,
                           eps1: float, eps2: float, alpha: float = 0.05,
                           mode: str = "auto", normalise: bool = True,
                           mixquant_mode: str = "det",
                           n_chunk: int = 65536,
                           moment_sums=None) -> CorrResult:
    """Streaming INT sign-flip, ≡ ``ci_int_signflip`` (vert-cor.R:260-317):
    Σ core per chunk, flips from per-chunk folded keys, the CI from the
    shared interval constructor."""
    if normalise:
        sx, sy = _standardizers(key, chunk_fn, n, n_chunk, eps1, eps2,
                                "int_sign", sums=moment_sums)
    else:
        def sx(v):
            return v
        sy = sx

    eps_s, eps_r = max(eps1, eps2), min(eps1, eps2)  # vert-cor.R:170-172
    e_s = math.exp(eps_s)
    p_keep = e_s / (e_s + 1.0)
    est_key = stream(key, "int_sign/est")
    flip_base = stream(est_key, "int_sign/flips")

    def stats(c):
        xy = chunk_fn(c)
        s = bernoulli(chunk_key(flip_base, c), p_keep, (n_chunk,))
        core = ((2.0 * s.to(torch.float32) - 1.0)
                * torch.sign(sx(xy[..., 0])) * torch.sign(sy(xy[..., 1])))
        live = _row_mask(c, n_chunk, n, xy.device)
        return (torch.where(live, core, 0.0).sum(-1),)

    (sum_core,) = _chunk_sums(stats, -(-n // n_chunk))
    scale_z = 2.0 * (e_s + 1.0) / (n * (e_s - 1.0) * eps_r)
    z = laplace(stream(est_key, "int_sign/lap_z"), (), scale_z)
    eta_hat = (e_s + 1.0) / (n * (e_s - 1.0)) * sum_core + z
    rho_hat = torch.sin(math.pi * eta_hat / 2.0)
    return interval_from_rho(key, rho_hat, n, eps_s, eps_r, alpha, mode,
                             mixquant_mode)


# -------------------------------------------------- INT subG pieces ----
def _int_subg_roles(n: int, eps1, eps2, eta1, eta2, device):
    """Sender selection and λ pair (ver-cor-subG.R:76-81,
    lambda_INT_n)."""
    sender_is_x = eps1 >= eps2
    eps_s, eps_r = (eps1, eps2) if sender_is_x else (eps2, eps1)
    eta_s, eta_r = (eta1, eta2) if sender_is_x else (eta2, eta1)
    lam_s, lam_r = lambda_int_n(n, eta_s=eta_s, eta_r=eta_r, eps_s=eps_s,
                                device=device)
    return sender_is_x, eps_s, eps_r, lam_s, lam_r


def _int_subg_chunk_stats(xy, c: int, noise_base, sender_is_x: bool, lam_s,
                          lam_r, eps_s, n: int, n_chunk: int):
    """One chunk's INT contribution (ver-cor-subG.R:87-97): sender noise
    from the chunk's folded key, clipped products, rows past n masked."""
    xs = xy[..., 0] if sender_is_x else xy[..., 1]
    xo = xy[..., 1] if sender_is_x else xy[..., 0]  # other: not clipped
    noise = laplace(chunk_key(noise_base, c), (n_chunk,),
                    2.0 * lam_s / eps_s)
    uc = clip_sym((clip_sym(xs, lam_s) + noise) * xo, lam_r)
    uc = torch.where(_row_mask(c, n_chunk, n, xy.device), uc, 0.0)
    return uc.sum(-1), (uc * uc).sum(-1)


def _int_subg_interval(key, s1, s2, n: int, eps_s, eps_r, lam_s, lam_r,
                       alpha: float, mixquant_mode: str) -> CorrResult:
    """INT subG estimate + grid-variant CI from Σ Uc and Σ Uc²
    (ver-cor-subG.R:95-104); the central draw and the CI keep their
    materialized key addresses."""
    mean_uc = s1 / n
    central_scale = 2.0 * lam_r / (n * eps_r)
    rho_hat = mean_uc + laplace(stream(key, "int_subg/lap_recv"), (),
                                central_scale)
    var_uc = torch.clamp_min((s2 - n * mean_uc * mean_uc) / (n - 1), 0.0)
    aux = {"lambda_sender": lam_s, "lambda_receiver": lam_r,
           "eps_sender": eps_s, "eps_receiver": eps_r}
    return grid_interval(key, rho_hat, torch.sqrt(var_uc), n, eps_r,
                         central_scale, alpha, mixquant_mode)._replace(aux=aux)


# ------------------------------------------------- paired subG pass ----
def subg_pair_stream(key_ni: torch.Tensor, key_int: torch.Tensor,
                     chunk_fn: ChunkFn, n: int, eps1: float, eps2: float,
                     eta1: float = 1.0, eta2: float = 1.0,
                     alpha: float = 0.05, mixquant_mode: str = "det",
                     n_chunk: int = 65536):
    """Both subG estimators in one pass over the chunks: each chunk is
    generated once and feeds the NI batch sums (Σ T_j, Σ T_j²) and the INT
    product sums (Σ Uc, Σ Uc²). Every draw keeps the key address and
    call shape of :func:`correlation_ni_subg_stream` and
    :func:`ci_int_subg_stream`, so the pair equals the two separate
    passes. The loop runs INT's ⌈n/n_chunk⌉ chunks; NI's mask zeroes the
    chunks past its last batch. Returns ``(ni, int)``."""
    m, k = batch_geometry(n, eps1, eps2)
    _check_aligned(n_chunk, m)
    dev = key_ni.device
    lam1 = lambda_n(n, eta1, dev)
    lam2 = lambda_n(n, eta2, dev)
    kc = n_chunk // m
    n_chunks = -(-n // n_chunk)
    lap_x, lap_y = _ni_batch_noise(
        stream(key_ni, "ni_subg/lap_x"), stream(key_ni, "ni_subg/lap_y"),
        k, 2.0 * lam1 / (m * eps1), 2.0 * lam2 / (m * eps2), n_chunks * kc)
    sender_is_x, eps_s, eps_r, lam_s, lam_r = _int_subg_roles(
        n, eps1, eps2, eta1, eta2, dev)
    noise_base = stream(key_int, "int_subg/lap_sender")

    def stats(c):
        xy = chunk_fn(c)  # generated once for both estimators
        return (_ni_chunk_stats(xy, c, lambda v: clip_sym(v, lam1),
                                lambda v: clip_sym(v, lam2), m, kc, k,
                                lap_x, lap_y)
                + _int_subg_chunk_stats(xy, c, noise_base, sender_is_x,
                                        lam_s, lam_r, eps_s, n, n_chunk))

    st, st2, s1, s2 = _chunk_sums(stats, n_chunks)
    ni = _ni_subg_interval(*_ni_from_sums(st, st2, k), k, m, lam1, lam2,
                           alpha)
    it = _int_subg_interval(key_int, s1, s2, n, eps_s, eps_r, lam_s, lam_r,
                            alpha, mixquant_mode)
    return ni, it


# ----------------------------------------------------------- INT subG ----
def ci_int_subg_stream(key: torch.Tensor, chunk_fn: ChunkFn, n: int,
                       eps1: float, eps2: float,
                       eta1: float = 1.0, eta2: float = 1.0,
                       alpha: float = 0.05, mixquant_mode: str = "det",
                       n_chunk: int = 65536) -> CorrResult:
    """Streaming INT clipped (grid variant), ≡ ``ci_int_subg(variant=
    "grid")`` (ver-cor-subG.R:67-108): Σ Uc and Σ Uc² per chunk, sender
    noise from per-chunk folded keys, one central draw at the
    materialized key address."""
    sender_is_x, eps_s, eps_r, lam_s, lam_r = _int_subg_roles(
        n, eps1, eps2, eta1, eta2, key.device)
    noise_base = stream(key, "int_subg/lap_sender")
    s1, s2 = _chunk_sums(lambda c: _int_subg_chunk_stats(
        chunk_fn(c), c, noise_base, sender_is_x, lam_s, lam_r, eps_s, n,
        n_chunk), -(-n // n_chunk))
    return _int_subg_interval(key, s1, s2, n, eps_s, eps_r, lam_s, lam_r,
                              alpha, mixquant_mode)
