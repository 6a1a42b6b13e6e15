"""The port's DP primitives against the JAX package on identical inputs.

Data are made with numpy from a seed and keys are carried across by
dpcorr_torch.interop, so both sides see the same values and draw the same
noise. The remaining differences are f32 summation order and the last
ulp of log1p: centered values are held within 1e-6 relative (plus 1e-6
absolute near zero), mixquant within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcorr.models.estimators.common import batch_geometry as jax_geometry
from dpcorr.ops.mixquant import mix_cdf as jax_mix_cdf
from dpcorr.ops.mixquant import mixquant as jax_mixquant
from dpcorr.ops import standardize as jstd
from dpcorr.utils import rng as jrng
from dpcorr_torch import interop
from dpcorr_torch.models.estimators.common import (
    batch_geometry,
    batch_means,
    sample_sd,
)
from dpcorr_torch.ops import mixquant, standardize
from dpcorr_torch.ops.noise import clip, clip_sym
from dpcorr_torch.utils import rng

B, N = 16, 1024


def _keys(seed):
    jk = jrng.rep_keys(jrng.master_key(seed), B)
    return jk, interop.keys_from_jax_data(np.asarray(jax.random.key_data(jk)))


def _data(seed, scale=1.5):
    return (np.random.default_rng(seed).standard_normal((B, N)) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("eps", [0.5, 1.0, 2.0])
def test_priv_center_matches_jax(eps):
    jk, pk = _keys(1)
    x = _data(2)
    l_clip = float(np.sqrt(2.0 * np.log(N)))
    want = np.asarray(jax.vmap(
        lambda k, v: jstd.priv_center(k, v, eps, l_clip))(jk, jnp.asarray(x)))
    got = standardize.priv_center(pk, torch.from_numpy(x), eps, l_clip)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("eps", [0.5, 1.0, 2.0])
def test_priv_standardize_matches_jax(eps):
    jk, pk = _keys(3)
    x = _data(4)
    want = np.asarray(jax.vmap(
        lambda k, v: jstd.priv_standardize(k, v, eps, 3.0))(jk,
                                                            jnp.asarray(x)))
    got = standardize.priv_standardize(pk, torch.from_numpy(x), eps, 3.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_priv_moments_share_the_mu_address():
    """The center-only mean is the full standardizer's mean, bit for bit."""
    _, pk = _keys(5)
    s1 = torch.full((B,), 3.0)
    mu_a = standardize.priv_mean_from_sum(pk, s1, N, 1.0, 2.0)
    mu_b, _ = standardize.priv_moments_from_sums(pk, s1, s1 * 4, N, 1.0, 2.0)
    assert torch.equal(mu_a, mu_b)


@pytest.mark.parametrize("c", [0.0, 0.005, 0.05, 0.5, 2.0, 10.0])
def test_mix_cdf_matches_jax(c):
    x = np.linspace(-12.0, 12.0, 481).astype(np.float32)
    want = np.asarray(jax_mix_cdf(jnp.asarray(x), c))
    got = mixquant.mix_cdf(torch.from_numpy(x), c).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_mixquant_matches_jax():
    c = np.array([0.0, 0.005, 0.02, 0.1, 0.5, 1.0, 3.0, 20.0], np.float32)
    for p in (0.5, 0.9, 0.975, 0.995):
        want = np.asarray(jax_mixquant(jnp.asarray(c), p))
        got = mixquant.mixquant(torch.from_numpy(c), p).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_batch_geometry_matches_reference_grid():
    """The static f64 rule over the reference ε grid (vert-cor.R:488-494)
    plus awkward products, at every n of the reference grid."""
    eps_grid = (0.1, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 2.0**0.5)
    for n in (1, 40, 1000, 1500, 2500, 4000, 6000, 9000, 10_000):
        for e1 in eps_grid:
            for e2 in eps_grid:
                for min_k in (False, True):
                    try:
                        want = jax_geometry(n, e1, e2, min_k)
                    except ValueError:
                        with pytest.raises(ValueError):
                            batch_geometry(n, e1, e2, min_k)
                        continue
                    assert batch_geometry(n, e1, e2, min_k) == want


def test_batch_means_sd_and_clip():
    v = torch.from_numpy(_data(6))
    bm = batch_means(v, 100, 10)
    np.testing.assert_allclose(bm.numpy(), v[:, :1000].numpy().reshape(
        B, 100, 10).mean(-1), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(sample_sd(v).numpy(),
                               v.numpy().std(-1, ddof=1), rtol=1e-5)
    assert clip(v, -0.5, 0.25).max() == 0.25
    assert clip_sym(v, torch.tensor(0.5)).min() == -0.5


# --------------------------------------------- real-data standardization ----
#: (lo, hi) of the real-data variables (real-data-sims.R:260-270) and a
#: pair that straddles 0, where the second moment's sensitivity is
#: max(lo², hi²)
BOUNDS = [(45.0, 90.0), (15.0, 35.0), (-3.0, 5.0)]


def _real_data(seed, lo, hi, n=5000):
    g = np.random.default_rng(seed)
    mid, half = (lo + hi) / 2, (hi - lo) / 2
    return (mid + half * 0.6 * g.standard_normal((4, n))).astype(np.float32)


@pytest.mark.parametrize("lo,hi", BOUNDS)
def test_dp_moments_match_jax(lo, hi):
    """dp_mean and dp_second_moment within 1e-6 relative (f32 summation
    order, the last ulp of log1p). dp_sd's sd = √(m2 − μ²) carries those
    errors magnified by the cancellation: held to
    1e-6 · (m2 + 2μ²) / (2 sd)."""
    x = _real_data(3, lo, hi)
    jk, pk = _keys(21)
    jk, pk = jk[:4], pk[:4]
    xt = torch.from_numpy(x)
    for jfn, pfn in ((jstd.dp_mean, standardize.dp_mean),
                     (jstd.dp_second_moment, standardize.dp_second_moment)):
        want = np.asarray(jax.vmap(lambda k, v: jfn(k, v, lo, hi, 0.1))(
            jk, jnp.asarray(x)))
        got = pfn(pk, xt, lo, hi, 0.1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)
    j_mu, j_sd = (np.asarray(v) for v in jax.vmap(
        lambda k, v: jstd.dp_sd(k, v, lo, hi, 0.1, 0.1))(jk, jnp.asarray(x)))
    p_mu, p_sd = (v.numpy() for v in standardize.dp_sd(pk, xt, lo, hi, 0.1,
                                                      0.1))
    np.testing.assert_allclose(p_mu, j_mu, rtol=1e-6, atol=0.0)
    m2 = j_sd.astype(np.float64) ** 2 + j_mu.astype(np.float64) ** 2
    tol = 1e-6 * (m2 + 2 * j_mu.astype(np.float64) ** 2) / (2 * j_sd)
    assert (np.abs(p_sd - j_sd) <= tol).all()


def test_dp_sd_floors_at_zero_and_standardize_dp_matches_jax():
    """A constant column has a negative noisy variance now and then: sd is
    floored at exactly 0 (real-data-sims.R:82), and standardize_dp's sd
    floor of 1e-8 keeps it finite; on the same moments the z-scores agree
    within 1e-6 relative."""
    x = np.full((64, 200), 60.0, np.float32)
    pk = rng.rep_keys(rng.master_key(22), 64)
    _, sd = standardize.dp_sd(pk, torch.from_numpy(x), 45.0, 90.0, 0.1, 0.1)
    assert (sd >= 0).all() and (sd == 0).any()
    z = _real_data(4, 45.0, 90.0, n=3000)[0]
    for mu, s in ((60.5, 12.25), (58.0, 0.0)):
        want = np.asarray(jstd.standardize_dp(jnp.asarray(z), mu, s, 45.0,
                                              90.0))
        got = standardize.standardize_dp(torch.from_numpy(z),
                                         torch.tensor(mu), torch.tensor(s),
                                         45.0, 90.0).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)
