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
