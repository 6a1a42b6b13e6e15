"""The port's Box–Muller sampler (dpcorr_torch.ops.fastnorm) against
dpcorr.ops.fastnorm on the same keys.

The range reduction and the polynomials are the same f32 operations in
the same order, so ``sincos_2pi`` is held within 2 ulp of JAX (it is
bit-equal on this CPU). The radius goes through ``log`` and ``sqrt``,
whose last ulp differs between torch and XLA: ``normal_pairs`` and
``gen_gaussian_bm`` are held within 1e-6 relative, relative to
max(|x|, 1), because ``y = ρ·z₁ + √(1−ρ²)·z₂`` cancels near 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcorr.ops import fastnorm as jfast
from dpcorr.utils import rng as jrng
from dpcorr_torch import interop
from dpcorr_torch.ops import fastnorm
from dpcorr_torch.utils import rng

RTOL = 1e-6


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def _keys(seed: int):
    jk = jrng.stream(jrng.master_key(seed), "fastnorm")
    return jk, interop.keys_from_jax_data(np.asarray(jax.random.key_data(jk)))


def _within(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


def test_sincos_within_two_ulp_on_2_20_uniforms():
    u = np.random.default_rng(0).random(1 << 20, dtype=np.float32)
    u[:4] = (0.0, 0.125, 0.5, np.nextafter(np.float32(1), np.float32(0)))
    js, jc = (np.asarray(v) for v in jfast.sincos_2pi(jnp.asarray(u)))
    ts, tc = (v.numpy() for v in fastnorm.sincos_2pi(torch.from_numpy(u)))
    assert ts.dtype == tc.dtype == np.float32
    assert _ulps(ts, js) <= 2 and _ulps(tc, jc) <= 2
    theta = 2 * np.pi * u.astype(np.float64)
    assert np.abs(ts - np.sin(theta)).max() < 5e-7
    assert np.abs(tc - np.cos(theta)).max() < 5e-7


@pytest.mark.parametrize("seed,n", [(0, 1000), (2025, 4097)])
def test_normal_pairs_match_jax(seed, n):
    jk, tk = _keys(seed)
    want = [np.asarray(v) for v in jfast.normal_pairs(jk, n)]
    got = [v.numpy() for v in fastnorm.normal_pairs(tk, n)]
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape == (n,) and g.dtype == np.float32
        assert _within(g, w) <= RTOL


@pytest.mark.parametrize("rho", [0.5, -0.9])
def test_gen_gaussian_bm_matches_jax(rho):
    jk, tk = _keys(11)
    want = np.asarray(jfast.gen_gaussian_bm(jk, 5000, rho, mu=1.0,
                                            sigma=2.0))
    got = fastnorm.gen_gaussian_bm(tk, 5000, rho, mu=1.0, sigma=2.0).numpy()
    assert got.shape == want.shape == (5000, 2)
    assert _within(got, want) <= RTOL


def test_leading_key_axes_and_the_law():
    """Keys with leading axes draw each row as its own key does, and a
    large draw has the law's moments and correlation."""
    keys = rng.rep_keys(rng.master_key(3), 4)
    rows = fastnorm.gen_gaussian_bm(keys, 300, 0.5)
    assert rows.shape == (4, 300, 2)
    for i in range(4):
        assert torch.equal(rows[i], fastnorm.gen_gaussian_bm(keys[i], 300,
                                                             0.5))
    xy = fastnorm.gen_gaussian_bm(rng.master_key(4), 200_000, 0.5).double()
    assert abs(float(torch.corrcoef(xy.T)[0, 1]) - 0.5) < 0.01
    assert float(xy.mean(0).abs().max()) < 0.01
    assert float((xy.std(0) - 1).abs().max()) < 0.01
