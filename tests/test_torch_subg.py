"""The port's sub-Gaussian family and its pieces against the JAX package.

Same numpy-seeded data and the same keys (carried by
``dpcorr_torch.interop``) go through both. Bit for bit: ``split``,
``bernoulli``, ``permutation`` (a stable sort on 32-bit keys; one seed
below has two equal sort keys), ``chunk_key``, the per-replication batch
geometry, ``k_pad_for``, the f32 geometry band, and the uniform-only
DGPs. Within tolerance: the λ rules (1 ulp), exponential draws (2 ulp),
``mixquant_mc`` (its normals go through ``torch.erfinv``), and the
estimators (1e-5 absolute on estimates and CI ends, two ulp on
estimates far outside [−1, 1]; f32 summation order and the last ulp of
log1p are the only differences).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcorr.models import dgp as jdgp
from dpcorr.models.estimators import common as jcommon
from dpcorr.models.estimators.int_subg import ci_int_subg as jax_ci_int
from dpcorr.models.estimators.ni_subg import correlation_ni_subg as jax_ni
from dpcorr.ops import lambdas as jlam
from dpcorr.ops.mixquant import mixquant_mc as jax_mixquant_mc
from dpcorr.utils import rng as jrng
from dpcorr_torch import interop
from dpcorr_torch.models import dgp
from dpcorr_torch.models.estimators import (
    batch_geometry_dyn,
    batch_means_dyn,
    ci_int_subg,
    correlation_ni_subg,
    k_pad_for,
)
from dpcorr_torch.models.estimators import common
from dpcorr_torch.ops import lambdas
from dpcorr_torch.ops.mixquant import mixquant_mc
from dpcorr_torch.utils import rng

B, N, RHO = 64, 1024, 0.5
#: a seed whose first permutation round at n = 10⁴ draws two equal
#: 32-bit sort keys, so only a stable sort reproduces JAX
COLLISION_SEED = 98


def _keys(seed, b=B):
    jk = jrng.rep_keys(jrng.master_key(seed), b)
    return jk, interop.keys_from_jax_data(np.asarray(jax.random.key_data(jk)))


def _words(jax_keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(jax_keys)).astype(np.int64)


def _bounded(seed, n=N, rho=RHO, b=B):
    """Bounded-factor-like numpy data, (b, n) each for x and y."""
    g = np.random.default_rng(seed)
    u = g.uniform(-1, 1, (b, n)) * np.sqrt(3 * rho)
    e = g.uniform(-1, 1, (2, b, n)) * np.sqrt(3 * (1 - rho))
    return (u + e[0]).astype(np.float32), (u + e[1]).astype(np.float32)


def _stack(r):
    return np.stack([np.asarray(t) for t in r[:3]], 1)


# ------------------------------------------------------------ key-tree ----
@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_bit_equal(num):
    jk, pk = _keys(3, 8)
    want = np.stack([_words(jax.random.split(k, num)) for k in jk])
    np.testing.assert_array_equal(rng.split(pk, num).numpy(), want)


def test_chunk_key_bit_equal():
    jk, pk = _keys(4, 8)
    for c in (0, 1, 15, 2**20):
        want = _words(jax.vmap(lambda k: jrng.chunk_key(k, c))(jk))
        np.testing.assert_array_equal(rng.chunk_key(pk, c).numpy(), want)


@pytest.mark.parametrize("p", [0.5, 0.2689414213699951, 0.999])
def test_bernoulli_bit_equal(p):
    jk, pk = _keys(5, 8)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.bernoulli(k, p, (4096,)))(jk))
    np.testing.assert_array_equal(rng.bernoulli(pk, p, (4096,)).numpy(),
                                  want)


@pytest.mark.parametrize("n,seed", [(300, 0), (4000, 1), (10_000, 2),
                                    (10_000, COLLISION_SEED)])
def test_permutation_bit_equal(n, seed):
    key = rng.master_key(seed)
    want = np.asarray(jax.random.permutation(jrng.master_key(seed), n))
    np.testing.assert_array_equal(rng.permutation(key, n).numpy(), want)
    if seed == COLLISION_SEED:
        sub = rng.split(key)[1]
        bits = rng.random_bits(sub, (n,))
        assert bits.unique().numel() < n  # the case a stable sort decides
    # batched keys draw what each key draws alone
    jk, pk = _keys(seed, 4)
    batched = rng.permutation(pk, n).numpy()
    for row, k in zip(batched, jk):
        np.testing.assert_array_equal(
            row, np.asarray(jax.random.permutation(k, n)))


def test_permutation_rounds_follow_jax():
    assert [rng.permutation_rounds(n) for n in (1, 300, 400, 1600, 1700,
                                                10**4, 2 * 10**6)] \
        == [0, 1, 1, 1, 2, 2, 2]


def test_exponential_within_two_ulp():
    jk, pk = _keys(6, 8)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.exponential(k, (4096,)))(jk))
    got = rng.exponential(pk, (4096,)).numpy()
    assert (np.abs(got - want) <= 2 * np.spacing(want)).all()


# --------------------------------------------------------------- λ rules ----
def _ulp_close(got: torch.Tensor, want, ulps=1):
    want = np.asarray(want, np.float32)
    assert np.abs(got.numpy() - want) <= ulps * np.spacing(np.abs(want))


@pytest.mark.parametrize("n", [2, 300, 2500, 4000, 12_000, 10**6])
def test_lambda_rules_within_one_ulp(n):
    for eta in (0.5, 1.0, 1.7):
        _ulp_close(lambdas.lambda_n(n, eta), jlam.lambda_n(n, eta))
        for eps_s in (0.25, 1.0, 1.5):
            got = lambdas.lambda_int_n(n, eta, 1.3, eps_s)
            want = jlam.lambda_int_n(n, eta, 1.3, eps_s)
            _ulp_close(got[0], want[0])
            _ulp_close(got[1], want[1])
            lam_s = jlam.lambda_n(n, eta)
            _ulp_close(lambdas.lambda_receiver_from_noise(
                lambdas.lambda_n(n, eta), 2.5, eps_s, 1.0 / n),
                jlam.lambda_receiver_from_noise(lam_s, 2.5, eps_s, 1.0 / n))
    _ulp_close(lambdas.lambda_from_priv(18.0, 80.0, 31.5, 4.25),
               jlam.lambda_from_priv(18.0, 80.0, 31.5, 4.25))


def test_lambda_rules_take_per_replication_tensors():
    eps = torch.tensor([0.5, 1.0, 2.0])
    lam_s, lam_r = lambdas.lambda_int_n(4000, 1.0, 1.0, eps)
    assert lam_s.shape == () and lam_r.shape == (3,)
    for i, e in enumerate((0.5, 1.0, 2.0)):
        assert lam_r[i] == lambdas.lambda_int_n(4000, 1.0, 1.0, e)[1]


# -------------------------------------------------------------- geometry ----
EPS_GRID = (0.1, 0.25, 0.5, 0.75, 1.0, 1.1547, 1.5, 2.0, 3.0, 2.0**0.5)


@pytest.mark.parametrize("n", [40, 400, 4000, 12_000])
def test_batch_geometry_dyn_and_k_pad_bit_equal(n):
    pairs = [(a, b) for a in EPS_GRID for b in EPS_GRID]
    e1 = np.array([p[0] for p in pairs], np.float32)
    e2 = np.array([p[1] for p in pairs], np.float32)
    for min_k in (False, True):
        jm, jk = jax.vmap(lambda a, b: jcommon.batch_geometry_dyn(
            n, a, b, enforce_min_k=min_k))(jnp.asarray(e1), jnp.asarray(e2))
        pm, pk = batch_geometry_dyn(n, torch.from_numpy(e1),
                                    torch.from_numpy(e2), min_k)
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        assert pk.dtype == pm.dtype == torch.int32
    products = sorted({a * b for a, b in pairs})
    for cut in (1, 5, len(products)):
        assert k_pad_for(n, products[:cut]) == jcommon.k_pad_for(
            n, products[:cut])
    # scalar ε give 0-d tensors with the same values
    m0, k0 = batch_geometry_dyn(n, 1.5, 0.5)
    assert (m0.item(), k0.item()) == tuple(
        int(v) for v in jcommon.batch_geometry_dyn(n, 1.5, 0.5))


def test_f32_geometry_band_on_the_band_example(caplog):
    pairs = [(1.1547, 1.1547), (1.0, 1.0), (2.0**0.5, 2.0**0.5)]
    want = jcommon.f32_geometry_band(pairs, n=4000)
    assert common.f32_geometry_band(pairs, n=4000) == want
    assert want and want[0][:2] == (1.1547, 1.1547)
    assert common.f32_geometry_band([(1.0, 1.0)]) == []
    with caplog.at_level("WARNING"):
        assert common.warn_f32_geometry_band_once(pairs, 4000, "t") == want
        common.warn_f32_geometry_band_once(pairs, 4000, "t")
    assert sum("geometry" in r.message for r in caplog.records) == 1


def test_batch_means_dyn_matches_jax():
    x, _ = _bounded(7, n=1000, b=6)
    ms = np.array([1, 8, 11, 50, 333, 1000], np.int32)
    ks = 1000 // ms
    want = np.asarray(jax.vmap(lambda v, m, k: jcommon.batch_means_dyn(
        v, m, k, 64))(jnp.asarray(x), jnp.asarray(ms), jnp.asarray(ks)))
    got = batch_means_dyn(torch.from_numpy(x), torch.from_numpy(ms),
                          torch.from_numpy(ks), 64).numpy()
    for row in range(6):
        live = slice(0, min(int(ks[row]), 64))
        np.testing.assert_allclose(got[row, live], want[row, live],
                                   rtol=1e-5, atol=2e-6)


# ------------------------------------------------------------------ DGPs ----
@pytest.mark.parametrize("rho", [0.0, 0.3, 0.5, 0.9])
def test_bounded_factor_within_one_ulp(rho):
    """Uniforms times √(3ρ): the draws are bit-equal, and XLA contracts
    U·c_u + E·c_e into a fused multiply-add where torch rounds twice, so
    a sum may sit one ulp away (most are bit-equal)."""
    jk, pk = _keys(8, 16)
    want = np.asarray(jax.vmap(lambda k: jdgp.gen_bounded_factor(
        k, 2048, jnp.float32(rho)))(jk))
    got = dgp.gen_bounded_factor(pk, 2048, rho).numpy()
    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()
    assert (got == want).mean() > 0.9
    # ρ per replication
    rhos = np.linspace(0.05, 0.95, 16).astype(np.float32)
    want = np.asarray(jax.vmap(lambda k, r: jdgp.gen_bounded_factor(
        k, 256, r))(jk, jnp.asarray(rhos)))
    got = dgp.gen_bounded_factor(pk, 256, torch.from_numpy(rhos)).numpy()
    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()


def test_bernoulli_and_mixture_dgps():
    jk, pk = _keys(9, 16)
    want = np.asarray(jax.vmap(lambda k: jdgp.gen_bernoulli(
        k, 2048, jnp.float32(0.3)))(jk))
    np.testing.assert_array_equal(dgp.gen_bernoulli(pk, 2048, 0.3).numpy(),
                                  want)
    want = np.asarray(jax.vmap(lambda k: jdgp.gen_mix_gaussian(
        k, 2048, jnp.float32(0.3)))(jk))
    got = dgp.gen_mix_gaussian(pk, 2048, 0.3).numpy()
    assert got.min() >= -1 and got.max() <= 1
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    labels = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(
        jrng.stream(k, "mix_gaussian/labels"), 0.5, (2048,)))(jk))
    np.testing.assert_array_equal(rng.bernoulli(
        rng.stream(pk, "mix_gaussian/labels"), 0.5, (2048,)).numpy(), labels)
    assert set(dgp.DGPS) == set(jdgp.DGPS)


# -------------------------------------------------------------- mixquant ----
@pytest.mark.parametrize("nsim", [1000, 2000])
def test_mixquant_mc_matches_jax(nsim):
    jk, pk = _keys(10, 32)
    c = np.geomspace(0.01, 20.0, 32).astype(np.float32)
    for p in (0.975, 0.5):
        want = np.asarray(jax.vmap(lambda k, cc: jax_mixquant_mc(
            k, cc, p, nsim=nsim))(jk, jnp.asarray(c)))
        got = mixquant_mc(pk, torch.from_numpy(c), p, nsim=nsim).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ estimators ----
def _close_rows(got, want, atol=1e-5):
    """Share of replications whose estimate and CI ends agree: within
    ``atol``, or within 2.5e-7 relative (two f32 ulp) for an estimate far
    outside [−1, 1], as the k = 2 fallback gives."""
    return np.isclose(_stack(got), _stack(want), rtol=2.5e-7,
                      atol=atol).all(1).mean()


@pytest.mark.parametrize("kw", [
    dict(),
    dict(randomize_batches=True, enforce_min_k=True),
    dict(eta1=0.7, eta2=1.3, lambda_y=2.5),
])
def test_correlation_ni_subg_static_matches_jax(kw):
    x, y = _bounded(11)
    jk, pk = _keys(11)
    eps = (1.5, 0.5)
    want = jax.vmap(lambda k, a, b: jax_ni(k, a, b, *eps, **kw))(
        jk, jnp.asarray(x), jnp.asarray(y))
    got = correlation_ni_subg(pk, torch.from_numpy(x), torch.from_numpy(y),
                              *eps, **kw)
    assert _close_rows(got, want) == 1.0
    assert (got.aux["k"], got.aux["m"]) == (int(want.aux["k"][0]),
                                            int(want.aux["m"][0]))


def test_correlation_ni_subg_min_k_fallback():
    """m = ⌈8/(0.1·0.1)⌉ = 800 > n/2: k = 2, m = ⌊n/2⌋."""
    x, y = _bounded(12, n=1000)
    jk, pk = _keys(12)
    want = jax.vmap(lambda k, a, b: jax_ni(
        k, a, b, 0.1, 0.1, randomize_batches=True, enforce_min_k=True))(
        jk, jnp.asarray(x), jnp.asarray(y))
    got = correlation_ni_subg(pk, torch.from_numpy(x), torch.from_numpy(y),
                              0.1, 0.1, randomize_batches=True,
                              enforce_min_k=True)
    assert (got.aux["k"], got.aux["m"]) == (2, 500)
    assert _close_rows(got, want) == 1.0


@pytest.mark.parametrize("randomize", [False, True])
def test_correlation_ni_subg_dynamic_matches_jax(randomize):
    """ε per replication, batch vectors padded to ``k_pad``: every
    replication at its own (m, k), one call, no host reads."""
    x, y = _bounded(13)
    jk, pk = _keys(13)
    e1 = np.tile(np.array([2.0, 1.5, 1.0, 1.1547], np.float32), B // 4)
    e2 = np.tile(np.array([1.0, 0.5, 1.0, 1.1547], np.float32), B // 4)
    k_pad = k_pad_for(N, set((e1 * e2).tolist()))
    kw = dict(dynamic_geometry=True, k_pad=k_pad,
              randomize_batches=randomize, enforce_min_k=randomize)
    want = jax.vmap(lambda k, a, b, p, q: jax_ni(k, a, b, p, q, **kw))(
        jk, jnp.asarray(x), jnp.asarray(y), jnp.asarray(e1), jnp.asarray(e2))
    got = correlation_ni_subg(pk, torch.from_numpy(x), torch.from_numpy(y),
                              torch.from_numpy(e1), torch.from_numpy(e2),
                              **kw)
    np.testing.assert_array_equal(got.aux["k"].numpy(),
                                  np.asarray(want.aux["k"]))
    assert _close_rows(got, want, atol=2e-5) == 1.0
    # the pad-bound tripwire poisons, never drops batches silently
    small = correlation_ni_subg(pk, torch.from_numpy(x),
                                torch.from_numpy(y), torch.from_numpy(e1),
                                torch.from_numpy(e2), dynamic_geometry=True,
                                k_pad=4)
    assert torch.isnan(small.rho_hat).all()


@pytest.mark.parametrize("variant", ["grid", "real"])
@pytest.mark.parametrize("mixquant_mode", ["det", "mc"])
@pytest.mark.parametrize("eps,sender", [((1.5, 0.5), None),
                                        ((0.5, 1.5), None),
                                        ((0.5, 1.5), "x")])
def test_ci_int_subg_matches_jax(variant, mixquant_mode, eps, sender):
    x, y = _bounded(14)
    jk, pk = _keys(14)
    kw = dict(variant=variant, mixquant_mode=mixquant_mode, sender=sender)
    want = jax.vmap(lambda k, a, b: jax_ci_int(k, a, b, *eps, **kw))(
        jk, jnp.asarray(x), jnp.asarray(y))
    got = ci_int_subg(pk, torch.from_numpy(x), torch.from_numpy(y), *eps,
                      **kw)
    assert _close_rows(got, want) >= 0.99
    assert set(got.aux) == set(want.aux)


def test_ci_int_subg_real_overrides_and_degenerate_branch():
    """λ overrides, and constant data: sd(Uc) = 0 takes the Laplace-only
    width (real-data-sims.R:237-238)."""
    x, y = _bounded(15)
    jk, pk = _keys(15)
    kw = dict(variant="real", lambda_sender=2.0, lambda_other=1.5,
              delta_clip=1e-3, sender="y")
    want = jax.vmap(lambda k, a, b: jax_ci_int(k, a, b, 1.0, 2.0, **kw))(
        jk, jnp.asarray(x), jnp.asarray(y))
    got = ci_int_subg(pk, torch.from_numpy(x), torch.from_numpy(y), 1.0,
                      2.0, **kw)
    assert _close_rows(got, want) == 1.0
    zeros = torch.zeros(4, 64)
    deg = ci_int_subg(pk[:4], zeros, zeros, 1.0, 1.0, variant="real")
    assert torch.isfinite(deg.ci_low).all()
    assert (deg.ci_high - deg.ci_low > 0).all()


def test_ci_int_subg_refuses_what_jax_refuses():
    x = torch.zeros(2, 16)
    _, pk = _keys(16, 2)
    with pytest.raises(ValueError, match="variant"):
        ci_int_subg(pk, x, x, 1.0, 1.0, variant="other")
    with pytest.raises(ValueError, match="sender"):
        ci_int_subg(pk, x, x, 1.0, 1.0, sender="z")
    with pytest.raises(ValueError, match="explicit sender"):
        ci_int_subg(pk, x, x, torch.ones(2), torch.ones(2))
