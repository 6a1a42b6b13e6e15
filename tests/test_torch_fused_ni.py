"""The fused replication kernel's plain version against the JAX Pallas
kernel, run in interpret mode on identical uniforms.

The plain version (dpcorr_torch.ops.fused_ni.fused_ni_plain) reads the
uniforms in the TPU kernel's take() order, so both compute the same
replication: ΣT_j and ΣT_j² agree within 1e-4 relative (f32 sums taken
in another order) and η̂_INT within 1e-5. The CUDA kernel is held against
the plain version on the card by tests/test_torch_cuda.py.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcorr.ops import pallas_ni
from dpcorr.sim import DETAIL_FIELDS as JAX_FIELDS
from dpcorr_torch.ops import fused_ni
from dpcorr_torch.sim import DETAIL_FIELDS, sim_detail_fused

N = 1024
EPS_PAIRS = [(1.0, 1.0), (1.5, 0.5)]


def _uniforms(seed, b, n, eps, compute_int):
    rows = pallas_ni.n_uniform_rows(n, *eps, compute_int)
    return np.random.default_rng(seed).uniform(
        1e-7, 1 - 1e-7, (b, rows, 128)).astype(np.float32)


def _rhos(b):
    return np.linspace(-0.6, 0.9, b).astype(np.float32)


@pytest.mark.parametrize("eps", EPS_PAIRS)
@pytest.mark.parametrize("normalise", [True, False])
@pytest.mark.parametrize("gauss", ["boxmuller", "ndtri"])
@pytest.mark.parametrize("compute_int", [False, True])
def test_plain_matches_interpret_kernel(compute_int, gauss, normalise, eps):
    b = 8
    u = _uniforms(1, b, N, eps, compute_int)
    rho = _rhos(b)
    st, st2, eta = pallas_ni._ni_sign_pallas_sums(
        jnp.zeros((b, 2), jnp.int32), jnp.asarray(rho), N, *eps, (0.0, 0.0),
        (1.0, 1.0), normalise, True, compute_int, gauss,
        uniforms=jnp.asarray(u))
    got = fused_ni.fused_ni_sums(
        torch.zeros(b, 2, dtype=torch.int32), torch.from_numpy(rho), N, *eps,
        normalise=normalise, compute_int=compute_int, gauss=gauss,
        uniforms=torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got[:, 0], np.asarray(st), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got[:, 1], np.asarray(st2), rtol=1e-4)
    np.testing.assert_allclose(got[:, 2], np.asarray(eta), rtol=0, atol=1e-5)


def test_mu_sigma_are_applied():
    eps, b = (1.0, 1.0), 4
    u = _uniforms(2, b, N, eps, True)
    mu, sigma = (0.3, -1.0), (2.0, 0.5)
    st, st2, eta = pallas_ni._ni_sign_pallas_sums(
        jnp.zeros((b, 2), jnp.int32), jnp.float32(0.4), N, *eps, mu, sigma,
        True, True, True, "boxmuller", uniforms=jnp.asarray(u))
    got = fused_ni.fused_ni_plain(
        None, torch.tensor(0.4), torch.from_numpy(u), n=N, eps1=1.0,
        eps2=1.0, mu=mu, sigma=sigma, compute_int=True).numpy()
    np.testing.assert_allclose(got[:, :2], np.stack([st, st2], 1),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[:, 2], np.asarray(eta), atol=1e-5)


@pytest.mark.parametrize("eps", EPS_PAIRS)
def test_ni_sign_fused_matches_ni_sign_pallas(eps):
    b = 16
    u = _uniforms(3, b, N, eps, False)
    want = pallas_ni.ni_sign_pallas(np.arange(b, dtype=np.int32), 0.5, N,
                                    *eps, uniforms=jnp.asarray(u))
    got = fused_ni.ni_sign_fused(np.zeros((b, 2), np.int32), 0.5, N, *eps,
                                 uniforms=torch.from_numpy(u), device="cpu")
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("eps,ci_mode", [((1.0, 1.0), "auto"),
                                         ((1.5, 0.5), "auto"),
                                         ((5.0, 0.015), "auto"),
                                         ((1.0, 1.0), "laplace")])
def test_sim_detail_fused_matches_sim_detail_pallas(eps, ci_mode):
    b = 16
    u = _uniforms(4, b, N, eps, True)
    rho = _rhos(b)
    want = pallas_ni.sim_detail_pallas(np.arange(b, dtype=np.int32), rho, N,
                                       *eps, ci_mode=ci_mode,
                                       uniforms=jnp.asarray(u))
    got = sim_detail_fused(torch.zeros(b, 2, dtype=torch.int32),
                           torch.from_numpy(rho), N, *eps, ci_mode=ci_mode,
                           uniforms=torch.from_numpy(u), device="cpu")
    assert DETAIL_FIELDS == JAX_FIELDS
    for name, g, w in zip(DETAIL_FIELDS, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=name)


def test_layout_matches_jax_on_reference_grid():
    for n in (1000, 1500, 2500, 4000, 6000, 9000, 10_000, 20_000):
        for eps in ((0.5, 0.5), (1.0, 1.0), (1.5, 0.5), (0.1, 0.1),
                    (5.0, 0.015)):
            assert (fused_ni.use_fused_ni(n, *eps)
                    == pallas_ni.use_ni_sign_pallas(n, *eps))
            assert fused_ni.layout(n, *eps) == pallas_ni._layout(n, *eps)
            for ci in (False, True):
                assert (fused_ni.n_uniform_rows(n, *eps, ci)
                        == pallas_ni.n_uniform_rows(n, *eps, ci))


def test_uniform_bits_no_sign_extension():
    """int32 bits with the sign bit set still give (0, 1) uniforms, the
    same as the TPU kernel's rule, at both ends of the range."""
    bits = np.array([-1, -(2**31), -123456789, 0, 1, 2**31 - 1], np.int32)
    u = fused_ni.uniform_from_bits(torch.from_numpy(bits)).numpy()
    assert (u > 0.0).all() and (u < 1.0).all()
    assert u.min() == 2.0**-24 and u.max() == 1.0 - 2.0**-24
    assert np.isfinite(np.log(u)).all()
    assert np.isfinite(np.log1p(-2.0 * np.abs(u - 0.5))).all()
    more = np.random.default_rng(5).integers(-2**31, 2**31, 4096,
                                             dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(
        fused_ni.uniform_from_bits(torch.from_numpy(more)).numpy(),
        np.asarray(pallas_ni._uniform(jnp.asarray(more))))


def test_device_helpers_match_jax():
    u = np.linspace(2.0**-24, 1.0 - 2.0**-24, 100_001).astype(np.float32)
    np.testing.assert_allclose(
        fused_ni.ndtri_inline(torch.from_numpy(u)).numpy(),
        np.asarray(pallas_ni._ndtri_inline(jnp.asarray(u))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        fused_ni.laplace_from_uniform(torch.from_numpy(u), 0.3).numpy(),
        np.asarray(pallas_ni._laplace_from_uniform(jnp.asarray(u), 0.3)),
        rtol=1e-6, atol=1e-6)


def test_wrapper_refuses_what_it_cannot_run():
    seeds = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="m <= 128"):
        fused_ni.fused_ni_sums(seeds, 0.5, 10_000, 0.1, 0.1)
    with pytest.raises(ValueError, match="gauss"):
        fused_ni.fused_ni_sums(seeds, 0.5, N, 1.0, 1.0, gauss="bm")
    with pytest.raises(ValueError, match="pass `uniforms`"):
        fused_ni.fused_ni_sums(seeds, 0.5, N, 1.0, 1.0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_ni.fused_ni_sums(seeds.to("meta"), 0.5, N, 1.0, 1.0)


def test_params_struct_has_no_padding():
    """Eight ints then twelve floats, as FusedNiParams in fused_ni.cu."""
    assert ctypes.sizeof(fused_ni._Params) == 20 * 4
    src = (fused_ni.__file__.rsplit("/ops/", 1)[0]
           + "/csrc/fused_ni.cu")
    text = open(src).read()
    for name, _ in fused_ni._Params._fields_:
        assert name in text


@pytest.mark.parametrize("compute_int,n_cap", [(False, 28_672),
                                               (True, 25_600)])
def test_planes_alone_cap_n(compute_int, n_cap):
    """At m = 8 the x and y planes (and INT's flips) cap n; the batch
    noise stays in shared memory at the main path's n = 10⁴ and moves to
    the kernel's sweep where it does not fit, so it never lowers the cap.
    The wrapper's limit is the kernel's ``kSmemLimit``."""
    def consts(n):
        return fused_ni._Consts(n, 1.0, 1.0, (0.0, 0.0), (1.0, 1.0))

    assert fused_ni.layout(n_cap, 1.0, 1.0)[1] == 8
    assert consts(n_cap).plane_bytes(compute_int) <= fused_ni._SMEM_LIMIT
    assert not consts(n_cap).noise_in_smem(compute_int)
    assert consts(n_cap + 1).plane_bytes(compute_int) > fused_ni._SMEM_LIMIT
    assert consts(10_000).noise_in_smem(compute_int)
    src = (fused_ni.__file__.rsplit("/ops/", 1)[0] + "/csrc/fused_ni.cu")
    total, margin = re.search(r"kSmemLimit = (\d+) - (\d+);",
                              open(src).read()).groups()
    assert int(total) - int(margin) == fused_ni._SMEM_LIMIT
