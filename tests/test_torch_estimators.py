"""The port's sign estimators against the JAX package, replication by
replication, on identical x, y and keys.

Both sides see the same numpy-seeded data and draw the same noise
(keys carried by dpcorr_torch.interop), so estimates and CI ends agree
within 1e-5 absolute. The one legitimate exception is a centered value
within 1e-5 of 0, whose sign can flip under a different f32 summation
order; such replications are counted and allowed up to 1%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcorr.models.estimators import ci_int_signflip as jax_ci_int
from dpcorr.models.estimators import ci_ni_signbatch as jax_ci_ni
from dpcorr.ops.standardize import priv_center as jax_priv_center
from dpcorr.utils import rng as jrng
from dpcorr_torch import interop
from dpcorr_torch.models.estimators import (
    ci_int_signflip,
    ci_ni_signbatch,
    correlation_int_signflip,
    correlation_ni_signbatch,
)

B, N, RHO = 64, 1024, 0.5
TIE = 1e-5


def _inputs(seed, rho=RHO):
    g = np.random.default_rng(seed)
    z = g.standard_normal((B, N, 2))
    x = z[..., 0]
    y = rho * z[..., 0] + np.sqrt(1 - rho * rho) * z[..., 1]
    jk = jrng.rep_keys(jrng.master_key(seed), B)
    pk = interop.keys_from_jax_data(np.asarray(jax.random.key_data(jk)))
    return (x.astype(np.float32), y.astype(np.float32), jk, pk)


def _near_tie(jk, x, y, eps1, eps2, prefix):
    """Per replication: does any centered value sit within TIE of 0?"""
    l_clip = float(np.sqrt(2.0 * np.log(N)))

    def centered(k, xv, yv):
        return (jax_priv_center(jrng.stream(k, f"{prefix}/std_x"), xv, eps1,
                                l_clip),
                jax_priv_center(jrng.stream(k, f"{prefix}/std_y"), yv, eps2,
                                l_clip))

    cx, cy = jax.vmap(centered)(jk, jnp.asarray(x), jnp.asarray(y))
    return ((np.abs(np.asarray(cx)) < TIE).any(1)
            | (np.abs(np.asarray(cy)) < TIE).any(1))


def _agree(got, want, ties):
    """Rows that disagree must be near-ties, and at most 1% of B."""
    got = np.stack([t.numpy() for t in got[:3]], 1)
    want = np.stack([np.asarray(t) for t in want[:3]], 1)
    bad = ~np.isclose(got, want, rtol=0.0, atol=1e-5).all(1)
    assert not (bad & ~ties).any(), np.flatnonzero(bad & ~ties)
    assert bad.sum() <= 0.01 * B


@pytest.mark.parametrize("eps", [(1.0, 1.0), (1.5, 0.5), (0.5, 0.5)])
@pytest.mark.parametrize("normalise", [True, False])
def test_ci_ni_signbatch_matches_jax(eps, normalise):
    x, y, jk, pk = _inputs(10)
    want = jax.vmap(lambda k, a, b: jax_ci_ni(
        k, a, b, *eps, alpha=0.05, normalise=normalise))(
            jk, jnp.asarray(x), jnp.asarray(y))
    got = ci_ni_signbatch(pk, torch.from_numpy(x), torch.from_numpy(y), *eps,
                          alpha=0.05, normalise=normalise)
    ties = (_near_tie(jk, x, y, *eps, "ni_sign") if normalise
            else np.zeros(B, bool))
    _agree(got, want, ties)


@pytest.mark.parametrize("eps,mode", [((1.0, 1.0), "auto"),
                                      ((1.5, 0.5), "normal"),
                                      ((0.5, 1.5), "auto"),
                                      ((5.0, 0.015), "auto"),
                                      ((1.0, 1.0), "laplace")])
def test_ci_int_signflip_matches_jax(eps, mode):
    """Normal regime (mixquant width) and Laplace regime (√n·ε_r ≤ 0.5,
    or forced), with the sender on either side."""
    x, y, jk, pk = _inputs(11)
    want = jax.vmap(lambda k, a, b: jax_ci_int(
        k, a, b, *eps, alpha=0.05, mode=mode))(
            jk, jnp.asarray(x), jnp.asarray(y))
    got = ci_int_signflip(pk, torch.from_numpy(x), torch.from_numpy(y), *eps,
                          alpha=0.05, mode=mode)
    _agree(got, want, _near_tie(jk, x, y, *eps, "int_sign"))


def test_point_estimators_match_jax():
    from dpcorr.models.estimators.int_sign import (
        correlation_int_signflip as jax_int,
    )
    from dpcorr.models.estimators.ni_sign import (
        correlation_ni_signbatch as jax_ni,
    )

    x, y, jk, pk = _inputs(12)
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    for jf, pf in ((jax_ni, correlation_ni_signbatch),
                   (jax_int, correlation_int_signflip)):
        want = np.asarray(jax.vmap(lambda k, a, b: jf(k, a, b, 1.0, 1.0))(
            jk, jnp.asarray(x), jnp.asarray(y)))
        np.testing.assert_allclose(pf(pk, xs, ys, 1.0, 1.0).numpy(), want,
                                   rtol=0.0, atol=1e-5)


def test_ci_ordering_and_range():
    x, y, _, pk = _inputs(13)
    for r in (ci_ni_signbatch(pk, torch.from_numpy(x), torch.from_numpy(y),
                              1.0, 1.0),
              ci_int_signflip(pk, torch.from_numpy(x), torch.from_numpy(y),
                              1.0, 1.0)):
        assert (r.ci_low <= r.ci_high).all()
        assert (r.ci_low >= -1).all() and (r.ci_high <= 1).all()
