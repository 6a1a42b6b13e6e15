"""The port's streaming (n-blocked) estimators.

Each estimator at n = 4096 with n_chunk = 1024 is held two ways on the
same keys: against the JAX package's streaming version on the same
numpy-seeded data (1e-5 absolute on estimates and CI ends), and against
the port's own materialized estimator on ``array_chunk_fn`` data. The NI
estimators draw their batch noise at the materialized address, so they
agree with the materialized estimator to summation order; the INT
estimators draw per-chunk noise, so they agree where that noise is
deterministic (ε_s = 30 makes every flip a keep; ε_s = 10⁶ makes the
sender noise ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcorr.models.dgp import gen_bounded_factor as jax_bounded_factor
from dpcorr.models.estimators import streaming as jst
from dpcorr.models.estimators.common import batch_geometry
from dpcorr.utils import rng as jrng
from dpcorr_torch import interop
from dpcorr_torch.models import dgp
from dpcorr_torch.models.estimators import (
    ci_int_signflip,
    ci_int_subg,
    ci_ni_signbatch,
    correlation_ni_subg,
)
from dpcorr_torch.models.estimators import streaming as st
from dpcorr_torch.utils import rng

B, N, N_CHUNK, RHO = 16, 4096, 1024, 0.5


def _keys(seed, b=B):
    jk = jrng.rep_keys(jrng.master_key(seed), b)
    return jk, interop.keys_from_jax_data(np.asarray(jax.random.key_data(jk)))


def _data(seed, n=N, b=B):
    """Correlated numpy data (b, n, 2): a bounded factor."""
    g = np.random.default_rng(seed)
    u = g.uniform(-1, 1, (b, n)) * np.sqrt(3 * RHO)
    e = g.uniform(-1, 1, (2, b, n)) * np.sqrt(3 * (1 - RHO))
    return np.stack([u + e[0], u + e[1]], -1).astype(np.float32)


def _rows(r):
    return np.stack([np.asarray(t) for t in r[:3]], 1)


def _agree(got, want, atol=1e-5):
    np.testing.assert_allclose(_rows(got), _rows(want), rtol=0.0, atol=atol)


def _jax_stream(fn, jk, xy, n_chunk, *args, **kw):
    return jax.vmap(lambda k, d: fn(k, jst.array_chunk_fn(d, n_chunk), N,
                                    *args, n_chunk=n_chunk, **kw))(
        jk, jnp.asarray(xy))


def test_choose_n_chunk_and_array_chunk_fn():
    for n, m, target in ((10_000, 8, 1000), (100, 64, 16), (100, 8, 65536),
                         (10**6, 48, 1000), (10**6, 1000, 999), (1, 4, 10)):
        assert st.choose_n_chunk(n, m, target) == jst.choose_n_chunk(
            n, m, target)
    xy = torch.arange(40.0).reshape(2, 10, 2)
    fn = st.array_chunk_fn(xy, 4)
    assert torch.equal(fn(0), xy[:, :4])
    assert torch.equal(fn(2)[:, :2], xy[:, 8:])
    assert (fn(2)[:, 2:] == 0).all()


@pytest.mark.parametrize("normalise", [True, False])
def test_ni_signbatch_stream(normalise):
    xy = _data(1)
    jk, pk = _keys(1)
    eps = (1.5, 0.5)
    m, _ = batch_geometry(N, *eps)
    n_chunk = st.choose_n_chunk(N, m, N_CHUNK)
    want = _jax_stream(jst.ci_ni_signbatch_stream, jk, xy, n_chunk, *eps,
                       normalise=normalise)
    got = st.ci_ni_signbatch_stream(pk, st.array_chunk_fn(
        torch.from_numpy(xy), n_chunk), N, *eps, normalise=normalise,
        n_chunk=n_chunk)
    _agree(got, want)
    t = torch.from_numpy(xy)
    if not normalise:  # the materialized estimator centers with priv_center
        _agree(got, ci_ni_signbatch(pk, t[..., 0], t[..., 1], *eps,
                                    normalise=False))


def test_ni_subg_stream():
    xy = _data(2)
    jk, pk = _keys(2)
    want = _jax_stream(jst.correlation_ni_subg_stream, jk, xy, N_CHUNK, 1.0,
                       1.0)
    got = st.correlation_ni_subg_stream(pk, st.array_chunk_fn(
        torch.from_numpy(xy), N_CHUNK), N, 1.0, 1.0, n_chunk=N_CHUNK)
    _agree(got, want)
    t = torch.from_numpy(xy)
    _agree(got, correlation_ni_subg(pk, t[..., 0], t[..., 1], 1.0, 1.0))
    assert (got.aux["k"], got.aux["m"]) == (512, 8)


@pytest.mark.parametrize("mixquant_mode", ["det", "mc"])
def test_int_signflip_stream(mixquant_mode):
    xy = _data(3)
    jk, pk = _keys(3)
    want = _jax_stream(jst.ci_int_signflip_stream, jk, xy, N_CHUNK, 1.0,
                       0.5, mixquant_mode=mixquant_mode)
    chunk_fn = st.array_chunk_fn(torch.from_numpy(xy), N_CHUNK)
    got = st.ci_int_signflip_stream(pk, chunk_fn, N, 1.0, 0.5,
                                    mixquant_mode=mixquant_mode,
                                    n_chunk=N_CHUNK)
    _agree(got, want)
    # ε_s = 30: every flip keeps, so per-chunk flips match the
    # materialized draw; the receiver's draw shares its address
    t = torch.from_numpy(xy)
    _agree(st.ci_int_signflip_stream(pk, chunk_fn, N, 30.0, 1.0,
                                     normalise=False, n_chunk=N_CHUNK),
           ci_int_signflip(pk, t[..., 0], t[..., 1], 30.0, 1.0,
                           normalise=False))


def test_int_subg_stream():
    xy = _data(4)
    jk, pk = _keys(4)
    want = _jax_stream(jst.ci_int_subg_stream, jk, xy, N_CHUNK, 0.5, 1.5)
    chunk_fn = st.array_chunk_fn(torch.from_numpy(xy), N_CHUNK)
    got = st.ci_int_subg_stream(pk, chunk_fn, N, 0.5, 1.5, n_chunk=N_CHUNK)
    _agree(got, want)
    # ε_s = 10⁶: the sender noise is ~1e-6, so the clipped products of
    # the two paths agree to ~1e-4
    t = torch.from_numpy(xy)
    _agree(st.ci_int_subg_stream(pk, chunk_fn, N, 1e6, 1.0,
                                 n_chunk=N_CHUNK),
           ci_int_subg(pk, t[..., 0], t[..., 1], 1e6, 1.0), atol=5e-4)


@pytest.mark.parametrize("n,eps,n_chunk", [(4096, (1.0, 1.0), 1024),
                                           (5000, (2.0, 0.5), 640),
                                           (33, (1.0, 1.0), 16)])
def test_subg_pair_equals_separate_passes(n, eps, n_chunk):
    """One pass for both estimators draws what the two passes draw;
    n = 33 needs 3 chunks for INT and 2 for NI."""
    xy = torch.from_numpy(_data(5, n=n))
    _, pk = _keys(5)
    key_ni, key_int = rng.stream(pk, "ni"), rng.stream(pk, "int")
    m, _ = batch_geometry(n, *eps)
    n_chunk = st.choose_n_chunk(n, m, n_chunk)
    cf = st.array_chunk_fn(xy, n_chunk)
    ni, it = st.subg_pair_stream(key_ni, key_int, cf, n, *eps,
                                 n_chunk=n_chunk)
    for a, b in ((ni, st.correlation_ni_subg_stream(key_ni, cf, n, *eps,
                                                    n_chunk=n_chunk)),
                 (it, st.ci_int_subg_stream(key_int, cf, n, *eps,
                                            n_chunk=n_chunk))):
        for fa, fb in zip(a[:3], b[:3]):
            assert torch.equal(fa, fb)
        assert set(a.aux) == set(b.aux)
    with pytest.raises(ValueError, match="multiple of the batch size"):
        st.subg_pair_stream(key_ni, key_int, st.array_chunk_fn(xy, 100), n,
                            0.5, 0.5, n_chunk=100)  # m = 32


def test_dgp_chunks_match_jax():
    """Chunk c of the streamed sample is the DGP at ``chunk_key(key, c)``:
    bounded-factor chunks equal JAX's to an ulp."""
    jk, pk = _keys(6, 4)
    want = np.asarray(jax.vmap(lambda k: jst.dgp_chunk_fn(
        jax_bounded_factor, k, 256, jnp.float32(RHO))(3))(jk))
    got = st.dgp_chunk_fn(dgp.gen_bounded_factor, pk, 256, RHO)(3).numpy()
    assert (np.abs(got - want) <= np.spacing(np.abs(want))).all()
