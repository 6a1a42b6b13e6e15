"""The port's key-tree (dpcorr_torch.utils.rng) against jax.random.

Key words, raw bits and f32 uniforms are integer-exact transforms of
threefry2x32, so they must be bit-equal to JAX's over many (design, rep,
stream-name) addresses. Laplace draws go through log1p, whose last ulp
differs between torch and XLA: held within 2 ulp. Normals go through
torch.erfinv, not XLA's f32 polynomial: held within 2e-5 relative (the
choice recorded in dpcorr_torch/models/dgp.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcorr.ops.noise import laplace as jax_laplace
from dpcorr.utils import rng as jrng
from dpcorr_torch import interop
from dpcorr_torch.models.dgp import normal
from dpcorr_torch.models.estimators.int_sign import bernoulli
from dpcorr_torch.ops.noise import laplace
from dpcorr_torch.utils import rng

NAMES = ("dgp", "ni", "int", "ni_sign/lap_x", "ni_sign/std_y",
         "priv_standardize/mu", "int_sign/flips", "pallas/seeds")
ADDRESSES = [(seed, design, name)
             for seed in (0, 2025, 2**31 - 1)
             for design in (0, 7, 123456)
             for name in NAMES[:3]] + [(2025, 3, name) for name in NAMES]


def _jax_key(seed, design, name):
    return jrng.stream(jrng.design_key(jrng.master_key(seed), design), name)


def _port_key(seed, design, name):
    return rng.stream(rng.design_key(rng.master_key(seed), design), name)


def _words(jax_keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(jax_keys)).astype(np.int64)


@pytest.mark.parametrize("seed,design,name", ADDRESSES)
def test_key_words_bit_equal(seed, design, name):
    np.testing.assert_array_equal(_port_key(seed, design, name).numpy(),
                                  _words(_jax_key(seed, design, name)))


@pytest.mark.parametrize("start", [0, 1, 1000, 2**20 + 3])
def test_rep_keys_slice_bit_equal(start):
    jk = jrng.rep_keys_slice(jrng.master_key(), start, 33)
    pk = rng.rep_keys_slice(rng.master_key(), start, 33)
    np.testing.assert_array_equal(pk.numpy(), _words(jk))
    if start == 0:
        np.testing.assert_array_equal(
            rng.rep_keys(rng.master_key(), 33).numpy(),
            _words(jrng.rep_keys(jrng.master_key(), 33)))


@pytest.mark.parametrize("seed,design,name", ADDRESSES[::3])
@pytest.mark.parametrize("shape", [(), (1,), (5, 7), (1024, 2)])
def test_bits_and_uniform_bit_equal(seed, design, name, shape):
    jk, pk = _jax_key(seed, design, name), _port_key(seed, design, name)
    np.testing.assert_array_equal(
        rng.random_bits(pk, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape)).astype(np.int64))
    for lo, hi in ((0.0, 1.0), (-1.0 + 2.0**-24, 1.0), (-3.0, 5.5)):
        ju = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
        pu = rng.uniform(pk, shape, lo, hi).numpy()
        np.testing.assert_array_equal(pu.view(np.int32), ju.view(np.int32))


def test_batched_keys_match_per_key_draws():
    """A leading key axis draws what each key draws alone."""
    jk = jrng.rep_keys(jrng.master_key(5), 17)
    pk = rng.rep_keys(rng.master_key(5), 17)
    ju = np.stack([np.asarray(jax.random.uniform(k, (3, 4))) for k in jk])
    np.testing.assert_array_equal(rng.uniform(pk, (3, 4)).numpy(), ju)


@pytest.mark.parametrize("seed,design,name", ADDRESSES[::4])
def test_laplace_within_two_ulp(seed, design, name):
    jk, pk = _jax_key(seed, design, name), _port_key(seed, design, name)
    ja = np.asarray(jax_laplace(jk, (4096,), 0.7))
    pa = laplace(pk, (4096,), 0.7).numpy()
    ulp = np.spacing(np.abs(ja).astype(np.float32))
    assert (np.abs(pa - ja) <= 2 * ulp).all()


@pytest.mark.parametrize("p", [0.5, 0.7310585786300049, 0.95])
def test_bernoulli_decisions_equal(p):
    jk = _jax_key(2025, 1, "int_sign/flips")
    pk = _port_key(2025, 1, "int_sign/flips")
    np.testing.assert_array_equal(
        bernoulli(pk, p, (8192,)).numpy(),
        np.asarray(jax.random.bernoulli(jk, p, (8192,))))


def test_normal_within_tolerance_no_sign_flips():
    jk, pk = _jax_key(2025, 0, "dgp"), _port_key(2025, 0, "dgp")
    jz = np.asarray(jax.random.normal(jk, (1 << 16, 2), jnp.float32))
    pz = normal(pk, (1 << 16, 2)).numpy()
    assert (np.sign(jz) == np.sign(pz)).all()
    np.testing.assert_allclose(pz, jz, rtol=2e-5, atol=1e-6)


def test_interop_round_trip():
    jk = jrng.rep_keys(jrng.master_key(9), 6)
    words = np.asarray(jax.random.key_data(jk))
    pk = interop.keys_from_jax_data(words)
    np.testing.assert_array_equal(pk.numpy(), words.astype(np.int64))
    back = interop.keys_to_jax_data(pk)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, words)
    # the carried keys draw JAX's noise
    jz = np.stack([np.asarray(jax.random.uniform(jrng.stream(k, "ni"), (8,)))
                   for k in jax.random.wrap_key_data(back)])
    np.testing.assert_array_equal(rng.uniform(rng.stream(pk, "ni"),
                                              (8,)).numpy(), jz)


def test_kernel_seeds_are_two_int32_words_per_rep():
    keys = rng.rep_keys(rng.master_key(), 4096)
    s = rng.kernel_seeds(keys)
    assert s.dtype == torch.int32 and tuple(s.shape) == (4096, 2)
    assert (s < 0).any() and (s > 0).any()  # full 32-bit words
    assert len({tuple(r) for r in s.tolist()}) == 4096
