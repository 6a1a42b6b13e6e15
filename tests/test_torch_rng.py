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


@pytest.mark.parametrize("start", [0, 5])
def test_rep_keys_of_a_key_batch_bit_equal(start):
    """The grid's bucket keys: each design key's replication stream from
    one call over the batch of design keys, as JAX gives it key by key."""
    idx = [3, 0, 41, 7]
    design = rng.design_key(rng.master_key(9), torch.tensor(idx))
    got = rng.rep_keys_slice(design, start, 6)
    assert got.shape == (4, 6, 2)
    for j, i in enumerate(idx):
        want = jrng.rep_keys_slice(jrng.design_key(jrng.master_key(9), i),
                                   start, 6)
        np.testing.assert_array_equal(got[j].numpy(), _words(want))


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


#: spans of randint/choice: the multiplier (2¹⁶ mod s)² wraps 32 bits from
#: s = 65,537 on, and the offset sum wraps from s = 65,536 on
SPANS = [1, 7, 19_433, 65_537, 2**31 - 1]


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("seed,design,name", ADDRESSES[::5])
def test_randint_and_choice_bit_equal(span, seed, design, name):
    jk, pk = _jax_key(seed, design, name), _port_key(seed, design, name)
    want = np.asarray(jax.random.randint(jk, (4096,), 0, span))
    np.testing.assert_array_equal(rng.randint(pk, (4096,), 0, span).numpy(),
                                  want)
    np.testing.assert_array_equal(
        rng.choice(pk, span, (4096,)).numpy(),
        np.asarray(jax.random.choice(jk, span, (4096,), replace=True)))


@pytest.mark.parametrize("lo,hi", [(-5, 10), (3, 3), (10, 2),
                                   (-2**31, 2**31 - 1), (-7, 2**31 - 1)])
def test_randint_bounds_bit_equal(lo, hi):
    """Negative bounds, an empty range (minval is returned) and the full
    int32 range, whose result wraps in int32 as JAX's add does."""
    jk, pk = _jax_key(2025, 2, "dgp"), _port_key(2025, 2, "dgp")
    np.testing.assert_array_equal(
        rng.randint(pk, (64, 3), lo, hi).numpy(),
        np.asarray(jax.random.randint(jk, (64, 3), lo, hi)))


def test_choice_over_a_key_batch_bit_equal():
    """The bootstrap's draw: one resample of n rows per replication key,
    as ``jax.vmap`` of ``jax.random.choice`` gives it."""
    jk = jrng.rep_keys(jrng.master_key(4), 6)
    pk = rng.rep_keys(rng.master_key(4), 6)
    want = jax.vmap(lambda k: jax.random.choice(
        jrng.stream(k, "hrs/boot/idx"), 19_433, (19_433,)))(jk)
    got = rng.choice(rng.stream(pk, "hrs/boot/idx"), 19_433, (19_433,))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="n > 0"):
        rng.choice(pk, 0, (3,))
    with pytest.raises(ValueError, match="int32"):
        rng.randint(pk, (3,), 0, 2**31)


@pytest.mark.parametrize("data", [2**32 + 5, -1, 2**40])
def test_fold_in_raises_for_ints_outside_uint32_as_jax(data):
    """A Python int outside [0, 2³²) is refused by both packages (the
    port used to mask it, so 2³² + 5 folded in as 5)."""
    with pytest.raises(OverflowError, match="out of bounds for uint32"):
        jax.random.fold_in(jrng.master_key(7), data)
    with pytest.raises(OverflowError, match="out of bounds for uint32"):
        rng.fold_in(rng.master_key(7), data)
    with pytest.raises(OverflowError, match="out of bounds for uint32"):
        rng.fold_in_words((0, 7), data)


@pytest.mark.parametrize("data", [0, 5, 2**31, 2**32 - 1])
def test_fold_in_edges_of_uint32_bit_equal(data):
    want = _words(jax.random.fold_in(jrng.master_key(7), data))
    np.testing.assert_array_equal(rng.fold_in(rng.master_key(7), data).numpy(),
                                  want)
    assert rng.fold_in_words((0, 7), data) == tuple(int(w) for w in want)


def test_fold_in_integer_tensors_keep_their_mask():
    """Integer tensors are masked to their low 32 bits, as JAX wraps an
    integer array: index 2³² + 5 in a tensor folds in as 5."""
    key = rng.master_key(7)
    wide = rng.fold_in(key, torch.tensor([2**32 + 5, -1], dtype=torch.int64))
    want = _words(jax.random.fold_in(jrng.master_key(7),
                                     np.array([5, 2**32 - 1], np.uint32)[0]))
    np.testing.assert_array_equal(wide[0].numpy(), want)
    np.testing.assert_array_equal(
        wide[1].numpy(), rng.fold_in(key, 2**32 - 1).numpy())


#: host scalars JAX casts to uint32 (masked to the low 32 bits; a float
#: truncated): numpy integer scalars of every width and sign, one past
#: 2³², numpy floats (a subclass of ``float`` for float64, masked all the
#: same), and a Python float
HOST_SCALARS = [np.int64(3), np.int64(-1), np.int32(-5), np.uint32(7),
                np.int64(2**32 + 5), np.uint64(2**40), 3.0,
                np.float64(3.0), np.float64(-1.0), np.float64(2**32 + 5),
                np.float32(3.7), np.float64(-3.7)]


@pytest.mark.parametrize("data", HOST_SCALARS, ids=repr)
def test_fold_in_numpy_scalars_masked_as_jax(data):
    """A numpy scalar folds in as JAX folds it: its low 32 bits, so
    np.int64(-1) is 2³² − 1 and np.int64(2³² + 5) is 5; a float is
    truncated. The same through ``design_key``, ``chunk_key`` and
    ``fold_in_words``."""
    want = _words(jax.random.fold_in(jrng.master_key(7), data))
    key = rng.master_key(7)
    for got in (rng.fold_in(key, data), rng.design_key(key, data),
                rng.chunk_key(key, data)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert rng.fold_in_words((0, 7), data) == tuple(int(w) for w in want)
    np.testing.assert_array_equal(
        rng.design_key(key, data).numpy(),
        _words(jrng.design_key(jrng.master_key(7), data)))


def test_design_key_of_a_design_column_element():
    """An element of a design table's index column (a numpy int64) keys
    its point as the JAX package's design_key does."""
    from dpcorr_torch.grid import GridConfig

    design = GridConfig(n_grid=(1000,), eps_pairs=((1.0, 1.0),),
                        b=2).design_points()
    i = design["i"][1]
    assert isinstance(i, np.integer)
    np.testing.assert_array_equal(
        rng.design_key(rng.master_key(), i).numpy(),
        _words(jrng.design_key(jrng.master_key(), i)))
    with pytest.raises(OverflowError, match="out of bounds for uint32"):
        rng.fold_in(rng.master_key(7), -1)


@pytest.mark.parametrize("data", [-1, 2**32, -1.0, 2.0**32 + 5],
                         ids=repr)
def test_fold_in_python_scalars_out_of_range_raise_as_jax(data):
    """A Python int or float outside [0, 2³²) is not masked: JAX and the
    port both raise ``OverflowError``, through ``fold_in_words`` too."""
    with pytest.raises(OverflowError, match="out of bounds for uint32"):
        jax.random.fold_in(jrng.master_key(7), data)
    with pytest.raises(OverflowError, match="out of bounds for uint32"):
        rng.fold_in(rng.master_key(7), data)
    with pytest.raises(OverflowError, match="out of bounds for uint32"):
        rng.fold_in_words((0, 7), data)


# ------------------------------------------------ the threefry op itself ----

#: Random123's known answers for threefry2x32-20, the vectors JAX's own
#: test holds: (key, counter) → (y0, y1)
THREEFRY_KAT = [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
]


@pytest.mark.parametrize("key,ctr,want", THREEFRY_KAT)
def test_threefry_known_answers_through_the_plain_path(key, ctr, want):
    """The plain rounds on host ints, and the op's CPU path on tensors
    (its hash and, at counter (0, i), its bits), give Random123's
    answers."""
    from dpcorr_torch.ops import threefry

    assert threefry.threefry_words(*key, *ctr) == want
    t = [torch.tensor(v, dtype=torch.int64) for v in (*key, *ctr)]
    assert threefry.threefry_hash(*t).tolist() == list(want)
    assert rng.threefry2x32(torch.tensor(key), t[2], t[3]) == want
    if ctr[0] == 0:  # word i of bits is y0 ^ y1 at counter (0, i)
        bits = threefry.threefry_bits(torch.tensor([key]), ctr[1] + 1)
        assert int(bits[0, -1]) == want[0] ^ want[1]


def _i64(*shape):
    return torch.zeros(shape, dtype=torch.int64)


@pytest.mark.parametrize("call,err,match", [
    (lambda t: t.threefry_bits(_i64(3, 2).int(), 4), TypeError, "int64"),
    (lambda t: t.threefry_bits(_i64(3, 4), 4), ValueError, r"\(K, 2\)"),
    (lambda t: t.threefry_bits(_i64(2), 4), ValueError, r"\(K, 2\)"),
    (lambda t: t.threefry_bits(_i64(3, 2), -1), ValueError, ">= 0"),
    (lambda t: t.threefry_bits(_i64(3, 2).to("meta"), 4), ValueError,
     "cuda or cpu"),
    (lambda t: t.threefry_hash(_i64(3).int(), _i64(3), 0, 1), TypeError,
     "int64"),
    (lambda t: t.threefry_hash(_i64(3), _i64(3), 0.5, 1), TypeError,
     "float"),
    (lambda t: t.threefry_hash(1, 2, 3, 4), TypeError, "one tensor"),
    (lambda t: t.threefry_hash(_i64(3), _i64(4), 0, 1), ValueError,
     "broadcast"),
    (lambda t: t.threefry_hash(_i64(3), _i64(3).to("meta"), 0, 1),
     ValueError, "different devices"),
    (lambda t: t.threefry_hash(_i64(3).to("meta"), 0, 0, 1), ValueError,
     "cuda or cpu"),
    (lambda t: t.threefry_uniform(_i64(3, 2).int(), 4), TypeError, "int64"),
    (lambda t: t.threefry_uniform(_i64(3, 4), 4), ValueError, r"\(K, 2\)"),
    (lambda t: t.threefry_uniform(_i64(2), 4), ValueError, r"\(K, 2\)"),
    (lambda t: t.threefry_uniform(_i64(3, 2), -1), ValueError, ">= 0"),
    (lambda t: t.threefry_uniform(_i64(3, 2).to("meta"), 4), ValueError,
     "cuda or cpu"),
], ids=["bits-dtype", "bits-words", "bits-rank", "bits-negative",
        "bits-device", "hash-dtype", "hash-float", "hash-no-tensor",
        "hash-broadcast", "hash-devices", "hash-device", "uniform-dtype",
        "uniform-words", "uniform-rank", "uniform-negative",
        "uniform-device"])
def test_threefry_wrapper_refuses_what_the_kernel_does_not_take(call, err,
                                                                match):
    from dpcorr_torch.ops import threefry

    with pytest.raises(err, match=match):
        call(threefry)


def test_threefry_on_the_cpu_launches_nothing_and_loads_no_library(
        monkeypatch):
    """The key-tree on CPU tensors runs the plain version: no launch is
    counted and the kernel's library is never built or loaded, whatever
    loaded it earlier in the process."""
    from dpcorr_torch.ops import threefry

    def no_library():
        raise AssertionError("the CPU path asked for the kernel's library")

    monkeypatch.setattr(threefry, "_library", no_library)
    before = dict(threefry.KERNEL_LAUNCHES)
    calls = dict(rng.UNIFORM_CALLS)
    keys = rng.rep_keys(rng.master_key(3), 5)
    rng.random_bits(keys, (7,))
    rng.uniform(rng.stream(keys, "dgp"), (4,))
    rng.permutation(keys[0], 9)
    rng.kernel_seeds(keys)
    threefry.threefry_uniform(keys, 6, -1.0, 1.0)
    assert threefry.KERNEL_LAUNCHES == before
    assert rng.UNIFORM_CALLS == {"kernel": calls["kernel"],
                                 "ops": calls["ops"] + 1}


def _old_uniform_map(bits, minval, maxval):
    """The key-tree's map of words to f32 uniforms as it was written
    before the kernel took it: mantissa bits under exponent 0, the
    product exact in f64, the sum rounded to f32, then the clamp."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = fbits.view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    span = float(np.float32(hi - lo))
    u = (f.to(torch.float64) * span + float(lo)).to(torch.float32)
    return torch.clamp_min(u, float(lo))


#: the (minval, maxval) pairs the port draws with: ``uniform``'s default,
#: the sign families' (−1, 1), and ``normal``'s and ``laplace``'s
#: (nextafter(−1, 0), 1)
UNIFORM_BOUNDS = [(0.0, 1.0), (-1.0, 1.0),
                  (float(np.nextafter(np.float32(-1), np.float32(0))), 1.0)]


@pytest.mark.parametrize("bounds", UNIFORM_BOUNDS, ids=str)
@pytest.mark.parametrize("n_keys,n_words", [(1, 1), (7, 129), (3, 1029),
                                            (40, 13), (5, 0), (0, 9)])
def test_threefry_uniform_plain_is_the_old_map_bit_for_bit(bounds, n_keys,
                                                           n_words):
    """The uniform entry's plain twin draws the bits and maps them exactly
    as the key-tree did before the kernel took the map, on words with
    the top bit set and at rows that do not divide a thread's words."""
    from dpcorr_torch.ops import threefry

    g = torch.Generator().manual_seed(n_keys * 1000 + n_words)
    keys = torch.randint(0, 2**32, (n_keys, 2), generator=g)
    if n_keys:
        keys[0] = torch.tensor([0xFFFFFFFF, 0x80000000])
    got = threefry.threefry_uniform_plain(keys, n_words, *bounds)
    want = _old_uniform_map(threefry.threefry_bits_plain(keys, n_words),
                            *bounds)
    assert got.dtype == torch.float32 and got.shape == (n_keys, n_words)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(threefry.threefry_uniform(keys, n_words, *bounds),
                       got)


def test_uniform_calls_count_the_ops_path_for_rbg_keys(monkeypatch):
    """A four-word key's uniforms are mapped by torch ops, on any device:
    :data:`rng.UNIFORM_CALLS` counts them under "ops", and the threefry
    uniform entry is not asked for them."""
    from dpcorr_torch.ops import threefry

    monkeypatch.setenv("DPCORR_PRNG", "rbg")
    key = rng.stream(rng.master_key(4), "dgp")
    assert key.shape == (4,)

    def no_entry(*args, **kwargs):
        raise AssertionError("an rbg key reached threefry_uniform")

    monkeypatch.setattr(rng, "threefry_uniform", no_entry)
    calls = dict(rng.UNIFORM_CALLS)
    u = rng.uniform(key, (3, 5), -1.0, 1.0)
    assert u.shape == (3, 5) and u.dtype == torch.float32
    assert torch.equal(u, threefry.uniform_from_bits(
        rng.random_bits(key, (3, 5)), -1.0, 1.0))
    assert rng.UNIFORM_CALLS == {"kernel": calls["kernel"],
                                 "ops": calls["ops"] + 1}


#: operand shapes as the key-tree hands them to the hash: fold_in of one
#: key over indices, of a key batch by a host scalar, a batch of keys'
#: rep streams, split of a batch, rbg's halves, a 0-d call
HASH_SHAPES = [
    ((), (), (), (1024,)),
    ((64,), (64,), (), ()),
    ((5, 1), (5, 1), (), (33,)),
    ((3, 4, 1), (3, 4, 1), (), (2,)),
    ((6, 2), (6, 2), (), (6, 1)),
    ((), (), (), ()),
    ((2, 1, 3, 1), (2, 1, 3, 1), (1, 4, 1, 1), (5,)),
]


@pytest.mark.parametrize("shapes", HASH_SHAPES, ids=str)
def test_threefry_hash_axes_address_the_broadcast(shapes):
    """The kernel's view of each operand, the merged axes with their
    strides over its storage, holds the element the broadcast puts
    there, for the strided key words of a ``(..., 2)`` key."""
    from dpcorr_torch.ops import threefry

    g = torch.Generator().manual_seed(5)
    keys = torch.randint(0, 2**32, (*shapes[0], 2), generator=g)
    ops = [keys[..., 0], keys[..., 1]] + [
        torch.randint(0, 2**32, s, generator=g) for s in shapes[2:]]
    shape = torch.broadcast_shapes(*(o.shape for o in ops))
    views = [o.expand(shape) for o in ops]
    axes = threefry._merged_axes(views, shape)
    assert len(axes) <= threefry._MAX_DIMS
    sizes = [s for s, _ in axes]
    for o, v in enumerate(views):
        got = torch.as_strided(v, sizes, [st[o] for _, st in axes],
                               v.storage_offset())
        assert torch.equal(got, v.reshape(sizes))
