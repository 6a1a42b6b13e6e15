"""Deterministic RNG key-tree: JAX's key-tree, bit for bit, on any of the
three PRNG implementations the JAX package reaches.

Counterpart of ``dpcorr/utils/rng.py``. The tree is the same

    master(seed) → design point (fold_in i) → replication (fold_in b)
                 → named substream (fold_in crc32(name) & 0x7FFFFFFF)

and every key word, raw bit and f32 uniform equals what ``jax.random``
gives under jax 0.9 with ``jax_threefry_partitionable=True`` (the
default there), so the port and the JAX package can be handed the same
keys (``dpcorr_torch.interop``) and draw the same noise. The
``jax.random`` samplers the estimators draw from are here too: ``split``,
``bernoulli``, ``permutation``, ``randint`` and ``choice`` bit for bit,
``exponential`` and ``normal`` within the stated tolerances.

Implementations (``master_key(impl=...)``; the process default is the
``DPCORR_PRNG`` environment variable, read at call time as JAX reads it):

- ``threefry2x32`` (the default, the bit-reproducibility contract): a key
  is two words; ``fold_in`` and ``split`` are threefry, and so are the
  bits.
- ``rbg``: a key is four words, two threefry keys side by side
  (``[0, s, 0, s]`` at the root); ``fold_in`` and ``split`` apply threefry
  to each half, both halves in one batched call; the bits are XLA's
  Philox generator (``lax.rng_bit_generator``), drawn by the kernel in
  ``dpcorr_torch.ops.rbg`` on the card.
- ``unsafe_rbg``: four words as well; ``fold_in(key, d)`` is the key xor
  block 9 of the Philox draw keyed by ``[0, d, 0, d]``, ``split`` takes
  every tenth block of the key's own draw, both through the same kernel.

A four-word key does not say whether it is ``rbg`` or ``unsafe_rbg``, so
the impl is never guessed from the words: four-word keys are read as
``unsafe_rbg`` when the process impl is ``unsafe_rbg`` and as ``rbg``
otherwise, and ``master_key(impl=...)`` / ``keys_from_data(impl=...)``
raise ``ValueError`` when they name the other one.

Host words. The serving layer and the stream fold short key chains on
the host in Python ints (:func:`fold_in_words`), two or four words,
bit-equal to :func:`fold_in` on the same words and read under the same
rule: rbg is threefry on each half, unsafe_rbg goes through a host
Philox (:func:`_philox_words`), the third implementation of the
generator beside the kernel and its plain version.

Per-key draws. A batch of keys ``(..., 4)`` draws each key's own stream:
row i equals ``jax.random.bits(keys[i], shape)`` called on that key alone.
JAX's batching rule for ``rng_bit_generator``
(``_rng_bit_generator_batching_rule`` in
jax/_src/lax/control_flow/loops.py) instead draws a vmapped batch from
its *first* key, so in the JAX package an rbg replication's bits depend
on its position in its vmap chunk. The port does not copy that rule: a
replication's bits depend on its key alone, the chunk width changes no
result, and the grid's stamp stays true. Results on rbg keys are
therefore statistically, not bitwise, comparable to the JAX package's
vmapped pipeline; they are bit-equal to its unbatched draws.

Ranges: every public function that derives keys or draws runs inside a
``keytree`` range while ``torch.profiler`` records (or inside
``utils.profiling.stage_host_seconds``), opened only by the outermost
such call on the thread, so a draw that derives keys, or a batch of rbg
keys drawn key by key, is one range. Otherwise a call pays one check.

Representation: a key is an int64 tensor whose last axis holds the
uint32 words, shape ``(..., 2)`` or ``(..., 4)``. torch's uint32 coverage
is thin, so the words live in int64. Threefry runs in
``dpcorr_torch.ops.threefry``: on the card its rounds run in registers in
one launch (``csrc/threefry.cu``: a batch of folds, or a batch of keys'
bits or f32 uniforms), on the CPU as int64 torch ops with every add and
shift masked back to 32 bits. Every function is vectorised over the
leading key axes, so a whole replication block's keys are derived on the
device that holds them.
"""

from __future__ import annotations

import os
import zlib

import numpy as np
import torch

from dpcorr_torch.ops.threefry import (
    threefry_bits,
    threefry_hash,
    threefry_uniform,
    threefry_words,
    uniform_from_bits,
)
from dpcorr_torch.utils.profiling import outermost

# Same master seed as the reference (vert-cor.R:16).
MASTER_SEED: int = 2025
#: the range each public derivation and draw opens while the profiler
#: records (``utils.profiling.outermost``: one range for the outermost
#: call on the thread, none for the calls it makes)
KEYTREE = "keytree"

_M32 = 0xFFFFFFFF

#: :func:`uniform` calls by path: ``"kernel"``, a threefry2x32 key on the
#: card (one ``threefry_uniform`` launch); ``"ops"``, an rbg-family key
#: or a CPU tensor (the words mapped by torch ops)
UNIFORM_CALLS = {"kernel": 0, "ops": 0}

#: the PRNG implementations of the key-tree, by JAX's names, and the
#: words of one key under each
IMPLS = {"threefry2x32": 2, "rbg": 4, "unsafe_rbg": 4}
DEFAULT_IMPL = "threefry2x32"


def _valid_impl(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown PRNG impl {impl!r}; one of "
                         f"{', '.join(IMPLS)}")
    return impl


def process_impl() -> str:
    """The process-default PRNG impl: ``DPCORR_PRNG`` when set and not
    empty, else ``threefry2x32``. Read at each call; an unknown name
    raises ``ValueError``."""
    return _valid_impl(os.environ.get("DPCORR_PRNG") or DEFAULT_IMPL)


def impl_tag() -> str:
    """The port's PRNG tag, for result-cache stamps: ``<impl>-torch`` for
    the process impl (``"threefry2x32-torch"`` by default). The key-tree
    is JAX's bit for bit, but the estimators on top agree with the JAX
    package's only to f32 rounding (and rbg-family batches draw per key,
    see the module docstring), so the tag differs from
    ``dpcorr.utils.rng.impl_tag()``'s and the two packages' caches never
    mix; nor do two impls' caches."""
    return f"{process_impl()}-torch"


def _four_word_impl() -> str:
    """The impl four-word keys are read as (module docstring)."""
    return "unsafe_rbg" if process_impl() == "unsafe_rbg" else "rbg"


def resolve_impl(impl: str | None = None) -> str:
    """``impl`` (None: the process impl) validated, and refused with
    ``ValueError`` when it is the rbg-family impl that four-word keys
    would not be read back as in this process."""
    impl = _valid_impl(process_impl() if impl is None else impl)
    if IMPLS[impl] == 4 and impl != _four_word_impl():
        raise ValueError(
            f"four-word keys are read as {_four_word_impl()!r} in this "
            f"process (DPCORR_PRNG={os.environ.get('DPCORR_PRNG')!r}); "
            f"set DPCORR_PRNG={impl} to use {impl!r} keys")
    return impl


@outermost(KEYTREE)
def threefry2x32(key: torch.Tensor, x0, x1) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds), as ``jax.random``
    evaluates it (``ops.threefry.threefry_hash``: the kernel on the card,
    its plain version on the CPU). ``key`` is ``(..., 2)`` int64;
    ``x0``/``x1``, int64 tensors or ints, broadcast against
    ``key[..., 0]``. Returns the two output words."""
    y = threefry_hash(key[..., 0], key[..., 1], x0, x1)
    return y[..., 0], y[..., 1]


def _as_key(key) -> torch.Tensor:
    key = torch.as_tensor(key)
    if key.shape[-1:] not in ((2,), (4,)):
        raise ValueError(f"a key has 2 (threefry2x32) or 4 (rbg, "
                         f"unsafe_rbg) words on its last axis, got shape "
                         f"{tuple(key.shape)}")
    return key.to(torch.int64) & _M32


@outermost(KEYTREE)
def master_key(seed: int = MASTER_SEED, device=None, *,
               impl: str | None = None) -> torch.Tensor:
    """Root of the key-tree, ``jax.random.key(seed, impl=impl)``'s words
    as the JAX package runs it (64-bit types off): for threefry2x32 high
    word 0, low word the seed's low 32 bits (a seed outside [0, 2³²)
    wraps as JAX wraps it); for rbg and unsafe_rbg that pair twice.
    ``impl`` None is the process impl (``DPCORR_PRNG``, read now); an
    unknown name, or the rbg-family impl four-word keys would not be read
    back as, raises ``ValueError``. ``device`` stays the second argument,
    where the port's callers have always passed it."""
    impl = resolve_impl(impl)
    s = int(seed) & _M32
    return torch.tensor([0, s] * (IMPLS[impl] // 2), dtype=torch.int64,
                        device=device)


def _check_u32(data: int) -> int:
    """A Python int as ``jax.random.fold_in`` takes it: in [0, 2³²), or
    ``OverflowError`` with JAX's message (it does not wrap)."""
    if not 0 <= data <= _M32:
        raise OverflowError(
            f"Python integer {data} out of bounds for uint32")
    return data


def _host_data(data) -> int:
    """A host scalar as ``jax.random.fold_in`` casts it to uint32: a
    numpy integer or float scalar, or a 0-d array, is truncated and
    masked to its low 32 bits; a Python int (or float, truncated) must
    lie in [0, 2³²) and raises ``OverflowError`` otherwise. numpy comes
    first: ``np.float64`` is a subclass of ``float``."""
    if isinstance(data, (int, float)) and not isinstance(data, np.generic):
        return _check_u32(int(data))
    return int(np.asarray(data).astype(np.int64)) & _M32


def _rbg_bits(keys: torch.Tensor, n_words: int, offset: int = 0,
              stride: int = 1) -> torch.Tensor:
    """XLA's Philox words of four-word keys ``(..., 4)``, each key's own
    stream (``dpcorr_torch.ops.rbg``: the kernel on the card, its plain
    version on the CPU): shape ``keys.shape[:-1] + (n_words,)``."""
    from dpcorr_torch.ops.rbg import rbg_bits

    flat = keys.reshape(-1, 4).contiguous()
    return rbg_bits(flat, n_words, offset, stride).reshape(
        tuple(keys.shape[:-1]) + (int(n_words),))


@outermost(KEYTREE)
def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``. threefry2x32: threefry(key, (0, data));
    rbg: that on each two-word half, both halves in one call; unsafe_rbg:
    the key xor block 9 of the Philox draw keyed by ``[0, d, 0, d]``.
    ``data`` is a host scalar (:func:`_host_data`) or an integer tensor
    that broadcasts against the key's leading axes; the result has the
    broadcast leading shape. A Python int outside [0, 2³²) raises
    ``OverflowError`` as JAX does; a numpy scalar and an integer tensor
    are masked to their low 32 bits."""
    key = _as_key(key)
    if isinstance(data, torch.Tensor):  # threefry reads its low 32 bits
        data = data.to(key.device, torch.int64)
    else:  # a constant of the launch: no copy
        data = _host_data(data)
    if key.shape[-1] == 2:
        return threefry_hash(key[..., 0], key[..., 1], 0, data)
    if _four_word_impl() == "rbg":
        halves = key.unflatten(-1, (2, 2))
        d = data[..., None] if isinstance(data, torch.Tensor) else data
        return threefry_hash(halves[..., 0], halves[..., 1], 0,
                             d).flatten(-2)
    if not isinstance(data, torch.Tensor):  # made on the device: no copy
        data = torch.full((), data, dtype=torch.int64, device=key.device)
    data = data & _M32
    zero = torch.zeros_like(data)
    seeds = torch.stack([zero, data, zero, data], dim=-1)
    return key ^ _rbg_bits(seeds, 4, offset=9)


def _philox_words(key4, n_blocks: int, offset: int = 0) -> tuple[int, ...]:
    """Blocks ``offset`` … ``offset + n_blocks − 1`` of XLA's Philox draw
    for the four-word key ``key4`` held as host ints: Philox4x32-10 keyed
    by (w0, w1) on the 128-bit counter (w2, w3, w0, w1) plus the block
    number, the carry taken through all four words (``ops.rbg``'s
    layout). The host twin of ``ops.rbg.rbg_bits`` for the few blocks a
    key chain needs; returns ``4 · n_blocks`` words."""
    from dpcorr_torch.ops.fused_ni import _PHILOX_M, _PHILOX_W

    w0, w1, w2, w3 = (int(v) & _M32 for v in key4)
    start = w2 | w3 << 32 | w0 << 64 | w1 << 96
    out: list[int] = []
    for b in range(int(n_blocks)):
        ctr = (start + int(offset) + b) & ((1 << 128) - 1)
        c = [(ctr >> (32 * i)) & _M32 for i in range(4)]
        k0, k1 = w0, w1
        for _ in range(10):
            p0, p1 = _PHILOX_M[0] * c[0], _PHILOX_M[1] * c[2]
            c = [(p1 >> 32) ^ c[1] ^ k0, p1 & _M32,
                 (p0 >> 32) ^ c[3] ^ k1, p0 & _M32]
            k0 = (k0 + _PHILOX_W[0]) & _M32
            k1 = (k1 + _PHILOX_W[1]) & _M32
        out += c
    return tuple(out)


@outermost(KEYTREE)
def fold_in_words(words: tuple[int, ...], data) -> tuple[int, ...]:
    """:func:`fold_in` on a key held as two or four host ints, for key
    chains short enough that device launches would cost more than the
    arithmetic (the serving layer's per-request keys, the stream's
    window and chunk keys). Bit-equal to :func:`fold_in` on the same
    words, and takes ``data`` as it does (:func:`_host_data`). Four words
    are read as :func:`fold_in` reads them (the process impl, never the
    words): rbg is threefry on each half, unsafe_rbg the key xor block 9
    of the Philox draw keyed by ``[0, d, 0, d]`` (:func:`_philox_words`).
    Any other number of words raises ``ValueError``."""
    w = tuple(int(v) & _M32 for v in words)
    d = _host_data(data)
    if len(w) == 2:
        return threefry_words(w[0], w[1], 0, d)
    if len(w) != 4:
        raise ValueError(f"fold_in_words takes a key of 2 (threefry2x32) "
                         f"or 4 (rbg, unsafe_rbg) words, got {len(w)}")
    if _four_word_impl() == "rbg":
        return (threefry_words(w[0], w[1], 0, d)
                + threefry_words(w[2], w[3], 0, d))
    return tuple(a ^ b for a, b in zip(w, _philox_words((0, d, 0, d), 1, 9)))


@outermost(KEYTREE)
def design_key(key: torch.Tensor, design_index) -> torch.Tensor:
    """Key for one design point (vert-cor.R:531's per-task seed)."""
    return fold_in(key, design_index)


@outermost(KEYTREE)
def rep_keys_slice(key: torch.Tensor, start, n_reps: int) -> torch.Tensor:
    """Keys ``[start, start + n_reps)`` of the :func:`rep_keys` stream,
    shape ``key.shape[:-1] + (n_reps, words)``, made on the key's device:
    a batch of keys ``(P, words)`` gives each one's stream in one call."""
    idx = torch.arange(int(start), int(start) + int(n_reps),
                       device=key.device)
    return fold_in(_as_key(key)[..., None, :], idx)


@outermost(KEYTREE)
def rep_keys(key: torch.Tensor, n_reps: int) -> torch.Tensor:
    """Per-replication keys, shape ``(n_reps, words)`` for one key
    (vert-cor.R:364, 392); ``(P, n_reps, words)`` for P keys. Under
    unsafe_rbg each is ``fold_in(key, b)`` on its own, not what JAX's
    ``vmap`` of ``fold_in`` gives there (module docstring)."""
    return rep_keys_slice(key, 0, n_reps)


def stream_index(name: str) -> int:
    """The fold-in index of a named substream: crc32 of the name, top bit
    cleared (as ``dpcorr.utils.rng.stream`` computes it)."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


@outermost(KEYTREE)
def stream(key: torch.Tensor, name: str) -> torch.Tensor:
    """Named substream: stable across code movement, unlike split order."""
    return fold_in(key, stream_index(name))


@outermost(KEYTREE)
def party_root(key: torch.Tensor, role: str,
               mode: str = "replay") -> torch.Tensor:
    """Root key for one protocol party (:mod:`dpcorr_torch.protocol`).

    ``"replay"`` hands the party the session key unchanged, so every named
    stream it draws keeps its monolithic address and a two-party run is
    bit-equal to the single-process estimator on the same master seed.
    ``"hardened"`` roots the party in its own disjoint named subtree
    (``"protocol/x"`` / ``"protocol/y"``): draws of the same distribution
    that the peer cannot reconstruct when each party's seed is secret."""
    if role not in ("x", "y"):
        raise ValueError(f"role must be 'x' or 'y', got {role!r}")
    if mode == "replay":
        return key
    if mode == "hardened":
        return stream(key, f"protocol/{role}")
    raise ValueError(f"unknown noise mode {mode!r}; "
                     "expected 'replay' or 'hardened'")


@outermost(KEYTREE)
def column_root(key: torch.Tensor, label: str) -> torch.Tensor:
    """Root key for one federated column (:mod:`dpcorr_torch.protocol.
    matrix`): the named subtree ``"protocol/col/<label>"``, so a column's
    release depends on (label, column) alone, the same bytes in every pair
    that reuses it, and noise across distinct columns is independent.
    :func:`party_root` applies below it."""
    if not label:
        raise ValueError("column label must be non-empty")
    return stream(key, f"protocol/col/{label}")


def key_data(keys: torch.Tensor) -> torch.Tensor:
    """Keys → raw words. A port key already is its words, so this is the
    identity; it mirrors the JAX package's export-boundary encoding
    (``jax.random.key_data``), four-word keys included."""
    return _as_key(keys)


def keys_from_data(data, impl: str | None = None) -> torch.Tensor:
    """Raw words (any integer tensor or array with a last axis of 2 or 4)
    → keys; the inverse of :func:`key_data`, counterpart of
    ``dpcorr.utils.rng.keys_from_data``. ``impl``, when given, must have
    the data's number of words and be an impl such words are read back
    as (``ValueError`` otherwise): the words themselves carry no impl."""
    if isinstance(data, np.ndarray):
        data = torch.from_numpy(data.astype(np.int64))
    key = _as_key(data)
    if impl is not None:
        want = IMPLS[resolve_impl(impl)]
        if key.shape[-1] != want:
            raise ValueError(f"{impl!r} keys have {want} words, got data "
                             f"of shape {tuple(key.shape)}")
    return key


@outermost(KEYTREE)
def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` on each key alone. A
    threefry2x32 key uses the partitionable counter layout: element i of
    the row-major flattened shape is y0 ^ y1 of threefry(key, (i >> 32,
    i & 0xFFFFFFFF)) (``ops.threefry.threefry_bits``). An rbg-family key
    draws XLA's Philox words (module docstring). Either way all the keys
    draw in one kernel launch on the card. Output
    shape is ``key.shape[:-1] + shape``, values in [0, 2³²) held in
    int64."""
    key = _as_key(key)
    shape = tuple(int(s) for s in shape)
    size = int(np.prod(shape, dtype=np.int64))
    if key.shape[-1] == 4:
        return _rbg_bits(key, size).reshape(tuple(key.shape[:-1]) + shape)
    return threefry_bits(key.reshape(-1, 2), size).reshape(
        tuple(key.shape[:-1]) + shape)


@outermost(KEYTREE)
def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32: ``max(min, f·(max−min)+min)`` with
    f from the top 23 bits, min and max rounded to f32 first
    (``ops.threefry.uniform_from_bits``). A threefry2x32 key draws and
    maps its words in one launch on the card
    (``ops.threefry.threefry_uniform``); an rbg-family key maps
    :func:`random_bits` with torch ops. :data:`UNIFORM_CALLS` counts the
    calls by path."""
    key = _as_key(key)
    shape = tuple(int(s) for s in shape)
    if key.shape[-1] == 4:
        UNIFORM_CALLS["ops"] += 1
        return uniform_from_bits(random_bits(key, shape), minval, maxval)
    UNIFORM_CALLS["kernel" if key.device.type == "cuda" else "ops"] += 1
    size = int(np.prod(shape, dtype=np.int64))
    return threefry_uniform(key.reshape(-1, 2), size, minval,
                            maxval).reshape(tuple(key.shape[:-1]) + shape)


@outermost(KEYTREE)
def chunk_key(key: torch.Tensor, chunk_index) -> torch.Tensor:
    """Key for one streaming n-chunk (``models/estimators/streaming.py``):
    ``fold_in(key, chunk_index)``, the same derivation as
    :func:`design_key`, named for the axis it folds over."""
    return fold_in(key, chunk_index)


@outermost(KEYTREE)
def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: with the partitionable layout subkey i is
    threefry(key, (0, i)), which is ``fold_in(key, i)``, on each half of
    an rbg key as on a threefry2x32 key; under unsafe_rbg subkey i is
    block 10·i of the key's own Philox draw. Returns shape
    ``key.shape[:-1] + (num, words)``."""
    key = _as_key(key)
    if key.shape[-1] == 4 and _four_word_impl() == "unsafe_rbg":
        return _rbg_bits(key, 4 * int(num), stride=10).unflatten(
            -1, (int(num), 4))
    return fold_in(key.unsqueeze(-2), torch.arange(int(num),
                                                   device=key.device))


@outermost(KEYTREE)
def bernoulli(key: torch.Tensor, p, shape) -> torch.Tensor:
    """``jax.random.bernoulli``: f32 uniform < p, with p in f32. A tensor
    ``p`` carries the key's leading axes."""
    u = uniform(key, shape)
    if isinstance(p, torch.Tensor):
        return u < p.to(u.device, torch.float32).reshape(
            *p.shape, *([1] * len(tuple(shape))))
    return u < float(np.float32(p))


@outermost(KEYTREE)
def exponential(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.exponential`` in f32: −log1p(−u). Within an ulp or two
    of JAX's (the last ulp of log1p differs between torch and XLA)."""
    return -torch.log1p(-uniform(key, shape))


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


@outermost(KEYTREE)
def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """Standard normal f32 draws, shape ``key.shape[:-1] + shape``: jax's
    construction √2·erfinv(u) with u ~ U(nextafter(−1, 0), 1) drawn bit
    for bit, but through ``torch.erfinv``, not XLA's f32 polynomial, so
    held to a tolerance (``models/dgp.py`` says which)."""
    return _SQRT2 * torch.erfinv(uniform(key, shape, _NORMAL_LO, 1.0))


def permutation_rounds(n: int) -> int:
    """Sort rounds of ``jax.random.permutation`` at length n:
    ⌈3·ln(max(1, n)) / ln(2³²−1)⌉ in numpy f64, as jax computes it
    (1 up to about n = 1,600, 2 up to about 2.6·10⁶)."""
    return int(np.ceil(3 * np.log(max(1, int(n)))
                       / np.log(np.iinfo(np.uint32).max)))


@outermost(KEYTREE)
def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for an int n, bit for bit: each
    round splits the key, draws n 32-bit sort keys from the subkey and
    reorders by a *stable* sort on them (two equal keys keep their
    order, as ``lax.sort_key_val`` does). Returns int64 indices of shape
    ``key.shape[:-1] + (n,)``."""
    key = _as_key(key)
    x = torch.arange(int(n), device=key.device).expand(
        *key.shape[:-1], int(n))
    for _ in range(permutation_rounds(n)):
        sub = split(key)
        key = sub[..., 0, :]
        order = torch.sort(random_bits(sub[..., 1, :], (int(n),)), dim=-1,
                           stable=True).indices
        x = torch.gather(x, -1, order)
    return x


_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


@outermost(KEYTREE)
def randint(key: torch.Tensor, shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` in its default
    int32, bit for bit: split the key, draw a high and a low 32-bit word
    per value, and reduce ((hi mod s)·((2¹⁶ mod s)² mod s) + lo mod s)
    mod s with s = maxval − minval, all in uint32, so the sum wraps at
    2³² as JAX's does (from s = 65,536 on). Bounds are Python ints inside
    the int32 range; returns int64 values of shape
    ``key.shape[:-1] + shape``."""
    minval, maxval = int(minval), int(maxval)
    if not (_I32_MIN <= minval <= _I32_MAX and _I32_MIN <= maxval <= _I32_MAX):
        raise ValueError(f"randint bounds must lie in the int32 range, got "
                         f"[{minval}, {maxval})")
    span = max(maxval - minval, 1)  # maxval ≤ minval gives minval
    mult = ((2**16 % span) ** 2 & _M32) % span  # the square wraps too
    sub = split(key)
    hi = random_bits(sub[..., 0, :], shape)
    lo = random_bits(sub[..., 1, :], shape)
    offset = (((hi % span) * mult) & _M32) + lo % span
    # minval + offset in int32, wrapping as JAX's add does
    return (minval + (offset & _M32) % span - _I32_MIN) % 2**32 + _I32_MIN


@outermost(KEYTREE)
def choice(key: torch.Tensor, n: int, shape) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace=True)`` with no ``p``:
    ``randint(key, shape, 0, n)``, int64 indices."""
    if int(n) <= 0:
        raise ValueError(f"choice needs n > 0, got {n}")
    return randint(key, shape, 0, n)


@outermost(KEYTREE)
def kernel_seeds(keys: torch.Tensor) -> torch.Tensor:
    """Per-replication (..., 2) int32 seed words for the fused kernel's
    in-kernel Philox generator, derived from the key-tree: for a
    threefry2x32 key the words of its ``"fused_ni/seed"`` substream, for
    an rbg-family key two words drawn from that substream by its own
    generator (its halves equal the threefry key at the same address, so
    taking its words would give threefry's fused results under an rbg
    stamp), reinterpreted as int32. Counterpart of
    ``dpcorr.utils.rng.pallas_seeds``, but not
    its bits: that one draws ``jax.random.randint`` from one design key,
    this one folds per replication so a block's seeds come from the same
    keys as its unfused replications. Either way the kernel's generator
    is a different stream family from threefry, so fused results are
    reproducible, not bit-comparable to the unfused path. Two words give
    a 2⁶⁴ seed space."""
    w = stream(keys, "fused_ni/seed")
    if w.shape[-1] == 4:
        w = random_bits(w, (2,))
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)
