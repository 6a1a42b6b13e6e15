"""Deterministic RNG key-tree: JAX's threefry2x32 tree, bit for bit.

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

Representation: a key is an int64 tensor whose last axis holds the two
uint32 words, shape ``(..., 2)``. torch's uint32 coverage is thin, so the
words live in int64 and every add and shift is masked back to 32 bits.
Every function is vectorised over the leading key axes, so a whole
replication block's keys are derived on the device that holds them.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

# Same master seed as the reference (vert-cor.R:16).
MASTER_SEED: int = 2025

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def impl_tag() -> str:
    """The port's PRNG tag, for result-cache stamps. The key-tree is JAX's
    threefry bit for bit, but the estimators on top agree with the JAX
    package's only to f32 rounding, so the tag differs from
    ``dpcorr.utils.rng.impl_tag()``'s and the two packages' caches never
    mix."""
    return "threefry2x32-torch"


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(key: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds), as ``jax.random``
    evaluates it. ``key`` is ``(..., 2)``; ``x0``/``x1`` broadcast against
    ``key[..., 0]``. Returns the two output words."""
    return _threefry_words(key[..., 0], key[..., 1], x0, x1)


def _threefry_words(k0, k1, x0, x1):
    """Threefry-2x32 on the key's two words, which may be tensors or host
    ints: the arithmetic is the same, masked to 32 bits either way."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _as_key(key) -> torch.Tensor:
    key = torch.as_tensor(key)
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key has 2 words on its last axis, got shape "
                         f"{tuple(key.shape)}")
    return key.to(torch.int64) & _M32


def master_key(seed: int = MASTER_SEED, device=None) -> torch.Tensor:
    """Root of the key-tree, ``jax.random.key(seed)``'s words as the JAX
    package runs it (64-bit types off): high word 0, low word the seed's
    low 32 bits, so a seed outside [0, 2³²) wraps as JAX wraps it."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
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


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: threefry(key, (0, data)). ``data`` is a
    host scalar (:func:`_host_data`) or an integer tensor that broadcasts
    against the key's leading axes; the result has the broadcast leading
    shape. A Python int outside [0, 2³²) raises ``OverflowError`` as JAX
    does; a numpy scalar and an integer tensor are masked to their low 32
    bits."""
    key = _as_key(key)
    if not isinstance(data, torch.Tensor):  # made on the device: no copy
        data = torch.full((), _host_data(data), dtype=torch.int64,
                          device=key.device)
    data = data.to(key.device, torch.int64) & _M32
    y0, y1 = threefry2x32(key, torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def fold_in_words(words: tuple[int, int], data: int) -> tuple[int, int]:
    """:func:`fold_in` on a key held as two host ints, for key chains
    short enough that device launches would cost more than the
    arithmetic (the serving layer's per-request keys). Bit-equal to
    :func:`fold_in` on the same words, and takes ``data`` as it does
    (:func:`_host_data`)."""
    return _threefry_words(int(words[0]) & _M32, int(words[1]) & _M32, 0,
                           _host_data(data))


def design_key(key: torch.Tensor, design_index) -> torch.Tensor:
    """Key for one design point (vert-cor.R:531's per-task seed)."""
    return fold_in(key, design_index)


def rep_keys_slice(key: torch.Tensor, start, n_reps: int) -> torch.Tensor:
    """Keys ``[start, start + n_reps)`` of the :func:`rep_keys` stream,
    shape ``key.shape[:-1] + (n_reps, 2)``, made on the key's device: a
    batch of keys ``(P, 2)`` gives each one's stream in one call."""
    idx = torch.arange(int(n_reps), device=key.device) + int(start)
    return fold_in(_as_key(key)[..., None, :], idx)


def rep_keys(key: torch.Tensor, n_reps: int) -> torch.Tensor:
    """Per-replication keys, shape ``(n_reps, 2)`` for one key
    (vert-cor.R:364, 392); ``(P, n_reps, 2)`` for P keys."""
    return rep_keys_slice(key, 0, n_reps)


def stream_index(name: str) -> int:
    """The fold-in index of a named substream: crc32 of the name, top bit
    cleared (as ``dpcorr.utils.rng.stream`` computes it)."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def stream(key: torch.Tensor, name: str) -> torch.Tensor:
    """Named substream: stable across code movement, unlike split order."""
    return fold_in(key, stream_index(name))


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
    identity; it mirrors the JAX package's export-boundary encoding."""
    return _as_key(keys)


def keys_from_data(data) -> torch.Tensor:
    """Raw words (any integer tensor or array with a last axis of 2) →
    keys; the inverse of :func:`key_data`."""
    if isinstance(data, np.ndarray):
        data = torch.from_numpy(data.astype(np.int64))
    return _as_key(data)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` with the partitionable
    counter layout: element i of the row-major flattened shape is
    y0 ^ y1 of threefry(key, (i >> 32, i & 0xFFFFFFFF)). Output shape is
    ``key.shape[:-1] + shape``, values in [0, 2³²) held in int64."""
    key = _as_key(key)
    shape = tuple(int(s) for s in shape)
    size = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(size, device=key.device)
    lead = key.shape[:-1]
    y0, y1 = threefry2x32(key.unsqueeze(-2), (idx >> 32) & _M32, idx & _M32)
    return (y0 ^ y1).reshape(tuple(lead) + shape)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits → f32 in [0, 1): mantissa bits under exponent 0."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32: ``max(min, f·(max−min)+min)`` with
    f from the top 23 bits, min and max rounded to f32 first. XLA fuses
    the multiply-add (one rounding); here the product is exact in f64
    and the sum is rounded to f32 from there, which the tests hold
    bit-equal to JAX."""
    f = _bits_to_unit(random_bits(key, shape))
    lo, hi = np.float32(minval), np.float32(maxval)
    span = float(np.float32(hi - lo))
    u = (f.to(torch.float64) * span + float(lo)).to(torch.float32)
    return torch.clamp_min(u, float(lo))


def chunk_key(key: torch.Tensor, chunk_index) -> torch.Tensor:
    """Key for one streaming n-chunk (``models/estimators/streaming.py``):
    ``fold_in(key, chunk_index)``, the same derivation as
    :func:`design_key`, named for the axis it folds over."""
    return fold_in(key, chunk_index)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: with the partitionable layout subkey i is
    threefry(key, (0, i)), which is ``fold_in(key, i)``. Returns shape
    ``key.shape[:-1] + (num, 2)``."""
    key = _as_key(key)
    return fold_in(key.unsqueeze(-2), torch.arange(int(num),
                                                   device=key.device))


def bernoulli(key: torch.Tensor, p, shape) -> torch.Tensor:
    """``jax.random.bernoulli``: f32 uniform < p, with p in f32. A tensor
    ``p`` carries the key's leading axes."""
    u = uniform(key, shape)
    if isinstance(p, torch.Tensor):
        return u < p.to(u.device, torch.float32).reshape(
            *p.shape, *([1] * len(tuple(shape))))
    return u < float(np.float32(p))


def exponential(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.exponential`` in f32: −log1p(−u). Within an ulp or two
    of JAX's (the last ulp of log1p differs between torch and XLA)."""
    return -torch.log1p(-uniform(key, shape))


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


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


def choice(key: torch.Tensor, n: int, shape) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace=True)`` with no ``p``:
    ``randint(key, shape, 0, n)``, int64 indices."""
    if int(n) <= 0:
        raise ValueError(f"choice needs n > 0, got {n}")
    return randint(key, shape, 0, n)


def kernel_seeds(keys: torch.Tensor) -> torch.Tensor:
    """Per-replication (..., 2) int32 seed words for the fused kernel's
    in-kernel Philox generator, derived from the key-tree: the words of
    each replication key's ``"fused_ni/seed"`` substream, reinterpreted
    as int32. Counterpart of ``dpcorr.utils.rng.pallas_seeds``, but not
    its bits: that one draws ``jax.random.randint`` from one design key,
    this one folds per replication so a block's seeds come from the same
    keys as its unfused replications. Either way the kernel's generator
    is a different stream family from threefry, so fused results are
    reproducible, not bit-comparable to the unfused path. Two words give
    a 2⁶⁴ seed space."""
    w = stream(keys, "fused_ni/seed")
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)
