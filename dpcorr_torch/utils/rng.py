"""Deterministic RNG key-tree: JAX's threefry2x32 tree, bit for bit.

Counterpart of ``dpcorr/utils/rng.py``. The tree is the same

    master(seed) → design point (fold_in i) → replication (fold_in b)
                 → named substream (fold_in crc32(name) & 0x7FFFFFFF)

and every key word, raw bit and f32 uniform equals what ``jax.random``
gives under jax 0.9 with ``jax_threefry_partitionable=True`` (the
default there), so the port and the JAX package can be handed the same
keys (``dpcorr_torch.interop``) and draw the same noise.

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


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(key: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds), as ``jax.random``
    evaluates it. ``key`` is ``(..., 2)``; ``x0``/``x1`` broadcast against
    ``key[..., 0]``. Returns the two output words."""
    k0, k1 = key[..., 0], key[..., 1]
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
    """Root of the key-tree, ``jax.random.key(seed)``'s words: the seed's
    high and low 32 bits (high is 0 for a 32-bit seed)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32],
                        dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: threefry(key, (0, data)). ``data`` is an
    int or an integer tensor that broadcasts against the key's leading
    axes; the result has the broadcast leading shape."""
    key = _as_key(key)
    if isinstance(data, int):  # made on the device: no host-to-device copy
        data = torch.full((), data, dtype=torch.int64, device=key.device)
    data = data.to(key.device, torch.int64) & _M32
    y0, y1 = threefry2x32(key, torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def design_key(key: torch.Tensor, design_index) -> torch.Tensor:
    """Key for one design point (vert-cor.R:531's per-task seed)."""
    return fold_in(key, design_index)


def rep_keys_slice(key: torch.Tensor, start, n_reps: int) -> torch.Tensor:
    """Keys ``[start, start + n_reps)`` of the :func:`rep_keys` stream,
    shape ``(n_reps, 2)``, made on the key's device."""
    idx = torch.arange(int(n_reps), device=key.device) + int(start)
    return fold_in(_as_key(key)[None, :], idx)


def rep_keys(key: torch.Tensor, n_reps: int) -> torch.Tensor:
    """Per-replication keys, shape ``(n_reps, 2)`` (vert-cor.R:364, 392)."""
    return rep_keys_slice(key, 0, n_reps)


def stream_index(name: str) -> int:
    """The fold-in index of a named substream: crc32 of the name, top bit
    cleared (as ``dpcorr.utils.rng.stream`` computes it)."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def stream(key: torch.Tensor, name: str) -> torch.Tensor:
    """Named substream: stable across code movement, unlike split order."""
    return fold_in(key, stream_index(name))


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
