"""Plain key-tree of the reference: threefry2x32 as ``jax.random`` runs it.

A frozen, self-contained copy of the draws the benchmarked program makes
from its key-tree, written here so the reference shares no code with the
program. A key is an int64 tensor whose last axis holds two uint32 words;
every add and rotation is masked back to 32 bits.

    master(seed) -> fold_in(i) -> ... -> stream(name) = fold_in(crc32(name) & 0x7FFFFFFF)

Bits: element i of a row-major shape is y0 ^ y1 of threefry(key, (i >> 32,
i & 0xFFFFFFFF)) (the partitionable layout). Uniforms take the top 23 bits
under exponent 0. Float work after the draws runs in ``dtype`` (f32, or a
lower precision for the control): the samplers draw in f32 and hand their
values on in it.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & M32


def threefry(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on int64 tensors holding uint32 words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def master(seed: int, device=None) -> torch.Tensor:
    """Root key of a seed: words (0, seed mod 2**32)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """threefry(key, (0, data)); ``data`` an int or an int64 tensor that
    broadcasts against the key's leading axes."""
    if not isinstance(data, torch.Tensor):
        data = torch.tensor(int(data) & M32, dtype=torch.int64,
                            device=key.device)
    data = data.to(key.device, torch.int64) & M32
    k0, k1 = key[..., 0], key[..., 1]
    y0, y1 = threefry(k0, k1, torch.zeros_like(data), data)
    y0, y1 = torch.broadcast_tensors(y0, y1)
    return torch.stack([y0, y1], dim=-1)


def stream(key: torch.Tensor, name: str) -> torch.Tensor:
    return fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF)


def rep_keys(key: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Replication keys ``fold_in(key, idx)`` at the given indices."""
    return fold_in(key[..., None, :], idx)


def bits(key: torch.Tensor, size: int) -> torch.Tensor:
    """(..., size) raw uint32 words of each key, in int64."""
    i = torch.arange(int(size), device=key.device, dtype=torch.int64)
    k0, k1 = key[..., 0:1], key[..., 1:2]
    y0, y1 = threefry(k0, k1, (i >> 32) & M32, i & M32)
    return y0 ^ y1


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """Subkey j is fold_in(key, j): shape (..., num, 2)."""
    return fold_in(key[..., None, :],
                   torch.arange(int(num), device=key.device))


def unit(words: torch.Tensor) -> torch.Tensor:
    """Words -> f32 in [0, 1): the top 23 bits under exponent 0."""
    f = ((words >> 9) | 0x3F800000).to(torch.int32)
    return f.view(torch.float32) - 1.0


def uniform(key, size: int, lo: float, hi: float):
    """f32 uniforms in [lo, hi): the product in f64, the sum rounded to
    f32 (one rounding, as a fused multiply-add gives)."""
    f = unit(bits(key, size))
    lo32, hi32 = np.float32(lo), np.float32(hi)
    span = float(np.float32(hi32 - lo32))
    u = (f.double() * span + float(lo32)).float()
    return torch.clamp_min(u, float(lo32))


LAPLACE_LO = -1.0 + float(np.finfo(np.float32).epsneg)
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = float(np.float32(np.sqrt(2.0)))


def laplace(key, size: int, dtype=torch.float32):
    """Unit Laplace draws: sign(u) * log1p(-|u|), u ~ U(-1 + epsneg, 1),
    drawn in f32 and handed on in ``dtype``."""
    u = uniform(key, size, LAPLACE_LO, 1.0)
    return (torch.sign(u) * torch.log1p(-torch.abs(u))).to(dtype)


def normal(key, size: int, dtype=torch.float32):
    """Standard normals: sqrt(2) * erfinv(u), u ~ U(nextafter(-1, 0), 1),
    drawn in f32 and handed on in ``dtype``."""
    u = uniform(key, size, NORMAL_LO, 1.0)
    return (SQRT2 * torch.erfinv(u)).to(dtype)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """Random permutation of range(n) per key: each round splits the key
    and reorders by a stable sort on n fresh words."""
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, device=key.device).expand(*key.shape[:-1], n)
    for _ in range(rounds):
        sub = split(key, 2)
        key = sub[..., 0, :]
        order = torch.sort(bits(sub[..., 1, :], n), dim=-1,
                           stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def choice(key: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """``size`` indices drawn uniformly from range(n) with replacement:
    a high and a low word per draw reduced mod n in uint32 arithmetic."""
    mult = ((2**16 % n) ** 2 & M32) % n
    sub = split(key, 2)
    hi = bits(sub[..., 0, :], size)
    lo = bits(sub[..., 1, :], size)
    off = (((hi % n) * mult) & M32) + lo % n
    return (off & M32) % n
