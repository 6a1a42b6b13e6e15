"""Threefry-2x32 for the key-tree's threefry2x32 keys: the Hopper kernel
and its plain twin.

Counterpart of the hash ``jax.random`` evaluates for every threefry2x32
key (``threefry_2x32`` in jax/_src/prng.py, integer ops under XLA, not a
Pallas kernel; no PyTorch call computes it): Random123's Threefry-2x32
with 20 rounds, and ``jax.random.uniform``'s map of its words to f32.
The kernel (``dpcorr_torch/csrc/threefry.cu``, CUDA C++ for sm_90a) says
what bounds it.

Three entry points, one round function:

- :func:`threefry_bits`: keys ``(K, 2)`` → ``(K, n_words)``; word i of
  key k is y0 ^ y1 of threefry(key_k, (i >> 32, i & 0xFFFFFFFF)), the
  partitionable counter layout of ``jax.random.bits``.
- :func:`threefry_uniform`: the same words mapped to f32 uniforms in
  [minval, maxval) as :func:`uniform_from_bits` maps them, in registers:
  one launch and 4 bytes stored a word.
- :func:`threefry_hash`: key words k0, k1 and counter words x0, x1 that
  broadcast to one shape (a tensor or a Python int each) → that shape
  plus a last axis of 2, y0 and y1 side by side: a two-word ``fold_in``
  writes its new keys in one launch.

Words are int64 holding uint32 values, the key-tree's convention; only
the low 32 bits of an input are read. A CPU tensor goes to the plain
version, :func:`threefry_words` on int64 tensors with every add and shift
masked back to 32 bits (the same function on host ints is
``rng.fold_in_words``' arithmetic), then :func:`uniform_from_bits` for
the uniforms; a CUDA tensor launches the kernel or raises. There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: axes of the broadcast shape the hash kernel takes, after merging
_MAX_DIMS = 4

#: launches of the kernel, counted where the wrapper launches it
KERNEL_LAUNCHES = {"threefry_bits": 0, "threefry_hash": 0,
                   "threefry_uniform": 0}


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry_words(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on the key's two words and the counter's
    two, which may be tensors or host ints: the arithmetic is the same,
    masked to 32 bits either way. Returns the two output words."""
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


def threefry_bits_plain(keys: torch.Tensor, n_words: int) -> torch.Tensor:
    """Plain PyTorch version of the bits kernel: ``keys`` (K, 2) int64 →
    (K, n_words) int64 words."""
    idx = torch.arange(int(n_words), device=keys.device)
    y0, y1 = threefry_words(keys[:, :1], keys[:, 1:], (idx >> 32) & _M32,
                            idx & _M32)
    return y0 ^ y1


def uniform_bounds(minval: float, maxval: float) -> tuple[float, float]:
    """``(lo, span)`` of the map to [minval, maxval): the bounds rounded
    to f32 first, as ``jax.random.uniform`` rounds them, and their
    difference in f32."""
    lo, hi = np.float32(minval), np.float32(maxval)
    return float(lo), float(np.float32(hi - lo))


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """uint32 words (int64) → f32 uniforms, ``jax.random.uniform``'s map:
    f in [0, 1) from the top 23 bits under exponent 0, then
    ``max(f·span + lo, lo)``. XLA fuses the multiply-add (one rounding);
    here the product is exact in f64 and the sum is rounded to f32 from
    there, which the tests hold bit-equal to JAX."""
    lo, span = uniform_bounds(minval, maxval)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = (f.to(torch.float64) * span + lo).to(torch.float32)
    return torch.clamp_min(u, lo)


def threefry_uniform_plain(keys: torch.Tensor, n_words: int,
                           minval: float = 0.0,
                           maxval: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of the uniform kernel: ``keys`` (K, 2) int64
    → (K, n_words) f32."""
    return uniform_from_bits(threefry_bits_plain(keys, n_words), minval,
                             maxval)


def threefry_hash_plain(k0, k1, x0, x1) -> torch.Tensor:
    """Plain PyTorch version of the hash kernel: y0 and y1 stacked on a
    new last axis."""
    return torch.stack(threefry_words(k0, k1, x0, x1), dim=-1)


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of csrc/threefry.cu on a loaded library."""
    if not getattr(lib, "_dpcorr_typed", False):
        lib.threefry_bits_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p]
        lib.threefry_bits_launch.restype = ctypes.c_int
        lib.threefry_uniform_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p]
        lib.threefry_uniform_launch.restype = ctypes.c_int
        lib.threefry_hash_launch.argtypes = [
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.threefry_hash_launch.restype = ctypes.c_int
        lib.threefry_error_string.argtypes = [ctypes.c_int]
        lib.threefry_error_string.restype = ctypes.c_char_p
        lib._dpcorr_typed = True
    return lib


def _library() -> ctypes.CDLL:
    from dpcorr_torch.ops import _build

    return _typed(_build.load("threefry"))


def _check(lib: ctypes.CDLL, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.threefry_error_string(err).decode())
    KERNEL_LAUNCHES[name] += 1


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _row_keys(keys: torch.Tensor, n_words: int, name: str) -> int:
    """Checks the operands of a per-key entry (``keys`` (K, 2) int64 on
    the CPU or the card, ``n_words`` ≥ 0); returns ``n_words``."""
    if keys.dtype != torch.int64:
        raise TypeError(f"keys must be torch.int64, got {keys.dtype}")
    if keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must have shape (K, 2), got "
                         f"{tuple(keys.shape)}")
    n_words = int(n_words)
    if n_words < 0:
        raise ValueError(f"n_words must be >= 0, got {n_words}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{keys.device}")
    return n_words


def threefry_bits(keys: torch.Tensor, n_words: int) -> torch.Tensor:
    """(K, n_words) int64 words of ``jax.random.bits``' layout for each of
    the K threefry2x32 keys ``(K, 2)`` int64 (uint32 words). On a CUDA
    tensor the kernel is launched; on the CPU the plain version runs; any
    other device raises."""
    n_words = _row_keys(keys, n_words, "threefry_bits")
    if keys.device.type == "cpu":
        return threefry_bits_plain(keys, n_words)
    out = torch.empty(keys.shape[0], n_words, dtype=torch.int64,
                      device=keys.device)
    return _launch_rows("threefry_bits", keys.contiguous(), out)


def threefry_uniform(keys: torch.Tensor, n_words: int, minval: float = 0.0,
                     maxval: float = 1.0) -> torch.Tensor:
    """(K, n_words) f32 uniforms in [minval, maxval), ``jax.random.uniform``
    on each of the K threefry2x32 keys ``(K, 2)`` int64: the words of
    :func:`threefry_bits` mapped by :func:`uniform_from_bits`, bit for
    bit. On a CUDA tensor the kernel is launched; on the CPU the plain
    version runs; any other device raises."""
    n_words = _row_keys(keys, n_words, "threefry_uniform")
    if keys.device.type == "cpu":
        return threefry_uniform_plain(keys, n_words, minval, maxval)
    out = torch.empty(keys.shape[0], n_words, dtype=torch.float32,
                      device=keys.device)
    return _launch_rows("threefry_uniform", keys.contiguous(), out,
                        *uniform_bounds(minval, maxval))


def _launch_rows(name: str, keys: torch.Tensor, out: torch.Tensor,
                 *args) -> torch.Tensor:
    """Launches the per-key entry ``name`` into ``out`` (K, n_words);
    ``args`` follow the word count in its C interface."""
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(keys.device):
        err = getattr(lib, name + "_launch")(
            keys.data_ptr(), out.data_ptr(), *out.shape, *args,
            _stream(keys.device))
    _check(lib, err, name)
    return out


def _operands(k0, k1, x0, x1) -> tuple[list, torch.Size, torch.device]:
    """The four operands checked: each an int64 tensor or a Python int,
    the tensors on one device and broadcasting to one shape. Returns the
    operands with each tensor replaced by its view of that shape, the
    shape and the device."""
    ops = [k0, k1, x0, x1]
    tensors = [v for v in ops if isinstance(v, torch.Tensor)]
    if not tensors:
        raise TypeError("threefry_hash needs at least one tensor operand")
    for v in ops:
        if not (isinstance(v, int) or isinstance(v, torch.Tensor)
                and v.dtype == torch.int64):
            raise TypeError(f"operands must be torch.int64 tensors or ints, "
                            f"got {getattr(v, 'dtype', type(v).__name__)}")
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"operands lie on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    try:
        views = iter(torch.broadcast_tensors(*tensors))
    except RuntimeError as e:
        raise ValueError(f"operands do not broadcast: "
                         f"{[tuple(t.shape) for t in tensors]}") from e
    ops = [next(views) if isinstance(v, torch.Tensor) else v for v in ops]
    shape = next(v for v in ops if isinstance(v, torch.Tensor)).shape
    return ops, shape, device


def _merged_axes(views: list, shape: torch.Size) -> list:
    """``[(size, [stride of each operand])]`` over the broadcast shape,
    axes of size 1 dropped and neighbours merged where every operand
    steps through them as one axis (a constant has stride 0)."""
    axes: list = []
    for d, size in enumerate(shape):
        if size == 1:
            continue
        strides = [v.stride(d) if v is not None else 0 for v in views]
        if axes and all(p == s * size for p, s in zip(axes[-1][1], strides)):
            axes[-1] = (axes[-1][0] * size, strides)
        else:
            axes.append((size, strides))
    return axes


def threefry_hash(k0, k1, x0, x1) -> torch.Tensor:
    """Threefry-2x32 of key words (k0, k1) on counter words (x0, x1), each
    an int64 tensor or a Python int, the tensors broadcasting to one shape
    on one device: returns that shape + (2,), y0 and y1, int64. On CUDA
    tensors the kernel is launched; on the CPU the plain version runs; any
    other device raises."""
    ops, shape, device = _operands(k0, k1, x0, x1)
    if device.type == "cpu":
        return threefry_hash_plain(*ops)
    if device.type != "cuda":
        raise ValueError(f"threefry_hash runs on cuda or cpu tensors, got "
                         f"{device}")
    return _launch_hash(ops, shape, device)


def _launch_hash(ops: list, shape: torch.Size,
                 device: torch.device) -> torch.Tensor:
    out = torch.empty(*shape, 2, dtype=torch.int64, device=device)
    n = out.numel() // 2
    if n == 0:
        return out
    views = [v if isinstance(v, torch.Tensor) else None for v in ops]
    axes = _merged_axes(views, shape)
    if len(axes) > _MAX_DIMS:
        raise ValueError(f"threefry_hash takes at most {_MAX_DIMS} axes "
                         f"after merging, got shape {tuple(shape)}")
    axes = [(1, [0] * 4)] * (_MAX_DIMS - len(axes)) + axes
    c_shape = (ctypes.c_longlong * _MAX_DIMS)(*(s for s, _ in axes))
    c_strides = (ctypes.c_longlong * (4 * _MAX_DIMS))(
        *(axes[d][1][o] for o in range(4) for d in range(_MAX_DIMS)))
    c_ptrs = (ctypes.c_void_p * 4)(
        *(v.data_ptr() if v is not None else None for v in views))
    c_values = (ctypes.c_longlong * 4)(
        *(0 if v is not None else int(op) & _M32
          for v, op in zip(views, ops)))
    lib = _library()
    with torch.cuda.device(device):
        err = lib.threefry_hash_launch(n, c_shape, c_ptrs, c_values,
                                       c_strides, out.data_ptr(),
                                       _stream(device))
    _check(lib, err, "threefry_hash")
    return out
