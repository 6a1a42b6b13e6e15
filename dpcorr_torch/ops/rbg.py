"""XLA's Philox bit generator for rbg-family keys: the Hopper kernel and its
plain twin.

Counterpart of ``lax.rng_bit_generator`` as ``jax.random.bits`` reaches it
on a key of JAX's ``rbg`` or ``unsafe_rbg`` implementation (an XLA
operation, not a Pallas kernel; no PyTorch call computes its layout). The
kernel (``dpcorr_torch/csrc/rbg_bits.cu``, CUDA C++ for sm_90a) says what
bounds it.

For key words (w0, w1, w2, w3): Philox4x32-10 keyed by (w0, w1) on the
128-bit counter whose little-endian 32-bit words start at (w2, w3, w0,
w1); block b takes that counter plus ``offset + b·stride``, with the
carry across all 128 bits, and output word j is word j mod 4 of block
j div 4. ``offset``/``stride`` serve unsafe_rbg's key-tree (block 9 of a
draw for ``fold_in``, every tenth block for ``split``).

:func:`rbg_bits` is the wrapper. A CPU tensor goes to
:func:`rbg_bits_plain`, the plain PyTorch version (``fused_ni``'s
``philox4x32`` round function on the 128-bit counter); a CUDA tensor
launches the kernel or raises. There is no fallback from one to the
other.
"""

from __future__ import annotations

import ctypes

import torch

from dpcorr_torch.ops.fused_ni import philox4x32

_M32 = 0xFFFFFFFF

#: launches of the kernel, counted where the wrapper launches it
KERNEL_LAUNCHES = {"rbg_bits": 0}


def _counters(keys: torch.Tensor, n_blocks: int, offset: int,
              stride: int) -> torch.Tensor:
    """(K, n_blocks, 4) counter words: the start (w2, w3, w0, w1) plus
    ``offset + b·stride``, added limb by limb in int64 with the carry
    taken through all four words."""
    inc = int(offset) + torch.arange(n_blocks, device=keys.device,
                                     dtype=torch.int64) * int(stride)
    start = keys[:, None, [2, 3, 0, 1]]
    add = torch.stack([inc & _M32, (inc >> 32) & _M32,
                       torch.zeros_like(inc), torch.zeros_like(inc)], -1)
    words, carry = [], 0
    for i in range(4):
        v = start[..., i] + add[None, :, i] + carry
        words.append(v & _M32)
        carry = v >> 32
    return torch.stack(words, -1)


def rbg_bits_plain(keys: torch.Tensor, n_words: int, offset: int = 0,
                   stride: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``keys`` (K, 4) int64 holding
    uint32 words → (K, n_words) int64 words."""
    n_words = int(n_words)
    n_blocks = -(-n_words // 4)
    keys = keys.to(torch.int64) & _M32
    ctr = _counters(keys, n_blocks, offset, stride)
    words = philox4x32(ctr, keys[:, None, :2])
    return words.reshape(keys.shape[0], n_blocks * 4)[:, :n_words]


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of csrc/rbg_bits.cu on a loaded library."""
    if not getattr(lib, "_dpcorr_typed", False):
        lib.rbg_bits_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p]
        lib.rbg_bits_launch.restype = ctypes.c_int
        lib.rbg_bits_error_string.argtypes = [ctypes.c_int]
        lib.rbg_bits_error_string.restype = ctypes.c_char_p
        lib._dpcorr_typed = True
    return lib


def _library() -> ctypes.CDLL:
    from dpcorr_torch.ops import _build

    return _typed(_build.load("rbg_bits"))


def _launch(keys: torch.Tensor, n_words: int, offset: int,
            stride: int) -> torch.Tensor:
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    out = torch.empty(keys.shape[0], n_words, dtype=torch.int64,
                      device=keys.device)
    if keys.shape[0] == 0 or n_words == 0:
        return out
    lib = _library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.rbg_bits_launch(keys.data_ptr(), out.data_ptr(),
                                  keys.shape[0], n_words, int(offset),
                                  int(stride), stream)
    if err != 0:
        raise RuntimeError("rbg_bits kernel launch failed: "
                           + lib.rbg_bits_error_string(err).decode())
    KERNEL_LAUNCHES["rbg_bits"] += 1
    return out


def rbg_bits(keys: torch.Tensor, n_words: int, offset: int = 0,
             stride: int = 1) -> torch.Tensor:
    """(K, n_words) int64 words of XLA's Philox generator for each of the
    K keys ``(K, 4)`` int64 (uint32 words), each key's own stream from
    block ``offset`` in steps of ``stride``. On a CUDA tensor the kernel
    is launched; on the CPU the plain version runs; any other device
    raises."""
    if keys.dtype != torch.int64:
        raise TypeError(f"keys must be torch.int64, got {keys.dtype}")
    if keys.dim() != 2 or keys.shape[1] != 4:
        raise ValueError(f"keys must have shape (K, 4), got "
                         f"{tuple(keys.shape)}")
    n_words, offset, stride = int(n_words), int(offset), int(stride)
    if n_words < 0 or offset < 0 or stride < 0:
        raise ValueError(f"n_words, offset and stride must be >= 0, got "
                         f"{n_words}, {offset}, {stride}")
    if keys.device.type == "cpu":
        return rbg_bits_plain(keys, n_words, offset, stride)
    if keys.device.type != "cuda":
        raise ValueError(f"rbg_bits runs on cuda or cpu tensors, got "
                         f"{keys.device}")
    return _launch(keys, n_words, offset, stride)
