"""Stage ladder of the fused NI kernel: the Hopper kernel and its plain twin.

Counterpart of the inner ``kernel`` of ``probe_level`` in
``benchmarks/pallas_bisect.py``, which builds the fused kernel K1 up one
feature per level (L1 raw bits, L2 Box–Muller, L3 the pair and its
weights, L4 the DP centering, L5 the sign aggregation; L6 and L7 are K1
itself, :mod:`dpcorr_torch.ops.fused_ni`). The kernel
(``dpcorr_torch/csrc/fused_ni_ladder.cu``, CUDA C++ for sm_90a) computes
one f32 ``acc`` per replication at a level; its source says what bounds
it and how each level stays a prefix of K1's own work.

:func:`ladder_sums` is the wrapper. A CPU tensor goes to
:func:`ladder_plain`, the plain PyTorch version, which reads given int32
bits in the JAX ladder's call order (``bits1``, ``bits2``, 8 Laplace
rows); a CUDA tensor launches the kernel (given bits, or K1's Philox on
the seed words) or raises. There is no fallback from one to the other.
:func:`philox_bits` lays the kernel's in-kernel words out as given bits.
"""

from __future__ import annotations

import ctypes
import math

import torch

from dpcorr_torch.ops.fused_ni import (
    _M32,
    _SMEM_LIMIT,
    LANES,
    _check,
    _stream_words,
    laplace_from_uniform,
    layout,
    position_masks,
    uniform_from_bits,
)

#: the levels the ladder kernel computes; L6 and L7 are K1
KERNEL_LEVELS = (1, 2, 3, 4, 5)
_TWO_PI = 2.0 * math.pi

#: launches of the kernel, counted where the wrapper launches it
KERNEL_LAUNCHES = {"fused_ni_ladder": 0}


def bit_rows(n: int, eps1: float, eps2: float) -> int:
    """Rows of (·, 128) int32 bits one replication reads: ``bits1`` and
    ``bits2`` (rows each) and 8 rows for the Laplace draws."""
    return 2 * layout(n, eps1, eps2)[4] + 8


def plane_bytes(n: int, eps1: float, eps2: float, level: int) -> int:
    """Shared memory the clipped x and y planes (f32) of one replication
    take from L4 on, as K1's planes do; 0 below L4."""
    return layout(n, eps1, eps2)[4] * LANES * 8 if level >= 4 else 0


def planes_kept(n: int, eps1: float, eps2: float, level: int,
                regen: bool = False) -> bool:
    """Whether the kernel keeps the planes in shared memory at ``level``
    (``launch_one`` in csrc/fused_ni_ladder.cu): from L4 on, where they
    fit, unless ``regen`` asks for the variant that draws them again."""
    return (level >= 4 and not regen
            and plane_bytes(n, eps1, eps2, level) <= _SMEM_LIMIT)


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """uint32 words held in int64 → the same bits as int32."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def philox_bits(seeds: torch.Tensor, n: int, eps1: float,
                eps2: float) -> torch.Tensor:
    """The kernel's in-kernel words, laid out as given bits.

    Position q of ``bits1`` and ``bits2`` takes words (x, y) or (z, w) of
    Philox4x32-10 on counter (q / 2, 0, 0, 0) keyed by the replication's
    seed words (``seeds``: (B, 2) int32), and the Laplace rows take words
    x, y of counter (0, 3, 0, 0) in lane 0: the counters and tags of K1
    (``csrc/fused_ni.cu``). Returns ``(B, bit_rows, 128)`` int32; words the
    kernel never reads are 0."""
    rows = layout(n, eps1, eps2)[4]
    plane = rows * LANES
    key = seeds.to(torch.int64) & _M32
    b = key.shape[0]
    out = torch.zeros(b, 2 * rows + 8, LANES, dtype=torch.int32,
                      device=seeds.device)
    w = _as_int32(_stream_words(key, 0, plane // 2)).reshape(b, plane, 2)
    out[:, :rows] = w[..., 0].reshape(b, rows, LANES)
    out[:, rows:2 * rows] = w[..., 1].reshape(b, rows, LANES)
    scal = _as_int32(_stream_words(key, 3, 1))
    out[:, 2 * rows, 0] = scal[:, 0]
    out[:, 2 * rows + 1, 0] = scal[:, 1]
    return out


def ladder_plain(bits: torch.Tensor, rho: float, n: int, eps1: float,
                 eps2: float, level: int,
                 magnitude: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel at ``level`` (1-5) on given
    int32 bits ``(B, bit_rows, 128)``, the JAX ladder's arithmetic step
    by step. Returns ``(B,)`` f32 ``acc``; with ``magnitude`` the sum of
    the terms' absolute values instead, the scale of a sum's rounding."""
    if level not in KERNEL_LEVELS:
        raise ValueError(f"the ladder kernel has levels 1-5, got {level}")
    m, m_pad, k, leftover, rows = layout(n, eps1, eps2)
    b = bits.shape[0]

    def total(a, c):
        if magnitude:
            a, c = a.abs(), c.abs()
        return a.sum((1, 2)) + c.sum((1, 2))

    b1, b2 = bits[:, :rows], bits[:, rows:2 * rows]
    if level == 1:
        return total(b1.to(torch.float32), b2.to(torch.float32))
    u1, u2 = uniform_from_bits(b1), uniform_from_bits(b2)
    r = torch.sqrt(-2.0 * torch.log(u1))
    z1 = r * torch.cos(_TWO_PI * u2)
    z2 = r * torch.sin(_TWO_PI * u2)
    if level == 2:
        return total(z1, z2)
    rho_t = torch.tensor(rho, dtype=torch.float32, device=bits.device)
    x = z1
    y = rho_t * z1 + torch.sqrt(1.0 - rho_t * rho_t) * z2
    batch_elem, w = position_masks(rows, m, m_pad, k, leftover, bits.device)
    if level == 3:
        return total(x * w, y * w)
    l_clip = math.sqrt(2.0 * math.log(n))
    lap = laplace_from_uniform(uniform_from_bits(bits[:, 2 * rows:, 0]))

    def center(v, eps, noise):
        vc = torch.clamp(v, -l_clip, l_clip)
        mu = ((vc * w).sum((1, 2)) / n
              + noise * 2.0 * l_clip / (n * (eps / 2.0)))
        return vc - mu[:, None, None]

    x_c = center(x, eps1, lap[:, 0])
    y_c = center(y, eps2, lap[:, 1])
    if level == 4:
        return total(x_c * w, y_c * w)
    bmask = batch_elem.to(torch.float32)
    g_cols = LANES // m_pad
    xb = (torch.sign(x_c) * bmask).reshape(b, rows, g_cols, m_pad).sum(-1) / m
    yb = (torch.sign(y_c) * bmask).reshape(b, rows, g_cols, m_pad).sum(-1) / m
    return total(xb, yb)


class _Params(ctypes.Structure):
    """Mirror of ``LadderParams`` in csrc/fused_ni_ladder.cu."""

    _fields_ = ([(f, ctypes.c_int) for f in
                 ("n", "m", "m_pad", "k", "leftover", "rows")]
                + [(f, ctypes.c_float) for f in
                   ("rho", "l_clip", "den_x", "den_y")])


def _library() -> ctypes.CDLL:
    from dpcorr_torch.ops import _build

    lib = _build.load("fused_ni_ladder")
    if not getattr(lib, "_dpcorr_typed", False):
        lib.ladder_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.ladder_launch.restype = ctypes.c_int
        lib.ladder_error_string.argtypes = [ctypes.c_int]
        lib.ladder_error_string.restype = ctypes.c_char_p
        lib._dpcorr_typed = True
    return lib


def _params(rho: float, n: int, eps1: float, eps2: float) -> _Params:
    m, m_pad, k, leftover, rows = layout(n, eps1, eps2)
    return _Params(n, m, m_pad, k, leftover, rows, rho,
                   math.sqrt(2.0 * math.log(n)), n * (eps1 / 2.0),
                   n * (eps2 / 2.0))


def _launch(seeds, bits, rho, n, eps1, eps2, level,
            regen=False) -> torch.Tensor:
    b = seeds.shape[0]
    dev = seeds.device
    _check(seeds, "seeds", torch.int32, (b, 2), dev)
    if bits is not None:
        _check(bits, "bits", torch.int32,
               (b, bit_rows(n, eps1, eps2), LANES), dev)
        if bits.data_ptr() % 16:
            raise ValueError("bits must start on a 16-byte boundary")
    out = torch.empty(b, dtype=torch.float32, device=dev)
    if b == 0:
        return out
    lib = _library()
    params = _params(rho, n, eps1, eps2)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ladder_launch(
            seeds.data_ptr(), None if bits is None else bits.data_ptr(),
            out.data_ptr(), b, ctypes.byref(params), level,
            int(bits is not None), int(regen), stream)
    if err != 0:
        raise RuntimeError("fused_ni_ladder kernel launch failed: "
                           + lib.ladder_error_string(err).decode())
    KERNEL_LAUNCHES["fused_ni_ladder"] += 1
    return out


def ladder_sums(seeds: torch.Tensor, rho: float, n: int, eps1: float,
                eps2: float, level: int,
                bits: torch.Tensor | None = None, *,
                _regen: bool = False) -> torch.Tensor:
    """``(B,)`` f32 ``acc`` of each replication at ``level`` (1-5).

    ``seeds``: (B, 2) int32 seed words. ``bits``: optional
    ``(B, bit_rows, 128)`` int32; required on the CPU, where the plain
    version runs. On a CUDA tensor the kernel is launched (K1's Philox on
    ``seeds`` without ``bits``); any other device raises. Levels 4 and 5
    keep the planes in shared memory where they fit, as K1 does, and
    draw each position again in the sweep above that (n above 28,672 at
    m = 8). ``_regen`` forces the variant without planes where they
    would fit (for the checks that hold the two bit-equal; not a user
    option)."""
    if level not in KERNEL_LEVELS:
        raise ValueError(f"the ladder kernel has levels 1-5, got {level}")
    dev = seeds.device
    if dev.type == "cpu":
        if bits is None:
            raise ValueError(
                "the in-kernel generator runs only on the card; on the CPU "
                "pass `bits` (philox_bits gives the kernel's) with shape "
                f"(B, {bit_rows(n, eps1, eps2)}, {LANES})")
        return ladder_plain(bits, rho, n, eps1, eps2, level)
    if dev.type != "cuda":
        raise ValueError(f"fused_ni_ladder runs on cuda or cpu tensors, got "
                         f"{dev}")
    return _launch(seeds, bits, rho, n, eps1, eps2, level, _regen)
