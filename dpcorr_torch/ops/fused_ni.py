"""Fused NI/INT sign-batch replication: the Hopper kernel and its plain twin.

Counterpart of ``dpcorr/ops/pallas_ni.py``. The kernel
(``dpcorr_torch/csrc/fused_ni.cu``, CUDA C++ for sm_90a) computes one whole
Monte-Carlo replication per thread block: Gaussian pairs (Box–Muller or
Acklam's inverse CDF) with a per-replication ρ, DP centering, sign batch
sums, per-batch Laplace noise and (ΣT_j, ΣT_j²), plus with ``compute_int``
the INT sign-flip η̂ on the same draw. Its source says which TPU kernel it
replaces and what bounds it.

:func:`fused_ni_sums` is the wrapper. A CPU tensor goes to
:func:`fused_ni_plain`, the plain PyTorch version, which consumes given
uniforms in the TPU kernel's (rows, 128) layout and ``take()`` order; a
CUDA tensor launches the kernel (external uniforms or the in-kernel Philox
generator) or raises. There is no fallback from one to the other.

Applicability is the JAX package's: m ≤ 128 and k ≥ 2
(:func:`use_fused_ni`), at every n. On the card the replication's x and y
planes live in shared memory where they fit, up to n = 28,672 at m = 8
(25,600 with INT; :func:`fits_on_chip`); above that the kernel's variant
without planes draws each observation again in its sweep, bit-equal to
the variant with planes wherever both can run.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch.special import ndtri

from dpcorr_torch.models.estimators.common import CorrResult, batch_geometry
from dpcorr_torch.utils.device import f32_on, resolve_device

LANES = 128
_TWO_PI = float(np.float32(2.0 * math.pi))
#: dynamic shared memory one block may use on an H100 (227 KB), less a
#: margin for the kernel's static scratch (reductions, quotient table);
#: ``kSmemLimit`` in csrc/fused_ni_common.cuh
_SMEM_LIMIT = 232448 - 2048
_GAUSS = ("boxmuller", "ndtri")

#: launches of each kernel, counted where the wrapper launches it;
#: ``fused_ni_regen`` counts the launches that took the variant without
#: planes, each also counted under ``fused_ni``
KERNEL_LAUNCHES = {"fused_ni": 0, "fused_ni_regen": 0}


def pad_m(m: int) -> int:
    """Smallest power of two ≥ m (the lane-group width m' | 128)."""
    return 1 << (m - 1).bit_length()


def layout(n: int, eps1: float, eps2: float):
    """(m, m', k, leftover, rows) of the padded lane-group layout
    (``pallas_ni._layout``): k groups of m' lanes hold the batches, the
    n − k·m leftovers follow, rows is rounded up to a multiple of 8."""
    m, k = batch_geometry(n, eps1, eps2)
    m_pad = pad_m(m)
    leftover = n - k * m
    rows = -(-(k * m_pad + leftover) // LANES)
    rows = -(-rows // 8) * 8
    return m, m_pad, k, leftover, rows


def use_fused_ni(n: int, eps1: float, eps2: float) -> bool:
    """True iff the fused kernel covers this configuration (m ≤ 128 so one
    lane group holds a batch, and k ≥ 2 so sd(T_j) exists)."""
    m, k = batch_geometry(n, eps1, eps2)
    return m <= LANES and k >= 2


def fits_on_chip(n: int, eps1: float, eps2: float,
                 compute_int: bool = True) -> bool:
    """True iff one replication's planes fit in the kernel's shared
    memory (``_Consts.plane_bytes`` ≤ ``_SMEM_LIMIT``): where the launch
    switches from the variant that keeps them there to the one that draws
    each observation again in its sweep."""
    return _Consts(n, eps1, eps2, (0.0, 0.0),
                   (1.0, 1.0)).planes_kept(compute_int)


def n_uniform_rows(n: int, eps1: float = 1.0, eps2: float = 1.0,
                   compute_int: bool = False) -> int:
    """Rows of (·, 128) uniforms one replication consumes in external
    mode: u1 + u2 (rows each) + 8 centering rows + 2·rows batch noise,
    plus with ``compute_int`` 8 INT rows + rows flip draws."""
    return _Consts(n, eps1, eps2, (0.0, 0.0), (1.0, 1.0)).u_rows(compute_int)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Random int32 bits → f32 uniforms in [2⁻²⁴, 1−2⁻²⁴] by the 23-bit
    rule (``pallas_ni._uniform``; the kernel's ``unit23``). The shift
    result is masked, so bits with the sign bit set do not sign-extend."""
    b23 = (bits.to(torch.int64) >> 9) & 0x7FFFFF
    return (b23.to(torch.float32) + 0.5) * (2.0**-23)


_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of the constant ``a`` times ``b`` (int64
    holding uint32), in int64 without overflow: ``b`` is split into 16-bit
    halves."""
    hi_part = a * (b >> 16)                         # < 2^48
    t = ((hi_part & 0xFFFF) << 16) + a * (b & 0xFFFF)
    return (hi_part >> 16) + (t >> 32), t & _M32


def philox4x32(counter: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 (Random123), the kernel's in-kernel generator, in
    int64 tensor ops. ``counter``: (..., 4) and ``key``: (..., 2) uint32
    words held in int64, broadcast against each other. Returns the
    (..., 4) output words."""
    c = [counter[..., i] & _M32 for i in range(4)]
    k0, k1 = key[..., 0] & _M32, key[..., 1] & _M32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0 = (k0 + _PHILOX_W[0]) & _M32
        k1 = (k1 + _PHILOX_W[1]) & _M32
    return torch.stack(torch.broadcast_tensors(*c), dim=-1)


def laplace_from_uniform(u: torch.Tensor, scale=1.0) -> torch.Tensor:
    """Inverse-CDF Laplace(0, scale) on centered u−½ (real-data-sims.R:58-61)."""
    c = u - 0.5
    return -scale * torch.sign(c) * torch.log1p(-2.0 * torch.abs(c))


def ndtri_inline(p: torch.Tensor) -> torch.Tensor:
    """Acklam's rational inverse normal CDF (``pallas_ni._ndtri_inline``,
    the kernel's ``ndtri_acklam``), f32."""
    q = p - 0.5
    r = q * q
    central = (q * (((((-3.969683028665376e+01 * r
                        + 2.209460984245205e+02) * r
                       - 2.759285104469687e+02) * r
                      + 1.383577518672690e+02) * r
                     - 3.066479806614716e+01) * r
                    + 2.506628277459239e+00)
               / (((((-5.447609879822406e+01 * r
                      + 1.615858368580409e+02) * r
                     - 1.556989798598866e+02) * r
                    + 6.680131188771972e+01) * r
                   - 1.328068155288572e+01) * r + 1.0))
    pt = torch.minimum(p, 1.0 - p)
    s = torch.sqrt(-2.0 * torch.log(pt))
    tail = ((((((-7.784894002430293e-03 * s
                 - 3.223964580411365e-01) * s
                - 2.400758277161838e+00) * s
               - 2.549732539343734e+00) * s
              + 4.374664141464968e+00) * s
             + 2.938163982698783e+00)
            / ((((7.784695709041462e-03 * s
                  + 3.224671290700398e-01) * s
                 + 2.445134137142996e+00) * s
                + 3.754408661907416e+00) * s + 1.0))
    tail = torch.where(q < 0.0, tail, -tail)
    return torch.where(torch.abs(q) <= 0.5 - 0.02425, central, tail)


def position_masks(rows: int, m: int, m_pad: int, k: int, leftover: int,
                   device=None):
    """(batch_elem, w) over the (rows, 128) layout: ``batch_elem`` marks
    the k·m estimator inputs (bool), ``w`` the n real observations
    (f32), as ``pallas_ni._position_masks``."""
    pos = torch.arange(rows * LANES, device=device).reshape(rows, LANES)
    batch_elem = (pos % m_pad < m) & (pos // m_pad < k)
    in_leftover = (pos >= k * m_pad) & (pos < k * m_pad + leftover)
    return batch_elem, (batch_elem | in_leftover).to(torch.float32)


class _Consts:
    """The scalar constants of one (n, ε, μ, σ) configuration, computed
    once on the host in f64 as the JAX kernel's Python closure does."""

    def __init__(self, n, eps1, eps2, mu, sigma):
        self.n = n
        self.m, self.m_pad, self.k, self.leftover, self.rows = layout(
            n, eps1, eps2)
        self.g_cols = LANES // self.m_pad
        self.l_clip = math.sqrt(2.0 * math.log(n))
        self.den_x = n * (eps1 / 2.0)
        self.den_y = n * (eps2 / 2.0)
        self.scale_x = 2.0 / (self.m * eps1)
        self.scale_y = 2.0 / (self.m * eps2)
        eps_s, eps_r = max(eps1, eps2), min(eps1, eps2)
        e_s = math.exp(eps_s)
        self.p_keep = e_s / (e_s + 1.0)
        self.c_eta = (e_s + 1.0) / (n * (e_s - 1.0))
        self.scale_z = 2.0 * (e_s + 1.0) / (n * (e_s - 1.0) * eps_r)
        self.mu = tuple(float(v) for v in mu)
        self.sigma = tuple(float(v) for v in sigma)

    def u_rows(self, compute_int: bool) -> int:
        """Uniform rows of one replication in external mode."""
        return 4 * self.rows + 8 + (self.rows + 8 if compute_int else 0)

    def plane_bytes(self, compute_int: bool) -> int:
        """Shared memory of one replication's planes: x and y (f32) and,
        with INT, one flip byte per position."""
        plane = self.rows * LANES
        return plane * 8 + (plane if compute_int else 0)

    def planes_kept(self, compute_int: bool, regen: bool = False) -> bool:
        """Which variant a launch takes, as ``planes_kept`` in
        csrc/fused_ni.cu: the one with planes in shared memory where they
        fit, unless ``regen`` asks for the one without them."""
        return not regen and self.plane_bytes(compute_int) <= _SMEM_LIMIT

    def noise_in_smem(self, compute_int: bool) -> bool:
        """Whether the kernel keeps the (x, y) noise of each batch (f32)
        beside the planes, as ``noise_fits`` in csrc/fused_ni.cu; else its
        sweep draws the noise where it forms T_j."""
        return self.plane_bytes(compute_int) + 8 * self.k <= _SMEM_LIMIT


def observation_positions(n: int, eps1: float, eps2: float,
                          device=None) -> torch.Tensor:
    """(n,) position of each observation in the (rows, 128) layout, as
    the kernel places it: observation o of batch o // m sits at lane
    o % m of lane group o // m; the leftovers follow the k·m' group
    lanes."""
    m, m_pad, k, _, _ = layout(n, eps1, eps2)
    o = torch.arange(n, device=device)
    in_batch = o < k * m
    return torch.where(in_batch, (o // m) * m_pad + o % m,
                       k * m_pad + o - k * m)


def _stream_words(key: torch.Tensor, tag: int, calls: int) -> torch.Tensor:
    """(B, 4·calls) words of the in-kernel stream ``tag``: Philox on
    counters (i, tag, 0, 0) for i < calls, in counter order."""
    ctr = torch.zeros(calls, 4, dtype=torch.int64, device=key.device)
    ctr[:, 0] = torch.arange(calls, device=key.device)
    ctr[:, 1] = tag
    return philox4x32(ctr[None], key[:, None]).reshape(key.shape[0], -1)


def philox_uniforms(seeds: torch.Tensor, n: int, eps1: float, eps2: float,
                    compute_int: bool = False,
                    normalise: bool = True) -> torch.Tensor:
    """The kernel's in-kernel draws, laid out as external uniforms.

    Plain twin of the kernel's Philox4x32-10 streams (the counter scheme
    in csrc/fused_ni.cu): for each replication's seed words ``(B, 2)``
    int32, every word the kernel draws in its in-kernel mode, turned into
    a uniform by the 23-bit rule and put where external mode reads it in
    the TPU kernel's take() order. Returns ``(B, n_uniform_rows, 128)``
    f32; positions the kernel never reads hold 0.5. External mode on this
    tensor computes what in-kernel mode computes from ``seeds``, with the
    same ``compute_int`` and ``normalise``."""
    c = _Consts(n, eps1, eps2, (0.0, 0.0), (1.0, 1.0))
    rows, k, plane = c.rows, c.k, c.rows * LANES
    dev = seeds.device
    key = seeds.to(torch.int64) & _M32
    b = key.shape[0]
    out = torch.full((b, c.u_rows(compute_int) * LANES), 0.5,
                     dtype=torch.float32, device=dev)
    pos = observation_positions(n, eps1, eps2, dev)
    unit = uniform_from_bits
    # tag 0: (u1, u2) of observations 2i and 2i + 1
    w = _stream_words(key, 0, -(-n // 2)).reshape(b, -1, 2)
    out[:, pos] = unit(w[:, :n, 0])
    out[:, plane + pos] = unit(w[:, :n, 1])
    # tag 3, counter 0: lx, ly, lxi, lyi; counter 1: the receiver draw
    scal = unit(_stream_words(key, 3, 2))
    row = 2 * rows
    if normalise:
        out[:, row * LANES] = scal[:, 0]
        out[:, (row + 1) * LANES] = scal[:, 1]
        row += 8
    # tag 2: (ux, uy) of batches 2i and 2i + 1, at (row, col) = divmod(j,
    # g_cols) of the x and y noise blocks
    w = _stream_words(key, 2, -(-k // 2)).reshape(b, -1, 2)[:, :k]
    j = torch.arange(k, device=dev)
    at = (row + j // c.g_cols) * LANES + j % c.g_cols
    out[:, at] = unit(w[..., 0])
    out[:, at + rows * LANES] = unit(w[..., 1])
    row += 2 * rows
    if compute_int:
        for i in range(3):
            out[:, (row + i) * LANES] = scal[:, 2 + i]
        # tag 1: flip uniforms of observations 4i .. 4i + 3
        w = _stream_words(key, 1, -(-n // 4))[:, :n]
        out[:, (row + 8) * LANES + pos] = unit(w)
    return out.reshape(b, -1, LANES)


def _planes(u: torch.Tensor, rho: torch.Tensor, c: _Consts,
            normalise: bool, gauss: str):
    """The plain version's data stage: x and y planes of shape
    (B, rows, 128) from the first 2·rows uniform rows, clipped at
    ±√(2 ln n) when ``normalise``, with the layout's masks."""
    rows = c.rows
    u1, u2 = u[:, :rows], u[:, rows:2 * rows]
    if gauss == "ndtri":
        z1, z2 = ndtri_inline(u1), ndtri_inline(u2)
    else:
        r = torch.sqrt(-2.0 * torch.log(u1))
        z1 = r * torch.cos(_TWO_PI * u2)
        z2 = r * torch.sin(_TWO_PI * u2)
    rho = rho.reshape(-1, 1, 1)
    x = c.mu[0] + c.sigma[0] * z1
    y = c.mu[1] + c.sigma[1] * (rho * z1 + torch.sqrt(1.0 - rho * rho) * z2)
    batch_elem, w = position_masks(rows, c.m, c.m_pad, c.k, c.leftover,
                                   u.device)
    if normalise:
        x = torch.clamp(x, -c.l_clip, c.l_clip)
        y = torch.clamp(y, -c.l_clip, c.l_clip)
    return x, y, batch_elem, w


def _centered(v, w, noise, den, c: _Consts):
    """A clipped plane minus its DP mean (vert-cor.R:322-348)."""
    mean = (v * w).sum((1, 2)) / c.n + noise * 2.0 * c.l_clip / den
    return v - mean[:, None, None]


def fused_ni_plain(seeds: torch.Tensor, rho: torch.Tensor,
                   uniforms: torch.Tensor, *, n: int, eps1: float,
                   eps2: float, mu=(0.0, 0.0), sigma=(1.0, 1.0),
                   normalise: bool = True, compute_int: bool = False,
                   gauss: str = "boxmuller") -> torch.Tensor:
    """Plain PyTorch version of the kernel on given uniforms
    ``(B, n_uniform_rows, 128)`` f32, read in the TPU kernel's take()
    order. Returns (B, 3) f32: (ΣT_j, ΣT_j², η̂_INT or 0). ``seeds`` is
    accepted for the kernel's signature and unused."""
    del seeds
    c = _Consts(n, eps1, eps2, mu, sigma)
    rows, k, m = c.rows, c.k, c.m
    b = uniforms.shape[0]
    rho = f32_on(rho, uniforms.device).expand(b)
    x, y, batch_elem, w = _planes(uniforms, rho, c, normalise, gauss)
    cur = 2 * rows
    lap = laplace_from_uniform

    if normalise:
        lap4 = lap(uniforms[:, cur:cur + 8, 0])
        cur += 8
        x_c = _centered(x, w, lap4[:, 0], c.den_x, c)
        y_c = _centered(y, w, lap4[:, 1], c.den_y, c)
    else:
        x_c, y_c = x, y

    # segmented sign sums: one sum per m'-lane group (the TPU kernel's
    # signs @ G), padding lanes masked out
    bmask = batch_elem.to(torch.float32)
    sx = (torch.sign(x_c) * bmask).reshape(b, rows, c.g_cols, c.m_pad)
    sy = (torch.sign(y_c) * bmask).reshape(b, rows, c.g_cols, c.m_pad)
    xb = sx.sum(-1) / m
    yb = sy.sum(-1) / m
    noise = lap(uniforms[:, cur:cur + 2 * rows, :c.g_cols])
    cur += 2 * rows
    xt = xb + noise[:, :rows] * c.scale_x
    yt = yb + noise[:, rows:] * c.scale_y
    rr = torch.arange(rows, device=uniforms.device)[:, None]
    cc = torch.arange(c.g_cols, device=uniforms.device)[None, :]
    live = rr * c.g_cols + cc < k
    t = torch.where(live, m * xt * yt, 0.0)
    out = torch.zeros(b, 3, dtype=torch.float32, device=uniforms.device)
    out[:, 0] = t.sum((1, 2))
    out[:, 1] = (t * t).sum((1, 2))

    if compute_int:
        lap_i = lap(uniforms[:, cur:cur + 3, 0])
        cur += 8
        if normalise:
            x_i = _centered(x, w, lap_i[:, 0], c.den_x, c)
            y_i = _centered(y, w, lap_i[:, 1], c.den_y, c)
        else:
            x_i, y_i = x, y
        p_keep = float(np.float32(c.p_keep))
        flips = torch.where(uniforms[:, cur:cur + rows] < p_keep, 1.0, -1.0)
        core = flips * torch.sign(x_i) * torch.sign(y_i) * w
        out[:, 2] = c.c_eta * core.sum((1, 2)) + lap_i[:, 2] * c.scale_z
    return out


class _Params(ctypes.Structure):
    """Mirror of ``FusedNiParams`` in csrc/fused_ni.cu."""

    _fields_ = ([(f, ctypes.c_int) for f in
                 ("n", "m", "m_pad", "k", "leftover", "rows", "u_rows",
                  "g_cols")]
                + [(f, ctypes.c_float) for f in
                   ("l_clip", "den_x", "den_y", "scale_x", "scale_y", "mu0",
                    "mu1", "sig0", "sig1", "p_keep", "c_eta", "scale_z")])


def _typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of csrc/fused_ni.cu on a loaded library."""
    if not getattr(lib, "_dpcorr_typed", False):
        lib.fused_ni_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(_Params),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.fused_ni_launch.restype = ctypes.c_int
        lib.fused_ni_blocks_per_sm.argtypes = [
            ctypes.POINTER(_Params)] + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.fused_ni_blocks_per_sm.restype = ctypes.c_int
        lib.fused_ni_error_string.argtypes = [ctypes.c_int]
        lib.fused_ni_error_string.restype = ctypes.c_char_p
        lib._dpcorr_typed = True
    return lib


def _library() -> ctypes.CDLL:
    from dpcorr_torch.ops import _build

    return _typed(_build.load("fused_ni"))


def _params(c: _Consts, compute_int: bool) -> _Params:
    return _Params(c.n, c.m, c.m_pad, c.k, c.leftover, c.rows,
                   c.u_rows(compute_int), c.g_cols, c.l_clip, c.den_x,
                   c.den_y, c.scale_x, c.scale_y, c.mu[0], c.mu[1],
                   c.sigma[0], c.sigma[1], c.p_keep, c.c_eta, c.scale_z)


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"fused_ni {what} failed: "
                           + lib.fused_ni_error_string(err).decode())


def _call(lib: ctypes.CDLL, seeds, rho, uniforms, out, c: _Consts,
          normalise, compute_int, gauss, regen=False) -> None:
    """One launch of ``lib``'s kernel on the current stream, on tensors
    the caller has checked; raises if the launch is refused. ``regen``
    forces the variant without planes."""
    params = _params(c, compute_int)
    dev = seeds.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_ni_launch(
            seeds.data_ptr(), rho.data_ptr(),
            None if uniforms is None else uniforms.data_ptr(),
            out.data_ptr(), seeds.shape[0], ctypes.byref(params),
            int(uniforms is not None), int(compute_int),
            int(gauss == "ndtri"), int(normalise), int(regen), stream)
    _raise_on(lib, err, "kernel launch")


def blocks_per_sm(n: int, eps1: float, eps2: float, *,
                  compute_int: bool = False) -> int:
    """Blocks (replications) of the in-kernel Box–Muller mode with
    ``normalise`` that the card keeps resident on one SM at this n, by the
    CUDA occupancy calculator. Card only."""
    c = _Consts(n, eps1, eps2, (0.0, 0.0), (1.0, 1.0))
    lib = _library()
    blocks = ctypes.c_int(0)
    _raise_on(lib, lib.fused_ni_blocks_per_sm(
        ctypes.byref(_params(c, compute_int)), 0, int(compute_int), 0, 1, 0,
        ctypes.byref(blocks)), "occupancy query")
    return blocks.value


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(seeds, rho, uniforms, c: _Consts, normalise, compute_int,
            gauss, regen=False) -> torch.Tensor:
    b = seeds.shape[0]
    dev = seeds.device
    u_rows = c.u_rows(compute_int)
    _check(seeds, "seeds", torch.int32, (b, 2), dev)
    _check(rho, "rho", torch.float32, (b,), dev)
    if uniforms is not None:
        _check(uniforms, "uniforms", torch.float32, (b, u_rows, LANES), dev)
    out = torch.empty(b, 3, dtype=torch.float32, device=dev)
    if b == 0:
        return out
    _call(_library(), seeds, rho, uniforms, out, c, normalise, compute_int,
          gauss, regen)
    KERNEL_LAUNCHES["fused_ni"] += 1
    if not c.planes_kept(compute_int, regen):
        KERNEL_LAUNCHES["fused_ni_regen"] += 1
    return out


def fused_ni_sums(seeds: torch.Tensor, rho, n: int, eps1: float,
                  eps2: float, mu=(0.0, 0.0), sigma=(1.0, 1.0),
                  normalise: bool = True, compute_int: bool = False,
                  gauss: str = "boxmuller",
                  uniforms: torch.Tensor | None = None, *,
                  _regen: bool = False) -> torch.Tensor:
    """(B, 3) f32 (ΣT_j, ΣT_j², η̂_INT) for a batch of replications.

    ``seeds``: (B, 2) int32 per-replication seed words
    (:func:`dpcorr_torch.utils.rng.kernel_seeds`). ``rho``: a float or a
    (B,) tensor. ``uniforms``: optional (B, n_uniform_rows, 128) f32
    external uniforms; required on the CPU, where the plain version runs.
    On a CUDA tensor the kernel is launched (in-kernel Philox without
    ``uniforms``); any other device raises. ``_regen`` forces the kernel's
    variant without planes where the planes would fit (for the checks
    that hold the two variants bit-equal; not a user option)."""
    if not use_fused_ni(n, eps1, eps2):
        m, k = batch_geometry(n, eps1, eps2)
        raise ValueError(f"fused kernel needs m <= {LANES} and k >= 2, got "
                         f"m={m}, k={k}")
    if gauss not in _GAUSS:
        raise ValueError(f"gauss must be 'boxmuller' or 'ndtri', got "
                         f"{gauss!r}")
    c = _Consts(n, eps1, eps2, mu, sigma)
    dev = seeds.device
    b = seeds.shape[0]
    rho_b = f32_on(rho, dev).expand(b).contiguous()
    if dev.type == "cpu":
        if uniforms is None:
            raise ValueError(
                "the in-kernel generator runs only on the card; on the CPU "
                "pass `uniforms` with shape "
                f"(B, {n_uniform_rows(n, eps1, eps2, compute_int)}, {LANES})")
        return fused_ni_plain(seeds, rho_b, uniforms, n=n, eps1=eps1,
                              eps2=eps2, mu=mu, sigma=sigma,
                              normalise=normalise, compute_int=compute_int,
                              gauss=gauss)
    if dev.type != "cuda":
        raise ValueError(f"fused_ni runs on cuda or cpu tensors, got {dev}")
    return _launch(seeds, rho_b, uniforms, c, normalise, compute_int, gauss,
                   _regen)


def ni_result(st: torch.Tensor, st2: torch.Tensor, k: int,
              alpha: float) -> CorrResult:
    """NI estimate + CI from (ΣT_j, ΣT_j²): the η-space clamp-then-sine
    construction of ``ci_ni_signbatch`` (vert-cor.R:249-254)."""
    eta_hat = st / k
    var_t = torch.clamp_min((st2 - k * eta_hat * eta_hat) / (k - 1), 0.0)
    rho_hat = torch.sin(math.pi * eta_hat / 2.0)
    crit = ndtri(torch.full((), 1.0 - alpha / 2.0, dtype=torch.float32,
                            device=st.device))
    half = crit * torch.sqrt(var_t) / math.sqrt(k)
    lo = torch.sin(math.pi / 2.0 * torch.clamp_min(eta_hat - half, -1.0))
    hi = torch.sin(math.pi / 2.0 * torch.clamp_max(eta_hat + half, 1.0))
    return CorrResult(rho_hat, lo, hi)


def ni_sign_fused(seeds: torch.Tensor, rho, n: int, eps1: float,
                  eps2: float, mu=(0.0, 0.0), sigma=(1.0, 1.0),
                  alpha: float = 0.05, normalise: bool = True,
                  gauss: str = "boxmuller",
                  uniforms: torch.Tensor | None = None,
                  device=None) -> CorrResult:
    """Fused generate + NI estimate + CI for a batch of replications
    (counterpart of ``ni_sign_pallas``). ``seeds``: (B, 2) int32 words,
    moved to ``device`` (the card unless the caller names another)."""
    dev = resolve_device(device)
    seeds = torch.as_tensor(seeds, dtype=torch.int32).to(dev).contiguous()
    if uniforms is not None:
        uniforms = uniforms.to(dev, torch.float32).contiguous()
    out = fused_ni_sums(seeds, rho, n, eps1, eps2, mu, sigma, normalise,
                        False, gauss, uniforms)
    _, k = batch_geometry(n, eps1, eps2)
    return ni_result(out[:, 0], out[:, 1], k, alpha)
