"""Frozen work counts and peaks of one NVIDIA H100 SXM, for roofline shares.

A copy of the fused kernel's per-pipe work model (``fused_pipe_ops``,
``least_time_ms``) as the program's ``utils/roofline.py`` held it when the
benchmark was defined, kept here so that no later change to the program
moves the yardstick. The count is of the function, not of what a kernel
issues: one operation per arithmetic, logic or compare operator of the
function's definition, one special-function operation per logf, sqrtf,
sinf, cosf, log1pf, division or int-to-float conversion.
"""

from __future__ import annotations

import math

#: H100 SXM at its 700 W limit (NVIDIA data sheet): HBM3 bytes/s, SMs and
#: the boost clock behind its 67 TFLOP/s f32 (132 x 128 FMA x 2 x 1.98 GHz)
HBM_BYTES_PER_S = 3.35e12
SMS = 132
CLOCK_HZ = 1.98e9
#: results per SM per clock on compute capability 9.0 (CUDA C++
#: Programming Guide, throughput of arithmetic instructions); four
#: warp-instructions issue per clock
PIPE_RATES = {"f32": 128, "int32": 64, "sfu": 16}
ISSUE_RATE = 4 * 32
LANES = 128


def layout(n: int, eps1: float, eps2: float):
    """(m, m', k, leftover, rows) of the kernel's lane-group layout."""
    m = min(math.ceil(8.0 / (eps1 * eps2)), n)
    k = n // m
    m_pad = 1 << (m - 1).bit_length()
    leftover = n - k * m
    rows = -(-(k * m_pad + leftover) // LANES)
    return m, m_pad, k, leftover, -(-rows // 8) * 8


def fused_pipe_ops(n: int, eps, compute_int: bool,
                   philox: bool = True) -> dict:
    """Operations one replication of the fused function needs, by pipe
    (Box-Muller, normalise on). A Philox4x32-10 call gives 4 words in 10
    rounds of two 32x32->64 multiplies and two three-input xors; a word
    becomes a uniform by a shift, an or and an f32 subtract."""
    m, _, k, _, _ = layout(n, *eps)
    ops = {"f32": 0.0, "int32": 0.0, "sfu": 0.0}

    def add(times, f32=0.0, int32=0.0, sfu=0.0):
        ops["f32"] += times * f32
        ops["int32"] += times * int32
        ops["sfu"] += times * sfu

    def draw(times, words):
        if philox:
            add(times, int32=words / 4 * 10 * 4 + 2 * words, f32=words)

    def laplace(times):  # u - 1/2, -2|c|, log1p, sign, product
        add(times, f32=3, sfu=1, int32=1)

    # per observation: u1, u2 (and the flip uniform), Box-Muller, Cholesky,
    # clip, sums
    draw(n, 3 if compute_int else 2)
    add(n, f32=4 + 4 + 2, sfu=4, int32=4)
    # per batch element: two sign tests and two count adds
    add(k * m, int32=4)
    if compute_int:  # flip test, two sign tests, two products, one add
        add(n, int32=6)
    # per batch: two draws, two Laplace, X~ and Y~, T = m X~ Y~, the sums
    draw(k, 2)
    laplace(2 * k)
    add(k, sfu=4, f32=2 + 2 + 2)
    # per replication: centering and receiver draws, the DP means
    scalars = 5 if compute_int else 2
    if philox:
        add(1, int32=(2 if compute_int else 1) * 40 + 2 * scalars,
            f32=scalars)
    laplace(scalars)
    add(4 if compute_int else 2, sfu=2, f32=3)
    return ops


def least_time_ms(ops: dict, reps: int, bytes_: int) -> dict:
    """Milliseconds each pipe, the issue slots and device memory need for
    ``reps`` replications of ``ops`` moving ``bytes_``."""
    clocks = SMS * CLOCK_HZ
    times = {pipe: 1e3 * reps * ops[pipe] / (rate * clocks)
             for pipe, rate in PIPE_RATES.items()}
    times["issue"] = 1e3 * reps * sum(ops.values()) / (ISSUE_RATE * clocks)
    times["bytes"] = 1e3 * bytes_ / HBM_BYTES_PER_S
    return times


def k1_bound(n: int, eps, reps: int) -> tuple[float, str]:
    """(least ms, bounding pipe) of one in-kernel-Philox NI launch over
    ``reps`` replications: seeds (8 B), rho (4 B) in, three sums (12 B)
    out per replication."""
    times = least_time_ms(fused_pipe_ops(n, eps, False), reps, reps * 24)
    pipe = max(times, key=times.get)
    return times[pipe], pipe
