"""Roofline and hardware-utilization accounting.

Counterpart of ``dpcorr/utils/roofline.py``: a measured reps/s becomes
%-of-peak numbers against what the device could do.

- **Peaks** (:class:`ChipPeaks`, :func:`peaks_for`) per device kind
  (``utils.device.device_kind``): the JAX package's CPU stand-in, and
  one NVIDIA H100 SXM. The field names are the JAX package's so that
  :func:`summarize` gives the same record: on the card ``mxu_bf16_flops``
  is the tensor cores' dense bf16 rate and ``vpu_f32_flops`` the CUDA
  cores' f32 rate.
- **Work model of a whole replication** (:func:`analytic_rep_model`), the
  JAX package's hand count.
- **K1's per-pipe work model** (:func:`fused_pipe_ops`,
  :func:`least_time_ms`): the operations one replication of the fused
  function needs, by pipe, and the least time the card needs for them
  at sm_90's per-SM rates; ``chip_smoke.py``'s kernel table bounds K1
  with it, each
  level of K1's stage ladder (:func:`ladder_pipe_ops`) and the rbg-family
  bit generator (:func:`rbg_bits_ops`, :func:`rbg_bits_bytes`) the same
  way.

The JAX module's ``xla_cost`` has no counterpart: eager torch compiles
no program, so there is no compiler cost analysis to read.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ChipPeaks:
    """Per-device ceilings in SI units (FLOP/s, B/s)."""

    name: str
    mxu_bf16_flops: float  #: matrix-unit peak (bf16 inputs, f32 acc)
    vpu_f32_flops: float   #: elementwise f32 peak (the relevant one here)
    hbm_bytes: float       #: device-memory streaming bandwidth
    note: str = ""


#: The JAX package's CPU stand-in: one modern x86 core ~ 1e11 f32 FLOP/s,
#: ~2e10 B/s effective per-core stream bandwidth. Order-of-magnitude only.
CPU_CORE = ChipPeaks(
    name="cpu-core",
    mxu_bf16_flops=1e11,
    vpu_f32_flops=1e11,
    hbm_bytes=2e10,
    note="order-of-magnitude single-core estimate",
)

#: NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense rates):
#: 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 on the CUDA cores
#: (132 SMs x 128 FMA x 2 x 1.98 GHz), 3.35 TB/s HBM3. A card set below
#: 700 W runs slower under load: state its limit beside any share.
H100_SXM = ChipPeaks(
    name="cuda-h100",
    mxu_bf16_flops=9.89e14,
    vpu_f32_flops=6.7e13,
    hbm_bytes=3.35e12,
    note="NVIDIA H100 SXM data sheet, dense, 700 W",
)

_PEAKS = {"cpu": CPU_CORE, "cuda-h100": H100_SXM}


def peaks_for(device_kind: str) -> ChipPeaks:
    """The peaks of a device kind (``utils.device.device_kind``). Raises
    for a kind it has no figures for: it never hands back another
    device's peaks."""
    try:
        return _PEAKS[device_kind]
    except KeyError:
        raise ValueError(f"no peak figures for device kind "
                         f"{device_kind!r}; known: {sorted(_PEAKS)}") from None


def analytic_rep_model(n: int, eps1: float, eps2: float) -> dict:
    """Hand count of one bench replication (FLOPs and minimal memory
    bytes), the JAX package's: per sample 2 uniforms at ~75 integer ops a
    word, Box–Muller (~30), the Cholesky combine (3), standardisation
    (~10) and the sign-batch estimate (2 + 2); the (n, 2) f32 sample table
    written and read once."""
    per_sample = (2 * 75) + 30 + 3 + 10 + 2 + 2  # ~197
    flops = per_sample * n
    m = min(max(math.ceil(8.0 / (eps1 * eps2)), 1), n)
    k = max(n // m, 1)
    return {
        "flops_per_rep": float(flops),
        "bytes_per_rep_floor": float(2 * n * 4 * 2),  # write+read (n,2) f32
        "per_sample_flops": per_sample,
        "batch_geometry": {"m": m, "k": k},
    }


def summarize(reps_per_sec: float, flops_per_rep: float,
              bytes_per_rep: float, peaks: ChipPeaks) -> dict:
    """Achieved rates and %-of-peak; classify the binding resource."""
    fl = reps_per_sec * flops_per_rep
    by = reps_per_sec * bytes_per_rep
    frac_vpu = fl / peaks.vpu_f32_flops
    frac_hbm = by / peaks.hbm_bytes
    return {
        "reps_per_sec": reps_per_sec,
        "achieved_flops_per_sec": fl,
        "achieved_bytes_per_sec": by,
        "pct_of_vpu_peak": round(100 * frac_vpu, 1),
        "pct_of_mxu_bf16_peak": round(100 * fl / peaks.mxu_bf16_flops, 2),
        "pct_of_hbm_peak": round(100 * frac_hbm, 1),
        "bound": ("vpu" if frac_vpu >= frac_hbm else "hbm"),
        "peaks": dataclasses.asdict(peaks),
    }


# ---- K1's per-pipe work model on sm_90

#: the H100 SXM's memory rate, SMs, and the boost clock behind its
#: 67 TFLOP/s f32 (132 SMs x 128 FMA x 2 x 1.98 GHz)
HBM_BYTES_PER_S = H100_SXM.hbm_bytes
SMS = 132
CLOCK_HZ = 1.98e9
#: results per SM per clock on compute capability 9.0 (CUDA C++
#: Programming Guide, throughput of arithmetic instructions): f32 add,
#: multiply and FMA; 32-bit integer add, logic, shift, compare, min/max
#: and multiply; conversions and special functions. Four warp-instructions
#: issue per clock.
PIPE_RATES = {"f32": 128, "int32": 64, "sfu": 16}
ISSUE_RATE = 4 * 32


def fused_pipe_ops(n: int, eps, compute_int: bool,
                   philox: bool = True) -> dict:
    """Operations one replication of the fused function needs, by pipe
    (Box–Muller, normalise on). Work, not what a kernel issues: one
    operation per arithmetic, logic or compare operator of the function's
    definition, and one special-function operation per logf, sqrtf,
    sinf, cosf, log1pf, division or int-to-float conversion (the least
    any implementation of a precise one needs). A Philox4x32-10 call
    gives 4 words in 10 rounds of two 32×32→64 multiplies and two
    three-input xors (the round keys are made once per replication); a
    word becomes a uniform by a shift, an or and an f32 subtract. External
    mode (``philox=False``) reads its uniforms instead."""
    from dpcorr_torch.ops.fused_ni import layout

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

    # per observation: u1, u2 (and the flip uniform), Box–Muller (-2 log,
    # 2 pi u, r cos, r sin; log, sqrt, sin, cos), Cholesky, clip, sums
    draw(n, 3 if compute_int else 2)
    add(n, f32=4 + 4 + 2, sfu=4, int32=4)
    # per batch element: two sign tests and two count adds
    add(k * m, int32=4)
    if compute_int:  # flip test, two sign tests, two products, one add
        add(n, int32=6)
    # per batch: ux, uy, two Laplace draws, X~ and Y~ (conversion,
    # division, FMA each), T = m X~ Y~, and the sums of T and T^2
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
    ``reps`` replications of ``ops`` (:func:`fused_pipe_ops`) moving
    ``bytes_``, at the H100's rates above."""
    clocks = SMS * CLOCK_HZ
    times = {pipe: 1e3 * reps * ops[pipe] / (rate * clocks)
             for pipe, rate in PIPE_RATES.items()}
    times["issue"] = 1e3 * reps * sum(ops.values()) / (ISSUE_RATE * clocks)
    times["bytes"] = 1e3 * bytes_ / HBM_BYTES_PER_S
    return times


def ladder_pipe_ops(level: int, n: int, eps, philox: bool = True) -> dict:
    """Operations one replication of K1's stage ladder needs at ``level``
    (1-7, ``dpcorr_torch.bisect.LEVELS``), by pipe, counted as
    :func:`fused_pipe_ops` counts K1's. L6 and L7 are K1 (NI): their count
    is :func:`fused_pipe_ops`'s. L1-L5 compute over every position of the
    (rows, 128) layout, as the JAX ladder's arrays do, where K1 draws only
    its n observations: L1 the Philox words of two per position (10
    rounds of two multiplies and two xors per 4 words), converted and
    summed; L2 the words' uniforms, Box–Muller and the sums; L3 the pair
    and the position weight; L4 the clip, the centering draws and means,
    and the weighted sweep of the centered planes; L5 the clip and the
    centering of L4 and, in place of its sweep, the sign tests and count
    adds of each batch element and each batch's quotients and sums."""
    from dpcorr_torch.ops.fused_ni import LANES, layout

    if level >= 6:
        return fused_pipe_ops(n, eps, False, philox)
    m, _, k, _, rows = layout(n, *eps)
    pos = rows * LANES
    ops = {"f32": 0.0, "int32": 0.0, "sfu": 0.0}

    def add(times, f32=0.0, int32=0.0, sfu=0.0):
        ops["f32"] += times * f32
        ops["int32"] += times * int32
        ops["sfu"] += times * sfu

    if philox:
        add(pos, int32=2 / 4 * 10 * 4)
    if level == 1:  # two int-to-float conversions and two adds
        add(pos, sfu=2, f32=2)
        return ops
    # uniforms (shift, or; subtract), Box-Muller, two sums
    add(pos, int32=2 * 2, f32=2 + 4 + 2, sfu=4)
    if level == 2:
        return ops
    # the weight (three tests, an and, an or) and the pair's two products
    add(pos, int32=5, f32=2)
    if level == 3:
        return ops
    # the clip; one Philox call and two Laplace draws; the two DP means
    add(pos, int32=4)
    if philox:
        add(1, int32=40 + 2 * 2, f32=2)
    add(2, f32=3, sfu=1, int32=1)
    add(2, sfu=2, f32=3)
    if level == 4:  # the sweep: the weight again, two subtracts, two adds
        add(pos, int32=5, f32=4)
        return ops
    # per batch element two sign tests and two count adds; per batch the
    # counts unpacked and their two quotients summed
    add(k * m, int32=4)
    add(k, int32=6, f32=2)
    return ops


def rbg_bits_ops(n_words: int) -> dict:
    """Operations one key's draw of ``n_words`` words from XLA's Philox
    generator needs (``ops/rbg.py``), by pipe, counted as
    :func:`fused_pipe_ops` counts K1's Philox: per block of four words 10
    rounds of two 32×32→64 multiplies and two three-input xors, and the
    128-bit counter add (four adds, four carry tests); per key the round
    keys (two adds a round). Integer work only."""
    blocks = -(-int(n_words) // 4)
    return {"f32": 0.0, "int32": float(blocks * (10 * 4 + 8) + 2 * 10),
            "sfu": 0.0}


def rbg_bits_bytes(n_keys: int, n_words: int) -> int:
    """Device-memory bytes of one call: each key's four int64 words read
    once, each int64 output word written once."""
    return int(n_keys) * (4 * 8 + int(n_words) * 8)
