#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dpcorr_torch``) on one NVIDIA card.

In order:

1. the card's name and power limit (``nvidia-smi``) and the versions;
2. the build: every kernel from ``dpcorr_torch/csrc`` (one ``nvcc`` per
   source, started together), then what ``ptxas`` reports for each of
   K1's 48 variants (16 modes × planes with the batch noise in shared
   memory, planes with the noise drawn in the sweep, no planes) and the
   stage ladder's 14 (L1-L5 × external or in-kernel bits, L4-L5 with
   planes and without): registers, stack frame, spills. The main-path
   variant must not spill;
3. the kernel table: each hand-written kernel alone, timed with CUDA
   events at the main path's shapes beside the least time the card could
   take for the same work and its plain PyTorch version's time, all in
   one JSON line ``{"kernels": [...]}`` (each kernel's ``name``,
   ``route``, ``ms``, ``plain_ms``, ``bound_ms``, ``library_ms``). It
   holds each kernel's output on the timed operands against its plain
   version's (``max_abs_err`` or ``words_differing``) and fails outside
   the card tests' tolerance. It runs one fused and one unfused block of
   the main path with every launch count set to 0 just before, and
   reports what each launched (``main_path_launches``):
   - ``fused_ni`` (K1) at the main path's launch (n = 10⁴, ε = (1, 1),
     B = 2¹⁴): in-kernel NI and NI+INT, external mode (≥ 99% of
     replications within 1e-4 relative on ΣT and ΣT² and 1e-5 on the
     third output of the plain version on the same uniforms), the plain
     version, blocks resident per SM, the bound by pipe and by issue
     slots; its variant without planes at n = 10⁵, B = 2¹⁴ and n = 10⁶,
     B = 2¹⁰;
   - ``fused_ni_ladder``: each level at B = 2¹⁴, n = 10⁴ (L6 = K1 at the
     same shape, which must lie within 10% of K1's time above; L7 = K1 at
     B = 4096); L1-L5 on the timed bits against the plain version (every
     replication within 1e-5 × Σ|terms| at L1-L4, ≥ 99% at L5);
   - ``rbg_bits`` at the unfused block's draw (2¹⁴ keys × 2·10⁴ words),
     bit-equal to the plain version;
   - ``threefry``: bits and the uniform at the unfused block's draw and
     at a stress-study chunk (512 × 65,536), the hash over the fused
     path's 2²⁰ replication indices, each bit-equal to its plain version
     in one launch a call;
4. the card tests, ``tests/test_torch_cuda.py``, in a child process that
   prints as it goes and is stopped after ``CARD_TESTS_TIMEOUT_S``: the
   smoke fails when they fail and prints their pass count. Every
   pass/fail check of the port's paths on the card lives there;
5. the device line, last and alone.

Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

import numpy as np
import torch

N, EPS, RHO = 10_000, (1.0, 1.0), 0.5
FUSED_BLOCK = 1 << 14          # replications per kernel launch on the main path
UNFUSED_CHUNK = 1 << 11        # the unfused block's chunk on the main path

#: the main-path variant's template flags (external, INT, ndtri, normalise,
#: noise in shared memory, planes in shared memory)
MAIN_VARIANT = (0, 0, 0, 1, 1, 1)
#: K1's variant without planes: the timed in-kernel shapes (n, B)
REGEN_TIMED = [(100_000, 1 << 14), (1_000_000, 1 << 10)]
#: the ladder's L7: K1 at the bisect script's probe shape
LADDER_BIG_B = 4096
RBG_TIMED_KEYS = 1 << 14       # the unfused block's keys
RBG_WORDS = 2 * N              # words a replication draws for its data
THREEFRY_KEYS = 1 << 14        # the unfused block's keys
THREEFRY_WORDS = 2 * N
THREEFRY_FOLDS = 1 << 20       # the fused path's replication keys
#: a chunk draw of the stress study (``subg.stream_n1e6``): 512 resident
#: replications × an n-chunk of 65,536 rows
STRESS_KEYS, STRESS_WORDS = 512, 1 << 16
#: int32 operations of the definition that only the integer ALU runs:
#: the 20 rotations and 20 xors of the rounds, and bits' output xor (the
#: uniform's map adds a shift and an or, left out of its bound)
THREEFRY_ALU_OPS = {"threefry_bits": 41, "threefry_hash": 40,
                    "threefry_uniform": 41}
#: (minval, maxval) of the timed uniform draws: the bounded factor's
#: U, E1, E2 at the stress shape, ``normal``'s at the unfused one
STRESS_BOUNDS = (-1.0, 1.0)
NORMAL_BOUNDS = (float(np.nextafter(np.float32(-1), np.float32(0))), 1.0)
CARD_TESTS = "tests/test_torch_cuda.py"
#: the card tests take about 10 minutes on an H100; a hang fails here
CARD_TESTS_TIMEOUT_S = 2400


def within_tolerance(got, want):
    """Per replication: ΣT and ΣT² within 1e-4 relative, and the third
    output within 1e-5 absolute, of the plain version."""
    close = torch.isclose(got[:, :2], want[:, :2], rtol=1e-4, atol=0.0).all(1)
    return close & torch.isclose(got[:, 2], want[:, 2], rtol=0.0, atol=1e-5)


def mode_label(flags) -> str:
    ext, ci, nd, norm, noise_smem, planes = flags
    return (f"{'external' if ext else 'philox'} {'NI+INT' if ci else 'NI'} "
            f"{'ndtri' if nd else 'boxmuller'} "
            f"{'normalise' if norm else 'raw'} "
            + (f"noise in {'smem' if noise_smem else 'sweep'}" if planes
               else "no planes"))


def fused_ni_ptxas() -> tuple:
    """K1's 48 variants as ``ptxas`` reports them; raises unless all 48
    are there and the main-path variant spills nothing."""
    from dpcorr_torch.ops import _build

    log = _build.log_path("fused_ni")
    if not log.exists():
        raise RuntimeError(f"no compiler report beside this build of "
                           f"fused_ni ({log}); remove its library to rebuild")
    report = _build.ptxas_report(log.read_text())
    for flags, (regs, stack, st, ld) in sorted(report.items()):
        print(f"ptxas fused_ni [{mode_label(flags)}]: {regs} registers, "
              f"{stack} bytes stack frame, {st} bytes spill stores, {ld} "
              f"bytes spill loads", flush=True)
    if len(report) != 48:
        raise RuntimeError(f"ptxas reported {len(report)} fused_ni "
                           f"variants, expected 48")
    if any(report[MAIN_VARIANT][2:]):
        raise RuntimeError(f"the main-path variant spills: "
                           f"{report[MAIN_VARIANT]}")
    return report


def ladder_levels_ptxas() -> dict:
    """``ptxas`` registers and spills of the ladder's 14 variants (L4-L5
    with planes and without), by level name, bit source and planes."""
    from dpcorr_torch.bisect import LEVELS
    from dpcorr_torch.ops import _build

    log = _build.log_path("fused_ni_ladder")
    if not log.exists():
        raise RuntimeError(f"no compiler report beside this build of "
                           f"fused_ni_ladder ({log})")
    report = _build.ptxas_report(log.read_text())
    want = [(lv, ext, pl) for lv in range(1, 6) for ext in (0, 1)
            for pl in ((0, 1) if lv >= 4 else (0,))]
    if sorted(report) != want:
        raise RuntimeError(f"ptxas reported ladder variants "
                           f"{sorted(report)}, expected {want}")
    out = {}
    for (lv, ext, pl), (regs, stack, st, ld) in sorted(report.items()):
        src = ("external" if ext else "in-kernel") + (
            "" if pl or lv < 4 else ", no planes")
        out.setdefault(LEVELS[lv - 1], {})[src] = {
            "registers": regs, "stack": stack, "spill_stores": st,
            "spill_loads": ld}
        print(f"ptxas fused_ni_ladder [L{lv} {LEVELS[lv - 1]} {src}]: "
              f"{regs} registers, {stack} bytes stack frame, {st} bytes "
              f"spill stores, {ld} bytes spill loads", flush=True)
    return out


def k1_times(card: str) -> dict:
    """K1 at the main path's launch shape (CUDA events): in-kernel NI and
    NI+INT, external mode, its plain version on the same replications,
    blocks resident per SM, and the least time the card could take for
    the same work, by pipe and by issue slots."""
    from dpcorr_torch.ops import fused_ni
    from dpcorr_torch.utils import rng
    from dpcorr_torch.utils.device import time_cuda
    from dpcorr_torch.utils.roofline import fused_pipe_ops, least_time_ms

    b = FUSED_BLOCK
    key = rng.master_key(device="cuda")
    seeds = rng.kernel_seeds(rng.rep_keys(key, b)).contiguous()
    rho_b = torch.full((b,), RHO, device="cuda")
    ms = time_cuda(lambda: fused_ni.fused_ni_sums(seeds, rho_b, N, *EPS), 20)
    int_ms = time_cuda(lambda: fused_ni.fused_ni_sums(
        seeds, rho_b, N, *EPS, compute_int=True), 10)
    rows = fused_ni.n_uniform_rows(N, *EPS)
    # dpcorr-lint: ignore[rng-raw-api] — timing uniforms for the external mode, not DP noise
    u = torch.rand(b, rows, 128, device="cuda") * (1 - 2e-7) + 1e-7
    ext_ms = time_cuda(lambda: fused_ni.fused_ni_sums(seeds, rho_b, N, *EPS,
                                                      uniforms=u), 10)
    plain_ms = time_cuda(lambda: fused_ni.fused_ni_plain(
        seeds, rho_b, u, n=N, eps1=EPS[0], eps2=EPS[1]), 3)
    got = fused_ni.fused_ni_sums(seeds, rho_b, N, *EPS, uniforms=u)
    want = fused_ni.fused_ni_plain(seeds, rho_b, u, n=N, eps1=EPS[0],
                                   eps2=EPS[1])
    share = within_tolerance(got, want).float().mean().item()
    err = (got - want).abs().max(0).values.tolist()
    print(f"[{card}] fused_ni external mode against its plain version on "
          f"the same uniforms, B={b}, n={N}: {share:.4f} within tolerance; "
          f"max |err| {[f'{e:.3g}' for e in err]}", flush=True)
    if not torch.isfinite(got).all() or share < 0.99:
        raise RuntimeError(f"fused_ni disagrees with its plain version at "
                           f"the main path's launch: {share} within "
                           f"tolerance, max |err| {err}")
    del got, want
    blocks = {ci: fused_ni.blocks_per_sm(N, *EPS, compute_int=ci)
              for ci in (False, True)}
    print(f"blocks resident per SM at n={N}: NI {blocks[False]}, NI+INT "
          f"{blocks[True]}", flush=True)
    bounds = {}
    for label, ci, philox, bytes_ in (
            ("in-kernel NI", False, True, b * (8 + 4 + 12)),
            ("in-kernel NI+INT", True, True, b * (8 + 4 + 12)),
            ("external NI", False, False, u.numel() * 4 + b * 24)):
        ops = fused_pipe_ops(N, EPS, ci, philox)
        times = least_time_ms(ops, b, bytes_)
        by = max(times, key=times.get)
        bounds[label] = (times[by], by, times["issue"])
        print(f"[{card}] bound, {label}, B={b}, n={N}: operations per "
              f"replication by pipe {json.dumps(ops)}; least ms "
              f"{json.dumps({p: round(t, 4) for p, t in times.items()})}; "
              f"bound {times[by]:.4f} ms by {by}", flush=True)
    bound_ms, bound_pipe, issue_ms = bounds["in-kernel NI"]
    print(f"[{card}] fused_ni in-kernel mode, B={b}, n={N}: {ms:.4f} ms "
          f"({bound_ms / ms:.1%} of its bound {bound_ms:.4f} ms by "
          f"{bound_pipe}; {issue_ms / ms:.1%} of the issue bound "
          f"{issue_ms:.4f} ms); NI+INT {int_ms:.4f} ms; external mode "
          f"{ext_ms:.4f} ms ({bounds['external NI'][0] / ext_ms:.1%} of "
          f"{bounds['external NI'][0]:.4f} ms by "
          f"{bounds['external NI'][1]}); plain version {plain_ms:.4f} ms",
          flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_pipe == "bytes" else "operations",
            "max_abs_err": err[0], "within_tolerance": share,
            "bound_pipe": bound_pipe, "issue_bound_ms": issue_ms,
            "batch": b, "blocks_per_sm": blocks[False], "int_ms": int_ms,
            "int_bound_ms": bounds["in-kernel NI+INT"][0],
            "external_ms": ext_ms,
            "external_bound_ms": bounds["external NI"][0]}


def regen_times(card: str) -> dict:
    """The variant without planes, in-kernel NI, timed at n = 10⁵,
    B = 2¹⁴ and n = 10⁶, B = 2¹⁰ beside the bound of the same work (the
    function's, not the variant's second draw)."""
    from dpcorr_torch.ops import fused_ni
    from dpcorr_torch.utils import rng
    from dpcorr_torch.utils.device import time_cuda
    from dpcorr_torch.utils.roofline import fused_pipe_ops, least_time_ms

    key = rng.master_key(device="cuda")
    out = {}
    for n, b in REGEN_TIMED:
        seeds = rng.kernel_seeds(rng.rep_keys(key, b)).contiguous()
        rho_b = torch.full((b,), RHO, device="cuda")
        got = fused_ni.fused_ni_sums(seeds, rho_b, n, *EPS)
        if not torch.isfinite(got).all():
            raise RuntimeError(f"the variant without planes: NaN/Inf at "
                               f"n={n}")
        ms = time_cuda(lambda: fused_ni.fused_ni_sums(seeds, rho_b, n, *EPS),
                       3)
        times = least_time_ms(fused_pipe_ops(n, EPS, False), b,
                              b * (8 + 4 + 12))
        by = max(times, key=times.get)
        blocks = fused_ni.blocks_per_sm(n, *EPS)
        out[n] = {"batch": b, "ms": ms, "bound_ms": times[by],
                  "bound_by": by, "blocks_per_sm": blocks}
        print(f"[{card}] fused_ni without planes, in-kernel NI, n={n}, "
              f"B={b}: {ms:.4f} ms, bound {times[by]:.4f} ms by {by} "
              f"({times[by] / ms:.1%}); {blocks} blocks per SM", flush=True)
    return out


def ladder_against_plain(card: str, seeds, bits, level: int) -> float:
    """The ladder kernel at ``level`` on the external ``bits`` against its
    plain version: every replication within 1e-5 × Σ|terms| at L1-L4,
    ≥ 99% at L5, and finite. Returns the largest |error|."""
    from dpcorr_torch.ops import ladder

    got = ladder.ladder_sums(seeds, RHO, N, *EPS, level, bits)
    want = ladder.ladder_plain(bits, RHO, N, *EPS, level)
    mag = ladder.ladder_plain(bits, RHO, N, *EPS, level, magnitude=True)
    diff = (got - want).abs()
    share = (diff <= 1e-5 * mag).float().mean().item()
    err = diff.max().item()
    print(f"[{card}] ladder L{level} external on the timed bits: "
          f"{share:.4f} within 1e-5 x sum|terms| of the plain version; "
          f"max |err| {err:.4g}", flush=True)
    if not torch.isfinite(got).all() or share < (0.99 if level == 5
                                                 else 1.0):
        raise RuntimeError(f"the ladder kernel disagrees with its plain "
                           f"version at L{level}: {share} within tolerance")
    return err


def ladder_times(card: str, k1_ms: float) -> dict:
    """Each level's ms at B = 2¹⁴, n = 10⁴, in-kernel (CUDA events; L6 =
    K1 at the same shape, L7 = K1 at B = 4096), beside its bound and its
    plain version's ms on random bits of the same shape, and the increment
    from the level before."""
    from dpcorr_torch.bisect import LEVELS
    from dpcorr_torch.ops import fused_ni, ladder
    from dpcorr_torch.utils.device import time_cuda
    from dpcorr_torch.utils.roofline import ladder_pipe_ops, least_time_ms

    b = FUSED_BLOCK
    seeds = torch.stack([torch.arange(b, dtype=torch.int32),
                         torch.zeros(b, dtype=torch.int32)], 1).cuda()
    rho_b = torch.full((b,), RHO, device="cuda")
    # dpcorr-lint: ignore[rng-raw-api] — timing bits for the plain version, not DP noise
    bits = torch.randint(-2**31, 2**31, (b, ladder.bit_rows(N, *EPS), 128),
                         device="cuda", dtype=torch.int64).to(torch.int32)
    u = None
    out, prev = {}, None
    for level in range(1, 8):
        name = LEVELS[level - 1]
        reps = b if level < 7 else LADDER_BIG_B
        err = None
        if level <= 5:
            ms = time_cuda(lambda: ladder.ladder_sums(
                seeds, RHO, N, *EPS, level), 20)
            plain_ms = time_cuda(lambda: ladder.ladder_plain(
                bits, RHO, N, *EPS, level), 3)
            bytes_ = reps * (8 + 4)
            err = ladder_against_plain(card, seeds, bits, level)
        else:
            s, r = seeds[:reps], rho_b[:reps]
            ms = time_cuda(lambda: fused_ni.fused_ni_sums(s, r, N, *EPS), 20)
            if u is None:
                # dpcorr-lint: ignore[rng-raw-api] — timing uniforms for the plain version, not DP noise
                u = torch.rand(b, fused_ni.n_uniform_rows(N, *EPS), 128,
                               device="cuda") * (1 - 2e-7) + 1e-7
            plain_ms = time_cuda(lambda: fused_ni.fused_ni_plain(
                s, r, u[:reps], n=N, eps1=EPS[0], eps2=EPS[1]), 3)
            bytes_ = reps * (8 + 4 + 12)
        times = least_time_ms(ladder_pipe_ops(level, N, EPS), reps, bytes_)
        by = max(times, key=times.get)
        inc = None if prev is None or level == 7 else ms - prev
        out[name] = {"level": level, "batch": reps, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": times[by],
                     "bound_by": by, "increment_ms": inc,
                     "max_abs_err": err}
        print(f"[{card}] ladder L{level} {name}, B={reps}, n={N}, "
              f"in-kernel: {ms:.4f} ms"
              + (f" (+{inc:.4f} ms on L{level - 1})" if inc is not None
                 else "")
              + f"; bound {times[by]:.4f} ms by {by} ({times[by] / ms:.1%})"
              f"; plain version {plain_ms:.4f} ms", flush=True)
        if level <= 6:
            prev = ms
    l6 = out["full"]["ms"]
    print(f"[{card}] ladder L6 {l6:.4f} ms against K1's {k1_ms:.4f} ms "
          f"({l6 / k1_ms - 1.0:+.2%}; gate ±10%)", flush=True)
    if abs(l6 / k1_ms - 1.0) > 0.10:
        raise RuntimeError(f"ladder L6 {l6} ms is not K1's time {k1_ms} ms")
    return out


def rbg_times(card: str) -> dict:
    """The rbg_bits kernel's ms at the unfused block's shape (2¹⁴ keys ×
    2·10⁴ words), its bound and its plain version's ms on the card."""
    from dpcorr_torch.ops import _build, rbg
    from dpcorr_torch.utils import rng
    from dpcorr_torch.utils.device import time_cuda
    from dpcorr_torch.utils.roofline import (
        least_time_ms,
        rbg_bits_bytes,
        rbg_bits_ops,
    )

    keys = rng.rep_keys(rng.master_key(impl="rbg", device="cuda"),
                        RBG_TIMED_KEYS).contiguous()
    ms = time_cuda(lambda: rbg.rbg_bits(keys, RBG_WORDS), 20)
    plain_ms = time_cuda(lambda: rbg.rbg_bits_plain(keys, RBG_WORDS), 3)
    got = rbg.rbg_bits(keys, RBG_WORDS)
    err = int((got - rbg.rbg_bits_plain(keys, RBG_WORDS)).abs().max())
    del got
    print(f"[{card}] rbg_bits bit-equal to its plain version at the timed "
          f"shape: {err == 0}", flush=True)
    if err:
        raise RuntimeError(f"rbg_bits disagrees with its plain version by "
                           f"{err}")
    times = least_time_ms(rbg_bits_ops(RBG_WORDS), RBG_TIMED_KEYS,
                          rbg_bits_bytes(RBG_TIMED_KEYS, RBG_WORDS))
    by = max(("bytes", "int32"), key=times.get)
    bound = times[by]
    ptxas = _build.ptxas_report(_build.log_path("rbg_bits").read_text())
    print(f"[{card}] rbg_bits, {RBG_TIMED_KEYS} keys x {RBG_WORDS} words: "
          f"{ms:.4f} ms ({bound / ms:.1%} of its bound {bound:.4f} ms by "
          f"{by}; int32 {times['int32']:.4f} ms); plain version "
          f"{plain_ms:.4f} ms; ptxas {ptxas}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if by == "bytes" else "operations",
            "max_abs_err": err, "int32_bound_ms": times["int32"], "ptxas": list(ptxas.values()),
            "shape": [RBG_TIMED_KEYS, RBG_WORDS]}


def threefry_cases():
    """The main path's operands on the card, as ``{label: (entry, kernel
    call, plain call, words, bytes moved)}``: 2¹⁴ replication keys × 2·10⁴
    words for bits and for ``normal``'s uniforms (the unfused block's
    draw), 512 keys × 65,536 words for bits and the bounded factor's
    uniforms (a stress chunk draw), and the master key's words over 2²⁰
    replication indices for the hash (``rep_keys`` of the fused path)."""
    from dpcorr_torch.ops import threefry
    from dpcorr_torch.utils import rng

    key = rng.master_key(device="cuda")
    keys = rng.rep_keys(key, THREEFRY_KEYS).contiguous()
    stress = rng.rep_keys(rng.design_key(key, 24), STRESS_KEYS).contiguous()
    hash_ops = (key[0], key[1], 0, torch.arange(THREEFRY_FOLDS,
                                                device="cuda"))
    words = THREEFRY_KEYS * THREEFRY_WORDS
    stress_words = STRESS_KEYS * STRESS_WORDS

    def rows(entry, k, n, *bounds):
        kernel = getattr(threefry, entry)
        plain = getattr(threefry, entry + "_plain")
        return lambda: kernel(k, n, *bounds), lambda: plain(k, n, *bounds)

    return {
        "threefry_bits": (
            "threefry_bits", *rows("threefry_bits", keys, THREEFRY_WORDS),
            words, THREEFRY_KEYS * 16 + words * 8),
        "threefry_hash": (
            "threefry_hash", lambda: threefry.threefry_hash(*hash_ops),
            lambda: threefry.threefry_hash_plain(*hash_ops),
            THREEFRY_FOLDS, THREEFRY_FOLDS * (8 + 2 * 8)),
        "threefry_uniform": (
            "threefry_uniform",
            *rows("threefry_uniform", stress, STRESS_WORDS, *STRESS_BOUNDS),
            stress_words, STRESS_KEYS * 16 + stress_words * 4),
        "threefry_uniform.unfused": (
            "threefry_uniform",
            *rows("threefry_uniform", keys, THREEFRY_WORDS, *NORMAL_BOUNDS),
            words, THREEFRY_KEYS * 16 + words * 4),
        "threefry_bits.stress": (
            "threefry_bits", *rows("threefry_bits", stress, STRESS_WORDS),
            stress_words, STRESS_KEYS * 16 + stress_words * 8),
    }


def threefry_times(card: str) -> dict:
    """Each threefry case's ms at its shape, its bound (the definition's
    rotations and xors at the integer ALU's 64 a clock per SM; the int64
    or f32 stores at 3.35 TB/s) and its plain version's ms on the card."""
    from dpcorr_torch.ops import _build, threefry
    from dpcorr_torch.utils.device import time_cuda
    from dpcorr_torch.utils.roofline import CLOCK_HZ, HBM_BYTES_PER_S, SMS

    ptxas = _build.ptxas_report(_build.log_path("threefry").read_text())
    out = {"ptxas": list(ptxas.values())}
    for label, (name, kernel, plain, words, bytes_) in (
            threefry_cases().items()):
        before = threefry.KERNEL_LAUNCHES[name]
        got = kernel()
        launched = threefry.KERNEL_LAUNCHES[name] - before
        want = plain()
        if got.dtype == torch.float32:  # compare the f32 words' bits
            got, want = got.view(torch.int32), want.view(torch.int32)
        # dpcorr-lint: ignore[sync-in-loop] — a check, case by case: the count is needed on the host
        differing = int((got != want).sum())
        del got, want
        if differing or launched != 1:
            raise RuntimeError(f"{label} disagrees with its plain version "
                               f"in {differing} words, or launched "
                               f"{launched} times for one call")
        ms = time_cuda(kernel, 20)
        plain_ms = time_cuda(plain, 3)
        alu_ms = 1e3 * words * THREEFRY_ALU_OPS[name] / (64 * SMS * CLOCK_HZ)
        bytes_ms = 1e3 * bytes_ / HBM_BYTES_PER_S
        bound = max(alu_ms, bytes_ms)
        by = "operations" if alu_ms >= bytes_ms else "bytes"
        print(f"[{card}] {label}, {words} words: {ms:.4f} ms "
              f"({bound / ms:.1%} of its bound {bound:.4f} ms by {by}; "
              f"ALU {alu_ms:.4f} ms, bytes {bytes_ms:.4f} ms); plain "
              f"version {plain_ms:.4f} ms; bit-equal to it in one launch",
              flush=True)
        out[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "words_differing": differing,
                      "alu_bound_ms": alu_ms,
                      "bytes_bound_ms": bytes_ms, "words": words}
    print(f"[{card}] threefry ptxas {ptxas}", flush=True)
    return out


def main_path_launches(card: str) -> dict:
    """One unfused and one fused block of the main path (2¹⁴ replications
    at n = 10⁴ through ``sim.RepBlockPipeline``), every launch count set
    to 0 just before each and read just after. Raises unless the fused
    block launches K1 once and the unfused block not at all, the
    key-tree's hash and uniform run in the threefry kernel, every
    ``uniform`` takes it, and neither ``rbg_bits`` nor the ladder
    launches."""
    from dpcorr_torch.ops import fused_ni, ladder, rbg, threefry
    from dpcorr_torch.sim import RepBlockPipeline, fused_ni_rep_fn, ni_rep_fn
    from dpcorr_torch.utils import rng

    counters = {"": (fused_ni.KERNEL_LAUNCHES, ladder.KERNEL_LAUNCHES,
                     rbg.KERNEL_LAUNCHES, threefry.KERNEL_LAUNCHES),
                "uniform_": (rng.UNIFORM_CALLS,)}
    key = rng.master_key(device="cuda")
    out = {}
    for arm, body, chunk in (
            ("unfused", ni_rep_fn(N, RHO, *EPS), UNFUSED_CHUNK),
            ("fused", fused_ni_rep_fn(N, RHO, *EPS), FUSED_BLOCK)):
        pipe = RepBlockPipeline(body, 3, key=key, block_reps=FUSED_BLOCK,
                                chunk_size=chunk)
        for counts in (c for group in counters.values() for c in group):
            counts.update(dict.fromkeys(counts, 0))
        sums, _ = pipe.run(1)
        out[arm] = {prefix + name: n for prefix, group in counters.items()
                    for counts in group for name, n in counts.items()}
        print(f"[{card}] launches in one {arm} block of the main path: "
              f"{json.dumps(out[arm])}; sums {sums}", flush=True)
        if not all(np.isfinite(sums)):
            raise RuntimeError(f"the {arm} block's sums are not finite: "
                               f"{sums}")
    both = {name: out["unfused"][name] + out["fused"][name]
            for name in out["fused"]}
    if out["fused"]["fused_ni"] != 1 or out["unfused"]["fused_ni"]:
        raise RuntimeError(f"K1 launched {out['fused']['fused_ni']} times "
                           f"in the fused block and "
                           f"{out['unfused']['fused_ni']} in the unfused "
                           f"one: expected 1 and 0")
    if not (both["threefry_hash"] and both["threefry_uniform"]):
        raise RuntimeError(f"the main path's folds and uniforms did not "
                           f"run in the threefry kernel: {both}")
    if both["uniform_ops"] or not both["uniform_kernel"]:
        raise RuntimeError(f"a main-path uniform took torch ops: {both}")
    if both["rbg_bits"] or both["fused_ni_ladder"]:
        raise RuntimeError(f"the threefry main path launched rbg_bits or "
                           f"the ladder: {both}")
    return out


def card_tests() -> tuple:
    """``tests/test_torch_cuda.py`` in a child process that prints as it
    goes, stopped after ``CARD_TESTS_TIMEOUT_S``; returns its exit code
    (124 when stopped), its pass count (read from its JUnit report) and
    its seconds."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "card_tests.xml")
        try:
            rc = subprocess.run(
                [sys.executable, "-m", "pytest", "--noconftest", "-p",
                 "no:cacheprovider", "-rfE", f"--junitxml={report}",
                 CARD_TESTS], timeout=CARD_TESTS_TIMEOUT_S).returncode
        except subprocess.TimeoutExpired:
            rc = 124
        passed = 0
        if os.path.exists(report):
            for suite in ET.parse(report).getroot().iter("testsuite"):
                passed += int(suite.get("tests", 0)) - sum(
                    int(suite.get(k, 0))
                    for k in ("errors", "failures", "skipped"))
    return rc, passed, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from dpcorr_torch.ops import _build
    from dpcorr_torch.utils.device import card_line

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- 2. build every kernel from the checkout's sources
    t0 = time.perf_counter()
    libs = _build.build_all()
    each = {k: round(v, 2) for k, v in _build.BUILD_SECONDS.items()}
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s, each "
          f"{json.dumps(each)}", flush=True)
    report = fused_ni_ptxas()
    ladder_ptxas = ladder_levels_ptxas()

    # ---- 3. the kernel table
    k1 = k1_times(card)
    regen = regen_times(card)
    levels = ladder_times(card, k1["ms"])
    for name, t in levels.items():
        t["ptxas"] = ladder_ptxas.get(name)
    top = levels["matmul"]
    rbg_t = rbg_times(card)
    tf_t = threefry_times(card)
    launches = main_path_launches(card)
    by_block = {arm: {name: n for name, n in counts.items() if n}
                for arm, counts in launches.items()}

    def on_main_path(*names):
        return sum(launches[arm][name] for arm in launches
                   for name in names)

    print(json.dumps({"kernels": [{
        "name": "fused_ni", "route": "cuda",
        "source": "dpcorr_torch/csrc/fused_ni.cu",
        "replaces": "dpcorr/ops/pallas_ni.py:280", **k1, "library_ms": None,
        "main_path_launches": on_main_path("fused_ni"),
        "ptxas_main": dict(zip(("registers", "stack", "spill_stores",
                                "spill_loads"), report[MAIN_VARIANT])),
        "regen": {str(n): t for n, t in regen.items()},
    }, {
        "name": "fused_ni_ladder", "route": "cuda",
        "source": "dpcorr_torch/csrc/fused_ni_ladder.cu",
        "replaces": "benchmarks/pallas_bisect.py:100",
        "main_path_launches": on_main_path("fused_ni_ladder"),
        "max_abs_err": max(t["max_abs_err"] for name, t in levels.items()
                           if t["max_abs_err"] is not None
                           and name != "prng"),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": "bytes" if top["bound_by"] == "bytes" else "operations",
        "library_ms": None, "batch": top["batch"], "levels": levels,
    }, {
        "name": "rbg_bits", "route": "cuda",
        "source": "dpcorr_torch/csrc/rbg_bits.cu",
        "main_path_launches": on_main_path("rbg_bits"),
        "replaces": "dpcorr/utils/rng.py:32 (lax.rng_bit_generator under "
                    "jax.random.bits on rbg-family keys; an XLA op)",
        **rbg_t, "library_ms": None,
    }, {
        "name": "threefry", "route": "cuda",
        "source": "dpcorr_torch/csrc/threefry.cu",
        "replaces": "dpcorr/utils/rng.py (threefry_2x32 under jax.random "
                    "on threefry2x32 keys; integer ops under XLA)",
        **tf_t["threefry_bits"], "library_ms": None,
        "main_path_launches": on_main_path(
            "threefry_bits", "threefry_hash", "threefry_uniform"),
        "words_differing": sum(
            t["words_differing"] for label, t in tf_t.items()
            if label != "ptxas"),
        "shape": [THREEFRY_KEYS, THREEFRY_WORDS],
        "hash": {**tf_t["threefry_hash"], "library_ms": None},
        "uniform": {**tf_t["threefry_uniform"], "library_ms": None,
                    "shape": [STRESS_KEYS, STRESS_WORDS],
                    "unfused": tf_t["threefry_uniform.unfused"],
                    "bits_at_this_shape": tf_t["threefry_bits.stress"]},
        "ptxas": tf_t["ptxas"],
    }], "main_path_launches_by_block": by_block}), flush=True)

    # ---- 4. the card tests
    rc, passed, seconds = card_tests()
    print(f"[{card}] card tests ({CARD_TESTS}): {passed} passed in "
          f"{seconds:.1f} s, rc {rc}", flush=True)
    if rc != 0:
        raise RuntimeError(f"the card tests failed (rc {rc})")

    # ---- 5. the device line
    print(f"smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
