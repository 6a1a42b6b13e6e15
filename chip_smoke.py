#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dpcorr_torch``) on one NVIDIA card.

Drives the port's main path, the Monte-Carlo replication loop of the
north-star workload (n = 10⁴ Gaussian pair → NI sign-batch estimate + CI →
(se², cover, ci_len); ε = (1, 1), ρ = 0.5, α = 0.05), end to end:

1. card name and power limit (``nvidia-smi``);
2. builds every kernel from ``dpcorr_torch/csrc`` (one ``nvcc`` per source,
   started together) and prints what ``ptxas`` reports for each variant
   (registers, stack frame, spills; the main-path variant must not spill);
3. holds the fused kernel against its plain PyTorch version in all 16
   modes (8 flag combinations × external or in-kernel uniforms) at every
   lane-group layout the kernel branches on (m' = 1, 8, 16 with leftovers,
   32, 64, 128; n = 1000 and 20,000), and near the shared-memory cap,
   where the kernel draws the batch noise in its sweep (m' = 1, 2, 4, 8,
   64, 128), B = 256: external mode on random uniforms, and in-kernel
   mode, which must equal external mode on ``philox_uniforms`` (its draws
   laid out) bit for bit;
4. the unfused path: ``RepBlockPipeline`` on the key-tree, 2¹⁶ reps;
5. the fused path: the same pipeline through the kernel's in-kernel
   Philox mode, 2²⁰ reps, and ``sim_detail_fused`` (NI + INT), 2¹⁶ reps,
   with the kernel's launch count read around this phase;
6. gates: coverage in [0.90, 0.99] on every path; fused against unfused
   mse and ci_len within 5% and coverage within 0.01; fused INT against
   the unfused ``run_sim_one``; launches > 0;
7. times: the kernel at the main path's launch shape (CUDA events), its
   plain version on the same replications, blocks resident per SM, and
   the least time the card could take for the same work, by pipe and by
   issue slots.

Every failure raises. The last line is the device record; before it come
the per-kernel JSON record and the card line. Run from the repository
root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import re
import sys
import time

import torch

N, EPS, RHO, ALPHA = 10_000, (1.0, 1.0), 0.5, 0.05
UNFUSED_REPS = 1 << 16
FUSED_BLOCK = 1 << 14          # replications per kernel launch on the main path
FUSED_BLOCKS = 64              # 2^20 replications
DETAIL_REPS = 1 << 16
COMPARE_B = 256
INT_REF_REPS = 1 << 13

#: (n, ε) of each lane-group layout the kernel branches on: m' = 1, 8,
#: 16 (m = 11, with leftovers), 32, 64, 128, and n = 1000 and 20,000
COMPARE_GEOMETRIES = [
    (10_000, (4.0, 2.0)), (10_000, (1.0, 1.0)), (9_000, (1.5, 0.5)),
    (10_000, (0.5, 0.5)), (10_000, (0.5, 0.25)), (10_000, (0.25, 0.25)),
    (1_000, (1.0, 1.0)), (20_000, (1.0, 1.0)),
]
#: (n, ε, compute_int) where the batch noise does not fit beside the
#: planes, so the sweep draws it: m' = 1 and 8 at the cap on n (NI and
#: INT), m' = 2, 4, 64, 128
NOISE_IN_SWEEP = [
    (28_000, (4.0, 2.0), False), (25_000, (4.0, 2.0), True),
    (20_000, (2.0, 2.0), False), (20_000, (2.0, 2.0), True),
    (24_000, (1.5, 1.5), False), (24_000, (1.5, 1.5), True),
    (28_000, (1.0, 1.0), False), (25_000, (1.0, 1.0), True),
    (28_000, (0.5, 0.25), False), (28_000, (0.25, 0.25), False),
]

# H100 SXM (NVIDIA data sheet, 700 W): memory rate, SMs, and the boost
# clock behind its 67 TFLOP/s f32 (132 SMs x 128 FMA x 2 x 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
SMS = 132
CLOCK_HZ = 1.98e9
# Results per SM per clock on compute capability 9.0 (CUDA C++
# Programming Guide, throughput of arithmetic instructions): f32 add,
# multiply and FMA; 32-bit integer add, logic, shift, compare, min/max and
# multiply; conversions and special functions. Four warp-instructions
# issue per clock.
PIPE_RATES = {"f32": 128, "int32": 64, "sfu": 16}
ISSUE_RATE = 4 * 32

#: the main-path variant's template flags (external, INT, ndtri, normalise,
#: noise in shared memory)
MAIN_VARIANT = (0, 0, 0, 1, 1)


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
    ``reps`` replications, at the rates above."""
    clocks = SMS * CLOCK_HZ
    times = {pipe: 1e3 * reps * ops[pipe] / (rate * clocks)
             for pipe, rate in PIPE_RATES.items()}
    times["issue"] = 1e3 * reps * sum(ops.values()) / (ISSUE_RATE * clocks)
    times["bytes"] = 1e3 * bytes_ / HBM_BYTES_PER_S
    return times


def ptxas_report(log: str) -> dict:
    """``{(external, int, ndtri, normalise, noise in shared memory):
    (registers, stack frame, spill stores, spill loads)}`` for each
    kernel variant, from ``nvcc -Xptxas=-v`` output."""
    report, entry, frame = {}, None, (0, 0, 0)
    for line in log.splitlines():
        if hit := re.search(r"Compiling entry function '(\S+)'", line):
            entry, frame = hit.group(1), (0, 0, 0)
        elif hit := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", line):
            frame = tuple(int(v) for v in hit.groups())
        elif (hit := re.search(r"Used (\d+) registers", line)) and entry:
            flags = tuple(int(v) for v in re.findall(r"Lb([01])E", entry))
            report[flags] = (int(hit.group(1)), *frame)
            entry = None
    return report


def mode_label(flags) -> str:
    ext, ci, nd, norm, noise_smem = flags
    return (f"{'external' if ext else 'philox'} {'NI+INT' if ci else 'NI'} "
            f"{'ndtri' if nd else 'boxmuller'} "
            f"{'normalise' if norm else 'raw'} "
            f"noise in {'smem' if noise_smem else 'sweep'}")


def compare_mode(n: int, eps, kw: dict, gen, rho):
    """One mode at one geometry, B = ``COMPARE_B``: per uniform source
    (external random, in-kernel Philox laid out by its plain twin) the
    share of replications within tolerance of the plain version and the
    largest |error| per output; and whether in-kernel mode equals external
    mode on ``philox_uniforms`` bit for bit."""
    from dpcorr_torch.ops import fused_ni

    rows = fused_ni.n_uniform_rows(n, *eps, kw["compute_int"])
    u = torch.rand(COMPARE_B, rows, 128, device="cuda",
                   generator=gen) * (1 - 2e-7) + 1e-7
    zeros = torch.zeros(COMPARE_B, 2, dtype=torch.int32, device="cuda")
    seeds = torch.randint(-2**31, 2**31, (COMPARE_B, 2), generator=gen,
                          device="cuda", dtype=torch.int64).to(torch.int32)
    pu = fused_ni.philox_uniforms(seeds, n, *eps, kw["compute_int"],
                                  kw["normalise"])
    fracs, errs = [], []
    for sd, uu in ((zeros, u), (seeds, pu)):
        got = fused_ni.fused_ni_sums(sd, rho, n, *eps, uniforms=uu, **kw)
        torch.cuda.synchronize()
        want = fused_ni.fused_ni_plain(sd, rho, uu, n=n, eps1=eps[0],
                                       eps2=eps[1], **kw)
        if not torch.isfinite(got).all():
            raise RuntimeError(f"kernel gave NaN/Inf: n={n} eps={eps} {kw}")
        close = torch.isclose(got[:, :2], want[:, :2], rtol=1e-4,
                              atol=0.0).all(1)
        close &= torch.isclose(got[:, 2], want[:, 2], rtol=0.0, atol=1e-5)
        fracs.append(close.float().mean().item())
        errs.append((got - want).abs().max(0).values.tolist())
    inside = fused_ni.fused_ni_sums(seeds, rho, n, *eps, **kw)
    torch.cuda.synchronize()
    return fracs, errs, torch.equal(inside, got)


def compare_kernel_with_plain() -> float:
    """Phase 3: the kernel against its plain version in all 16 modes at
    every geometry of ``COMPARE_GEOMETRIES`` and ``NOISE_IN_SWEEP``.
    Returns the largest |ΣT| error seen."""
    from dpcorr_torch.ops import fused_ni

    gen = torch.Generator(device="cuda").manual_seed(2025)
    rho = torch.linspace(-0.6, 0.9, COMPARE_B, device="cuda")
    worst = 0.0
    cases = [(n, eps, ci) for n, eps in COMPARE_GEOMETRIES
             for ci in (False, True)] + NOISE_IN_SWEEP
    for n, eps, compute_int in cases:
        m, m_pad, k, leftover, _ = fused_ni.layout(n, *eps)
        noise_smem = fused_ni._Consts(n, *eps, (0.0, 0.0), (1.0, 1.0)
                                      ).noise_in_smem(compute_int)
        if (n, eps, compute_int) in NOISE_IN_SWEEP and noise_smem:
            raise RuntimeError(f"n={n} eps={eps} int={compute_int} keeps "
                               f"its noise in shared memory")
        for gauss in ("boxmuller", "ndtri"):
            for normalise in (True, False):
                kw = dict(normalise=normalise, compute_int=compute_int,
                          gauss=gauss)
                fracs, errs, bit_equal = compare_mode(n, eps, kw, gen, rho)
                worst = max(worst, errs[0][0], errs[1][0])
                print(f"compare n={n} eps={eps} m={m} m'={m_pad} k={k} "
                      f"left={leftover} int={int(compute_int)} {gauss} "
                      f"norm={int(normalise)} noise in "
                      f"{'smem' if noise_smem else 'sweep'}: within tol "
                      f"external {fracs[0]:.4f} philox {fracs[1]:.4f} of "
                      f"{COMPARE_B}; in-kernel == external on "
                      f"philox_uniforms: {bit_equal}; max |err| "
                      f"{[f'{e:.3g}' for e in errs[0] + errs[1]]}",
                      flush=True)
                if min(fracs) < 0.99:
                    raise RuntimeError(
                        f"kernel disagrees with its plain version: {fracs} "
                        f"within tolerance, n={n} eps={eps} {kw}")
                if not bit_equal:
                    raise RuntimeError(
                        f"in-kernel mode differs from external mode on "
                        f"philox_uniforms: n={n} eps={eps} {kw}")
    return worst


def run_pipeline(body, block_reps, chunk, n_blocks, key):
    from dpcorr_torch.sim import RepBlockPipeline

    pipe = RepBlockPipeline(body, 3, key=key, block_reps=block_reps,
                            chunk_size=chunk)
    pipe.run(1, start_block=10_000)  # warm: allocator, first launches
    t0 = time.perf_counter()
    sums, n_reps = pipe.run(n_blocks)
    dt = time.perf_counter() - t0
    if pipe.fetches != 2:
        raise RuntimeError(f"expected one host read per run, saw "
                           f"{pipe.fetches} over two runs")
    mse, cover, ci_len = (s / n_reps for s in sums)
    return {"reps": n_reps, "seconds": dt, "reps_per_s": n_reps / dt,
            "mse": mse, "coverage": cover, "ci_length": ci_len}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from dpcorr_torch.ops import _build, fused_ni
    from dpcorr_torch.sim import (
        DETAIL_FIELDS,
        SimConfig,
        fused_ni_rep_fn,
        ni_rep_fn,
        run_sim_one,
        sim_detail_fused,
    )
    from dpcorr_torch.utils import rng
    from dpcorr_torch.utils.device import card_line, time_cuda

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- 2. build every kernel from the checkout's sources
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    log = _build.log_path("fused_ni")
    if not log.exists():
        raise RuntimeError(f"no compiler report beside this build of "
                           f"fused_ni ({log}); remove its library to rebuild")
    report = ptxas_report(log.read_text())
    for flags, (regs, stack, st, ld) in sorted(report.items()):
        print(f"ptxas fused_ni [{mode_label(flags)}]: {regs} registers, "
              f"{stack} bytes stack frame, {st} bytes spill stores, {ld} "
              f"bytes spill loads", flush=True)
    if len(report) != 32:
        raise RuntimeError(f"ptxas reported {len(report)} fused_ni "
                           f"variants, expected 32")
    if any(report[MAIN_VARIANT][2:]):
        raise RuntimeError(f"the main-path variant spills: "
                           f"{report[MAIN_VARIANT]}")

    # ---- 3. kernel against its plain version (these launches do not count)
    worst_err = compare_kernel_with_plain()

    # ---- 4-5. the main path, unfused then fused: every launch count is
    # set to 0 just before and read just after
    for name in fused_ni.KERNEL_LAUNCHES:
        fused_ni.KERNEL_LAUNCHES[name] = 0
    key = rng.master_key(device="cuda")
    unfused = run_pipeline(ni_rep_fn(N, RHO, *EPS, ALPHA), 1 << 14, 1 << 11,
                           UNFUSED_REPS >> 14, key)
    print(f"[{card}] unfused pipeline: {json.dumps(unfused)}", flush=True)

    fused = run_pipeline(fused_ni_rep_fn(N, RHO, *EPS, ALPHA), FUSED_BLOCK,
                         FUSED_BLOCK, FUSED_BLOCKS, key)
    keys = rng.rep_keys(rng.design_key(key, 777), DETAIL_REPS)
    t0 = time.perf_counter()
    detail = sim_detail_fused(rng.kernel_seeds(keys).contiguous(), RHO, N,
                              *EPS, alpha=ALPHA)
    torch.cuda.synchronize()
    detail_s = time.perf_counter() - t0
    launches = dict(fused_ni.KERNEL_LAUNCHES)
    print(f"[{card}] fused pipeline: {json.dumps(fused)}", flush=True)
    d = {f: v.double().mean().item() for f, v in zip(DETAIL_FIELDS, detail)}
    print(f"[{card}] sim_detail_fused {DETAIL_REPS} reps in {detail_s:.3f} s:"
          f" {json.dumps(d)}", flush=True)
    print(f"launches in the main path's run: {launches}", flush=True)

    # ---- 6. gates
    for field in DETAIL_FIELDS:
        col = dict(zip(DETAIL_FIELDS, detail))[field]
        if tuple(col.shape) != (DETAIL_REPS,) or not torch.isfinite(col).all():
            raise RuntimeError(f"sim_detail_fused {field}: bad values")
    for label, cov in (("unfused", unfused["coverage"]),
                       ("fused", fused["coverage"]),
                       ("fused NI detail", d["ni_cover"]),
                       ("fused INT detail", d["int_cover"])):
        if not 0.90 <= cov <= 0.99:
            raise RuntimeError(f"{label} coverage {cov} outside [0.90, 0.99]")
    for metric in ("mse", "ci_length"):
        rel = abs(fused[metric] / unfused[metric] - 1.0)
        print(f"fused/unfused {metric}: relative difference {rel:.5f}",
              flush=True)
        if rel > 0.05:
            raise RuntimeError(f"fused {metric} differs from unfused by "
                               f"{rel:.4f} > 0.05")
    if abs(fused["coverage"] - unfused["coverage"]) > 0.01:
        raise RuntimeError("fused and unfused coverage differ by > 0.01")
    ref = run_sim_one(SimConfig(n=N, rho=RHO, eps1=EPS[0], eps2=EPS[1],
                                b=INT_REF_REPS, alpha=ALPHA,
                                chunk_size=1 << 11)).summary["INT"]
    print(f"[{card}] unfused run_sim_one INT ({INT_REF_REPS} reps): "
          f"{json.dumps(ref)}", flush=True)
    if abs(d["int_cover"] - ref["coverage"]) > 0.02:
        raise RuntimeError("fused INT coverage differs from unfused by > 0.02")
    if abs(d["int_ci_len"] / ref["ci_length"] - 1.0) > 0.05:
        raise RuntimeError("fused INT ci_length differs from unfused by > 5%")
    if abs(d["int_se2"] / ref["mse"] - 1.0) > 0.15:
        raise RuntimeError("fused INT mse differs from unfused by > 15%")
    if launches["fused_ni"] <= 0:
        raise RuntimeError("the main path never launched the fused kernel")

    # ---- 7. times at the main path's launch shape
    b = FUSED_BLOCK
    seeds = rng.kernel_seeds(rng.rep_keys(key, b)).contiguous()
    rho_b = torch.full((b,), RHO, device="cuda")
    ms = time_cuda(lambda: fused_ni.fused_ni_sums(seeds, rho_b, N, *EPS), 20)
    int_ms = time_cuda(lambda: fused_ni.fused_ni_sums(
        seeds, rho_b, N, *EPS, compute_int=True), 10)
    rows = fused_ni.n_uniform_rows(N, *EPS)
    u = torch.rand(b, rows, 128, device="cuda") * (1 - 2e-7) + 1e-7
    ext_ms = time_cuda(lambda: fused_ni.fused_ni_sums(seeds, rho_b, N, *EPS,
                                                      uniforms=u), 10)
    plain_ms = time_cuda(lambda: fused_ni.fused_ni_plain(
        seeds, rho_b, u, n=N, eps1=EPS[0], eps2=EPS[1]), 3)
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
    record = {"kernels": [{
        "name": "fused_ni",
        "route": "cuda",
        "source": "dpcorr_torch/csrc/fused_ni.cu",
        "replaces": "dpcorr/ops/pallas_ni.py:280",
        "launches": launches["fused_ni"],
        "max_abs_err": worst_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_pipe == "bytes" else "operations",
        "library_ms": None,
        "bound_pipe": bound_pipe,
        "issue_bound_ms": issue_ms,
        "batch": b,
        "blocks_per_sm": blocks[False],
        "ptxas_main": dict(zip(("registers", "stack", "spill_stores",
                                "spill_loads"), report[MAIN_VARIANT])),
        "int_ms": int_ms,
        "int_bound_ms": bounds["in-kernel NI+INT"][0],
        "external_ms": ext_ms,
        "external_bound_ms": bounds["external NI"][0],
    }]}
    print(json.dumps(record), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
