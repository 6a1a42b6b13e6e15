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
   issue slots;
8. the sub-Gaussian and streaming paths (no kernel of their own: torch
   ops on the key-tree), each driven with the launch counts set to 0
   just before it and read just after:
   (a) card against CPU on the same keys: ``permutation`` and the
       bounded-factor data bit for bit, and ``_one_rep`` for the subG grid
       pair, the real-data pair and the streaming pair within 1e-5 for
       ≥ 99% of 256 replications;
   (b) the acceptance points ``subg_factor`` (det and mc) and
       ``subg_real`` (det) through ``run_sim_one``, 2¹⁸ replications
       each, against the JAX package's committed coverage at B ≈ 10⁶:
       |Δ coverage| ≤ 0.003, ci_length within 1%, mse within 3%;
   (c) full width: ``RepBlockPipeline`` over the subG body at
       n = 12,000, ε = (1.5, 0.5), 2¹⁶ replications: NI coverage in
       [0.90, 0.99], one host read per run, reps/s;
   (d) streaming: n = 10⁶, ``stream_n_chunk`` = 65536, the subG pair,
       2048 replications: finite values, NI coverage in [0.90, 0.99],
       reps/s. The INT estimator's receiver clips its products at
       λ_r = 30, which biases η̂ by about −0.031 at every n ≥ 403 (the
       JAX package's construction, replication by replication:
       ``tests/test_torch_sim.py``); at n = 10⁶ its CI is 0.034 wide, so
       it covers ρ in about 5% of replications. Its gates are therefore
       against the materialized path of (b) in the same run: bias within
       0.003, and ci_length within 2% of (b)'s scaled by √(4000/n).

Every failure raises. The last line is the device record; before it come
the per-kernel JSON record and the card line. Run from the repository
root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import math
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

#: the JAX package's committed coverage at B ≈ 10⁶ for the sub-Gaussian
#: acceptance points (dpcorr/acceptance.py:109-130), copied here so the
#: script reads nothing of the JAX package: benchmarks/results/
#: acceptance_r02.json, points "subg_factor" det and mc (b = 1,015,808),
#: and benchmarks/results/acceptance_r03_subg_real.json, point
#: "subg_real" det (b = 1,048,576)
SUBG_POINT = dict(n=4000, rho=0.5, eps1=1.0, eps2=1.0,
                  dgp="bounded_factor", use_subg=True)
_NI_FACTOR = {"coverage": 0.9507869597404234, "mse": 0.33798967205709024,
              "ci_length": 1.4930936636463288}
ACCEPTANCE = {
    "subg_factor det": (SUBG_POINT, {
        "NI": _NI_FACTOR,
        "INT": {"coverage": 0.9415470246345766, "mse": 0.02039640261641433,
                "ci_length": 0.5391578020588044}}),
    "subg_factor mc": (dict(SUBG_POINT, mixquant_mode="mc"), {
        "NI": _NI_FACTOR,
        "INT": {"coverage": 0.9396736391129032, "mse": 0.02039640261641433,
                "ci_length": 0.5365214145952656}}),
    "subg_real det": (dict(SUBG_POINT, subg_variant="real"), {
        "NI": {"coverage": 0.9502944946289062, "mse": 0.3388798236846924,
               "ci_length": 1.492500677704811},
        "INT": {"coverage": 0.9500713348388672, "mse": 0.04646471468731761,
                "ci_length": 0.8032669238746166}}),
}
ACCEPTANCE_REPS = 1 << 18
#: card-against-CPU configurations of phase 8a, 256 replications each
PARITY = {
    "subg-grid": SUBG_POINT,
    "subg-real": dict(SUBG_POINT, subg_variant="real"),
    "stream-subg": dict(SUBG_POINT, n=40_000, stream_n_chunk=8192),
}
PARITY_REPS = 256
FULL_WIDTH = dict(n=12_000, rho=0.5, eps1=1.5, eps2=0.5,
                  dgp="bounded_factor", use_subg=True)
FULL_WIDTH_REPS, FULL_WIDTH_BLOCK = 1 << 16, 1 << 14
STREAM = dict(n=10**6, rho=0.5, eps1=1.0, eps2=1.0, dgp="bounded_factor",
              use_subg=True, stream_n_chunk=65536)
STREAM_REPS = 2048
#: replications resident per chunk on the materialized subG path
SUBG_CHUNK = 8192

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


def run_pipeline(body, block_reps, chunk, n_blocks, key, out_len=3):
    from dpcorr_torch.sim import DETAIL_FIELDS, RepBlockPipeline

    pipe = RepBlockPipeline(body, out_len, key=key, block_reps=block_reps,
                            chunk_size=chunk)
    pipe.run(1, start_block=10_000)  # warm: allocator, first launches
    t0 = time.perf_counter()
    sums, n_reps = pipe.run(n_blocks)
    dt = time.perf_counter() - t0
    if pipe.fetches != 2:
        raise RuntimeError(f"expected one host read per run, saw "
                           f"{pipe.fetches} over two runs")
    out = {"reps": n_reps, "seconds": dt, "reps_per_s": n_reps / dt}
    if out_len == 3:
        mse, cover, ci_len = (s / n_reps for s in sums)
        return {**out, "mse": mse, "coverage": cover, "ci_length": ci_len}
    return {**out, **{f: s / n_reps for f, s in zip(DETAIL_FIELDS, sums,
                                                      strict=True)}}


def reset_launches() -> None:
    from dpcorr_torch.ops import fused_ni

    for name in fused_ni.KERNEL_LAUNCHES:
        fused_ni.KERNEL_LAUNCHES[name] = 0


def read_launches(label: str) -> dict:
    from dpcorr_torch.ops import fused_ni

    launches = dict(fused_ni.KERNEL_LAUNCHES)
    print(f"launches in the {label} run: {launches} (the path has no kernel "
          f"of its own)", flush=True)
    return launches


def detail_agreement(got, want) -> float:
    """Share of replications whose 12 detail fields agree: 1e-5 absolute,
    and 1e-6 relative on the squared errors, which magnify ρ̂'s last bits
    by 2|ρ̂ − ρ|."""
    from dpcorr_torch.sim import DETAIL_FIELDS

    ok = torch.ones(got[0].shape[0], dtype=torch.bool)
    for name, g, w in zip(DETAIL_FIELDS, got, want, strict=True):
        rtol = 1e-6 if name.endswith("se2") else 0.0
        ok &= torch.isclose(g.cpu(), w.cpu(), rtol=rtol, atol=1e-5)
    return ok.float().mean().item()


def card_against_cpu(card: str) -> None:
    """Phase 8a: the same keys through the card and the CPU."""
    from dpcorr_torch.models.dgp import gen_bounded_factor
    from dpcorr_torch.sim import SimConfig, _one_rep
    from dpcorr_torch.utils import rng

    for n, seed in ((4000, 1), (10_000, 98)):
        keys = rng.rep_keys(rng.master_key(seed), 64)
        perm = torch.equal(rng.permutation(keys.cuda(), n).cpu(),
                           rng.permutation(keys, n))
        data = torch.equal(gen_bounded_factor(keys.cuda(), n, 0.5).cpu(),
                           gen_bounded_factor(keys, n, 0.5))
        print(f"[{card}] card == CPU at n={n}, seed {seed}: permutation "
              f"{perm}, bounded-factor data {data}", flush=True)
        if not (perm and data):
            raise RuntimeError(f"card and CPU differ at n={n}: permutation "
                               f"{perm}, bounded-factor data {data}")
    keys = rng.rep_keys(rng.master_key(), PARITY_REPS)
    for name, kw in PARITY.items():
        cfg = SimConfig(**kw, b=PARITY_REPS)
        share = detail_agreement(_one_rep(keys.cuda(), cfg.rho, cfg),
                                 _one_rep(keys, cfg.rho, cfg))
        print(f"[{card}] _one_rep {name}: card agrees with CPU on "
              f"{share:.4f} of {PARITY_REPS} replications", flush=True)
        if share < 0.99:
            raise RuntimeError(f"_one_rep {name}: card agrees with CPU on "
                               f"only {share:.4f} of replications")


def acceptance_points(card: str) -> dict:
    """Phase 8b: the subG acceptance points against the committed
    coverage of the JAX package. Returns each point's summary."""
    from dpcorr_torch.sim import SimConfig, run_sim_one

    summaries = {}
    for label, (kw, ref) in ACCEPTANCE.items():
        cfg = SimConfig(**kw, b=ACCEPTANCE_REPS, chunk_size=SUBG_CHUNK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = run_sim_one(cfg).summary
        dt = time.perf_counter() - t0
        summaries[label] = summary
        print(f"[{card}] acceptance {label}, B={ACCEPTANCE_REPS}, "
              f"{dt:.3f} s ({ACCEPTANCE_REPS / dt:.1f} reps/s): "
              f"{json.dumps(summary)}", flush=True)
        for meth in ("NI", "INT"):
            got, want = summary[meth], ref[meth]
            gaps = {"coverage": abs(got["coverage"] - want["coverage"]),
                    "ci_length": abs(got["ci_length"] / want["ci_length"]
                                     - 1.0),
                    "mse": abs(got["mse"] / want["mse"] - 1.0)}
            print(f"acceptance {label} {meth}: |Δ coverage| "
                  f"{gaps['coverage']:.5f} (≤ 0.003), ci_length "
                  f"{gaps['ci_length']:.2%} (≤ 1%), mse {gaps['mse']:.2%} "
                  f"(≤ 3%) from the JAX package at B ≈ 10⁶", flush=True)
            if (gaps["coverage"] > 0.003 or gaps["ci_length"] > 0.01
                    or gaps["mse"] > 0.03):
                raise RuntimeError(f"acceptance {label} {meth} outside its "
                                   f"gates: {gaps}")
    return summaries


def full_width(card: str) -> dict:
    """Phase 8c: the block pipeline over the subG body at n = 12,000."""
    from dpcorr_torch.sim import DETAIL_FIELDS, SimConfig, _one_rep
    from dpcorr_torch.utils import rng

    cfg = SimConfig(**FULL_WIDTH)
    res = run_pipeline(lambda k: _one_rep(k, cfg.rho, cfg),
                       FULL_WIDTH_BLOCK, SUBG_CHUNK,
                       FULL_WIDTH_REPS // FULL_WIDTH_BLOCK,
                       rng.master_key(device="cuda"), len(DETAIL_FIELDS))
    print(f"[{card}] subG pipeline n={cfg.n} eps=({cfg.eps1}, {cfg.eps2}) "
          f"bounded_factor: {json.dumps(res)}", flush=True)
    if not 0.90 <= res["ni_cover"] <= 0.99:
        raise RuntimeError(f"full-width NI coverage {res['ni_cover']} "
                           f"outside [0.90, 0.99]")
    return res


def streaming(card: str, materialized: dict) -> dict:
    """Phase 8d: the streaming subG pair at n = 10⁶; ``materialized`` is
    the INT summary of phase 8b's ``subg_factor det`` point."""
    from dpcorr_torch.sim import DETAIL_FIELDS, SimConfig, run_sim_one
    from dpcorr_torch.sim import stress_chunk_size

    cfg = SimConfig(**STREAM, b=STREAM_REPS,
                    chunk_size=stress_chunk_size(STREAM_REPS, True))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_sim_one(cfg)
    dt = time.perf_counter() - t0
    out = {"reps": STREAM_REPS, "seconds": dt,
           "reps_per_s": STREAM_REPS / dt, "chunk": cfg.chunk_size,
           **res.summary}
    print(f"[{card}] streaming n={cfg.n} n_chunk={cfg.stream_n_chunk} subG "
          f"pair: {json.dumps(out)}", flush=True)
    for name in DETAIL_FIELDS:
        if not torch.isfinite(res.detail[name]).all():
            raise RuntimeError(f"streaming {name}: non-finite values")
    if not 0.90 <= res.summary["NI"]["coverage"] <= 0.99:
        raise RuntimeError(f"streaming NI coverage outside [0.90, 0.99]: "
                           f"{res.summary['NI']}")
    it = res.summary["INT"]
    bias_gap = abs(it["bias"] - materialized["bias"])
    len_gap = abs(it["ci_length"] / (materialized["ci_length"]
                                     * math.sqrt(SUBG_POINT["n"] / cfg.n))
                  - 1.0)
    print(f"streaming INT against the materialized path at n="
          f"{SUBG_POINT['n']}: |Δ bias| {bias_gap:.5f} (≤ 0.003), ci_length "
          f"{len_gap:.2%} from √n scaling (≤ 2%)", flush=True)
    if bias_gap > 0.003 or len_gap > 0.02:
        raise RuntimeError(f"streaming INT differs from the materialized "
                           f"path: |Δ bias| {bias_gap}, ci_length {len_gap}")
    return out


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

    # ---- 8. the sub-Gaussian and streaming paths, each driven with the
    # launch counts set to 0 just before it and read just after
    t0 = time.perf_counter()
    reset_launches()
    card_against_cpu(card)
    read_launches("card-against-CPU")
    reset_launches()
    accepted = acceptance_points(card)
    read_launches("subG acceptance")
    reset_launches()
    full_width(card)
    read_launches("subG full-width")
    reset_launches()
    streaming(card, accepted["subg_factor det"]["INT"])
    read_launches("streaming")
    print(f"sub-Gaussian and streaming phases: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

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
