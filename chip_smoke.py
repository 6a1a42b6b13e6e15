#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dpcorr_torch``) on one NVIDIA card.

Drives the port's main path, the Monte-Carlo replication loop of the
north-star workload (n = 10⁴ Gaussian pair → NI sign-batch estimate + CI →
(se², cover, ci_len); ε = (1, 1), ρ = 0.5, α = 0.05), end to end:

1. card name and power limit (``nvidia-smi``);
2. builds every kernel from ``dpcorr_torch/csrc`` (one ``nvcc`` per source,
   started together);
3. holds the fused kernel against its plain PyTorch version on identical
   uniforms, in all 8 flag combinations at ε = (1, 1) and at ε = (1.5, 0.5),
   B = 256, n = 10⁴;
4. the unfused path: ``RepBlockPipeline`` on the key-tree, 2¹⁶ reps;
5. the fused path: the same pipeline through the kernel's in-kernel
   Philox mode, 2²⁰ reps, and ``sim_detail_fused`` (NI + INT), 2¹⁶ reps,
   with the kernel's launch count read around this phase;
6. gates: coverage in [0.90, 0.99] on every path; fused against unfused
   mse and ci_len within 5% and coverage within 0.01; fused INT against
   the unfused ``run_sim_one``; launches > 0;
7. times: the kernel at the main path's launch shape (CUDA events), its
   plain version on the same replications, and the least time the card
   could take for the same work.

Every failure raises. The last line is the device record, the line before
it the per-kernel JSON record. Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
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

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): the memory
# rate and the f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def fused_ops_per_rep(n: int, eps, compute_int: bool, gauss: str,
                      philox: bool = True) -> float:
    """Operations of one in-kernel-mode replication, counted from the
    source of csrc/fused_ni.cu at one per arithmetic, logical or compare
    operator and one per call of logf, log1pf, sqrtf or sincosf. Integer
    operations are counted at the f32 rate, which can only lower the
    bound."""
    from dpcorr_torch.ops.fused_ni import layout

    k = layout(n, *eps)[2]
    # in-kernel mode: 4 mul, 4 xor, 2 key adds a round, 10 rounds, then
    # shift, and, convert, add, mul per uniform; external mode reads them
    philox, unit = (10 * 10, 5) if philox else (0, 0)
    gen = (3 * (8 + 2 * 9) if gauss == "ndtri"  # two rational chains + tail
           else 1 + 2 + 1 + 1 + 2)       # log, 2 mul, sqrt, sincos, 2 mul
    per_pos = (philox + 3 * unit + gen + 7   # Cholesky
               + 4 + 2 + 2)                  # clip, sums, pad test
    per_pos += 6                             # pass 2: 2 subtract, 2 sign, 2 add
    if compute_int:
        per_pos += 2 + 6 + 3                 # flip, signs, product, add
    per_batch = philox + 2 * unit + 2 * 6 + 8
    return float(n * per_pos + k * per_batch)


def time_cuda(fn, reps: int) -> float:
    """Milliseconds per call by CUDA events over ``reps`` calls after two
    warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_kernel_with_plain() -> float:
    """Phase 3: kernel (external uniforms) against the plain version, all
    flag combinations. Returns the largest |ΣT| error seen."""
    from dpcorr_torch.ops import fused_ni

    gen = torch.Generator(device="cuda").manual_seed(2025)
    worst = 0.0
    for eps in (EPS, (1.5, 0.5)):
        for compute_int in (False, True):
            for gauss in ("boxmuller", "ndtri"):
                for normalise in (True, False):
                    rows = fused_ni.n_uniform_rows(N, *eps, compute_int)
                    u = torch.rand(COMPARE_B, rows, 128, device="cuda",
                                   generator=gen) * (1 - 2e-7) + 1e-7
                    seeds = torch.zeros(COMPARE_B, 2, dtype=torch.int32,
                                        device="cuda")
                    rho = torch.full((COMPARE_B,), RHO, device="cuda")
                    kw = dict(normalise=normalise, compute_int=compute_int,
                              gauss=gauss)
                    got = fused_ni.fused_ni_sums(seeds, rho, N, *eps,
                                                 uniforms=u, **kw)
                    torch.cuda.synchronize()
                    want = fused_ni.fused_ni_plain(
                        seeds, rho, u, n=N, eps1=eps[0], eps2=eps[1], **kw)
                    if not torch.isfinite(got).all():
                        raise RuntimeError(f"kernel gave NaN/Inf: {eps} {kw}")
                    close = torch.isclose(got[:, :2], want[:, :2],
                                          rtol=1e-4, atol=0.0).all(1)
                    if compute_int:
                        close &= torch.isclose(got[:, 2], want[:, 2],
                                               rtol=0.0, atol=1e-5)
                    frac = close.float().mean().item()
                    err = (got - want).abs().max(0).values.tolist()
                    worst = max(worst, err[0])
                    print(f"compare eps={eps} {kw}: within tolerance "
                          f"{frac:.4f} of {COMPARE_B}, max |err| "
                          f"(sumT, sumT2, eta_int) = {err}", flush=True)
                    if frac < 0.99:
                        raise RuntimeError(
                            f"kernel disagrees with its plain version: "
                            f"{frac:.4f} within tolerance, eps={eps} {kw}")
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

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # ---- 2. build every kernel from the checkout's sources
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in libs:
        log = (_build.BUILD_DIR / f"{name}.log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

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
    ms = time_cuda(lambda: fused_ni.fused_ni_sums(seeds, RHO, N, *EPS), 20)
    rows = fused_ni.n_uniform_rows(N, *EPS)
    u = torch.rand(b, rows, 128, device="cuda") * (1 - 2e-7) + 1e-7
    rho_b = torch.full((b,), RHO, device="cuda")
    ext_ms = time_cuda(lambda: fused_ni.fused_ni_sums(seeds, rho_b, N, *EPS,
                                                      uniforms=u), 10)
    plain_ms = time_cuda(lambda: fused_ni.fused_ni_plain(
        seeds, rho_b, u, n=N, eps1=EPS[0], eps2=EPS[1]), 3)
    bytes_ = b * (8 + 4 + 12)
    ops = b * fused_ops_per_rep(N, EPS, False, "boxmuller")
    bound_ms = 1e3 * max(bytes_ / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
    ext_ops = b * fused_ops_per_rep(N, EPS, False, "boxmuller", philox=False)
    ext_bound_ms = 1e3 * max((u.numel() * 4 + b * 24) / HBM_BYTES_PER_S,
                             ext_ops / F32_OPS_PER_S)
    print(f"[{card}] fused_ni in-kernel mode, B={b}, n={N}: {ms:.4f} ms "
          f"(bound {bound_ms:.4f} ms by operations, {ops:.4g} ops); "
          f"external mode {ext_ms:.4f} ms (bound {ext_bound_ms:.4f} ms); "
          f"plain version {plain_ms:.4f} ms", flush=True)
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
        "bound_by": "operations" if ops / F32_OPS_PER_S
                    >= bytes_ / HBM_BYTES_PER_S else "bytes",
        "library_ms": None,
        "batch": b,
        "external_ms": ext_ms,
        "external_bound_ms": ext_bound_ms,
    }]}
    print(json.dumps(record), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
