"""Measures the fused kernel, the fused path's block and the design
grid's buckets on one card.

    python -m dpcorr_torch.perf_fused [--old-source PATH [--kernel-only]]

1. With ``--old-source``: the kernel against an earlier version of
   ``csrc/fused_ni.cu`` (the same C interface, or the one before the
   ``regen`` argument), built here with the same ``nvcc`` flags, with
   each side's ``ptxas`` registers and spills for the main path's
   variant, timed in turns (old, new, new, old, three times) with CUDA
   events at the main path's launch shape (B = 2¹⁴ replications,
   n = 10⁴, ε = (1, 1)), in-kernel and external-uniform modes. Launches
   go straight to each library, so neither side pays the wrapper's
   checks. A source that includes ``fused_ni_common.cuh`` needs its own
   commit's header beside it.
2. The fused path itself (``RepBlockPipeline`` over
   ``sim.fused_ni_rep_fn``), 32 blocks of 2¹⁴ replications, split by the
   stages the path marks (``sim.stage``, ``sim.FUSED_STAGES``): host time
   per block; host time inside each stage (``sim.stage_host_seconds``);
   then under ``torch.profiler`` the device time and count of the device
   activities each stage launches and in all, the largest device
   activities and the device's idle share; and the kernel alone by CUDA
   events.
3. The reference's v1 sign grid (144 points, B = 250,
   bucketed) fused and unfused, and its subG grid (120 points) ε-merged
   and not, each split the same way per bucket, by the stages a fused
   bucket marks (``sim.GRID_STAGES``). The grids' wall times in turns are
   ``chip_smoke.py`` phase 9's.

Each result is one JSON line stamped with the card's name and power limit;
the device is the card, never the CPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from dpcorr_torch.utils.device import card_line, time_cuda

N, EPS, RHO, ALPHA = 10_000, (1.0, 1.0), 0.5, 0.05
BLOCK = 1 << 14
BLOCKS = 32
AB_ROUNDS = 3
#: template arguments of the main path's K1 variant in ``ptxas`` reports
MAIN_VARIANT = (0, 0, 0, 1, 1, 1)


def emit(card: str, what: str, **fields) -> None:
    print(json.dumps({"card": card, "what": what, **fields}), flush=True)


def build_library(src: Path, name: str) -> tuple[ctypes.CDLL, str]:
    """``src`` compiled as the port's kernels are, into the build
    directory, and loaded; with the compiler's report."""
    from dpcorr_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = _build.BUILD_DIR / f"{name}.so"
    # dpcorr-lint: ignore[aot-outside-compile-layer] — builds an earlier kernel source for the A/B, which the build cache must not hold
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(target),
         str(src)], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(target)), proc.stdout + proc.stderr


def _old_launcher(lib: ctypes.CDLL, source: str):
    """A launcher of an earlier library with ``fused_ni._call``'s
    arguments. Sources from before the variant without planes take no
    ``regen`` argument; their launch is typed without it."""
    from dpcorr_torch.ops import fused_ni

    fused_ni._typed(lib)
    if "int regen" in source:
        return lambda *args: fused_ni._call(lib, *args)
    lib.fused_ni_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.POINTER(fused_ni._Params), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def launch(seeds, rho, uniforms, out, c, normalise, compute_int, gauss):
        params = fused_ni._params(c, compute_int)
        stream = torch.cuda.current_stream(seeds.device).cuda_stream
        err = lib.fused_ni_launch(
            seeds.data_ptr(), rho.data_ptr(),
            None if uniforms is None else uniforms.data_ptr(),
            out.data_ptr(), seeds.shape[0], ctypes.byref(params),
            int(uniforms is not None), int(compute_int),
            int(gauss == "ndtri"), int(normalise), stream)
        fused_ni._raise_on(lib, err, "kernel launch")
    return launch


def kernel_ab(card: str, old_source: Path) -> None:
    """Phase 1: old and new kernel in turns, both modes, with the
    ``ptxas`` registers and spills of each side's main-path variant."""
    from dpcorr_torch.ops import _build, fused_ni
    from dpcorr_torch.utils import rng

    new_lib = fused_ni._library()
    old_lib, old_log = build_library(old_source, "fused_ni_old")
    launch = {"new": lambda *args: fused_ni._call(new_lib, *args),
              "old": _old_launcher(old_lib, old_source.read_text())}
    # the main path's variant: philox, NI, Box-Muller, normalise, noise in
    # shared memory (and, where the source has the flag, planes kept)
    main = {"new": _build.ptxas_report(
                _build.log_path("fused_ni").read_text())[MAIN_VARIANT]}
    old_report = _build.ptxas_report(old_log)
    main["old"] = old_report.get(MAIN_VARIANT, old_report.get(
        MAIN_VARIANT[:-1]))
    emit(card, "kernel_ab_ptxas", variant="philox NI boxmuller normalise",
         fields=["registers", "stack_frame", "spill_stores", "spill_loads"],
         old=main["old"], new=main["new"])
    c = fused_ni._Consts(N, *EPS, (0.0, 0.0), (1.0, 1.0))
    seeds = rng.kernel_seeds(rng.rep_keys(rng.master_key(device="cuda"),
                                          BLOCK)).contiguous()
    rho = torch.full((BLOCK,), RHO, device="cuda")
    out = torch.empty(BLOCK, 3, device="cuda")
    # dpcorr-lint: ignore[rng-raw-api] — timing uniforms for the kernel A/B, not DP noise
    u = (torch.rand(BLOCK, c.u_rows(False), 128, device="cuda")
         * (1 - 2e-7) + 1e-7)
    for mode, uniforms, reps in (("in-kernel", None, 50),
                                 ("external", u, 20)):
        times = {"old": [], "new": []}
        for side in ("old", "new", "new", "old") * AB_ROUNDS:
            times[side].append(time_cuda(
                lambda f=launch[side]: f(seeds, rho, uniforms, out, c, True,
                                         False, "boxmuller"), reps))
        emit(card, "kernel_ab", mode=mode, batch=BLOCK, n=N, eps=EPS,
             order=f"(old, new, new, old) x {AB_ROUNDS}",
             reps_per_timing=reps, old_ms=times["old"],
             new_ms=times["new"],
             speedup=float(np.mean(times["old"]) / np.mean(times["new"])))


def _activities(event) -> list:
    """The device activities launched inside a profiler range, its
    nested ranges and operators included."""
    return list(event.kernels) + [k for child in event.cpu_children
                                  for k in _activities(child)]


def stage_split(run, stages: tuple, units: int) -> dict:
    """``run()`` split by the stages it marks (``sim.stage``), per unit
    (a block or a bucket): host ms of an unprofiled run and of one timed
    by stage; host ms inside each stage (``sim.stage_host_seconds``,
    enqueue time: the stages are async); then under ``torch.profiler``
    the count and device ms of the activities each stage launches and of
    all the run's, the largest ones, and the device's idle share of the
    unprofiled run (1 − device time / its host time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dpcorr_torch import sim

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    host_ms = timed()
    with sim.stage_host_seconds() as seconds:
        timed_ms = timed()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = timed()
    ranges = set(stages) | set(sim.FUSED_STAGES + sim.GRID_STAGES)
    acts = {name: [] for name in stages}
    device = []   # (name, µs) of kernels and copies, not the ranges' spans
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name in acts:
            acts[ev.name] += [(k.name, k.duration) for k in _activities(ev)]
        elif ev.device_type == DeviceType.CUDA and ev.name not in ranges:
            device.append((ev.name, ev.time_range.elapsed_us()))
    # a launch through ctypes may correlate with no range: take the kernel
    # by its name then
    if "fused_ni" in acts and not any("fused_ni_kernel" in name
                                      for name, _ in acts["fused_ni"]):
        acts["fused_ni"] += [a for a in device if "fused_ni_kernel" in a[0]]
    nm = "not measured"
    measured = bool(device)
    device_ms = sum(us for _, us in device) / 1e3
    by_name = {}
    for name, us in device:
        row = by_name.setdefault(name[:80], [0, 0.0])
        row[0] += 1
        row[1] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {
        "units": units, "host_ms_per_unit": host_ms / units,
        "host_timed_ms_per_unit": timed_ms / units,
        "profiled_ms_per_unit": profiled_ms / units,
        "activities_per_unit": len(device) / units if measured else nm,
        "device_ms_per_unit": device_ms / units if measured else nm,
        "idle_share": (max(0.0, 1.0 - device_ms / host_ms) if measured
                       else nm),
        "stages": {name: {
            "host_ms": 1e3 * seconds.get(name, 0.0) / units,
            "device_ms": (sum(us for _, us in a) / 1e3 / units if measured
                          else nm),
            "activities": len(a) / units if measured else nm}
            for name, a in acts.items()},
        "top_device_activities_per_unit": [
            {"name": name, "count": c / units, "ms": us / 1e3 / units}
            for name, (c, us) in top] if measured else nm}


def block_split(card: str) -> None:
    """Phase 2: the fused path's block, stage by stage."""
    from dpcorr_torch import sim
    from dpcorr_torch.ops.fused_ni import fused_ni_sums
    from dpcorr_torch.utils import rng

    key = rng.master_key(device="cuda")
    pipe = sim.RepBlockPipeline(sim.fused_ni_rep_fn(N, RHO, *EPS, ALPHA), 3,
                                key=key, block_reps=BLOCK, chunk_size=BLOCK)
    pipe.run(2, start_block=10_000)  # warm: allocator, first launches
    split = stage_split(lambda: pipe.run(BLOCKS), sim.FUSED_STAGES, BLOCKS)
    seeds = rng.kernel_seeds(rng.rep_keys(key, BLOCK)).contiguous()
    emit(card, "fused_block_split", batch=BLOCK, n=N, eps=EPS, **split,
         kernel_ms_by_events=time_cuda(
             lambda: fused_ni_sums(seeds, RHO, N, *EPS), 20))


#: phase 3: the reference's grids at B = 250 (vert-cor.R:486-499,
#: ver-cor-subG.R:245), bucketed
GRID_B = 250
_SUBG = dict(n_grid=(2500, 4000, 6000, 9000, 12000), dgp="bounded_factor",
             use_subg=True)
GRID_ARMS = {
    "v1 fused": dict(fused="auto"),
    "v1 unfused": {},
    "subg merged": dict(_SUBG, bucket_merge="eps"),
    "subg unmerged": _SUBG,
}


def grid_split(card: str) -> None:
    """Phase 3: each grid arm split by the stages a bucket marks
    (``sim.GRID_STAGES``; only fused buckets mark them), per bucket."""
    from dpcorr_torch import sim
    from dpcorr_torch.grid import GridConfig, run_grid

    for arm, kw in GRID_ARMS.items():
        gc = GridConfig(b=GRID_B, backend="bucketed", **kw)
        res = run_grid(gc)  # warm: the kernel's library, the allocator
        emit(card, "grid_bucket_split", arm=arm, b=GRID_B,
             points=len(res.detail_all["repl"]) // GRID_B,
             fused_buckets=int(res.timings["fused"].sum()),
             **stage_split(lambda gc=gc: run_grid(gc), sim.GRID_STAGES,
                           len(res.timings["n"])))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-source", type=Path,
                    help="an earlier csrc/fused_ni.cu to time against")
    ap.add_argument("--kernel-only", action="store_true",
                    help="stop after the kernel A/B (phase 1)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perf_fused: needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    emit(card, "device", kind=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda)
    if args.old_source is not None:
        kernel_ab(card, args.old_source)
    if args.kernel_only:
        return 0
    block_split(card)
    grid_split(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
