"""Measures the fused kernel, and the fused path's block, on one card.

    python -m dpcorr_torch.perf_fused [--old-source PATH]

1. With ``--old-source``: the kernel against an earlier version of
   ``csrc/fused_ni.cu`` (same C interface), built here with the same
   ``nvcc`` flags, timed in turns (old, new, new, old) with CUDA events at
   the main path's launch shape (B = 2¹⁴ replications, n = 10⁴,
   ε = (1, 1)), in-kernel and external-uniform modes. Launches go straight
   to each library, so neither side pays the wrapper's checks.
2. The fused path itself (``RepBlockPipeline`` over
   ``sim.fused_ni_rep_fn``), 32 blocks of 2¹⁴ replications, split by the
   stages the path marks (``sim.stage``, ``sim.FUSED_STAGES``): host time
   per block; host time inside each stage (``sim.stage_host_seconds``);
   then under ``torch.profiler`` the device time and count of the device
   activities each stage launches, and the largest device activities; and
   the kernel alone by CUDA events.

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


def emit(card: str, what: str, **fields) -> None:
    print(json.dumps({"card": card, "what": what, **fields}), flush=True)


def build_library(src: Path, name: str) -> ctypes.CDLL:
    """``src`` compiled as the port's kernels are, into the build
    directory, and loaded."""
    from dpcorr_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = _build.BUILD_DIR / f"{name}.so"
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(target),
         str(src)], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(target))


def kernel_ab(card: str, old_source: Path) -> None:
    """Phase 1: old and new kernel in turns, both modes."""
    from dpcorr_torch.ops import fused_ni
    from dpcorr_torch.utils import rng

    libs = {"new": fused_ni._library(),
            "old": fused_ni._typed(build_library(old_source, "fused_ni_old"))}
    c = fused_ni._Consts(N, *EPS, (0.0, 0.0), (1.0, 1.0))
    seeds = rng.kernel_seeds(rng.rep_keys(rng.master_key(device="cuda"),
                                          BLOCK)).contiguous()
    rho = torch.full((BLOCK,), RHO, device="cuda")
    out = torch.empty(BLOCK, 3, device="cuda")
    u = (torch.rand(BLOCK, c.u_rows(False), 128, device="cuda")
         * (1 - 2e-7) + 1e-7)
    for mode, uniforms, reps in (("in-kernel", None, 50),
                                 ("external", u, 20)):
        times = {"old": [], "new": []}
        for side in ("old", "new", "new", "old"):
            times[side].append(time_cuda(
                lambda lib=libs[side]: fused_ni._call(
                    lib, seeds, rho, uniforms, out, c, True, False,
                    "boxmuller"), reps))
        emit(card, "kernel_ab", mode=mode, batch=BLOCK, n=N, eps=EPS,
             order="old, new, new, old", reps_per_timing=reps,
             old_ms=times["old"], new_ms=times["new"],
             speedup=float(np.mean(times["old"]) / np.mean(times["new"])))


def _activities(event) -> list:
    """The device activities launched inside a profiler range, its
    nested ranges and operators included."""
    return list(event.kernels) + [k for child in event.cpu_children
                                  for k in _activities(child)]


def block_split(card: str) -> None:
    """Phase 2: the fused path's block, stage by stage."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dpcorr_torch import sim
    from dpcorr_torch.ops.fused_ni import fused_ni_sums
    from dpcorr_torch.utils import rng

    key = rng.master_key(device="cuda")
    pipe = sim.RepBlockPipeline(sim.fused_ni_rep_fn(N, RHO, *EPS, ALPHA), 3,
                                key=key, block_reps=BLOCK, chunk_size=BLOCK)
    pipe.run(2, start_block=10_000)  # warm: allocator, first launches
    t0 = time.perf_counter()
    pipe.run(BLOCKS)
    block_ms = 1e3 * (time.perf_counter() - t0) / BLOCKS

    # host clock inside each stage (enqueue time: the stages are async)
    with sim.stage_host_seconds() as seconds:
        t0 = time.perf_counter()
        pipe.run(BLOCKS)
        timed_ms = 1e3 * (time.perf_counter() - t0) / BLOCKS
    host = {name: 1e3 * seconds.get(name, 0.0) / BLOCKS
            for name in sim.FUSED_STAGES}

    # device time and count of what each stage launches, by the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.run(BLOCKS)
        profiled_ms = 1e3 * (time.perf_counter() - t0) / BLOCKS
    events = prof.events()
    # (name, µs) of the device activities each stage launched
    acts = {name: [] for name in sim.FUSED_STAGES}
    for ev in events:
        if ev.device_type == DeviceType.CPU and ev.name in acts:
            acts[ev.name] += [(k.name, k.duration) for k in _activities(ev)]
    device = [(ev.name, ev.time_range.elapsed_us()) for ev in events
              if ev.device_type == DeviceType.CUDA]
    # a launch through ctypes may correlate with no range: take the kernel
    # by its name then
    if not any("fused_ni_kernel" in name for name, _ in acts["fused_ni"]):
        acts["fused_ni"] += [a for a in device if "fused_ni_kernel" in a[0]]
    measured = bool(device)
    stages = {name: {
        "host_ms": host[name],
        "device_ms": (sum(us for _, us in a) / 1e3 / BLOCKS if measured
                      else "not measured"),
        "launches": len(a) / BLOCKS if measured else "not measured"}
        for name, a in acts.items()}
    by_name = {}
    for name, us in device:
        row = by_name.setdefault(name[:80], [0, 0.0])
        row[0] += 1
        row[1] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    seeds = rng.kernel_seeds(rng.rep_keys(key, BLOCK)).contiguous()
    emit(card, "fused_block_split", batch=BLOCK, n=N, eps=EPS,
         blocks=BLOCKS, block_ms=block_ms, host_timed_block_ms=timed_ms,
         profiled_block_ms=profiled_ms,
         device_work_ms_per_block=(
             sum(st["device_ms"] for st in stages.values()) if measured
             else "not measured"),
         launches_per_block=(
             sum(st["launches"] for st in stages.values()) if measured
             else "not measured"),
         stages=stages,
         kernel_ms_by_events=time_cuda(
             lambda: fused_ni_sums(seeds, RHO, N, *EPS), 20),
         top_device_activities_per_block=[
             {"name": name, "count": c / BLOCKS, "ms": us / 1e3 / BLOCKS}
             for name, (c, us) in top])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-source", type=Path,
                    help="an earlier csrc/fused_ni.cu to time against")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perf_fused: needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    emit(card, "device", kind=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda)
    if args.old_source is not None:
        kernel_ab(card, args.old_source)
    block_split(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
