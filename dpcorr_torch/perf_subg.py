"""Measures the sub-Gaussian and streaming paths on one card.

    python -m dpcorr_torch.perf_subg

1. The sub-Gaussian path: ``RepBlockPipeline`` over ``sim._one_rep`` with
   the grid pair on bounded-factor data, at n = 4000, ε = (1, 1) (the
   acceptance point) and n = 12,000, ε = (1.5, 0.5) (the reference grid's
   widest point), for several replication chunk widths: replications per
   second (host clock around runs that end in the pipeline's one device
   read) and peak device memory.
2. The streaming path: the subG pair at n = 10⁶, n_chunk = 65536, for
   several numbers of resident replications (what
   ``sim.STRESS_CHUNK_CARD`` is chosen from).
3. One block of each path at its chosen width under ``torch.profiler``:
   device activities launched per block, device time per block, and the
   device's idle share of that profiled block (1 − the union of its
   kernel, copy and fill intervals over the block's window, from the
   one profiled run).

Each result is one JSON line stamped with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from dpcorr_torch.utils.device import card_line

SUBG_POINTS = ((4000, (1.0, 1.0)), (12_000, (1.5, 0.5)))
SUBG_WIDTHS = (2048, 4096, 8192)
STREAM_N, STREAM_CHUNK = 10**6, 65536
STREAM_WIDTHS = (64, 128, 256, 512)
RHO = 0.5


def emit(card: str, what: str, **fields) -> None:
    print(json.dumps({"card": card, "what": what, **fields}), flush=True)


def _pipeline(cfg, block_reps: int, chunk: int):
    from dpcorr_torch import sim
    from dpcorr_torch.utils import rng

    return sim.RepBlockPipeline(lambda k: sim._one_rep(k, cfg.rho, cfg),
                                len(sim.DETAIL_FIELDS),
                                key=rng.master_key(device="cuda"),
                                block_reps=block_reps, chunk_size=chunk)


def _rate(pipe, n_blocks: int) -> dict:
    """Replications per second over ``n_blocks`` after one warm block,
    and the run's peak device memory."""
    pipe.run(1, start_block=10_000)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sums, n_reps = pipe.run(n_blocks)
    dt = time.perf_counter() - t0
    return {"reps": n_reps, "seconds": dt, "reps_per_s": n_reps / dt,
            "block_ms": 1e3 * dt / n_blocks,
            "ni_coverage": sums[8] / n_reps, "int_coverage": sums[9] / n_reps,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def _profile_block(pipe) -> dict:
    """Launches and device ms of one profiled block (the profiler's
    device-side annotations of the host's ranges left out), the host ms
    of an unprofiled one, and the device's idle share of the profiled
    block from that run alone (``utils.profiling.device_idle_share``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from dpcorr_torch.utils import profiling

    pipe.run(1, start_block=20_000)
    t0 = time.perf_counter()
    pipe.run(1, start_block=20_001)
    host_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(profiling.RUN_RANGE):
            pipe.run(1, start_block=20_002)  # ends in the block's read
    device = [b - a for _, a, b in profiling.device_activities(prof)]
    if not device:
        return {"launches_per_block": "not measured",
                "device_ms_per_block": "not measured",
                "host_ms_per_block": host_ms, "idle_share": "not measured"}
    return {"launches_per_block": len(device),
            "device_ms_per_block": sum(device) / 1e3,
            "host_ms_per_block": host_ms,
            "idle_share": profiling.device_idle_share(prof)}


def subg_path(card: str) -> None:
    from dpcorr_torch.sim import SimConfig

    for n, eps in SUBG_POINTS:
        cfg = SimConfig(n=n, rho=RHO, eps1=eps[0], eps2=eps[1],
                        dgp="bounded_factor", use_subg=True)
        best = None
        for chunk in SUBG_WIDTHS:
            pipe = _pipeline(cfg, 1 << 14, chunk)
            res = _rate(pipe, 2)
            emit(card, "subg_rate", n=n, eps=eps, block_reps=1 << 14,
                 chunk=chunk, **res)
            if best is None or res["reps_per_s"] > best[1]:
                best = (chunk, res["reps_per_s"])
            del pipe
            torch.cuda.empty_cache()
        emit(card, "subg_block_profile", n=n, eps=eps, chunk=best[0],
             block_reps=1 << 14,
             **_profile_block(_pipeline(cfg, 1 << 14, best[0])))


def streaming_path(card: str) -> None:
    from dpcorr_torch.sim import SimConfig

    cfg = SimConfig(n=STREAM_N, rho=RHO, eps1=1.0, eps2=1.0,
                    dgp="bounded_factor", use_subg=True,
                    stream_n_chunk=STREAM_CHUNK)
    best = None
    for width in STREAM_WIDTHS:
        pipe = _pipeline(cfg, 2 * width, width)
        res = _rate(pipe, 1)
        emit(card, "stream_rate", n=STREAM_N, n_chunk=STREAM_CHUNK,
             width=width, block_reps=2 * width, **res)
        if best is None or res["reps_per_s"] > best[1]:
            best = (width, res["reps_per_s"])
        del pipe
        torch.cuda.empty_cache()
    emit(card, "stream_block_profile", n=STREAM_N, n_chunk=STREAM_CHUNK,
         width=best[0], block_reps=best[0],
         **_profile_block(_pipeline(cfg, best[0], best[0])))


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]
                            ).parse_args(argv)
    if not torch.cuda.is_available():
        print("perf_subg: needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    emit(card, "device", kind=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda)
    subg_path(card)
    streaming_path(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
