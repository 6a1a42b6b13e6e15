#!/usr/bin/env python3
"""The benchmark of dpcorr_torch: one cell, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for. Set-up (imports, the card, the program's build or load, the
inputs, one warm-up study at the cell's shape) is timed as ``setup_s``;
then whole studies run for ``--seconds``; then what they produced is
held against the plain reference. With ``--trace 1`` the window runs
under ``torch.profiler`` and the per-layer metrics are read from its
trace. The last line of standard output is the result as one JSON
object; the compared numbers and their limits are the last lines of
standard error.
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the benchmark and the program import from the checkout's root
sys.path[0] = str(ROOT)


def _caches() -> None:
    """Every build and kernel cache at a fixed place inside the checkout
    (the program's own nvcc builds already live in its package)."""
    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()

    from portbench import core

    wl = next((w for w in core.benchmark()["workloads"]
               if w["name"] == args.workload), None)
    if wl is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    result = core.execute(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", int(wl["chips"]))
    bad = core.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3

    from dpcorr_torch.obs import transfer
    from dpcorr_torch.ops import _build

    info = {"card": _card(), "run": result.pop("_run"),
            "max_memory_allocated": result["device"]["memory_peak_bytes"],
            "transfer": transfer.default_counters().snapshot(),
            "built": {k: round(v, 3) for k, v in _build.BUILD_SECONDS.items()},
            "libraries": sorted(os.path.basename(str(p))
                                for p in _build._LIBS)}
    print(json.dumps(info, default=str))
    check = result["check"]
    for name, c in check.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
