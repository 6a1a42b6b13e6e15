#!/usr/bin/env python3
"""Readings behind a cell's correctness limits, many seeds in one process.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 [--control 1] [--out FILE]

For each seed: the cell's set-up, a short window at the cell's own load,
then the numbers ``correct`` is decided on, for the program and (with
``--control 1``) for the control, the plain reference in bf16 put in the
program's place. One JSON line per seed, on standard output and in
``--out``. The lower end of a limit is the largest program reading over
a dozen seeds or more; the upper end the smallest control reading.
"""

import argparse
import json
import sys
from pathlib import Path


def readings(workload: str, seeds, seconds: float, control: bool,
             device: str = "cuda", config=None, cell=None):
    """Yields one dict of readings per seed: a whole run of the cell
    (``core.execute``) and, with ``control``, the control's numbers on
    the same outputs."""
    from portbench import core

    for seed in seeds:
        r = core.execute(workload, seed, seconds, device=device,
                         config=config, cell=cell, control=control)
        out = {"seed": int(seed), "studies": r["_run"]["studies"],
               "window_s": r["_run"]["window_s"],
               "program": {k: c["value"] for k, c in r["check"].items()},
               "correct": r["correct"]}
        if control:
            c = r["_control"]
            out["control"] = {k: v["value"] for k, v in c["check"].items()}
            out["control_correct"] = c["correct"]
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    sink = open(args.out, "a") if args.out else None
    try:
        for r in readings(args.workload, seeds, args.seconds,
                          bool(args.control)):
            line = json.dumps({"workload": args.workload, **r})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    # the benchmark and the program import from the checkout's root
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    sys.exit(main())
