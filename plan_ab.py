"""Two trees of the repository in turns on one card, on the paths the
build-and-dispatch layer (``dpcorr_torch/plan``) touched.

- Default: the serving exact engine (``chip_smoke.py`` phase 12a/c) and
  the stream's release costs (phase 14f), each measured by that tree's
  own ``chip_smoke.py`` in a process of its own, in the order other,
  this, this, other.
- ``--sketch``: the other tree's ``dpcorr_torch/stream/sketch.py`` is
  loaded beside this one's in one process and the two release the same
  windows in turns, other first in even rounds, ``--rounds`` pairs
  (default 12). That takes the spread between processes out of the
  comparison; the releases must be byte-equal. Then, in turns, µs per
  65,536-row chunk copy and per key copy through this tree's counted
  ``plan.placement`` against the plain call the other tree makes.

Run it from the root of this tree, with the other unpacked by
``git archive`` into a git-ignored directory (``.proof/``):

    python3 plan_ab.py --against .proof/parent [--sketch] [--rounds N]

Prints one ``PLAN_AB`` JSON line per arm (or per family and width),
each stamped with the card. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: run in each tree's root: its own chip_smoke.py measures
_ARM = """
import json, sys, tempfile, time
sys.path.insert(0, ".")
import chip_smoke as cs
from dpcorr_torch.perf_stream import (STREAM_SEED, STRESS_ROWS,
                                      gaussian_pair, hrs_pair)
from dpcorr_torch.utils.device import card_line

card = card_line()
work = tempfile.TemporaryDirectory()
parts, _, _ = cs.serving_exact(card, "cuda", work.name)
costs = cs.stream_costs(card, hrs_pair(),
                        gaussian_pair(STRESS_ROWS, STREAM_SEED, "cuda"))
print("ARM " + json.dumps({
    "card": card, "req_per_s": parts["req_per_s"],
    "hrs_req_per_s": parts["hrs"]["req_per_s"],
    "release_ms": {k: v["ms"] for k, v in costs.items()}}), flush=True)
"""


def run_arm(tree: str) -> dict:
    """One measurement in ``tree``'s root, in a fresh process."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(tree)
    out = subprocess.run([sys.executable, "-c", _ARM], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=1800)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("ARM ")]
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"arm in {tree} failed (rc {out.returncode}): "
                           f"{out.stderr[-2000:]}")
    return json.loads(lines[-1][4:])


def sketch_turns(other_root: str, reps: int = 10,
                 rounds: int = 12) -> dict:
    """Median ms per release of each family at n = 19,433 and 10⁶ for
    this tree's ``sketch.release_window`` and the other tree's, in turns
    in one process; and µs per chunk copy and per key copy to the card
    through this tree's counted ``plan.placement`` against the plain
    calls. Each row also gives the median over rounds of this tree's
    reading over the other's (``ratio_median``)."""
    import importlib.util
    import time

    import numpy as np
    import torch

    from dpcorr_torch.perf_stream import (
        RELEASE_EPS,
        STREAM_SEED,
        STRESS_ROWS,
        gaussian_pair,
        hrs_pair,
    )
    from dpcorr_torch.stream import sketch as this
    from dpcorr_torch.utils import rng

    spec = importlib.util.spec_from_file_location(
        "other_sketch",
        os.path.join(other_root, "dpcorr_torch", "stream", "sketch.py"))
    other = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = other  # dataclasses look their module up
    spec.loader.exec_module(other)
    data = {"hrs": hrs_pair(),
            "stress": gaussian_pair(STRESS_ROWS, STREAM_SEED, "cuda")}
    out: dict = {}
    for r in range(rounds):
        order = [("other", other), ("this", this)]
        for name, mod in (order if r % 2 == 0 else order[::-1]):
            for width, xy in data.items():
                for fam in ("ni_sign", "int_sign", "ni_subg", "int_subg"):
                    params = mod.ReleaseParams(fam, *RELEASE_EPS,
                                               normalise=True)
                    wkey = mod.window_key(rng.master_key(STREAM_SEED),
                                          "0-2000")
                    rel = mod.release_window(xy, params, wkey,
                                             device="cuda")
                    times = []
                    for _ in range(reps):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        mod.release_window(xy, params, wkey, device="cuda")
                        times.append(1e3 * (time.perf_counter() - t0))
                    row = out.setdefault(f"{fam} {width}", {})
                    row.setdefault(name, []).append(float(np.median(times)))
                    row.setdefault("bytes_" + name, json.dumps(
                        rel, sort_keys=True))
    for key, row in out.items():
        if row.pop("bytes_this") != row.pop("bytes_other"):
            raise RuntimeError(f"{key}: the two trees' releases differ")
        row["ratio_median"] = float(np.median(
            [t / o for t, o in zip(row["this"], row["other"])]))
    # one chunk's rows and one key to the card: this tree's counted
    # copies against the plain calls, µs per copy over 400, in turns
    rows = torch.from_numpy(np.ascontiguousarray(data["stress"][:65536]))
    dev = this._device("cuda")
    words = (0x12345678, 0x0FEDCBA9)
    arms = {"chunk copy us": (lambda: this._put(rows, dev),
                              lambda: rows.to("cuda")),
            "key copy us": (lambda: this._key_on(words, dev),
                            lambda: torch.tensor(words, dtype=torch.int64,
                                                 device="cuda"))}
    for r in range(rounds):
        for label, (ours, plain) in arms.items():
            order = [("this", ours), ("plain", plain)]
            for name, fn in (order if r % 2 == 0 else order[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(400):
                    fn()
                torch.cuda.synchronize()
                out.setdefault(label, {}).setdefault(name, []).append(
                    1e6 * (time.perf_counter() - t0) / 400)
    for label in arms:
        row = out[label]
        row["ratio_median"] = float(np.median(
            [t / p for t, p in zip(row["this"], row["plain"])]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="plan_ab.py")
    ap.add_argument("--against", required=True,
                    help="root of the other tree (e.g. an unpacked parent)")
    ap.add_argument("--sketch", action="store_true",
                    help="the two trees' stream sketches in one process")
    ap.add_argument("--rounds", type=int, default=12,
                    help="interleaved pairs for --sketch")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("plan_ab.py: no CUDA device", file=sys.stderr)
        return 1
    if args.sketch:
        from dpcorr_torch.utils.device import card_line

        card = card_line()
        for key, row in sketch_turns(args.against,
                                     rounds=args.rounds).items():
            print("PLAN_AB " + json.dumps({"card": card, "release": key,
                                           **row}), flush=True)
        return 0
    by_tree: dict[str, list] = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        res = run_arm(args.against if name == "other" else ".")
        by_tree[name].append(res)
        print("PLAN_AB " + json.dumps({"tree": name, **res}), flush=True)
    summary = {name: {
        "req_per_s": [r["req_per_s"] for r in runs],
        "hrs_req_per_s": [r["hrs_req_per_s"] for r in runs],
        "release_ms": {k: [r["release_ms"][k] for r in runs]
                       for k in runs[0]["release_ms"]}}
        for name, runs in by_tree.items()}
    print("PLAN_AB_SUMMARY " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
