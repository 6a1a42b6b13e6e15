"""The stream service and the per-user budget directory, measured on one
card.

    python -m dpcorr_torch.perf_stream [--users 1000000] [--reps 20]

The counterpart of the JAX package's stream load arms
(``benchmarks/stream_load.py``: the fixed two-shard batch plan over 2 s
tumbling windows at ε = 0.4) and of its budget-directory drill
(``benchmarks/serve_load.py`` ``run_users``), written for the port: the
pieces ``chip_smoke.py`` phase 14 drives, and a script that measures them
at full size. Run as a script, on the card only, it prints one JSON line
per result, each stamped with the card's name and power limit:

1. ``release``: for each family, a window release (``release_window``,
   normalise on, ε = (1.0, 0.5)) at n = 19,433 (the HRS wave-2 pair of
   ``perf_hrs.synthetic_panel(0)``, raw age and BMI) and at n = 10⁶ (a
   ρ = 0.5 Gaussian pair from ``gen_gaussian``): ms per release (median,
   min and max of ``--reps``), the CUDA activities of one release
   (``torch.profiler``) and its host syncs
   (``torch.cuda.set_sync_debug_mode``);
2. ``users``: the directory drill at ``--users`` users (10⁶ by default,
   the JAX CI's size), 64 shards, 2,048 users resident per shard, fsync
   off: admissions/s, p50 and p99, and every exact gate.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from dpcorr_torch.utils.device import card_line

FAMILIES = ("ni_sign", "ni_subg", "int_sign", "int_subg")
#: stream_load.py's window and ε, and the CLI's default seed
WINDOW_S, STREAM_EPS, STREAM_SEED = 2.0, 0.4, 2025
#: the release measurements' ε pair, and the stress width (BASELINE.md
#: config 5: 10⁶ rows, 16 chunks of 65,536)
RELEASE_EPS = (1.0, 0.5)
STRESS_ROWS = 10**6
#: the drill's directory: serve_load.py's --users-shards and
#: --users-max-resident defaults
USERS_SHARDS, USERS_MAX_RESIDENT = 64, 2048


def emit(card: str, what: str, **fields) -> None:
    print(json.dumps({"card": card, "what": what, **fields}), flush=True)


# ------------------------------------------------------------- data ----
def hrs_pair(cols=None) -> np.ndarray:
    """Wave 2's complete cases of the synthetic panel (seed 0), raw age
    for X and BMI for Y, as an (n, 2) f32 array."""
    from dpcorr_torch import hrs
    from dpcorr_torch.perf_hrs import synthetic_panel

    if cols is None:
        cols = synthetic_panel(0)
    _ids, age, bmi = hrs.extract_wave(cols)
    return np.stack([np.asarray(age, np.float32),
                     np.asarray(bmi, np.float32)], axis=1)


def gaussian_pair(n: int, seed: int, device) -> np.ndarray:
    """A ρ = 0.5 Gaussian pair of n rows from the port's ``gen_gaussian``
    on the key-tree, as an (n, 2) f32 array on the host."""
    from dpcorr_torch.models.dgp import gen_gaussian
    from dpcorr_torch.utils import rng

    key = rng.master_key(seed, device=device)
    return gen_gaussian(key, n, 0.5).cpu().numpy().astype(np.float32)


def batch_plan(xy: np.ndarray, windows: int = 4,
               batches_per_window: int = 10) -> list[tuple]:
    """stream_load.py's fixed plan over ``xy``: every window receives all
    of ``xy``, cut into ``batches_per_window`` consecutive batches from
    two interleaved shards, at event times inside the window; then one
    far-future heartbeat that closes everything. Rows are the f32 values
    as Python floats, so the service's one f32 cast gives them back
    exactly."""
    parts = np.array_split(np.asarray(xy, np.float32), batches_per_window)
    out = []
    for w in range(windows):
        for b, part in enumerate(parts):
            shard = "a" if b % 2 == 0 else "b"
            ts = w * WINDOW_S + (b + 0.5) * WINDOW_S \
                / (batches_per_window + 1)
            # dpcorr-lint: ignore[sync-in-loop] — host rows: no device value in reach
            out.append((f"shard-{shard}:w{w}b{b}", ts, part.tolist()))
    out.append(("heartbeat:final", windows * WINDOW_S + 1e6, []))
    return out


def plan_windows(plan) -> dict[str, np.ndarray]:
    """Window id → the (n, 2) f32 rows the plan lands in it, in order."""
    from dpcorr_torch.stream.windows import WindowManager, WindowSpec

    m = WindowManager(WindowSpec(size_s=WINDOW_S))
    for _bid, ts, rows in plan:
        m.admit(ts, rows)
    return {w.id: w.rows for w in m.pending()}


def stream_charges(families=FAMILIES) -> dict[str, float]:
    from dpcorr_torch.stream.service import window_charges

    return window_charges(families, STREAM_EPS, STREAM_EPS, True,
                          "party/x", "party/y")


# ---------------------------------------------------------- release ----
def release_once(xy, family: str, device, shards=None) -> dict:
    from dpcorr_torch.stream import sketch
    from dpcorr_torch.utils import rng

    params = sketch.ReleaseParams(family, *RELEASE_EPS, normalise=True)
    wkey = sketch.window_key(rng.master_key(STREAM_SEED), "0-2000")
    return sketch.release_window(xy, params, wkey, shards=shards,
                                 device=device)


def activities(fn) -> int:
    """CUDA activities (kernels, copies, sets) ``torch.profiler`` records
    for one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type.name == "CUDA")


def host_syncs(fn) -> int:
    """Synchronizing CUDA calls of one call of ``fn``, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def release_cost(xy, family: str, device, reps: int) -> dict:
    """ms per release (median, min and max of ``reps`` after one warm
    call; the host's clock spreads, so the min is the steadiest),
    CUDA activities and host syncs of one release."""
    release_once(xy, family, device)
    times = []
    for _ in range(reps):
        # dpcorr-lint: ignore[sync-in-loop] — timing barrier: the clock starts on an idle card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        release_once(xy, family, device)
        times.append(1e3 * (time.perf_counter() - t0))
    return {"n": len(xy), "ms": float(np.median(times)),
            "ms_min": min(times), "ms_max": max(times),
            "activities": activities(lambda: release_once(xy, family,
                                                          device)),
            "host_syncs": host_syncs(lambda: release_once(xy, family,
                                                          device))}


# ------------------------------------------------------- directory ----
def users_drill(n_users: int, shards: int = USERS_SHARDS,
                max_resident: int = USERS_MAX_RESIDENT) -> dict:
    """``serve_load.run_users``'s drill through the port's
    :class:`~dpcorr_torch.serve.budget_dir.CompositeLedger`, with its
    arithmetic as it is: every ε dyadic (party legs 2⁻⁴ each, user leg
    2⁻³, user budget 2⁻²), so every balance gate is exact float
    equality. Every user charges once, every 8th twice (its window is
    then full), every 64th a third time (refused at the user level,
    charge-free), and every 16th's second charge is refunded. The
    directory holds ``max_resident`` users per shard, so the spill and
    rehydrate path runs at scale; fsync is off and compaction never
    runs (it would fold the whole user table per cycle)."""
    from dpcorr_torch.serve.budget_dir import (
        BudgetDirectory,
        CompositeLedger,
    )
    from dpcorr_torch.serve.ledger import BudgetExceededError, PrivacyLedger
    from dpcorr_torch.serve.stats import percentiles

    leg = 0.0625
    user_leg = 2 * leg
    user_budget = 2 * user_leg
    root = tempfile.mkdtemp(prefix="dpcorr_users_")
    try:
        directory = BudgetDirectory(
            os.path.join(root, "dir"), shards=shards,
            user_budget=user_budget, max_resident=max_resident,
            compact_every=None, fsync=False)
        comp = CompositeLedger(PrivacyLedger(1e9), directory)
        charges = {"pa": leg, "pb": leg}
        lat: list[float] = []
        admitted = refused = 0
        refused_levels: dict[str, int] = {}
        t0 = time.perf_counter()

        def charge(i: int, k: int) -> None:
            nonlocal admitted, refused
            aug = comp.augment(charges, user=f"u{i:07d}")
            t = time.perf_counter()
            try:
                comp.charge(aug, charge_id=f"c:{i}:{k}")
            except BudgetExceededError as e:
                refused += 1
                refused_levels[e.level] = refused_levels.get(e.level, 0) + 1
            else:
                admitted += 1
            lat.append(time.perf_counter() - t)

        for i in range(n_users):
            charge(i, 0)
        for i in range(0, n_users, 8):
            charge(i, 1)
        for i in range(0, n_users, 64):
            charge(i, 2)
        n_refunds = 0
        for i in range(0, n_users, 16):
            comp.refund(comp.augment(charges, user=f"u{i:07d}"),
                        charge_id=f"c:{i}:1", reason="shed")
            n_refunds += 1
        wall = time.perf_counter() - t0
        expect_admitted = n_users + -(-n_users // 8)
        expect_refused = -(-n_users // 64)
        counters = directory.counters()
        spot_every = max(1, n_users // 1000)
        spot_checked = spot_mismatches = 0
        for i in range(0, n_users, spot_every):
            want = (user_leg if i % 16 == 0
                    else user_budget if i % 8 == 0 else user_leg)
            spot_checked += 1
            if directory.spent(f"u{i:07d}") != want:
                spot_mismatches += 1
        gates = {
            "admitted_expected": admitted == expect_admitted,
            "refused_expected": refused == expect_refused
            and refused_levels == {"user": expect_refused},
            "directory_balance_exact":
                counters["charged_eps"] == user_leg * expect_admitted
                and counters["refunded_eps"] == user_leg * n_refunds,
            "ledger_balance_exact": all(
                comp.ledger.spent(p) == leg * (expect_admitted - n_refunds)
                for p in ("pa", "pb")),
            "spot_checks_exact": spot_checked > 0 and spot_mismatches == 0,
            "refusals_charge_free":
                comp.refusals_by_level()["user"] == expect_refused,
            "evictions": counters["evictions"] > 0,
            "rehydrations": counters["rehydrations"] > 0,
        }
        pct = percentiles(lat, (0.5, 0.99))
        out = {"users": n_users, "shards": directory.n_shards,
               "max_resident_per_shard": max_resident,
               "charges_admitted": admitted, "charges_refused": refused,
               "refunds": n_refunds, "wall_s": wall,
               "admissions_per_s": len(lat) / wall,
               "admission_p50_s": pct["p50"], "admission_p99_s": pct["p99"],
               "evictions": counters["evictions"],
               "rehydrations": counters["rehydrations"],
               "gates": gates, "ok": all(gates.values())}
        comp.close()
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--users", type=int, default=10**6,
                    help="users in the directory drill")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed releases per family and width")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perf_stream: needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    emit(card, "device", kind=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda)
    pairs = {"hrs": hrs_pair(),
             "stress": gaussian_pair(STRESS_ROWS, STREAM_SEED, "cuda")}
    for width, xy in pairs.items():
        for family in FAMILIES:
            emit(card, "release", width=width, family=family,
                 **release_cost(xy, family, "cuda", args.reps))
    drill = users_drill(args.users)
    emit(card, "users", **drill)
    return 0 if drill["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
