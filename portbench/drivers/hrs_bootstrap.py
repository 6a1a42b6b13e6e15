"""The HRS bootstrap through the program's ``hrs.bootstrap``.

A study is ``hrs.bootstrap(HrsConfig(seed=seed + study), cols=panel,
reps, eps, chunk)``: private standardisation, then replications in
chunks, each resampling the 19,433 rows and running NI and INT, with one
host read of all six columns. The window keeps a sample of each study's
rows, drawn from the seed; after it they are held against the plain
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.panel import synthetic_panel, wave_cases

FIELDS = ("ni_hat", "ni_low", "ni_high", "int_hat", "int_low", "int_high")


def setup(run):
    from dpcorr_torch import hrs

    cfg, cell = run.config, run.cell
    # the panel (handed to the program) and its wave-2 complete cases
    # (handed to the reference), both from the run's seed
    cols = synthetic_panel(run.seed)
    age, bmi = wave_cases(cols, cfg["wave"])
    g = np.random.default_rng([int(run.seed) & 0xFFFFFFFF, 11])
    rows = g.integers(0, int(cfg["boot_reps"]),
                      size=(int(cell["max_studies"]),
                            int(cell["sample_per_study"])))
    state = {"hrs": hrs, "run": run, "cols": cols, "age": age, "bmi": bmi,
             "rows": rows, "got": []}
    study(state, -1)  # warm-up at the cell's own shape
    state["got"].clear()
    return state


def study(state, index: int) -> dict:
    hrs, run = state["hrs"], state["run"]
    cfg = run.config
    res = hrs.bootstrap(
        hrs.HrsConfig(seed=run.seed + index, eps_mean=cfg["eps_mean"],
                      eps_m2=cfg["eps_m2"], alpha=cfg["alpha"],
                      mixquant_mode=cfg["mixquant"]),
        cols=state["cols"], reps=int(cfg["boot_reps"]),
        eps=float(cfg["eps_corr"]), chunk=int(run.cell["chunk"]),
        device=run.device)
    if 0 <= index < state["rows"].shape[0]:
        rows = state["rows"][index]
        state["got"].append((index, rows,
                             {f: res.runs[f][rows] for f in FIELDS}))
    return {"reps": len(res.runs[FIELDS[0]])}


def collect(state) -> dict:
    return {"got": state["got"], "age": state["age"], "bmi": state["bmi"]}


def numbers(answers: dict, run, control: bool = False) -> dict:
    """The median and the share above tau of the per-row gaps between the
    program's bootstrap rows and the reference's (with ``control`` the
    reference in bf16 takes the program's place)."""
    ref_mod = run.reference
    cfg = run.config
    prog = {f: [] for f in FIELDS}
    ref = {f: [] for f in FIELDS}
    for index, rows, vals in answers["got"]:
        kw = dict(eps=float(cfg["eps_corr"]), device=run.device)
        want = ref_mod.bootstrap_rows(cfg, answers["age"], answers["bmi"],
                                      run.seed + index, rows, **kw)
        have = vals if not control else ref_mod.bootstrap_rows(
            cfg, answers["age"], answers["bmi"], run.seed + index, rows,
            dtype=torch.bfloat16, **kw)
        for f in FIELDS:
            prog[f].extend(have[f])
            ref[f].extend(want[f])
    if not prog[FIELDS[0]]:
        return {"median_gap": float("nan"), "share_over_tau": float("nan")}
    # per sampled row the widest gap over its fields, NaN infinite
    g = np.max([np.abs(np.asarray(prog[f]) - np.asarray(ref[f]))
                for f in FIELDS], axis=0)
    g = np.where(np.isfinite(g), g, np.inf)
    return {"median_gap": float(np.median(g)),
            "share_over_tau": float(np.mean(g > float(run.cell["tau"])))}
