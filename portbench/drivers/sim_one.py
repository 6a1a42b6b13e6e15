"""Monte-Carlo studies through the program's ``run_sim_one``, the CLI's
``stress`` path.

A study is ``sim.run_sim_one(SimConfig(..., b=study_reps,
chunk_size=sim.stress_chunk_size(study_reps, on_card)),
key=master_key(seed + study))``, built as ``python -m dpcorr_torch
stress`` builds it: the replications in chunks of the program's resident
width, each replication's sample streamed in n-chunks, the detail table
summarised with one host read of its twelve fields.

What is checked: after each study the window keeps a sample of its
replications, drawn from the seed (an ``index_select`` of the detail
table on the device, no host read); after the window each sampled
replication is held against the plain reference, on the estimate, the CI
ends and the cover of both estimators.
"""

from __future__ import annotations

import numpy as np
import torch

#: detail fields compared, per estimator: estimate, CI ends, cover
COMPARED = {"ni": ("ni_hat", "ni_low", "ni_up", "ni_cover"),
            "int": ("int_hat", "int_low", "int_up", "int_cover")}


def sim_config(sim, config: dict, on_card: bool):
    """The program's ``SimConfig`` of a configuration file."""
    b = int(config["study_reps"])
    eps1, eps2 = (float(e) for e in config["eps"])
    eta1, eta2 = (float(e) for e in config["eta"])
    return sim.SimConfig(
        n=int(config["n"]), rho=float(config["rho"]), eps1=eps1, eps2=eps2,
        b=b, alpha=float(config["alpha"]), dgp=config["dgp"],
        use_subg=bool(config["use_subg"]),
        subg_variant=config["subg_variant"], eta1=eta1, eta2=eta2,
        mixquant_mode=config["mixquant"],
        stream_n_chunk=int(config["stream_n_chunk"]),
        chunk_size=sim.stress_chunk_size(b, on_card=on_card))


def setup(run):
    from dpcorr_torch import sim
    from dpcorr_torch.utils import rng

    cell = run.cell
    dev = torch.device(run.device)
    cfg = sim_config(sim, run.config, dev.type == "cuda")
    per = int(cell["sample_per_study"])
    cap = int(cell["max_studies"])
    g = np.random.default_rng([int(run.seed) & 0xFFFFFFFF, 13])
    idx = g.integers(0, cfg.b, size=(cap, per))
    state = {"sim": sim, "rng": rng, "cfg": cfg, "run": run, "dev": dev,
             "idx": torch.as_tensor(idx, device=dev), "samples": []}
    # warm-up at the cell's own shape, its sampling included (so the
    # window's first gather loads nothing)
    study(state, -1)
    state["samples"].clear()
    return state


def study(state, index: int) -> dict:
    run, sim, rng = state["run"], state["sim"], state["rng"]
    res = sim.run_sim_one(state["cfg"],
                          key=rng.master_key(run.seed + index, state["dev"]),
                          device=state["dev"])
    if index < state["idx"].shape[0]:
        table = torch.stack([res.detail[f] for f in sim.DETAIL_FIELDS])
        state["samples"].append(
            table.index_select(1, state["idx"][max(index, 0)]))
    return {"reps": state["cfg"].b}


def collect(state) -> dict:
    """The sampled replications of each study, on the host, with their
    addresses."""
    fields = state["sim"].DETAIL_FIELDS
    n = len(state["samples"])
    per = state["idx"].shape[1]
    got = (torch.cat(state["samples"], dim=1).double().cpu().numpy()
           if n else np.zeros((len(fields), 0)))
    out = dict(zip(fields, got))
    out["study"] = np.repeat(np.arange(n), per)
    out["idx"] = state["idx"][:n].reshape(-1).cpu().numpy()
    return out


def rep_gaps(prog: dict, ref: dict, rho: float) -> np.ndarray:
    """Per sampled replication, the widest over both estimators of: the
    gap in the estimate and in each CI end, and for a cover that differs
    the reference's distance from rho to its nearer CI end (a flip at the
    edge is rounding; a flip away from it is not). NaN counts as
    infinite."""
    gaps = []
    for hat, lo, hi, cover in COMPARED.values():
        g = np.maximum.reduce([np.abs(prog[f] - ref[f])
                               for f in (hat, lo, hi)])
        margin = np.minimum(np.abs(rho - ref[lo]), np.abs(rho - ref[hi]))
        gaps.append(np.maximum(g, (prog[cover] != ref[cover]) * margin))
    g = np.maximum.reduce(gaps)
    return np.where(np.isfinite(g), g, np.inf)


def numbers(answers: dict, run, control: bool = False) -> dict:
    """The numbers ``correct`` is decided on: the median and the share
    above the cell's ``tau`` of the per-replication gaps. With
    ``control`` the reference in bf16 stands in for the program."""
    ref_mod = run.reference
    seeds = [run.seed + int(s) for s in answers["study"]]
    ref = ref_mod.outputs(run.config, seeds, answers["idx"],
                          device=run.device)
    prog = answers
    if control:
        prog = ref_mod.outputs(run.config, seeds, answers["idx"],
                               device=run.device, dtype=torch.bfloat16)
    g = rep_gaps(prog, ref, float(np.float32(run.config["rho"])))
    return {"median_gap": float(np.median(g)) if g.size else float("nan"),
            "share_over_tau": float(np.mean(g > float(run.cell["tau"])))
            if g.size else float("nan")}
