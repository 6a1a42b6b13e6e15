"""Monte-Carlo studies through the program's replication-block pipeline.

A study is ``RepBlockPipeline(body, 3, key=master_key(seed + study),
block_reps, chunk_size).run(1)``: one block of replications, in chunks,
summed on the device and read back once. The body is the north star's
replication (NI sign-batch estimate and CI on a Gaussian pair), fused
(the kernel with in-kernel Philox) or unfused (torch ops on the
key-tree), as the cell says.

What is checked: after each study the window keeps a sample of its
per-replication outputs, drawn from the seed (a gather on the device, no
host read); after the window each sampled replication is held against
the plain reference, and the last study's read-back sums against the sum
of its outputs.
"""

from __future__ import annotations

import numpy as np
import torch


def setup(run):
    from dpcorr_torch import sim
    from dpcorr_torch.utils import rng

    cfg, cell = run.config, run.cell
    n, rho, alpha = int(cfg["n"]), float(cfg["rho"]), float(cfg["alpha"])
    eps1, eps2 = (float(e) for e in cfg["eps"])
    make = {"fused": sim.fused_ni_rep_fn, "unfused": sim.ni_rep_fn}
    body = make[cell["body"]](n, rho, eps1, eps2, alpha)
    per = int(cell["sample_per_study"])
    cap = int(cell["max_studies"])
    g = np.random.default_rng([int(run.seed) & 0xFFFFFFFF, 7])
    idx = g.integers(0, int(cell["block_reps"]), size=(cap, per))
    state = {"sim": sim, "rng": rng, "body": body, "run": run,
             "dev": torch.device(run.device),
             "idx": torch.as_tensor(idx, device=run.device),
             "samples": [], "sums": None, "last": None}
    study(state, -1)  # warm-up at the cell's own shape
    state["samples"].clear()
    return state


def study(state, index: int) -> dict:
    run, sim, rng = state["run"], state["sim"], state["rng"]
    cell = run.cell
    pipe = sim.RepBlockPipeline(
        state["body"], 3, key=rng.master_key(run.seed + index, state["dev"]),
        block_reps=int(cell["block_reps"]),
        chunk_size=int(cell["chunk_size"]), device=state["dev"])
    sums, reps = pipe.run(1)
    out = block_outputs(pipe)
    if 0 <= index < state["idx"].shape[0]:
        state["samples"].append(out.index_select(1, state["idx"][index]))
    state["sums"], state["last"] = sums, out
    return {"reps": reps}


def block_outputs(pipe) -> torch.Tensor:
    """The (3, block_reps) per-replication outputs the pipeline's last
    block left in its output buffer."""
    shards = getattr(pipe, "_shards", None)
    if not shards or len(shards) != 1:
        raise RuntimeError("the pipeline no longer exposes one shard's "
                           "output buffer; the benchmark reads it")
    return shards[0].out


def collect(state) -> dict:
    """The program's outputs, on the host: the sampled replications of
    each study with their addresses, and the last study's read-back sums
    beside the exact (f64) and the bf16 sums of its outputs."""
    run = state["run"]
    n = len(state["samples"])
    per = state["idx"].shape[1]
    got = (torch.cat(state["samples"], dim=1).double().cpu().numpy()
           if n else np.zeros((3, 0)))
    out = state["last"]
    chunk = int(run.cell["chunk_size"])
    exact = out.double().sum(dim=1).cpu().numpy()
    # the control's accumulation: chunk sums and the total in bf16
    acc = torch.zeros(3, dtype=torch.bfloat16, device=out.device)
    for a in range(0, out.shape[1], chunk):
        acc += out[:, a:a + chunk].to(torch.bfloat16).sum(dim=1)
    return {"se2": got[0], "cover": got[1], "ci_len": got[2],
            "study": np.repeat(np.arange(n), per),
            "idx": state["idx"][:n].reshape(-1).cpu().numpy(),
            "sums": np.asarray(state["sums"], dtype=np.float64),
            "exact": exact,
            "sums_bf16": acc.double().cpu().numpy()}


def rep_gaps(prog: dict, ref: dict, rho: float) -> np.ndarray:
    """Per sampled replication, the widest of: the gap in |rho_hat - rho|,
    the gap in CI length, and for a cover that differs the reference's
    distance from rho to its nearer CI end (a flip at the edge is
    rounding; a flip away from it is not). NaN counts as infinite."""
    with np.errstate(invalid="ignore"):  # a negative se^2 reads as NaN
        g = np.maximum(np.abs(np.sqrt(prog["se2"]) - np.sqrt(ref["se2"])),
                       np.abs(prog["ci_len"] - ref["ci_len"]))
    margin = np.minimum(np.abs(rho - ref["lo"]), np.abs(rho - ref["hi"]))
    g = np.maximum(g, (prog["cover"] != ref["cover"]) * margin)
    return np.where(np.isfinite(g), g, np.inf)


def numbers(answers: dict, run, control: bool = False) -> dict:
    """The numbers ``correct`` is decided on: the median and the share
    above the cell's ``tau`` of the per-replication gaps, and the relative gap of
    the read-back sums. With ``control`` the reference in bf16 stands in
    for the program."""
    ref_mod = run.reference
    seeds = [run.seed + int(s) for s in answers["study"]]
    ref = ref_mod.outputs(run.config, run.cell["body"], seeds,
                          answers["idx"], device=run.device)
    prog = answers
    sums = answers["sums"]
    if control:
        prog = ref_mod.outputs(run.config, run.cell["body"], seeds,
                               answers["idx"], device=run.device,
                               dtype=torch.bfloat16)
        sums = answers["sums_bf16"]
    g = rep_gaps(prog, ref, float(np.float32(run.config["rho"])))
    scale = np.maximum(np.abs(answers["exact"]), 1.0)
    return {"median_gap": float(np.median(g)) if g.size else float("nan"),
            "share_over_tau": float(np.mean(g > float(run.cell["tau"])))
            if g.size else float("nan"),
            "sum_gap": float(np.max(np.abs(sums - answers["exact"]) / scale))}
