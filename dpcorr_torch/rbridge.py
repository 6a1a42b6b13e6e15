"""reticulate-facing bridge: plain-data API for the R front-end.

Counterpart of ``dpcorr/rbridge.py``. The reference's only process
boundary is the ``mclapply`` fan-out over design-grid rows
(vert-cor.R:534-554); ``r/backend_torch.R`` patches that call site with
``backend = c("cuda", "mclapply")`` and, for ``"cuda"``, calls into this
module through reticulate. Everything here speaks reticulate-native types:
a list of dicts in, a dict of numpy columns out (reticulate makes a named
list of it, which ``as.data.frame`` turns into the reference's frame), so
the R side stays a thin shim. Column order is the dict's insertion order;
``repl`` and ``n`` are int64, the detail fields f32 and the design
columns f64, as in the JAX bridge's frame.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from dpcorr_torch import grid as grid_mod
from dpcorr_torch.utils import rng
from dpcorr_torch.utils.device import resolve_device

#: the backends the bridge runs (``grid.BACKENDS`` less the composed one)
BACKENDS = ("local", "sharded", "bucketed")


def _design(rows: Sequence[Mapping]) -> dict[str, np.ndarray]:
    """The rows as the grid's design columns, indexed in row order."""
    return {"i": np.arange(len(rows), dtype=np.int64),
            "n": np.asarray([int(r["n"]) for r in rows], np.int64),
            "rho": np.asarray([float(r["rho"]) for r in rows], np.float64),
            "eps1": np.asarray([float(r["eps1"]) for r in rows], np.float64),
            "eps2": np.asarray([float(r["eps2"]) for r in rows], np.float64)}


def run_design_rows(rows: Sequence[Mapping], b: int = 250,
                    seed: int = rng.MASTER_SEED,
                    dgp: str = "gaussian", use_subg: bool = False,
                    alpha: float = 0.05, normalise: bool = True,
                    ci_mode: str = "auto",
                    backend: str = "local",
                    fused: str = "off",
                    bucket_merge: str = "off",
                    device=None) -> dict[str, np.ndarray]:
    """Run design-grid rows and return the replicate-level detail table.

    ``rows``: list of ``{"n": .., "rho": .., "eps1": .., "eps2": ..}``,
    the columns of the reference's ``design_df`` (vert-cor.R:507-511).
    Row i gets the key-tree counterpart of the reference's per-task
    ``seed = 1e6 + i`` (vert-cor.R:531), ``design_key(master, i)``.
    Returns the reference's metadata-joined detail columns
    (vert-cor.R:557-568): repl, the 12 detail fields, n, rho_true, eps1,
    eps2. ``backend``: "local" (``run_sim_one`` per row), "sharded"
    (``parallel.run_detail_sharded`` per row) or "bucketed" (one call per
    (n, ε) bucket; with ``fused="auto"`` eligible buckets run K1 on the
    card), all bit-equal but the fused buckets. ``device``: the card
    unless the caller names another.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {', '.join(BACKENDS)}; "
                         f"got {backend!r}")
    # same fail-fast contract as grid.run_grid: a typo'd or silently
    # inapplicable fused value must not run the wrong path
    grid_mod.validate_fused(fused, backend)
    # ε pairs for validation come from the rows (the merged bucket's
    # ε₁ ≥ ε₂ sender contract is checked against the design that runs);
    # validated for every backend, so a wrong knob fails alike
    row_pairs = tuple(sorted({(float(r["eps1"]), float(r["eps2"]))
                              for r in rows}))
    grid_mod.validate_bucket_merge(bucket_merge, backend, bool(use_subg),
                                   row_pairs)
    dev = resolve_device(device)
    master = rng.master_key(int(seed), dev)
    gcfg = grid_mod.GridConfig(
        b=int(b), alpha=float(alpha), dgp=dgp, use_subg=bool(use_subg),
        normalise=bool(normalise), ci_mode=ci_mode, seed=int(seed),
        backend=backend, fused=fused, bucket_merge=bucket_merge,
        eps_pairs=row_pairs, device=dev)
    design = _design(rows)
    by_i, _, failures = grid_mod.run_rows(gcfg, grid_mod._rows(design),
                                          master, None, dev)
    grid_mod._raise_if_failed(failures, len(design["i"]))
    return grid_mod._assemble_details(design, by_i, gcfg.b)


def run_hrs_sweep(eps_grid: Sequence[float], reps: int = 200,
                  seed: int = rng.MASTER_SEED, device=None,
                  panel_path: str | None = None) -> dict[str, np.ndarray]:
    """HRS ε-sweep for the R front-end (real-data-sims.R:342-448 seam):
    the per-(method, ε) summary table of ``hrs.eps_sweep`` on the panel
    at ``panel_path`` (default ``hrs.DEFAULT_PANEL``)."""
    from dpcorr_torch import hrs

    cfg = hrs.HrsConfig(seed=int(seed),
                        panel_path=panel_path or hrs.DEFAULT_PANEL)
    return hrs.eps_sweep(cfg, eps_grid=[float(e) for e in eps_grid],
                         reps=int(reps), device=device).summary
