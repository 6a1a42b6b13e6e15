"""HRS real-data pipeline (reference real-data-sims.R, components #25-#34).

Counterpart of ``dpcorr/hrs.py``: the BMI-against-age DP correlation on
wave 2 of the HRS long panel.

1. ingest through the port's RDS reader (real-data-sims.R:13);
2. per-wave missingness (:16-33);
3. wave-2 complete cases (:38-41);
4. central-DP standardisation of both variables, λ bounds from the
   private moments (:273-287);
5. point estimates: NI clipped batches with λ overrides and randomized
   batches, and INT with AGE as sender (:290-323);
6. the ε-sweep: per ε of a grid, replications of both estimators
   (:342-448), one call per method and ε over all replications, every ε
   dispatched before the first is read back;
7. the bootstrap: row resamples with fresh DP noise (BASELINE.md
   config 4), in chunks of replications (``sim.chunked``).

Everything after the column extraction runs on the device (the card
unless the caller passes ``device="cpu"``). Tables are dicts of numpy
columns in the JAX package's frames' column and row order; the
summaries reproduce pandas' grouped means and quantiles.

Scalars enter the estimators as the JAX package hands them over: Python
numbers where it calls them eagerly (the point estimates), f32 tensors
where its jitted kernels take them as traced arguments (the sweep's ε,
λ, λ_r and δ; the bootstrap's λ, λ_r and δ), so each division rounds as
XLA's does.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from dpcorr_torch.grid import _group_mean
from dpcorr_torch.io.rds import read_rds_table
from dpcorr_torch.models.estimators import ci_int_subg, correlation_ni_subg
from dpcorr_torch.models.estimators.common import (
    k_pad_for,
    warn_f32_geometry_band_once,
)
from dpcorr_torch.obs import trace as obs_trace
from dpcorr_torch.ops.lambdas import (
    lambda_from_priv,
    lambda_receiver_from_noise,
)
from dpcorr_torch.ops.standardize import dp_sd, standardize_dp
from dpcorr_torch.sim import chunked, stage
from dpcorr_torch.utils import rng
from dpcorr_torch.utils.device import f32_on, resolve_device
from dpcorr_torch.utils.profiling import (
    HOST_READ,
    outermost,
    outermost_stage,
)

#: the panel's place in a checkout of the repository (the JAX package
#: reads the same file from its data directory); not in the repository
DEFAULT_PANEL = str(Path(__file__).resolve().parents[1] / "reference"
                    / "hrs_long_panel.rds")

#: the reference's ε grid, 0.25 … 2.45 by 0.1 (real-data-sims.R:345)
EPS_GRID = tuple(float(e) for e in np.round(np.arange(0.25, 2.5001, 0.1),
                                            10))
SWEEP_FIELDS = ("rho_hat", "ci_low", "ci_high")
BOOT_FIELDS = ("ni_hat", "ni_low", "ni_high", "int_hat", "int_low",
               "int_high")
#: bootstrap replications resident per chunk on the card: 4,775, 5,604,
#: 6,263, 6,732 and 6,833 reps/s at 256 … 4096 resident on an H100 at
#: n = 19,433, peak 3.3 GiB at 2048 and 6.5 at 4096 (``python -m
#: dpcorr_torch.perf_hrs``, PERF.md §5); on the CPU the JAX package's
#: default, not measured for the port
BOOT_CHUNK_CARD = 2048
BOOT_CHUNK_CPU = 64
#: the stages a sweep ε and a bootstrap chunk mark (``sim.stage``)
HRS_STAGES = ("hrs_keys", "hrs_resample", "hrs_ni", "hrs_int")


@dataclasses.dataclass(frozen=True)
class HrsConfig:
    """The reference's script globals (real-data-sims.R:260-270)."""

    panel_path: str = DEFAULT_PANEL
    wave: str = "2"
    age_lo: float = 45.0
    age_hi: float = 90.0
    bmi_lo: float = 15.0
    bmi_hi: float = 35.0
    eps_mean: float = 0.10
    eps_m2: float = 0.10
    eps_corr: float = 2.00
    alpha: float = 0.05
    seed: int = rng.MASTER_SEED
    mixquant_mode: str = "det"


# ---------------------------------------------------------------- ingest ----
def load_panel(path: str = DEFAULT_PANEL) -> Mapping:
    """Read the HRS long panel (723,744 × 8; SURVEY.md Appendix B)."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"HRS panel not found at {path}: the panel is not part of the "
            f"repository; place hrs_long_panel.rds there, or pass "
            f"HrsConfig(panel_path=...) or cols=")
    return read_rds_table(path)


def wave_missingness(cols: Mapping) -> dict[str, np.ndarray]:
    """Per-wave n, missing age, missing BMI and complete cases
    (real-data-sims.R:16-33), waves in numeric order."""
    wave = np.asarray(cols["wave"].values, dtype=object)
    age, bmi = cols["agey_e"].values, cols["bmi"].values
    rows = []
    for w in sorted(set(wave.tolist()), key=int):
        m = wave == w
        a_miss, b_miss = np.isnan(age[m]), np.isnan(bmi[m])
        rows.append((int(w), int(m.sum()), int(a_miss.sum()),
                     int(b_miss.sum()), int((~a_miss & ~b_miss).sum())))
    names = ("wave", "n", "missing_age", "missing_bmi", "complete")
    return {k: np.asarray([r[j] for r in rows], dtype=np.int64)
            for j, k in enumerate(names)}


def extract_wave(cols: Mapping, wave: str = "2"):
    """Complete-case (hhidpn, age, bmi) of one wave (real-data-sims.R:38-41),
    age and BMI as f32. NA removal is on the host, before any device
    work."""
    m = np.asarray(cols["wave"].values, dtype=object) == wave
    age = cols["agey_e"].values[m]
    bmi = cols["bmi"].values[m]
    ids = cols["hhidpn"].values[m]
    ok = ~np.isnan(age) & ~np.isnan(bmi)
    return ids[ok], age[ok].astype(np.float32), bmi[ok].astype(np.float32)


# ------------------------------------------------------- standardization ----
@dataclasses.dataclass(frozen=True)
class Standardized:
    """Private standardisation: z-scores on the device, private moments,
    λ bounds and the non-private baseline ρ as floats."""

    age_z: torch.Tensor
    bmi_z: torch.Tensor
    age_mean: float
    age_sd: float
    bmi_mean: float
    bmi_sd: float
    lam_age: float
    lam_bmi: float
    rho_np: float  # non-private baseline on the standardized data (:349)


def _corrcoef(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.corrcoef(a, b)[0, 1]``: centred cross moment over the product
    of the standard deviations (denominators n − 1), clipped to [−1, 1]."""
    n = a.shape[-1]
    da, db = a - a.mean(-1), b - b.mean(-1)
    c_ab = (da * db).sum(-1) / (n - 1)
    sd_a = torch.sqrt((da * da).sum(-1) / (n - 1))
    sd_b = torch.sqrt((db * db).sum(-1) / (n - 1))
    return torch.clamp(c_ab / sd_a / sd_b, -1.0, 1.0)


@outermost("hrs_standardize")
def standardize(age: np.ndarray, bmi: np.ndarray, cfg: HrsConfig,
                key: torch.Tensor | None = None,
                device=None) -> Standardized:
    """DP-standardize both variables and derive their λ bounds
    (real-data-sims.R:273-287): streams ``"hrs/std/age"`` and
    ``"hrs/std/bmi"`` of the master key, one host read for the moments
    and ρ and one for the two λ, all inside an ``hrs_standardize``
    range (none of its own inside one the caller opened)."""
    dev = resolve_device(device)
    key = rng.master_key(cfg.seed, dev) if key is None else key.to(dev)
    age_t = torch.as_tensor(age, dtype=torch.float32).to(dev)
    bmi_t = torch.as_tensor(bmi, dtype=torch.float32).to(dev)
    a_mu, a_sd = dp_sd(rng.stream(key, "hrs/std/age"), age_t, cfg.age_lo,
                       cfg.age_hi, cfg.eps_mean, cfg.eps_m2)
    b_mu, b_sd = dp_sd(rng.stream(key, "hrs/std/bmi"), bmi_t, cfg.bmi_lo,
                       cfg.bmi_hi, cfg.eps_mean, cfg.eps_m2)
    age_z = standardize_dp(age_t, a_mu, a_sd, cfg.age_lo, cfg.age_hi)
    bmi_z = standardize_dp(bmi_t, b_mu, b_sd, cfg.bmi_lo, cfg.bmi_hi)
    corr = _corrcoef(age_z, bmi_z)
    moments = torch.stack([a_mu, a_sd, b_mu, b_sd, corr])
    with stage(HOST_READ):
        a_mu, a_sd, b_mu, b_sd, corr = moments.tolist()
    lam_t = [lambda_from_priv(lo, hi, mu, sd, device=dev)
             for lo, hi, mu, sd in ((cfg.age_lo, cfg.age_hi, a_mu, a_sd),
                                    (cfg.bmi_lo, cfg.bmi_hi, b_mu, b_sd))]
    with stage(HOST_READ):
        lam = [float(v) for v in lam_t]
    return Standardized(age_z, bmi_z, a_mu, a_sd, b_mu, b_sd, lam[0], lam[1],
                        corr)


# ------------------------------------------------------------- estimators ----
def _ni_once(key, age_z, bmi_z, eps, lam_age, lam_bmi, alpha):
    """One NI run at privacy ε: λ overrides, randomized batches
    (real-data-sims.R:355-372)."""
    return correlation_ni_subg(key, age_z, bmi_z, eps, eps, alpha=alpha,
                               lambda_x=lam_age, lambda_y=lam_bmi,
                               randomize_batches=True, enforce_min_k=True)


def _int_once(key, age_z, bmi_z, eps, lam_age, lam_bmi, lam_recv, delta,
              alpha, mixquant_mode):
    """One INT run at ε, AGE as sender (real-data-sims.R:374-404):
    ε₁ = ε₂ = ε makes the sender rule pick X = age."""
    return ci_int_subg(key, age_z, bmi_z, eps, eps, alpha=alpha,
                       variant="real", lambda_sender=lam_age,
                       lambda_other=lam_bmi, lambda_receiver=lam_recv,
                       delta_clip=delta, mixquant_mode=mixquant_mode)


@dataclasses.dataclass
class HrsPointResult:
    ni: dict
    int_: dict
    std: Standardized
    n: int
    config: HrsConfig


def _wave_arrays(cfg: HrsConfig, cols):
    """Wave ``cfg.wave``'s complete-case age and BMI, from ``cols`` or,
    when None, from the panel file; inside an ``hrs_wave`` range."""
    with stage("hrs_wave"):
        cols = load_panel(cfg.panel_path) if cols is None else cols
        _, age, bmi = extract_wave(cols, cfg.wave)
    return age, bmi


def point_estimates(cfg: HrsConfig = HrsConfig(), cols=None,
                    device=None) -> HrsPointResult:
    """The headline HRS numbers (real-data-sims.R:259-333): one NI and one
    INT (AGE→BMI) estimate at ε_corr on the privately standardized data,
    streams ``"hrs/ni"`` and ``"hrs/int"``; each dict carries the CI and
    the λ/geometry block (real-data-sims.R:141-147, 244-252)."""
    dev = resolve_device(device)
    age, bmi = _wave_arrays(cfg, cols)
    std = standardize(age, bmi, cfg, device=dev)
    n = int(age.shape[0])
    delta = 1.0 / n
    lam_recv = float(lambda_receiver_from_noise(std.lam_age, std.lam_bmi,
                                                cfg.eps_corr, delta,
                                                device=dev))
    key = rng.master_key(cfg.seed, dev)
    ni = _ni_once(rng.stream(key, "hrs/ni"), std.age_z, std.bmi_z,
                  cfg.eps_corr, std.lam_age, std.lam_bmi, cfg.alpha)
    it = _int_once(rng.stream(key, "hrs/int"), std.age_z, std.bmi_z,
                   cfg.eps_corr, std.lam_age, std.lam_bmi, lam_recv, delta,
                   cfg.alpha, cfg.mixquant_mode)

    def as_dict(r):
        out = {"rho_hat": float(r.rho_hat), "ci_low": float(r.ci_low),
               "ci_high": float(r.ci_high)}
        out.update({k: float(v) for k, v in r.aux.items()})
        return out

    return HrsPointResult(as_dict(ni), as_dict(it), std, n, cfg)


# --------------------------------------------------------------- ε-sweep ----
@dataclasses.dataclass
class HrsSweep:
    """``runs``: one row per (ε, method, replication), the JAX package's
    ``attrs["runs"]`` frame; ``summary``: one row per (method, ε), its
    summary frame; ``rho_np``: the non-private baseline."""

    runs: dict
    summary: dict
    rho_np: float


def _sweep_dispatch(k_eps, std: Standardized, eps_t, lam_recv, delta_t,
                    reps: int, k_pad: int, cfg: HrsConfig) -> torch.Tensor:
    """Enqueue one ε of the sweep, NI then INT over ``reps`` replications
    each, with nothing read back: returns their (6, reps) results. NI runs
    with per-replication geometry padded to ``k_pad``, INT with the sender
    named ``"x"`` (AGE), as the JAX package's sweep kernels do."""
    n = std.age_z.shape[-1]
    age = std.age_z.expand(reps, n)
    bmi = std.bmi_z.expand(reps, n)
    lam_age, lam_bmi = (f32_on(v, eps_t.device)
                        for v in (std.lam_age, std.lam_bmi))
    with stage("hrs_keys"):
        keys_ni = rng.rep_keys(rng.stream(k_eps, "hrs/sweep/ni"), reps)
        keys_int = rng.rep_keys(rng.stream(k_eps, "hrs/sweep/int"), reps)
    with stage("hrs_ni"):
        ni = correlation_ni_subg(
            keys_ni, age, bmi, eps_t, eps_t, alpha=cfg.alpha,
            lambda_x=lam_age, lambda_y=lam_bmi, randomize_batches=True,
            enforce_min_k=True, dynamic_geometry=True, k_pad=k_pad)
    with stage("hrs_int"):
        it = ci_int_subg(
            keys_int, age, bmi, eps_t, eps_t, alpha=cfg.alpha,
            variant="real", lambda_sender=lam_age, lambda_other=lam_bmi,
            lambda_receiver=lam_recv, delta_clip=delta_t,
            mixquant_mode=cfg.mixquant_mode, sender="x")
    return torch.stack([ni.rho_hat, ni.ci_low, ni.ci_high,
                        it.rho_hat, it.ci_low, it.ci_high])


def _quantile(col: np.ndarray, q: float) -> float:
    """pandas' linear quantile of a group (``groupby().quantile``): in
    f64, v[⌊h⌋] + (v[⌊h⌋ + 1] − v[⌊h⌋])·frac(h) at h = q·(n − 1)."""
    v = np.sort(col.astype(np.float64))
    h = q * (len(v) - 1)
    lo = int(h)
    frac = h % 1
    return float(v[lo] if frac == 0.0 else v[lo] + (v[lo + 1] - v[lo]) * frac)


def summarize_sweep(runs: Mapping[str, np.ndarray]) -> dict:
    """The per-(method, ε) summary of a runs table (real-data-sims.R:
    416-448), as ``groupby(["method", "eps_corr"], sort=True)`` gives it:
    means of ρ̂ and the CI ends (pandas' Kahan f32 sums,
    ``grid._group_mean``), the q10 of the CI lows and the q90 of the CI
    highs (pandas' linear quantile)."""
    method = np.asarray(runs["method"])
    eps = np.asarray(runs["eps_corr"], dtype=np.float64)
    keys = sorted(set(zip(method.tolist(), eps.tolist())))
    index = {k: g for g, k in enumerate(keys)}
    groups = np.asarray([index[k] for k in zip(method.tolist(),
                                               eps.tolist())])
    out = {"method": np.asarray([k[0] for k in keys]),
           "eps_corr": np.asarray([k[1] for k in keys])}
    for f in SWEEP_FIELDS:
        out[f"{f}_mean"] = _group_mean(np.asarray(runs[f]), groups,
                                       len(keys))
    for f, q in (("ci_low", 0.10), ("ci_high", 0.90)):
        col = np.asarray(runs[f])
        out[f"{f}_q{round(q * 100)}"] = np.asarray(
            [_quantile(col[groups == g], q) for g in range(len(keys))])
    return out


def eps_sweep(cfg: HrsConfig = HrsConfig(), cols=None, eps_grid=None,
              reps: int = 200, progress: bool = False,
              device=None) -> HrsSweep:
    """The ε-sweep (real-data-sims.R:342-448): for each ε of the grid
    (default :data:`EPS_GRID`), ``reps`` replications of NI and INT on
    the standardized data, keys ``rep_keys(stream(design_key(master,
    ε index), "hrs/sweep/ni" | "hrs/sweep/int"), reps)``.

    Every receiver λ is computed before the first dispatch; every ε is
    dispatched before the first is read back, under one ``hrs.eps_sweep``
    span with an ``hrs.dispatch`` and an ``hrs.fetch`` child per ε. NI's
    padded batch vectors take one ``k_pad`` from the whole grid, as the
    JAX package's do, so its noise layout matches."""
    dev = resolve_device(device)
    age, bmi = _wave_arrays(cfg, cols)
    std = standardize(age, bmi, cfg, device=dev)
    n = int(age.shape[0])
    delta = 1.0 / n
    eps_grid = [float(e) for e in (EPS_GRID if eps_grid is None
                                   else eps_grid)]
    master = rng.master_key(cfg.seed, dev)
    eps_all = torch.tensor(eps_grid, dtype=torch.float32).to(dev)
    lam_recvs = lambda_receiver_from_noise(std.lam_age, std.lam_bmi, eps_all,
                                           delta)
    # the per-replication geometry is the f32 rule: say once if an ε sits
    # in the band where it picks another m than the static f64 rule
    warn_f32_geometry_band_once([(e, e) for e in eps_grid], n=n,
                                where="hrs.eps_sweep")
    k_pad = k_pad_for(n, [e * e for e in eps_grid])
    delta_t = f32_on(delta, dev)
    tr = obs_trace.tracer()
    root = tr.start_span("hrs.eps_sweep", n=n, n_eps=len(eps_grid),
                         reps=reps)
    try:
        pending = []
        for i, eps in enumerate(eps_grid):
            dsp = tr.start_span("hrs.dispatch", parent=root, eps=eps)
            try:
                pending.append((eps, _sweep_dispatch(
                    rng.design_key(master, i), std, eps_all[i],
                    lam_recvs[i], delta_t, reps, k_pad, cfg)))
                if progress:
                    print(f"eps={eps:.2f}: dispatched "
                          f"({i + 1}/{len(eps_grid)})", flush=True)
            finally:
                dsp.end()
        parts = []
        for eps, out in pending:
            fsp = tr.start_span("hrs.fetch", parent=root, eps=eps)
            try:
                host = out.cpu().numpy()  # this ε's one host read
            finally:
                fsp.end()
            parts.append((eps, host))
            if progress:
                print(f"eps={eps:.2f}: NI mean {host[0].mean():+.4f}, "
                      f"INT mean {host[3].mean():+.4f}", flush=True)
        runs = _sweep_runs(parts, reps)
        summary = summarize_sweep(runs)
    finally:
        root.end()
    return HrsSweep(runs, summary, std.rho_np)


def _sweep_runs(parts, reps: int) -> dict:
    """Per ε, the NI rows then the INT rows (the JAX package's concat
    order): method, eps_corr, rep (1-based), rho_hat, ci_low, ci_high."""
    blocks = [(meth, eps, host[3 * j: 3 * j + 3])
              for eps, host in parts for j, meth in enumerate(("NI", "INT"))]
    runs = {"method": np.repeat([b[0] for b in blocks], reps),
            "eps_corr": np.repeat([b[1] for b in blocks], reps),
            "rep": np.tile(np.arange(1, reps + 1), len(blocks))}
    for c, f in enumerate(SWEEP_FIELDS):
        runs[f] = np.concatenate([b[2][c] for b in blocks])
    return runs


# -------------------------------------------------------------- bootstrap ----
@dataclasses.dataclass
class HrsBootstrap:
    """``runs``: the six per-replication columns (:data:`BOOT_FIELDS`);
    ``summary``: per method the mean, sd (ddof 1), q025 and q975 of ρ̂;
    ``rho_np``: the non-private baseline; ``chunk``: replications
    resident per chunk."""

    runs: dict
    summary: dict
    rho_np: float
    chunk: int


def _boot_reps(keys, age_z, bmi_z, eps: float, lam_age, lam_bmi, lam_recv,
               delta, alpha: float, mixquant_mode: str) -> tuple:
    """Replications ``keys`` (C, 2) of the bootstrap: per replication a
    with-replacement resample of the rows (stream ``"hrs/boot/idx"``,
    gathered on the device), then NI and INT on the resample (streams
    ``"hrs/boot/ni"``, ``"hrs/boot/int"``)."""
    n = age_z.shape[-1]
    with stage("hrs_resample"):
        idx = rng.choice(rng.stream(keys, "hrs/boot/idx"), n, (n,))
        a, b = age_z[idx], bmi_z[idx]
    with stage("hrs_ni"):
        ni = _ni_once(rng.stream(keys, "hrs/boot/ni"), a, b, eps, lam_age,
                      lam_bmi, alpha)
    with stage("hrs_int"):
        it = _int_once(rng.stream(keys, "hrs/boot/int"), a, b, eps,
                       lam_age, lam_bmi, lam_recv, delta, alpha,
                       mixquant_mode)
    return (ni.rho_hat, ni.ci_low, ni.ci_high,
            it.rho_hat, it.ci_low, it.ci_high)


def boot_chunk_size(reps: int, on_card: bool) -> int:
    """Bootstrap replications resident at once: :data:`BOOT_CHUNK_CARD`
    on the card (a chunk costs the same launches whatever its width),
    :data:`BOOT_CHUNK_CPU` on the CPU. Outputs do not depend on it."""
    return min(reps, BOOT_CHUNK_CARD if on_card else BOOT_CHUNK_CPU)


def _series_summary(col: np.ndarray) -> dict:
    """pandas' ``Series.mean``, ``std(ddof=1)`` and ``quantile`` of an f32
    column: the mean an f32 sum over an f32 count, the sd a two-pass f64
    variance rounded to f32, the quantiles numpy's linear quantiles at f64
    levels (the f32 difference of neighbours, interpolated in f64)."""
    n = len(col)
    mean = col.sum(dtype=col.dtype) / col.dtype.type(n)
    avg = col.sum(dtype=np.float64) / n
    var = (((avg - col) ** 2).sum(dtype=np.float64) / (n - 1)).astype(
        col.dtype)
    q025, q975 = np.quantile(col, np.asarray([0.025, 0.975]),
                             method="linear")
    return {"mean": float(mean), "sd": float(np.sqrt(var)),
            "q025": float(q025), "q975": float(q975)}


def bootstrap(cfg: HrsConfig = HrsConfig(), cols=None, reps: int = 10_000,
              eps: float | None = None, chunk: int | None = None,
              device=None) -> HrsBootstrap:
    """``reps`` bootstrap replications (row resampling and fresh DP noise)
    of the headline estimates at ``eps`` (default ε_corr), keys
    ``rep_keys(stream(master, "hrs/boot"), reps)``, ``chunk`` replications
    at a time (default :func:`boot_chunk_size`)."""
    dev = resolve_device(device)
    age, bmi = _wave_arrays(cfg, cols)
    # one hrs_standardize range over the standardisation and the scalars
    # the chunks take from it
    with outermost_stage("hrs_standardize"):
        std = standardize(age, bmi, cfg, device=dev)
        n = int(age.shape[0])
        eps = cfg.eps_corr if eps is None else float(eps)
        delta = 1.0 / n
        lam_recv = lambda_receiver_from_noise(std.lam_age, std.lam_bmi, eps,
                                              delta, device=dev)
        chunk = chunk or boot_chunk_size(reps, dev.type == "cuda")
        lam_age, lam_bmi, delta_t = (f32_on(v, dev) for v in
                                     (std.lam_age, std.lam_bmi, delta))
    keys = rng.rep_keys(rng.stream(rng.master_key(cfg.seed, dev),
                                   "hrs/boot"), reps)
    out = torch.stack(chunked(
        lambda k: _boot_reps(k, std.age_z, std.bmi_z, eps, lam_age,
                             lam_bmi, lam_recv, delta_t, cfg.alpha,
                             cfg.mixquant_mode), keys, chunk))
    with stage(HOST_READ):
        host = out.cpu().numpy()  # the run's one host read
    runs = dict(zip(BOOT_FIELDS, host, strict=True))
    summary = {meth: _series_summary(runs[f"{meth}_hat"])
               for meth in ("ni", "int")}
    return HrsBootstrap(runs, summary, std.rho_np, chunk)

