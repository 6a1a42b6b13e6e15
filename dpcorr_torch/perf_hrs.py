"""The HRS pipeline at the panel's full size, and its measurements on one
card.

    python -m dpcorr_torch.perf_hrs

The HRS panel is not in the repository, so :func:`synthetic_panel` builds
one with its shape from a seed (SURVEY.md Appendix B): 723,744 rows,
16 waves of 45,234 rows, the eight columns by name, ``wave`` a character
column "1" … "16", ``agey_e`` and ``bmi`` doubles with NA whose values
reach past the clip bounds [45, 90] and [15, 35], correlated so that the
non-private ρ on the standardized data is about −0.19, and exactly
19,433 complete cases in wave 2 (``docs/ARCHITECTURE.md:193``). The
other four columns are plain doubles and strings (the real panel holds
factors and haven labels there, which the pipeline never reads).

Run as a script, on the card only:

1. writes the panel as gzip RDS with the port's writer and reads it back
   (seconds each);
2. the bootstrap at several chunk widths (what ``hrs.BOOT_CHUNK_CARD``
   is chosen from): replications per second and peak device memory;
3. one ε of the sweep and one bootstrap chunk at its chosen width, split
   by the stages they mark (``hrs.HRS_STAGES``) as
   ``perf_fused.stage_split`` splits a block: host ms, device activities
   and device ms under ``torch.profiler``, in all and by stage, and the
   device's idle share of the profiled run (from that run alone).

Each result is one JSON line stamped with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from dpcorr_torch.io.rds_py import RColumn
from dpcorr_torch.perf_fused import stage_split
from dpcorr_torch.utils.device import card_line

N_WAVES = 16
PANEL_ROWS = 723_744
WAVE2_COMPLETE = 19_433
COLUMNS = ("hhidpn", "wave", "cenreg", "cendiv", "urbrur", "agey_e",
           "bmi", "hearte")
REGIONS = {"Northeast": ("New England", "Mid Atlantic"),
           "Midwest": ("EN Central", "WN Central"),
           "South": ("S Atlantic", "ES Central", "WS Central"),
           "West": ("Mountain", "Pacific")}
#: correlation of the latent age and BMI scores: with both clips it gives
#: ρ ≈ −0.19 on the standardized wave-2 data
LATENT_RHO = -0.195
BOOT_WIDTHS = (256, 512, 1024, 2048, 4096)
BOOT_REPS = 8192
SWEEP_REPS = 200


def synthetic_panel(seed: int, n_rows: int = PANEL_ROWS
                    ) -> dict[str, RColumn]:
    """A long panel of ``n_rows`` rows (a multiple of 16: one row per
    person and wave, person-major), columns as the HRS panel names them.
    Wave 2 has ``round(19,433 · persons / 45,234)`` complete cases:
    exactly 19,433 at the full size."""
    if n_rows % N_WAVES:
        raise ValueError(f"n_rows must be a multiple of {N_WAVES}, got "
                         f"{n_rows}")
    persons = n_rows // N_WAVES
    g = np.random.default_rng(seed)
    wave_no = np.tile(np.arange(1, N_WAVES + 1), persons)
    # age at wave 1 and a person-level BMI score; ages move two years a
    # wave, BMI scores drift a little
    age0 = np.repeat(g.normal(57.0, 11.0, persons), N_WAVES)
    z_age = (age0 - 57.0) / 11.0
    z_bmi = (LATENT_RHO * z_age + np.sqrt(1 - LATENT_RHO**2)
             * np.repeat(g.standard_normal(persons), N_WAVES))
    age = age0 + 2.0 * (wave_no - 1) + g.uniform(-0.5, 0.5, n_rows)
    bmi = 27.5 + 5.5 * z_bmi + g.normal(0.0, 0.8, n_rows)
    # incomplete rows: both values missing (70%), age only (10%), BMI
    # only (20%); wave 2 has its exact complete count, other waves a
    # share drawn per wave
    share = g.uniform(0.3, 0.7, N_WAVES)
    complete = g.random(n_rows) < share[wave_no - 1]
    w2 = np.flatnonzero(wave_no == 2)
    n_w2 = round(WAVE2_COMPLETE * persons / (PANEL_ROWS // N_WAVES))
    complete[w2] = False
    complete[g.choice(w2, n_w2, replace=False)] = True
    kind = g.random(n_rows)
    age[~complete & (kind < 0.8)] = np.nan
    bmi[~complete & ((kind < 0.7) | (kind >= 0.8))] = np.nan
    region = g.choice(list(REGIONS), persons)
    division = np.asarray([g.choice(REGIONS[r]) for r in region],
                          dtype=object)
    hearte = (g.random(n_rows) < 0.2).astype(np.float64)
    hearte[g.random(n_rows) < 0.05] = np.nan
    values = {
        "hhidpn": np.repeat(10_001_010.0 + 1000.0 * np.arange(persons),
                            N_WAVES),
        "wave": np.asarray([str(w) for w in range(1, N_WAVES + 1)],
                           dtype=object)[wave_no - 1].tolist(),
        "cenreg": np.repeat(region.astype(object), N_WAVES).tolist(),
        "cendiv": np.repeat(division, N_WAVES).tolist(),
        "urbrur": np.repeat(g.integers(1, 4, persons).astype(np.float64),
                            N_WAVES),
        "agey_e": age,
        "bmi": bmi,
        "hearte": hearte,
    }
    return {name: RColumn(name, "string" if isinstance(v, list)
                          else "double", v)
            for name, v in values.items()}


def write_panel(path: str, cols: dict[str, RColumn]) -> None:
    """The panel as a gzip data.frame .rds, through the port's writer."""
    from dpcorr_torch.io.rds_write import write_rds_table

    # dpcorr-lint: ignore[sync-in-loop] — host panel columns: no device value in reach
    write_rds_table(path, {name: (np.asarray(c.values, dtype=object)
                                  if c.kind == "string" else c.values)
                           for name, c in cols.items()})


def emit(card: str, what: str, **fields) -> None:
    print(json.dumps({"card": card, "what": what, **fields}), flush=True)


def ingest(card: str, seed: int = 0) -> dict:
    """Write the full-size panel and read it back through
    ``io.rds.read_rds_table``: seconds for each."""
    from dpcorr_torch.io.rds import read_rds_table

    cols = synthetic_panel(seed)
    with tempfile.TemporaryDirectory(prefix="dpcorr_hrs_") as d:
        path = os.path.join(d, "hrs_long_panel.rds")
        t0 = time.perf_counter()
        write_panel(path, cols)
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        back = read_rds_table(path)
        read_s = time.perf_counter() - t0
    out = {"rows": len(back["wave"].values), "bytes": size,
           "write_s": write_s, "read_s": read_s}
    emit(card, "ingest", **out)
    return out


def sweep_eps_split(cols, eps: float = 2.0, reps: int = SWEEP_REPS) -> dict:
    """One ε of the sweep (NI and INT, ``reps`` replications each, then
    its one host read), split by the stages it marks
    (``hrs.HRS_STAGES``)."""
    from dpcorr_torch import hrs
    from dpcorr_torch.models.estimators.common import k_pad_for
    from dpcorr_torch.ops.lambdas import lambda_receiver_from_noise
    from dpcorr_torch.utils import rng
    from dpcorr_torch.utils.device import f32_on

    cfg = hrs.HrsConfig()
    age, bmi = hrs._wave_arrays(cfg, cols)
    std = hrs.standardize(age, bmi, cfg, device="cuda")
    n = int(age.shape[0])
    k_pad = k_pad_for(n, [e * e for e in hrs.EPS_GRID])
    eps_t = f32_on(eps, "cuda")
    lam_r = lambda_receiver_from_noise(std.lam_age, std.lam_bmi, eps_t,
                                       1.0 / n)
    key = rng.design_key(rng.master_key(cfg.seed, "cuda"), 0)

    def run():
        hrs._sweep_dispatch(key, std, eps_t, lam_r, f32_on(1.0 / n, "cuda"),
                            reps, k_pad, cfg).cpu()

    run()  # warm: the allocator, the first launches
    return {"n": n, "eps": eps, "reps": reps, "k_pad": k_pad,
            **stage_split(run, hrs.HRS_STAGES, 1)}


def boot_chunk_split(cols, chunk: int) -> dict:
    """One bootstrap chunk of ``chunk`` replications, then its host read,
    split by the stages it marks (``hrs.HRS_STAGES``)."""
    from dpcorr_torch import hrs
    from dpcorr_torch.ops.lambdas import lambda_receiver_from_noise
    from dpcorr_torch.utils import rng
    from dpcorr_torch.utils.device import f32_on

    cfg = hrs.HrsConfig()
    age, bmi = hrs._wave_arrays(cfg, cols)
    std = hrs.standardize(age, bmi, cfg, device="cuda")
    n = int(age.shape[0])
    lam_r = lambda_receiver_from_noise(std.lam_age, std.lam_bmi,
                                       cfg.eps_corr, 1.0 / n, device="cuda")
    args = (std.age_z, std.bmi_z, cfg.eps_corr,
            *(f32_on(v, "cuda") for v in (std.lam_age, std.lam_bmi)),
            lam_r, f32_on(1.0 / n, "cuda"), cfg.alpha, cfg.mixquant_mode)
    keys = rng.rep_keys(rng.master_key(cfg.seed, "cuda"), chunk)

    def run():
        torch.stack(hrs._boot_reps(keys, *args)).cpu()

    run()  # warm
    return {"n": n, "chunk": chunk, **stage_split(run, hrs.HRS_STAGES, 1)}


def boot_widths(card: str, cols) -> int:
    """The bootstrap (``BOOT_REPS`` replications) at each width of
    ``BOOT_WIDTHS``: reps/s and peak device memory; returns the fastest
    width."""
    from dpcorr_torch import hrs

    best = None
    for chunk in BOOT_WIDTHS:
        hrs.bootstrap(cols=cols, reps=chunk, chunk=chunk)  # warm
        # dpcorr-lint: ignore[sync-in-loop] — timing barrier: the clock starts on an idle card
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hrs.bootstrap(cols=cols, reps=BOOT_REPS, chunk=chunk)
        dt = time.perf_counter() - t0
        emit(card, "boot_rate", reps=BOOT_REPS, chunk=chunk, seconds=dt,
             reps_per_s=BOOT_REPS / dt,
             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        if best is None or BOOT_REPS / dt > best[1]:
            best = (chunk, BOOT_REPS / dt)
        torch.cuda.empty_cache()
    return best[0]


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]
                            ).parse_args(argv)
    if not torch.cuda.is_available():
        print("perf_hrs: needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    emit(card, "device", kind=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda)
    ingest(card)
    cols = synthetic_panel(0)
    chunk = boot_widths(card, cols)
    emit(card, "sweep_eps_split", **sweep_eps_split(cols))
    emit(card, "boot_chunk_split", **boot_chunk_split(cols, chunk))
    return 0


if __name__ == "__main__":
    sys.exit(main())
