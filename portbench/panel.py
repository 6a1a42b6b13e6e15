"""The HRS long panel, synthetic, at the real panel's shape, from a seed.

A frozen copy of the program's ``perf_hrs.synthetic_panel`` (the real
panel is not in the repository): 723,744 rows, 16 waves of 45,234 rows,
the eight columns by name, ``wave`` a character column "1" ... "16",
``agey_e`` and ``bmi`` doubles with NA whose values reach past the clip
bounds [45, 90] and [15, 35], correlated so that the non-private rho on
the standardized data is about -0.19, and exactly 19,433 complete cases
in wave 2. Made in memory: nothing is written.
"""

from __future__ import annotations

import dataclasses

import numpy as np

N_WAVES = 16
PANEL_ROWS = 723_744
WAVE2_COMPLETE = 19_433
REGIONS = {"Northeast": ("New England", "Mid Atlantic"),
           "Midwest": ("EN Central", "WN Central"),
           "South": ("S Atlantic", "ES Central", "WS Central"),
           "West": ("Mountain", "Pacific")}
LATENT_RHO = -0.195


@dataclasses.dataclass
class Column:
    """One column as the program's table reader hands it over."""

    name: str
    kind: str
    values: object


def synthetic_panel(seed: int, n_rows: int = PANEL_ROWS) -> dict:
    """A long panel of ``n_rows`` rows (a multiple of 16: one row per
    person and wave, person-major)."""
    if n_rows % N_WAVES:
        raise ValueError(f"n_rows must be a multiple of {N_WAVES}")
    persons = n_rows // N_WAVES
    g = np.random.default_rng(int(seed))
    wave_no = np.tile(np.arange(1, N_WAVES + 1), persons)
    age0 = np.repeat(g.normal(57.0, 11.0, persons), N_WAVES)
    z_age = (age0 - 57.0) / 11.0
    z_bmi = (LATENT_RHO * z_age + np.sqrt(1 - LATENT_RHO**2)
             * np.repeat(g.standard_normal(persons), N_WAVES))
    age = age0 + 2.0 * (wave_no - 1) + g.uniform(-0.5, 0.5, n_rows)
    bmi = 27.5 + 5.5 * z_bmi + g.normal(0.0, 0.8, n_rows)
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
    return {name: Column(name, "string" if isinstance(v, list) else "double",
                         v) for name, v in values.items()}


def wave_cases(cols: dict, wave: str = "2") -> tuple[np.ndarray, np.ndarray]:
    """(age, bmi) of one wave's complete cases, as f32."""
    m = np.asarray(cols["wave"].values, dtype=object) == wave
    age, bmi = cols["agey_e"].values[m], cols["bmi"].values[m]
    ok = ~np.isnan(age) & ~np.isnan(bmi)
    return age[ok].astype(np.float32), bmi[ok].astype(np.float32)
