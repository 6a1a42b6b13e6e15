"""The port's HRS pipeline (dpcorr_torch.hrs) against the JAX package's
(dpcorr.hrs), on a synthetic panel of the real one's columns made from
a seed (``perf_hrs.synthetic_panel``, 16,000 rows, 430 complete cases in
wave 2; the real panel is not in the repository).

Two levels of agreement:

- From the same standardized data (the JAX package's z-scores and λ
  handed to the port), the point estimates, every row of a 3 ε × 8 rep
  sweep and of an 8 rep bootstrap agree within 1e-5 (they measure
  within 1e-6): only f32 summation order and the last ulp of log1p
  differ. Batch geometry k and m, and the bootstrap's resample indices,
  are equal.
- End to end, each package standardizing on its own: the DP moments'
  f32 sums differ in order by a few ulps, which the cancellation in
  sd = √(m2 − μ²) turns into about 3e-6 relative on λ and the z-scores.
  The moments and λ are held within 1e-5 relative, the z-scores within
  1e-5; point estimates and CI ends within 1e-5; per-rep rows within
  1e-5 absolute or 1e-4 relative (at ε = 0.25, n = 430, the sweep's NI
  multiplies by m/k = 43); the summaries within 1e-5.

The summaries of the JAX package's own runs come out equal to pandas'.
"""

import dataclasses

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from dpcorr import hrs as jhrs
from dpcorr.utils import rng as jrng
from dpcorr_torch import hrs, perf_hrs
from dpcorr_torch.utils import rng

ROWS = 16 * 1000
EPS = [0.25, 1.05, 2.45]
REPS = 8
CFG, JCFG = hrs.HrsConfig(), jhrs.HrsConfig()


@pytest.fixture(scope="module")
def cols():
    return perf_hrs.synthetic_panel(7, ROWS)


@pytest.fixture(scope="module")
def wave2(cols):
    return hrs.extract_wave(cols, "2")


@pytest.fixture(scope="module")
def jax_std(wave2):
    _, age, bmi = wave2
    return jhrs.standardize(age, bmi, JCFG)


@pytest.fixture(scope="module")
def jax_runs(cols):
    """The JAX package's point estimates, sweep and bootstrap."""
    return (jhrs.point_estimates(JCFG, cols=cols),
            jhrs.eps_sweep(JCFG, cols=cols, eps_grid=EPS, reps=REPS),
            jhrs.bootstrap(JCFG, cols=cols, reps=REPS, chunk=4))


@pytest.fixture(scope="module")
def from_jax_std(cols, jax_std):
    """The port's point estimates, sweep and bootstrap on the JAX
    package's standardized data."""
    std = hrs.Standardized(
        torch.from_numpy(np.array(jax_std.age_z)),
        torch.from_numpy(np.array(jax_std.bmi_z)),
        *(getattr(jax_std, f.name)
          for f in dataclasses.fields(jax_std)[2:]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hrs, "standardize", lambda *a, **k: std)
        return (hrs.point_estimates(CFG, cols=cols, device="cpu"),
                hrs.eps_sweep(CFG, cols=cols, eps_grid=EPS, reps=REPS,
                              device="cpu"),
                hrs.bootstrap(CFG, cols=cols, reps=REPS, device="cpu"))


@pytest.fixture(scope="module")
def end_to_end(cols):
    return (hrs.point_estimates(CFG, cols=cols, device="cpu"),
            hrs.eps_sweep(CFG, cols=cols, eps_grid=EPS, reps=REPS,
                          device="cpu"),
            hrs.bootstrap(CFG, cols=cols, reps=REPS, chunk=3, device="cpu"))


def test_missingness_and_extraction_match_jax(cols, wave2):
    want = jhrs.wave_missingness(cols)
    got = hrs.wave_missingness(cols)
    assert list(got) == list(want.columns)
    for c in want.columns:
        np.testing.assert_array_equal(got[c], want[c].to_numpy())
    for a, b in zip(wave2, jhrs.extract_wave(cols, "2")):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(wave2[1]) == round(19_433 * 1000 / 45_234) == 430


def test_standardize_matches_jax(wave2, jax_std):
    _, age, bmi = wave2
    std = hrs.standardize(age, bmi, CFG, device="cpu")
    for f in ("age_mean", "age_sd", "bmi_mean", "bmi_sd", "lam_age",
              "lam_bmi"):
        assert getattr(std, f) == pytest.approx(getattr(jax_std, f),
                                                rel=1e-5), f
    assert std.rho_np == pytest.approx(jax_std.rho_np, abs=1e-6)
    for z, jz in ((std.age_z, jax_std.age_z), (std.bmi_z, jax_std.bmi_z)):
        assert z.dtype == torch.float32
        np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=1e-5,
                                   rtol=0.0)


def _point_close(got, want, atol=1e-5):
    for meth in ("ni", "int_"):
        g, w = getattr(got, meth), getattr(want, meth)
        assert list(g) == list(w)
        for f in ("rho_hat", "ci_low", "ci_high"):
            assert g[f] == pytest.approx(w[f], abs=atol, rel=0.0), (meth, f)
        for f in set(w) - {"rho_hat", "ci_low", "ci_high"}:
            assert g[f] == pytest.approx(w[f], rel=1e-5), (meth, f)
    assert (got.ni["k"], got.ni["m"]) == (want.ni["k"], want.ni["m"])
    assert got.n == want.n


def test_point_estimates_match_jax(jax_runs, from_jax_std, end_to_end):
    _point_close(from_jax_std[0], jax_runs[0])
    _point_close(end_to_end[0], jax_runs[0])


def _rows_close(got: dict, want: pd.DataFrame, fields, rtol=0.0):
    for f in fields:
        np.testing.assert_allclose(got[f], want[f].to_numpy(), atol=1e-5,
                                   rtol=rtol, err_msg=f)


def test_sweep_rows_and_summary_match_jax(jax_runs, from_jax_std,
                                          end_to_end):
    summ = jax_runs[1]
    runs = summ.attrs["runs"]
    for ours, rtol in ((from_jax_std[1], 0.0), (end_to_end[1], 1e-4)):
        assert list(ours.runs) == list(runs.columns)
        assert list(ours.runs["method"]) == list(runs["method"])
        np.testing.assert_array_equal(ours.runs["eps_corr"],
                                      runs["eps_corr"].to_numpy())
        np.testing.assert_array_equal(ours.runs["rep"], runs["rep"])
        _rows_close(ours.runs, runs, hrs.SWEEP_FIELDS, rtol)
        assert list(ours.summary) == list(summ.columns)
        for c in list(summ.columns)[2:]:
            np.testing.assert_allclose(ours.summary[c], summ[c].to_numpy(),
                                       atol=1e-5, rtol=0.0, err_msg=c)
        assert ours.rho_np == pytest.approx(summ.attrs["rho_np"], abs=1e-6)


def test_bootstrap_rows_and_summary_match_jax(jax_runs, from_jax_std,
                                              end_to_end):
    boot = jax_runs[2]
    for ours in (from_jax_std[2], end_to_end[2]):
        assert list(ours.runs) == list(boot.columns)
        _rows_close(ours.runs, boot, hrs.BOOT_FIELDS)
        for meth, s in boot.attrs["summary"].items():
            for k, v in s.items():
                assert ours.summary[meth][k] == pytest.approx(v, abs=1e-5)


def test_bootstrap_resamples_are_jax_choices(wave2):
    """The resample indices, bit for bit, at the pipeline's addresses."""
    n = len(wave2[1])
    jkeys = jrng.rep_keys(jrng.stream(jrng.master_key(JCFG.seed),
                                      "hrs/boot"), REPS)
    want = jax.vmap(lambda k: jax.random.choice(
        jrng.stream(k, "hrs/boot/idx"), n, (n,), replace=True))(jkeys)
    keys = rng.rep_keys(rng.stream(rng.master_key(CFG.seed), "hrs/boot"),
                        REPS)
    got = rng.choice(rng.stream(keys, "hrs/boot/idx"), n, (n,))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bootstrap_does_not_depend_on_its_chunk_width(cols, end_to_end):
    """chunk 3 (end_to_end) against one chunk of all replications."""
    whole = hrs.bootstrap(CFG, cols=cols, reps=REPS, chunk=REPS,
                          device="cpu")
    for f in hrs.BOOT_FIELDS:
        np.testing.assert_array_equal(whole.runs[f], end_to_end[2].runs[f])


def test_summaries_of_jax_runs_equal_pandas(jax_runs):
    """The port's summaries fed the JAX package's own runs give pandas'
    numbers: grouped Kahan f32 means and linear quantiles; the Series
    mean, sd and quantiles."""
    summ = jax_runs[1]
    runs = summ.attrs["runs"]
    ours = hrs.summarize_sweep({c: runs[c].to_numpy() for c in runs.columns})
    assert list(ours["method"]) == list(summ["method"])
    for c in list(summ.columns)[1:]:
        assert ours[c].dtype == summ[c].dtype, c
        np.testing.assert_array_equal(ours[c], summ[c].to_numpy())
    boot = jax_runs[2]
    for meth, want in boot.attrs["summary"].items():
        assert hrs._series_summary(boot[f"{meth}_hat"].to_numpy()) == want


def test_entry_points_raise_without_a_card(monkeypatch, cols):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (hrs.point_estimates, hrs.eps_sweep, hrs.bootstrap):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(CFG, cols=cols)


def test_missing_panel_raises_a_clear_error(tmp_path):
    cfg = hrs.HrsConfig(panel_path=str(tmp_path / "absent.rds"))
    with pytest.raises(FileNotFoundError, match="HRS panel not found"):
        hrs.point_estimates(cfg, device="cpu")
    assert hrs.DEFAULT_PANEL.endswith("reference/hrs_long_panel.rds")


def test_synthetic_panel_has_the_real_panels_shape():
    """723,744 rows, 16 waves of 45,234, 19,433 complete cases in wave 2,
    both clips reached, and a non-private ρ near the real −0.193."""
    cols = perf_hrs.synthetic_panel(0)
    assert list(cols) == list(perf_hrs.COLUMNS)
    miss = hrs.wave_missingness(cols)
    assert miss["wave"].tolist() == list(range(1, 17))
    assert (miss["n"] == 45_234).all()
    assert miss["complete"][1] == 19_433
    _, age, bmi = hrs.extract_wave(cols, "2")
    assert age.min() < 45 and age.max() > 90
    assert bmi.min() < 15 and bmi.max() > 35
    rho = hrs.standardize(age, bmi, CFG, device="cpu").rho_np
    assert -0.25 < rho < -0.15
    with pytest.raises(ValueError, match="multiple of 16"):
        perf_hrs.synthetic_panel(0, 1000)
