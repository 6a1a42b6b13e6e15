"""The port's design grid against dpcorr.grid, on the CPU.

Same seed, same design: the port's replicate table agrees with the JAX
grid's column by column (1e-5 absolute, 1e-6 relative on the squared
errors, for at least 99% of rows; ``test_torch_sim.py``'s tolerance) and
its summaries within 1e-6; its ``summarize_grid`` equals the JAX
package's on the same table to f32 rounding. The bucketed backend is
bit-equal to the local one; ε-merged buckets match unmerged ones
statistically; caches of one package, mode or body never load into
another; a failing bucket, a fused one included, is isolated and raised
without a rerun of another kind.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

import dpcorr.grid as jgrid
from dpcorr.io.rds_py import read_rds_table as jax_read_rds_table
from dpcorr.ops import pallas_ni
from dpcorr.utils import rng as jrng
from dpcorr_torch import grid
from dpcorr_torch import sim as sim_mod
from dpcorr_torch.io.rds import read_rds_table
from dpcorr_torch.io.rds_write import write_rds_frame
from dpcorr_torch.ops import fused_ni
from dpcorr_torch.utils import rng

SIGN = dict(n_grid=(200, 400), rho_grid=(0.0, 0.5),
            eps_pairs=((1.0, 1.0), (1.5, 0.5)), b=16, seed=11)
SUBG = dict(n_grid=(400,), rho_grid=(0.2, 0.5),
            eps_pairs=((1.0, 1.0), (1.5, 0.5)), b=16, seed=12,
            dgp="bounded_factor", use_subg=True)
GRIDS = {"sign": SIGN, "subg": SUBG}


def _jax_grid(kw, **extra):
    return jgrid.run_grid(jgrid.GridConfig(**kw, backend="bucketed",
                                           precompile="off", **extra))


def _port_grid(kw, **extra):
    extra.setdefault("backend", "bucketed")
    return grid.run_grid(grid.GridConfig(**kw, device="cpu", **extra))


@pytest.fixture(scope="module")
def jax_results():
    return {name: _jax_grid(kw) for name, kw in GRIDS.items()}


@pytest.fixture(scope="module")
def port_results():
    return {(name, backend): _port_grid(kw, backend=backend)
            for name, kw in GRIDS.items() for backend in ("local",
                                                          "bucketed")}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_design_points_match_jax(name):
    want = jgrid.GridConfig(**GRIDS[name]).design_points()
    got = grid.GridConfig(**GRIDS[name]).design_points()
    assert list(got) == list(want.columns)
    for col in want.columns:
        np.testing.assert_array_equal(got[col], want[col].to_numpy())
        assert got[col].dtype == want[col].dtype
    # the reference's v1 grid: 144 points, n fastest, then ρ, then ε
    v1 = grid.GridConfig().design_points()
    assert len(v1["i"]) == 144
    assert list(v1["n"][:7]) == [1000, 1500, 2500, 4000, 6000, 9000, 1000]


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grid_matches_jax(name, jax_results, port_results):
    want = jax_results[name]
    got = port_results[(name, "bucketed")]
    assert list(got.detail_all) == list(want.detail_all.columns)
    ok = np.ones(len(want.detail_all), bool)
    for col in want.detail_all.columns:
        w = want.detail_all[col].to_numpy()
        g = got.detail_all[col]
        assert g.dtype == w.dtype, col
        rtol = 1e-6 if col.endswith("se2") else 0.0
        ok &= np.isclose(g, w, rtol=rtol, atol=1e-5, equal_nan=True)
    assert ok.mean() >= 0.99
    assert list(got.summ_all) == list(want.summ_all.columns)
    for col in want.summ_all.columns:
        w = want.summ_all[col].to_numpy()
        if col == "method":
            assert list(got.summ_all[col]) == list(w)
        else:
            assert got.summ_all[col].dtype == w.dtype, col
            np.testing.assert_allclose(got.summ_all[col], w, rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_bucketed_backend_bit_equal_to_local(name, port_results):
    loc = port_results[(name, "local")]
    buck = port_results[(name, "bucketed")]
    for col, v in loc.detail_all.items():
        np.testing.assert_array_equal(buck.detail_all[col], v)
    # one timings row per (n, ε) bucket, one per point on the local backend
    assert len(buck.timings["n"]) == len(GRIDS[name]["n_grid"]) * 2
    assert len(loc.timings["i"]) == len(loc.detail_all["repl"]) // 16


def _jax_summary(table: dict) -> pd.DataFrame:
    return jgrid.summarize_grid(pd.DataFrame(table))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_summarize_grid_equals_jax_on_the_same_table(name, port_results):
    """pandas' groupby mean: Kahan-compensated f32 sums, NaN skipped, groups
    in first-appearance order. The table gets NaNs and shuffled rows."""
    table = {k: v.copy() for k, v in
             port_results[(name, "bucketed")].detail_all.items()}
    perm = np.random.default_rng(3).permutation(len(table["repl"]))
    table = {k: v[perm] for k, v in table.items()}
    table["ni_ci_len"][:5] = np.nan
    want = _jax_summary(table)
    got = grid.summarize_grid(table)
    for col in want.columns:
        w = want[col].to_numpy()
        if col == "method":
            assert list(got[col]) == list(w)
            continue
        assert got[col].dtype == w.dtype, col
        np.testing.assert_allclose(got[col], w, rtol=np.finfo(np.float32).eps,
                                   atol=0)


def test_summarize_grid_pure_function():
    table = {"n": np.full(4, 100), "rho_true": np.full(4, 0.5),
             "eps1": np.ones(4), "eps2": np.ones(4),
             "ni_hat": np.array([0.4, 0.6, 0.5, 0.5], np.float32),
             "ni_se2": np.array([0.01, 0.01, 0.0, 0.0], np.float32),
             "ni_cover": np.array([1, 1, 0, 1], np.float32),
             "ni_ci_len": np.full(4, 0.2, np.float32),
             "int_hat": np.full(4, 0.5, np.float32),
             "int_se2": np.zeros(4, np.float32),
             "int_cover": np.ones(4, np.float32),
             "int_ci_len": np.full(4, 0.1, np.float32)}
    s = grid.summarize_grid(table)
    assert list(s["method"]) == ["NI", "INT"]
    assert s["coverage"][0] == 0.75
    np.testing.assert_allclose(s["bias"][0], 0.0, atol=1e-7)


MERGE = dict(n_grid=(400,), rho_grid=(0.2, 0.5),
             eps_pairs=((0.5, 0.5), (1.0, 1.0), (1.5, 0.5)), b=48,
             dgp="bounded_factor", use_subg=True, seed=9)


def test_bucket_merge_statistically_matches_off(tmp_path):
    """Merged buckets run the per-replication geometry: the same math in a
    padded noise layout. INT rides the same stream (exact agreement), NI
    agrees statistically; merged stamps never serve unmerged points."""
    off = _port_grid(MERGE)
    mrg_cfg = dict(bucket_merge="eps", out_dir=str(tmp_path))
    mrg = _port_grid(MERGE, **mrg_cfg)
    assert len(mrg.timings["n"]) == 1                 # one bucket per n
    assert list(mrg.timings["merged_eps_pairs"]) == [3]
    assert np.isnan(mrg.timings["eps1"]).all()
    assert len(mrg.detail_all["repl"]) == 6 * 48
    np.testing.assert_allclose(mrg.summ_all["coverage"][6:],
                               off.summ_all["coverage"][6:], atol=1e-6)
    assert np.abs(mrg.summ_all["coverage"][:6]
                  - off.summ_all["coverage"][:6]).max() <= 0.11
    np.testing.assert_allclose(mrg.summ_all["mse"], off.summ_all["mse"],
                               rtol=0.35)
    again = _port_grid(MERGE, **mrg_cfg)              # same mode: all cached
    assert again.timings["points_run"].sum() == 0
    for col, v in mrg.detail_all.items():
        np.testing.assert_array_equal(again.detail_all[col], v)
    rerun = _port_grid(MERGE, out_dir=str(tmp_path))  # stamps differ
    assert rerun.timings["points_run"].sum() == 6
    for col, v in off.detail_all.items():
        np.testing.assert_array_equal(rerun.detail_all[col], v)


def test_bucket_merge_matches_jax():
    """The ε-merged grid against the JAX package's on the same seed: the
    bucket's pad bound from its ε set, the four per-replication tensors
    chunked together, each point's rows cut from the merged bucket."""
    want = _jax_grid(MERGE, bucket_merge="eps", chunk_size=40)
    got = _port_grid(MERGE, bucket_merge="eps", chunk_size=40)
    assert list(got.timings["merged_eps_pairs"]) == [3]
    assert list(got.detail_all) == list(want.detail_all.columns)
    ok = np.ones(len(want.detail_all), bool)
    for col in want.detail_all.columns:
        w = want.detail_all[col].to_numpy()
        assert got.detail_all[col].dtype == w.dtype, col
        rtol = 1e-6 if col.endswith("se2") else 0.0
        ok &= np.isclose(got.detail_all[col], w, rtol=rtol, atol=1e-5,
                         equal_nan=True)
    assert ok.mean() >= 0.99
    # mse reaches 15 at ε = 0.5, where 1e-6 is below one f32 step: the
    # detail's 1e-6 relative tolerance on se² holds for its means too
    for col in want.summ_all.columns:
        if col != "method":
            np.testing.assert_allclose(got.summ_all[col],
                                       want.summ_all[col].to_numpy(),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(MERGE, backend="bucketed", bucket_merge="bogus"),
    dict(SIGN, backend="bucketed", bucket_merge="eps"),
    dict(MERGE, backend="local", bucket_merge="eps"),
    dict(MERGE, backend="bucketed", bucket_merge="eps",
         eps_pairs=((0.5, 1.5),)),
    dict(SIGN, backend="local", fused="auto"),
    dict(SIGN, backend="bucketed", fused="bogus"),
])
def test_validation_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jgrid.run_grid(jgrid.GridConfig(**kw))
    with pytest.raises(ValueError) as got:
        grid.run_grid(grid.GridConfig(**kw, device="cpu"))
    assert str(got.value) == str(want.value)


def test_retired_and_unknown_knobs_raise():
    with pytest.raises(ValueError, match="retired"):
        grid.run_grid(grid.GridConfig(**SIGN, backend="bucketed",
                                      fused="all", device="cpu"))
    with pytest.raises(ValueError, match="backend"):
        grid.run_grid(grid.GridConfig(**SIGN, backend="bogus",
                                      device="cpu"))


TINY = dict(n_grid=(200,), rho_grid=(0.0, 0.5), eps_pairs=((1.0, 1.0),),
            b=8, seed=5)


def test_persistence_and_resume(tmp_path):
    first = _port_grid(SIGN, out_dir=str(tmp_path))
    assert len(list(tmp_path.glob("design_*.npz"))) == 8
    again = _port_grid(SIGN, out_dir=str(tmp_path))
    assert again.timings["points_run"].sum() == 0
    for col, v in first.detail_all.items():
        np.testing.assert_array_equal(again.detail_all[col], v)
    local = _port_grid(SIGN, backend="local", out_dir=str(tmp_path))
    assert local.timings["cached"].all()      # the backends share caches
    with np.load(tmp_path / "detail_all.npz") as d:
        assert list(d.files) == list(first.detail_all)
        for col, v in first.detail_all.items():
            np.testing.assert_array_equal(d[col], v)
    with np.load(tmp_path / "summ_all.npz") as s:
        np.testing.assert_array_equal(s["coverage"],
                                      first.summ_all["coverage"])
    # detail_all.rds reads back through both packages' readers
    ours = read_rds_table(str(tmp_path / "detail_all.rds"))
    theirs = jax_read_rds_table(str(tmp_path / "detail_all.rds"))
    assert list(ours) == list(first.detail_all) == list(theirs)
    for col, v in first.detail_all.items():
        np.testing.assert_array_equal(ours[col].values, v)
        np.testing.assert_array_equal(theirs[col].values, v)


def test_rds_writer_round_trips_every_column_kind(tmp_path):
    """Doubles (NaN kept), integers (beyond 32 bits promoted to doubles),
    logicals and strings (None as NA), through both packages' readers."""
    table = {"x": np.array([0.5, np.nan, -2.0], np.float32),
             "i": np.array([1, -3, 7], np.int64),
             "big": np.array([2**40, 0, 1], np.int64),
             "b": np.array([True, False, True]),
             "s": np.array(["NI", None, "é"], dtype=object)}
    path = str(tmp_path / "t.rds")
    write_rds_frame(path, table)
    ours = read_rds_table(path)
    theirs = jax_read_rds_table(path)
    assert list(ours) == list(table) == list(theirs)
    np.testing.assert_array_equal(ours["x"].values,
                                  table["x"].astype(np.float64))
    np.testing.assert_array_equal(ours["i"].values, table["i"])
    np.testing.assert_array_equal(ours["big"].values,
                                  table["big"].astype(float))
    np.testing.assert_array_equal(ours["b"].values, table["b"])
    assert ours["s"].values == ["NI", None, "é"] == theirs["s"].values
    for name, kind in (("x", "double"), ("i", "integer"), ("big", "double"),
                       ("b", "logical"), ("s", "string")):
        assert ours[name].kind == theirs[name].kind == kind
    np.testing.assert_array_equal(theirs["x"].values, ours["x"].values)
    with pytest.raises(TypeError, match="strings"):
        write_rds_frame(path, {"o": np.array([1, "a"], dtype=object)})


def test_caches_of_the_two_packages_never_mix(tmp_path):
    """The port stamps its caches with its own PRNG tag: a directory the
    JAX grid wrote is rerun in full by the port, and the reverse."""
    out = dict(out_dir=str(tmp_path))
    _jax_grid(TINY, **out)
    port = _port_grid(TINY, **out)
    assert port.timings["points_run"].sum() == 2
    jax_again = _jax_grid(TINY, **out)
    assert jax_again.timings["points_run"].sum() == 2
    cfg = grid.GridConfig(**TINY).sim_config(grid._Row(0, 200, 0.0, 1.0,
                                                       1.0))
    assert grid._stamp(cfg).endswith(f"|prng={rng.impl_tag()}")
    assert rng.impl_tag() != jrng.impl_tag()


def test_stamp_encodes_real_mc_mixquant_nsim():
    cfg = grid.GridConfig(**TINY).sim_config(grid._Row(0, 200, 0.0, 1.0,
                                                       1.0))
    mc_real = dataclasses.replace(cfg, mixquant_mode="mc",
                                  subg_variant="real", use_subg=True,
                                  dgp="bounded_factor")
    assert "mixquant_nsim=2000" in grid._stamp(mc_real)
    assert "mixquant_nsim" not in grid._stamp(cfg)
    assert "mixquant_nsim" not in grid._stamp(
        dataclasses.replace(mc_real, mixquant_mode="det"))
    # on the card the unfused body's last bits depend on the chunk width
    # (tests/test_torch_cuda.py), so every width has its own stamp
    assert grid._stamp(cfg) != grid._stamp(dataclasses.replace(
        cfg, chunk_size=7))
    assert grid._stamp(cfg) != grid._stamp(dataclasses.replace(
        cfg, chunk_size=1))


def test_bucket_failure_isolated(monkeypatch, tmp_path):
    """A failing bucket is recorded, the other buckets still run and
    persist, and one aggregated error is raised at the end."""
    real = sim_mod._run_detail_flat

    def flaky(cfg, keys, rhos):
        if cfg.n == 200:
            raise ValueError("boom in bucket n=200")
        return real(cfg, keys, rhos)

    monkeypatch.setattr(sim_mod, "_run_detail_flat", flaky)
    with pytest.raises(RuntimeError, match="4/8 design points failed"):
        _port_grid(SIGN, out_dir=str(tmp_path))
    done = sorted(p.name for p in tmp_path.glob("design_*.npz"))
    assert done == [f"design_{i:05d}.npz" for i in (1, 3, 5, 7)]


def test_fused_auto_on_cpu_equals_off(tmp_path, port_results):
    auto = _port_grid(SIGN, fused="auto", out_dir=str(tmp_path))
    assert not auto.timings["fused"].any()
    for col, v in port_results[("sign", "bucketed")].detail_all.items():
        np.testing.assert_array_equal(auto.detail_all[col], v)
    # no fused stamp on these caches: an unfused run loads them all
    off = _port_grid(SIGN, out_dir=str(tmp_path))
    assert off.timings["points_run"].sum() == 0


def test_fused_failure_raises_and_never_reruns_unfused(monkeypatch,
                                                        tmp_path):
    """Every bucket eligible on the CPU: the fused dispatch cannot run its
    in-kernel generator there, so each bucket fails, nothing is rerun
    through the unfused body, and the grid raises."""
    monkeypatch.setattr(grid, "_fused_bucket_ok", lambda gcfg, cfg: "sign")
    unfused = []
    real = sim_mod._run_detail_flat
    monkeypatch.setattr(sim_mod, "_run_detail_flat",
                        lambda *a: unfused.append(1) or real(*a))
    with pytest.raises(RuntimeError, match="8/8 design points failed") as e:
        _port_grid(SIGN, fused="auto", out_dir=str(tmp_path))
    assert "in-kernel generator runs only on the card" in str(e.value)
    assert not unfused
    assert not list(tmp_path.glob("design_*.npz"))


def test_fused_bucket_eligibility(monkeypatch):
    """The gate: opt-in, bucketed backend, a CUDA device, det mixquant,
    the Gaussian sign pair, m ≤ 128, k ≥ 2, at every n (above the cap on
    the planes the kernel's variant without them runs)."""
    gc = grid.GridConfig(**SIGN, backend="bucketed", fused="auto",
                         device="cpu")
    cfg = gc.sim_config(grid._Row(0, 1000, 0.5, 1.0, 1.0))
    assert grid._fused_bucket_ok(gc, cfg) is None      # the CPU
    monkeypatch.setattr(grid, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    assert grid._fused_bucket_ok(gc, cfg) == "sign"
    for e1, e2 in ((0.5, 0.5), (1.5, 0.5)):
        for n in (1000, 9000, 30_000):
            assert grid._fused_bucket_ok(gc, dataclasses.replace(
                cfg, n=n, eps1=e1, eps2=e2)) == "sign"
    off = [dataclasses.replace(gc, fused="off"),
           dataclasses.replace(gc, backend="local")]
    assert all(grid._fused_bucket_ok(g, cfg) is None for g in off)
    for change in (dict(dgp="bernoulli"), dict(mixquant_mode="mc"),
                   dict(use_subg=True), dict(stream_n_chunk=256),
                   dict(eps1=0.05, eps2=0.05)):      # m = 3200 > 128
        assert grid._fused_bucket_ok(
            gc, dataclasses.replace(cfg, **change)) is None, change


@pytest.mark.parametrize("eps", [(1.0, 1.0), (1.5, 0.5), (0.5, 0.5)])
def test_fits_on_chip_caps_n(eps):
    """The shared-memory cap on n where a launch switches from the
    kernel's variant with planes to the one without: the sign grid's
    widest n = 9000 fits at every ε pair of the grid; n = 30,000 fits at
    none, with INT."""
    assert fused_ni.fits_on_chip(9000, *eps)
    assert fused_ni.use_fused_ni(9000, *eps)
    assert not fused_ni.fits_on_chip(30_000, *eps)
    assert fused_ni.fits_on_chip(25_600, 1.0, 1.0)
    assert not fused_ni.fits_on_chip(25_601, 1.0, 1.0)
    assert fused_ni.fits_on_chip(28_672, 1.0, 1.0, compute_int=False)


@pytest.mark.parametrize("n", [1000, 9000, 25_601, 28_673, 40_000,
                               100_000, 10**6])
@pytest.mark.parametrize("eps", [(1.0, 1.0), (1.5, 0.5), (0.25, 0.25),
                                 (0.1, 0.1), (5.0, 0.015)])
def test_sign_gate_geometry_is_use_fused_ni(monkeypatch, n, eps):
    """On a CUDA device the fused sign gate's geometry is JAX's rule
    alone (``use_ni_sign_pallas``: m ≤ 128 and k ≥ 2), as
    ``dpcorr/grid.py`` routes buckets, whatever the shared memory."""
    monkeypatch.setattr(grid, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    gc = grid.GridConfig(**SIGN, backend="bucketed", fused="auto")
    cfg = dataclasses.replace(gc.sim_config(grid._Row(0, 1000, 0.5, 1.0,
                                                       1.0)),
                              n=n, eps1=eps[0], eps2=eps[1])
    want = pallas_ni.use_ni_sign_pallas(n, *eps)
    assert fused_ni.use_fused_ni(n, *eps) == want
    assert (grid._fused_bucket_ok(gc, cfg) == "sign") == want


def test_grid_raises_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        grid.run_grid(grid.GridConfig(**TINY, backend="bucketed"))
