"""The port's figures (dpcorr_torch.report) against dpcorr.report, drawn
from the same tables: the port's numpy tables, and for the JAX package
pandas frames built from them.

Every axis must carry the same title, labels and scales, every
``Line2D`` the same data (``get_xydata``), color, style and label, and
every collection (``fill_between`` polygons, error bars) the same
vertices, within 1e-6 relative with NaN in the same places. The grouped
means come from numpy in the port and from pandas in the JAX package.
"""

import numpy as np
import pandas as pd
import pytest

from dpcorr import report as jreport
from dpcorr_torch import grid, hrs, perf_hrs, report


@pytest.fixture(scope="module")
def tables():
    res = grid.run_grid(grid.GridConfig(
        n_grid=(200, 400), rho_grid=(0.0, 0.3, 0.5),
        eps_pairs=((1.5, 0.5), (1.0, 1.0), (0.5, 0.5)), b=8, seed=4,
        backend="bucketed", device="cpu"))
    detail = {k: v.copy() for k, v in res.detail_all.items()}
    # a whole ρ group's upper ends missing (a NaN band end) and a few
    # single values (skipped by the means)
    group = ((detail["n"] == 200) & (detail["rho_true"] == 0.3)
             & (detail["eps1"] == 1.5))
    detail["ni_up"][group] = np.nan
    detail["int_hat"][::7] = np.nan
    summ = {k: v.copy() for k, v in res.summ_all.items()}
    summ["ci_len"][1] = np.nan
    cols = perf_hrs.synthetic_panel(6, 16 * 400)
    sweep = hrs.eps_sweep(cols=cols, eps_grid=[0.5, 1.5, 2.5], reps=4,
                          device="cpu")
    return detail, summ, sweep


def _frame(table: dict) -> pd.DataFrame:
    return pd.DataFrame({k: np.asarray(v) for k, v in table.items()})


def _describe(fig) -> list:
    out = []
    for ax in fig.axes:
        legend = ax.get_legend()
        out.append({
            "text": (ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                     ax.get_xscale(), ax.get_yscale(),
                     [t.get_text() for t in legend.get_texts()]
                     if legend else None),
            "ylim": np.asarray(ax.get_ylim()),
            "lines": [(line.get_xydata(), line.get_color(),
                       line.get_linestyle(), line.get_label())
                      for line in ax.get_lines()],
            "collections": [[p.vertices for p in c.get_paths()]
                            for c in ax.collections],
        })
    return out


def _same_figure(got, want):
    g, w = _describe(got), _describe(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a["text"] == b["text"]
        np.testing.assert_allclose(a["ylim"], b["ylim"], rtol=1e-6)
        assert len(a["lines"]) == len(b["lines"])
        for la, lb in zip(a["lines"], b["lines"]):
            assert la[1:] == lb[1:]
            np.testing.assert_allclose(la[0], lb[0], rtol=1e-6,
                                       equal_nan=True)
        assert len(a["collections"]) == len(b["collections"])
        for ca, cb in zip(a["collections"], b["collections"]):
            assert len(ca) == len(cb)
            for va, vb in zip(ca, cb):
                np.testing.assert_allclose(va, vb, rtol=1e-6, equal_nan=True)


FIGURES = {
    "mean_band": lambda m, d, s: m.fig_mean_band_vs_rho(d, 200, (1.5, 0.5)),
    "width_coverage": lambda m, d, s: m.fig_width_coverage_vs_n(s, 0.5),
    "mse": lambda m, d, s: m.fig_mse_vs_n(s, 0.5),
    "subg_mean_band": lambda m, d, s: m.fig_subg_mean_band(d, 400,
                                                           (1.0, 1.0)),
    "subg_width": lambda m, d, s: m.fig_subg_width(s, 0.3),
    "subg_coverage": lambda m, d, s: m.fig_subg_coverage(s, 0.3),
    "subg_mse": lambda m, d, s: m.fig_subg_mse(s, 0.0),
}


@pytest.mark.parametrize("name", sorted(FIGURES))
def test_grid_figures_match_jax(tables, name):
    detail, summ, _ = tables
    got = FIGURES[name](report, detail, summ)
    want = FIGURES[name](jreport, _frame(detail), _frame(summ))
    _same_figure(got, want)
    report._plt().close("all")


def test_nan_band_end_is_drawn_alike(tables):
    """The NaN upper end at ρ = 0.3 reaches the band in both."""
    detail, _, _ = tables
    fig = report.fig_mean_band_vs_rho(detail, 200, (1.5, 0.5))
    verts = np.concatenate([p.vertices for p in
                            fig.axes[0].collections[0].get_paths()])
    assert not np.isclose(verts[:, 0], 0.3).any()  # cut out of the polygon
    report._plt().close("all")


@pytest.mark.parametrize("with_rho_np", [True, False])
def test_hrs_sweep_figure_matches_jax(tables, with_rho_np):
    _, _, sweep = tables
    frame = _frame(sweep.summary)
    if with_rho_np:
        frame.attrs["rho_np"] = sweep.rho_np
    got = report.fig_hrs_sweep(sweep.summary,
                               sweep.rho_np if with_rho_np else None)
    _same_figure(got, jreport.fig_hrs_sweep(frame))
    report._plt().close("all")


def test_mean_at_reindexes_like_pandas():
    d = {"k": np.array([0.5, 0.0, 0.5, 0.9]),
         "v": np.array([1.0, np.nan, 3.0, 4.0], np.float32)}
    at = np.array([0.0, 0.3, 0.5, 0.9])
    want = pd.DataFrame(d).groupby("k")["v"].mean().reindex(at).to_numpy()
    np.testing.assert_array_equal(report._mean_at(d, "k", "v", at), want)


def test_render_all_writes_the_jax_names(tables, tmp_path):
    detail, summ, sweep = tables
    got = report.render_all(detail, summ, sweep.summary, tmp_path / "p",
                            fig1_n=200, hrs_rho_np=sweep.rho_np)
    frame = _frame(sweep.summary)
    frame.attrs["rho_np"] = sweep.rho_np
    want = jreport.render_all(_frame(detail), _frame(summ), frame,
                              tmp_path / "j", fig1_n=200)
    assert [p.name for p in got] == [p.name for p in want]
    assert all(p.exists() and p.stat().st_size > 0 for p in got)
    got = report.render_all_subg(detail, summ, tmp_path / "ps", fig1_n=400,
                                 fig1_eps=(1.0, 1.0))
    want = jreport.render_all_subg(_frame(detail), _frame(summ),
                                   tmp_path / "js", fig1_n=400,
                                   fig1_eps=(1.0, 1.0))
    assert [p.name for p in got] == [p.name for p in want]


def test_tables_round_trip_and_render_from(tables, tmp_path):
    detail, summ, sweep = tables
    np.savez(tmp_path / "detail_all.npz", **detail)
    np.savez(tmp_path / "summ_all.npz", **summ)
    report.write_hrs_tables(tmp_path, sweep)
    t = report.read_tables(tmp_path)
    for got, want in ((t["detail"], detail), (t["summ"], summ),
                      (t["hrs_summ"], sweep.summary)):
        assert list(got) == list(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v)
    assert t["hrs_rho_np"] == sweep.rho_np
    names = [p.name for p in report.render_from(tmp_path, "subg")]
    assert names == ["subG_fig1_mean_band.pdf", "subG_fig2a_width.pdf",
                     "subG_fig2b_cov.pdf", "subG_fig3_mse.pdf",
                     "hrs_eps_sweep.pdf"]
    with pytest.raises(ValueError, match="family"):
        report.render_from(tmp_path, "v2")
