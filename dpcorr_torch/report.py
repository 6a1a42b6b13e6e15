"""Figures (reference layer L6), drawn from the port's tables.

Counterpart of ``dpcorr/report.py``: the reference's three synthetic
figure families (vert-cor.R:600-721), the sub-Gaussian grid's own family
(ver-cor-subG.R:338-436) and the HRS ε-sweep panels
(real-data-sims.R:450-506), written as PDFs like the reference's
``ggsave`` calls, with the JAX package's styles, titles and file names.
Each function takes the port's tables, dicts of numpy columns
(``grid.run_grid``'s ``detail_all`` and ``summ_all``, ``hrs.eps_sweep``'s
``summary``), in place of DataFrames, and returns the figure (also saved
when ``out`` is given). Grouped means are pandas' (``grid._group_mean``),
so the points drawn are the JAX package's.

matplotlib is imported inside the drawing functions (the card's machine
has none, and draws nothing); :func:`read_tables`,
:func:`write_hrs_tables`, :func:`serve_stats_frame`,
:func:`protocol_transcript_frame` and :func:`correlation_matrix_frame`
need only numpy.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from dpcorr_torch.grid import _group_mean

#: fixed series colors: NI is always blue, INT always orange
COLORS = {"NI": "#3b6fb5", "INT": "#e07b39"}
_GRID_KW = dict(color="#cccccc", linestyle=":", linewidth=0.6)
#: the subG family's fills and lines (grey70 / steelblue, grey35 /
#: steelblue; ver-cor-subG.R:369-372), one color per ε pair, linetype by
#: method
_SUBG_FILL = {"NI": "#b3b3b3", "INT": "#4682b4"}
_SUBG_LINE = {"NI": "#595959", "INT": "#4682b4"}
_EPS_COLORS = ("#3b6fb5", "#e07b39", "#4daf8c")
_METH_LS = {"NI": "-", "INT": "--"}

#: the tables ``report --from`` reads, as ``grid --out`` and ``hrs-sweep
#: --out`` write them
TABLE_FILES = {"detail": "detail_all.npz", "summ": "summ_all.npz",
               "hrs_summ": "hrs_sweep_summary.npz"}
HRS_RUNS_FILE = "hrs_sweep_runs.npz"
#: the sweep's non-private ρ, which its summary table does not hold
HRS_META_FILE = "hrs_sweep.json"


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _style(ax, xlabel, ylabel, title=None):
    ax.grid(True, **_GRID_KW)
    ax.set_axisbelow(True)
    ax.spines[["top", "right"]].set_visible(False)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title, fontsize=10)


def _save(fig, out):
    if out:
        out = Path(out)
        out.parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(out, bbox_inches="tight")
    return fig


def _where(table: dict, mask: np.ndarray) -> dict:
    return {k: np.asarray(v)[mask] for k, v in table.items()}


def _slice(detail: dict, n: int, eps_pair) -> dict:
    return _where(detail, (np.asarray(detail["n"]) == n)
                  & (np.asarray(detail["eps1"]) == eps_pair[0])
                  & (np.asarray(detail["eps2"]) == eps_pair[1]))


def _mean_at(d: dict, key: str, col: str, at: np.ndarray) -> np.ndarray:
    """Mean of ``col`` per value of ``key`` at the labels ``at``, NaN
    where a label has no row: pandas' ``groupby(key)[col].mean()
    .reindex(at)``."""
    index = {v: g for g, v in enumerate(at.tolist()) if v == v}
    keys = np.asarray(d[key]).tolist()
    rows = np.asarray([k in index for k in keys], bool)
    groups = np.asarray([index[k] for k, r in zip(keys, rows) if r],
                        np.int64)
    return _group_mean(np.asarray(d[col])[rows], groups, len(at))


def _rho_labels(d: dict) -> np.ndarray:
    """``sorted(d.rho_true.unique())``: the distinct ρ, ascending."""
    return np.asarray(sorted(set(np.asarray(d["rho_true"]).tolist())),
                      np.float64)


def _sorted_by(table: dict, col: str) -> dict:
    order = np.argsort(np.asarray(table[col]), kind="stable")
    return {k: np.asarray(v)[order] for k, v in table.items()}


def _eps_pairs(d: dict) -> list:
    return sorted(set(zip(np.asarray(d["eps1"]).tolist(),
                          np.asarray(d["eps2"]).tolist())))


def _series(d: dict, meth: str, e1: float, e2: float) -> dict:
    """One method's rows at one ε pair, sorted by n."""
    return _sorted_by(_where(d, (np.asarray(d["method"]) == meth)
                             & (np.asarray(d["eps1"]) == e1)
                             & (np.asarray(d["eps2"]) == e2)), "n")


def _at_rho(summ_all: dict, rho: float) -> dict:
    return _where(summ_all, np.asarray(summ_all["rho_true"]) == rho)


def fig_mean_band_vs_rho(detail_all: dict, n: int,
                         eps_pair: tuple[float, float], out=None):
    """Family 1 (vert-cor.R:600-661): mean estimate offset and mean CI-end
    offsets vs true ρ, at one (n, ε) slice. Offsets = value − ρ_true, so a
    perfect estimator hugs the zero line."""
    plt = _plt()
    d = _slice(detail_all, n, eps_pair)
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.4), sharey=True)
    for ax, meth in zip(axes, ("NI", "INT")):
        p = meth.lower()
        rho = _rho_labels(d)
        mean_off = _mean_at(d, "rho_true", f"{p}_hat", rho) - rho
        lo_off = _mean_at(d, "rho_true", f"{p}_low", rho) - rho
        hi_off = _mean_at(d, "rho_true", f"{p}_up", rho) - rho
        c = COLORS[meth]
        ax.axhline(0.0, color="#888888", linestyle="--", linewidth=0.8)
        ax.fill_between(rho, lo_off, hi_off, color=c, alpha=0.18,
                        label="mean CI band")
        ax.plot(rho, mean_off, color=c, linewidth=2, marker="o",
                markersize=4, label="mean offset")
        _style(ax, r"true $\rho$", "offset from truth",
               f"{meth}  (n={n}, ε=({eps_pair[0]}, {eps_pair[1]}))")
        ax.legend(frameon=False, fontsize=8)
    fig.tight_layout()
    return _save(fig, out)


def fig_width_coverage_vs_n(summ_all: dict, rho: float,
                            alpha: float = 0.05, out=None):
    """Family 2 (vert-cor.R:663-694): CI width and empirical coverage vs n
    at one ρ, per ε-pair; dashed nominal-coverage line."""
    plt = _plt()
    d = _at_rho(summ_all, rho)
    eps_pairs = _eps_pairs(d)
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.4))
    for meth in ("NI", "INT"):
        for (e1, e2) in eps_pairs:
            se = _series(d, meth, e1, e2)
            ls = "-" if (e1, e2) == eps_pairs[0] else \
                 ("--" if (e1, e2) == eps_pairs[min(1, len(eps_pairs) - 1)]
                  else ":")
            axes[0].plot(se["n"], se["ci_len"], color=COLORS[meth],
                         linestyle=ls, marker="o", markersize=3,
                         linewidth=1.6, label=f"{meth} ε=({e1},{e2})")
            axes[1].plot(se["n"], se["coverage"], color=COLORS[meth],
                         linestyle=ls, marker="o", markersize=3,
                         linewidth=1.6)
    axes[1].axhline(1 - alpha, color="#888888", linestyle="--", linewidth=0.8)
    _style(axes[0], "n", "mean CI length", f"CI width vs n (ρ={rho})")
    _style(axes[1], "n", "empirical coverage", f"coverage vs n (ρ={rho})")
    axes[0].legend(frameon=False, fontsize=7)
    fig.tight_layout()
    return _save(fig, out)


def fig_mse_vs_n(summ_all: dict, rho: float, out=None):
    """Family 3 (vert-cor.R:696-721): MSE vs n at one ρ (log-y), per ε."""
    plt = _plt()
    d = _at_rho(summ_all, rho)
    eps_pairs = _eps_pairs(d)
    fig, ax = plt.subplots(figsize=(5.2, 3.6))
    for meth in ("NI", "INT"):
        for j, (e1, e2) in enumerate(eps_pairs):
            se = _series(d, meth, e1, e2)
            ax.plot(se["n"], se["mse"], color=COLORS[meth],
                    linestyle=["-", "--", ":"][j % 3], marker="o",
                    markersize=3, linewidth=1.6,
                    label=f"{meth} ε=({e1},{e2})")
    ax.set_yscale("log")
    _style(ax, "n", "MSE", f"MSE vs n (ρ={rho})")
    ax.legend(frameon=False, fontsize=7)
    fig.tight_layout()
    return _save(fig, out)


def fig_subg_mean_band(detail_all: dict, n: int = 6000,
                       eps_pair: tuple[float, float] = (1.5, 0.5), out=None):
    """subG_fig1 (ver-cor-subG.R:338-380): mean CI offset bands vs ρ at one
    (n, ε) slice, both methods on one panel, dashed zero line,
    y = mean(CI) − ρ."""
    plt = _plt()
    d = _slice(detail_all, n, eps_pair)
    fig, ax = plt.subplots(figsize=(6.8, 4.4))
    ax.axhline(0.0, color="#888888", linestyle="--", linewidth=0.9)
    rho = _rho_labels(d)
    for meth in ("NI", "INT"):
        p = meth.lower()
        lo_off = _mean_at(d, "rho_true", f"{p}_low", rho) - rho
        hi_off = _mean_at(d, "rho_true", f"{p}_up", rho) - rho
        est_off = _mean_at(d, "rho_true", f"{p}_hat", rho) - rho
        ax.fill_between(rho, lo_off, hi_off, color=_SUBG_FILL[meth],
                        alpha=0.35, linewidth=0, label=meth)
        ax.plot(rho, est_off, color=_SUBG_LINE[meth], linewidth=1.6)
    _style(ax, r"$\rho$", r"mean(CI) $-$ $\rho$",
           f"Mean CI offset bands — n = {n}, "
           f"ε₁ = {eps_pair[0]}, ε₂ = {eps_pair[1]}")
    ax.legend(frameon=False, fontsize=9, title="Estimator", title_fontsize=9)
    fig.tight_layout()
    return _save(fig, out)


def _fig_subg_vs_n(summ_all: dict, rho: float, ycol: str, ylabel: str,
                   title: str, logy: bool = False,
                   nominal: float | None = None, out=None):
    """Shared body of subG fig2a/2b/3: y vs n (log-x), one color per
    ε-pair, linetype by method (ver-cor-subG.R:383-436)."""
    plt = _plt()
    d = _at_rho(summ_all, rho)
    fig, ax = plt.subplots(figsize=(6.0, 4.0))
    for j, (e1, e2) in enumerate(_eps_pairs(d)):
        c = _EPS_COLORS[j % len(_EPS_COLORS)]
        for meth in ("NI", "INT"):
            s = _series(d, meth, e1, e2)
            ax.plot(s["n"], s[ycol], color=c, linestyle=_METH_LS[meth],
                    marker="o", markersize=3, linewidth=1.6,
                    label=f"({e1},{e2}) {meth}")
    if nominal is not None:
        ax.axhline(nominal, color="#888888", linestyle="--", linewidth=0.8)
    ax.set_xscale("log")
    if logy:
        ax.set_yscale("log")
    _style(ax, "n (log-scale)", ylabel, title)
    ax.legend(frameon=False, fontsize=7, title="(ε₁,ε₂)  method",
              title_fontsize=7)
    fig.tight_layout()
    return _save(fig, out)


def fig_subg_width(summ_all: dict, rho: float = 0.5, out=None):
    """subG_fig2a (ver-cor-subG.R:383-397): average CI width vs n."""
    return _fig_subg_vs_n(summ_all, rho, "ci_len", "Average CI length",
                          f"Average CI width vs n (ρ = {rho})", out=out)


def fig_subg_coverage(summ_all: dict, rho: float = 0.5,
                      alpha: float = 0.05, out=None):
    """subG_fig2b (ver-cor-subG.R:399-413): coverage vs n, nominal line."""
    return _fig_subg_vs_n(summ_all, rho, "coverage", "Empirical coverage",
                          f"Coverage vs n (ρ = {rho})",
                          nominal=1 - alpha, out=out)


def fig_subg_mse(summ_all: dict, rho: float = 0.5, out=None):
    """subG_fig3 (ver-cor-subG.R:418-436): MSE vs n, log-log."""
    return _fig_subg_vs_n(summ_all, rho, "mse", "MSE (log-scale)",
                          f"MSE of ρ̂ vs n (ρ = {rho})", logy=True, out=out)


def render_all_subg(grid_detail: dict | None = None,
                    grid_summ: dict | None = None,
                    out_dir: str | Path = "figures",
                    fig1_n: int = 6000, fig1_eps=(1.5, 0.5),
                    rho: float = 0.5) -> list[Path]:
    """The v2 grid's four-figure dump with the reference's file names
    (ver-cor-subG.R:380, 411-413, 434)."""
    out_dir = Path(out_dir)
    written = []
    if grid_detail is not None:
        p = out_dir / "subG_fig1_mean_band.pdf"
        fig_subg_mean_band(grid_detail, fig1_n, fig1_eps, out=p)
        written.append(p)
    if grid_summ is not None:
        for name, fn in (("subG_fig2a_width.pdf", fig_subg_width),
                         ("subG_fig2b_cov.pdf", fig_subg_coverage),
                         ("subG_fig3_mse.pdf", fig_subg_mse)):
            p = out_dir / name
            fn(grid_summ, rho, out=p)
            written.append(p)
    _plt().close("all")
    return written


def fig_hrs_sweep(summ: dict, rho_np: float | None = None, out=None):
    """HRS ε-sweep panels (real-data-sims.R:450-506): per method, the
    mean-CI midpoint ``(ci_low_mean + ci_high_mean)/2`` as the point
    (real-data-sims.R:459-461) with mean-CI error bars vs ε, dashed
    non-private baseline ``rho_np`` when given, red zero line; shared
    y-limits spanning the CIs, ρ_np and 0 (real-data-sims.R:463-468)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(9, 3.4), sharey=True)
    y_all = [np.nanmin(summ["ci_low_mean"]), np.nanmax(summ["ci_high_mean"]),
             0.0]
    if rho_np is not None:
        y_all.append(rho_np)
    ylo, yhi = min(y_all), max(y_all)
    pad = 0.02 * (yhi - ylo)
    titles = {"NI": "Non-interactive", "INT": "Interactive"}
    for ax, meth in zip(axes, ("NI", "INT")):
        s = _sorted_by(_where(summ, np.asarray(summ["method"]) == meth),
                       "eps_corr")
        lo, hi = s["ci_low_mean"], s["ci_high_mean"]
        mid = (lo + hi) / 2.0
        c = COLORS[meth]
        ax.axhline(0.0, color="#b03030", linewidth=0.9)
        if rho_np is not None:
            ax.axhline(rho_np, color="#555555", linestyle="--", linewidth=0.9,
                       label=r"non-private $\rho$")
        ax.errorbar(s["eps_corr"], mid, yerr=[mid - lo, hi - mid],
                    color=c, fmt="o", markersize=3.5,
                    elinewidth=1.0, capsize=2, label="mean CI (midpoint)")
        ax.set_ylim(ylo - pad, yhi + pad)
        _style(ax, r"$\varepsilon_{corr}$", r"mean(CI) for $\rho$",
               titles[meth])
        ax.legend(frameon=False, fontsize=8)
    fig.tight_layout()
    return _save(fig, out)


def render_all(grid_detail: dict | None = None,
               grid_summ: dict | None = None,
               hrs_summ: dict | None = None,
               out_dir: str | Path = "figures",
               fig1_n: int = 1500, fig1_eps=(1.5, 0.5),
               fig23_rho: float = 0.5,
               hrs_rho_np: float | None = None) -> list[Path]:
    """Render every available figure family into ``out_dir``; returns the
    written paths (the reference's end-of-script figure dumps).
    ``hrs_rho_np``: the sweep's non-private ρ, which the JAX package's
    frame carries in its ``attrs``."""
    out_dir = Path(out_dir)
    written = []
    if grid_detail is not None:
        p = out_dir / "fig1_mean_band_vs_rho.pdf"
        fig_mean_band_vs_rho(grid_detail, fig1_n, fig1_eps, out=p)
        written.append(p)
    if grid_summ is not None:
        p = out_dir / "fig2_width_coverage_vs_n.pdf"
        fig_width_coverage_vs_n(grid_summ, fig23_rho, out=p)
        written.append(p)
        p = out_dir / "fig3_mse_vs_n.pdf"
        fig_mse_vs_n(grid_summ, fig23_rho, out=p)
        written.append(p)
    if hrs_summ is not None:
        p = out_dir / "hrs_eps_sweep.pdf"
        fig_hrs_sweep(hrs_summ, hrs_rho_np, out=p)
        written.append(p)
    _plt().close("all")
    return written


# ---------------------------------------------------------------- tables ----
def write_hrs_tables(out_dir: str | Path, sweep) -> list[Path]:
    """An ``hrs.eps_sweep`` result as ``hrs-sweep --out`` writes it: the
    runs and summary tables, and its non-private ρ."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = [out_dir / HRS_RUNS_FILE, out_dir / TABLE_FILES["hrs_summ"],
             out_dir / HRS_META_FILE]
    np.savez(paths[0], **sweep.runs)
    np.savez(paths[1], **sweep.summary)
    paths[2].write_text(json.dumps({"rho_np": float(sweep.rho_np)}))
    return paths


def read_tables(src_dir: str | Path) -> dict:
    """The tables a finished ``grid``, ``grid-subg`` or ``hrs-sweep --out``
    directory holds: ``{"detail", "summ", "hrs_summ"}`` as dicts of numpy
    columns (None where absent) and ``hrs_rho_np``."""
    src_dir = Path(src_dir)
    out: dict = {}
    for name, fname in TABLE_FILES.items():
        path = src_dir / fname
        if path.exists():
            with np.load(path) as z:
                out[name] = {k: z[k] for k in z.files}
        else:
            out[name] = None
    meta = src_dir / HRS_META_FILE
    out["hrs_rho_np"] = (json.loads(meta.read_text())["rho_np"]
                         if meta.exists() else None)
    return out


#: per family, the slice figure 1 draws (``python -m dpcorr``'s
#: defaults: vert-cor.R's n = 1500, ver-cor-subG.R:342's n = 6000)
FIG1_DEFAULTS = {"v1": (1500, (1.5, 0.5)), "subg": (6000, (1.5, 0.5))}


def render_from(src_dir: str | Path, family: str = "v1",
                out_dir: str | Path | None = None) -> list[Path]:
    """Draw every figure the tables in ``src_dir`` allow into ``out_dir``
    (default ``src_dir``), with the JAX command's file names: the v1 or
    subG grid family, and the HRS sweep."""
    if family not in FIG1_DEFAULTS:
        raise ValueError(f"family must be 'v1' or 'subg', got {family!r}")
    t = read_tables(src_dir)
    out_dir = Path(out_dir or src_dir)
    fig1_n, fig1_eps = FIG1_DEFAULTS[family]
    if family == "subg":
        written = render_all_subg(t["detail"], t["summ"], out_dir,
                                  fig1_n=fig1_n, fig1_eps=fig1_eps)
        return written + render_all(hrs_summ=t["hrs_summ"], out_dir=out_dir,
                                    hrs_rho_np=t["hrs_rho_np"])
    return render_all(t["detail"], t["summ"], t["hrs_summ"], out_dir,
                      fig1_n=fig1_n, fig1_eps=fig1_eps,
                      hrs_rho_np=t["hrs_rho_np"])


def serve_stats_frame(snapshot: dict) -> dict:
    """Flatten a serving stats snapshot (``serve.ServeStats.snapshot``) into
    a tidy (metric, value) table, as a dict of two numpy object columns
    (counterpart of ``dpcorr.report.serve_stats_frame``'s DataFrame).
    Nested groups flatten with dotted keys (``latency_s.p99``,
    ``ledger.parties.<p>.spent``)."""
    rows = []

    def walk(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        else:
            rows.append((prefix, obj))

    walk("", snapshot)
    metric = np.empty(len(rows), dtype=object)
    value = np.empty(len(rows), dtype=object)
    for i, (m, v) in enumerate(rows):
        metric[i], value[i] = m, v
    return {"metric": metric, "value": value}


def _column(values: list) -> np.ndarray:
    """A list as a numpy column: numeric when every value is a number,
    else an object column (strings, ``None``)."""
    if values and all(isinstance(v, (int, float)) and not isinstance(v, bool)
                      for v in values):
        return np.asarray(values)
    col = np.empty(len(values), dtype=object)
    col[:] = values
    return col


def _table(rows: list[dict], columns: list[str]) -> dict:
    return {c: _column([r[c] for r in rows]) for c in columns}


def protocol_transcript_frame(transcript) -> dict:
    """One party's wire transcript (``protocol.messages.Transcript`` JSONL,
    or the entry list ``read_transcript`` returns) as a per-message table,
    a dict of numpy columns (counterpart of
    ``dpcorr.report.protocol_transcript_frame``'s DataFrame). One row per
    frame, as logged: direction, sequence number, message type, wire
    bytes, retries, send latency, the ε charged through the release gate
    (0 for ungated traffic), the trace ID and the time stamp."""
    from dpcorr_torch.protocol.messages import read_transcript

    entries = (read_transcript(transcript) if isinstance(transcript, str)
               else list(transcript))
    rows = [{"seq": e.get("seq"), "dir": e.get("dir"),
             "type": e.get("wire", {}).get("msg_type"),
             "bytes": e.get("bytes"), "retries": e.get("retries"),
             "latency_s": e.get("latency_s"), "eps": e.get("eps"),
             "trace_id": e.get("trace_id"), "ts": e.get("ts")}
            for e in entries]
    return _table(rows, ["seq", "dir", "type", "bytes", "retries",
                         "latency_s", "eps", "trace_id", "ts"])


def correlation_matrix_frame(results, plan=None) -> dict:
    """A completed federation matrix (``protocol.federation``) as a
    per-cell table, a dict of numpy columns (counterpart of
    ``dpcorr.report.correlation_matrix_frame``). ``results`` is one
    ``FederationResult``, a ``{party: FederationResult}`` mapping (the
    table is the union of the parties' cells), or a cells dict
    ``{"i,j": {"rho_hat", "ci_low", "ci_high"}}``. Parties must agree
    bitwise on every shared cell; disagreement raises. With ``plan`` each
    row also carries the cell's column labels and venue (``local@P`` or
    ``link P-Q``)."""
    cells: dict = {}

    def merge(d):
        for key, val in d.items():
            if key in cells and cells[key] != val:
                raise ValueError(f"parties disagree on cell {key}: "
                                 f"{cells[key]} != {val}")
            cells.setdefault(key, val)

    if hasattr(results, "cells"):
        merge(results.cells)
    elif isinstance(results, dict) \
            and all(hasattr(r, "cells") for r in results.values()):
        for r in results.values():
            merge(r.cells)
    else:
        merge(dict(results))
    rows = []
    for key in sorted(cells,
                      key=lambda s: tuple(int(t) for t in s.split(","))):
        i, j = (int(t) for t in key.split(","))
        val = cells[key]
        row = {"i": i, "j": j, "label_x": None, "label_y": None,
               "venue": None, "rho_hat": val["rho_hat"],
               "ci_low": val["ci_low"], "ci_high": val["ci_high"]}
        if plan is not None:
            row["label_x"], row["label_y"] = plan.label(i), plan.label(j)
            v = plan.cell_venue(i, j)
            row["venue"] = (f"local@{v[1]}" if v[0] == "local"
                            else f"link {v[1]}-{v[2]}")
        rows.append(row)
    return _table(rows, ["i", "j", "label_x", "label_y", "venue",
                         "rho_hat", "ci_low", "ci_high"])
