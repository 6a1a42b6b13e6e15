"""The port's R bridge (dpcorr_torch.rbridge, r/backend_torch.R) against
dpcorr.rbridge, on the CPU: the Python half of the reticulate seam.

The bridge returns a dict of numpy columns in the reference's order
(repl, the 12 detail fields, n, rho_true, eps1, eps2) with the JAX
frame's dtypes; its values agree with the JAX bridge's within
``test_torch_grid.py``'s tolerance (1e-5 absolute, 1e-6 relative on the
squared errors, for at least 99% of rows); its backends are bit-equal to
each other; the R shim passes only keywords the functions take.
"""

import inspect
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from dpcorr import rbridge as jrbridge
from dpcorr.io import rds_py as jrds
from dpcorr_torch import hrs, perf_hrs, rbridge
from dpcorr_torch.io.rds import read_rds_table
from dpcorr_torch.sim import DETAIL_FIELDS

REPO = Path(__file__).parent.parent
ORDER = ["repl", *DETAIL_FIELDS, "n", "rho_true", "eps1", "eps2"]
ROWS = [{"n": 400, "rho": 0.0, "eps1": 1.0, "eps2": 1.0},
        {"n": 400, "rho": 0.5, "eps1": 1.0, "eps2": 1.0},
        {"n": 600, "rho": 0.5, "eps1": 1.5, "eps2": 0.5}]


def _run(rows=ROWS, **kw):
    kw.setdefault("b", 16)
    return rbridge.run_design_rows(rows, device="cpu", **kw)


def test_run_design_rows_schema():
    rows = [{"n": 400, "rho": 0.0, "eps1": 1.0, "eps2": 1.0},
            {"n": 600, "rho": 0.5, "eps1": 1.5, "eps2": 0.5}]
    d = _run(rows)
    assert list(d) == ORDER
    assert len(d["repl"]) == 32
    assert sorted(set(d["n"].tolist())) == [400, 600]
    assert d["repl"].max() == 16
    assert set(d["ni_cover"].tolist()) <= {0.0, 1.0}


def test_matches_the_jax_bridge():
    """Same rows, seed and backend: the JAX bridge's frame column for
    column, in order and dtype, values within the grid's tolerance."""
    got = _run(backend="bucketed")
    want = jrbridge.run_design_rows(ROWS, b=16, backend="bucketed")
    assert list(got) == list(want.columns) == ORDER
    ok = np.ones(len(want), bool)
    for col in want.columns:
        w = want[col].to_numpy()
        assert got[col].dtype == w.dtype, col
        rtol = 1e-6 if col.endswith("se2") else 0.0
        ok &= np.isclose(got[col], w, rtol=rtol, atol=1e-5, equal_nan=True)
    assert ok.mean() >= 0.99
    for col in ("repl", "n", "rho_true", "eps1", "eps2"):
        np.testing.assert_array_equal(got[col], want[col].to_numpy())


@pytest.mark.parametrize("backend", ["bucketed", "sharded"])
def test_backends_bit_identical_to_local(backend):
    local = _run()
    got = _run(backend=backend)
    assert list(got) == list(local)
    for col, v in local.items():
        np.testing.assert_array_equal(got[col], v, err_msg=col)


def _r_call_kwargs(r_src: str, fn: str) -> set[str]:
    """Keyword names used in ``bridge$<fn>(...)`` calls inside the shim."""
    m = re.search(rf"bridge\${fn}\((.*?)\)\n", r_src, re.S)
    assert m, f"backend_torch.R never calls bridge${fn}"
    return set(re.findall(r"(\w+)\s*=", m.group(1)))


def test_backend_r_call_contract():
    """No R runtime here, so the reticulate call contract is pinned the
    executable way: every keyword backend_torch.R passes is a parameter of
    the port's function it calls, and it imports the port's bridge."""
    r_src = (REPO / "r" / "backend_torch.R").read_text()
    assert 'reticulate::import("dpcorr_torch.rbridge")' in r_src
    assert "dpcorr.rbridge" not in r_src
    for fn, py in (("run_design_rows", rbridge.run_design_rows),
                   ("run_hrs_sweep", rbridge.run_hrs_sweep)):
        params = set(inspect.signature(py).parameters)
        used = _r_call_kwargs(r_src, fn)
        assert used and used <= params, f"{fn}: passes {used - params}"
    assert "4.5x" not in r_src


def test_table_feeds_reference_downstream_unchanged():
    """The table holds every column the reference's data.table summaries
    read (vert-cor.R:575-597), and that grouped recipe runs over it."""
    df = pd.DataFrame(_run(ROWS[:2]))
    consumed = {"int_se2", "int_hat", "int_cover", "int_ci_len",
                "ni_se2", "ni_hat", "ni_cover", "ni_ci_len",
                "n", "rho_true", "eps1", "eps2"}
    assert consumed <= set(df.columns)
    g = df.groupby(["n", "rho_true", "eps1", "eps2"])
    summ = g.agg(mse=("ni_se2", "mean"), coverage=("ni_cover", "mean"),
                 ci_len=("ni_ci_len", "mean")).reset_index()
    assert len(summ) == 2
    assert summ.coverage.between(0, 1).all()
    assert np.isfinite(summ.mse).all()


def test_run_design_rows_deterministic():
    rows = [{"n": 300, "rho": 0.3, "eps1": 1.0, "eps2": 1.0}]
    a = _run(rows, b=8)
    b = _run(rows, b=8)
    np.testing.assert_array_equal(a["ni_hat"], b["ni_hat"])
    c = _run(rows, b=8, seed=7)  # another master seed, other draws
    assert not np.allclose(a["ni_hat"], c["ni_hat"])


def test_fused_and_backend_validation_fail_fast():
    rows = ROWS[:1]
    for kw in (dict(backend="local", fused="auto"),
               dict(backend="bucketed", fused="Auto")):
        with pytest.raises(ValueError, match="fused") as got:
            _run(rows, b=4, **kw)
        with pytest.raises(ValueError, match="fused") as want:
            jrbridge.run_design_rows(rows, b=4, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="backend"):
        _run(rows, b=4, backend="bucketed-sharded")


def test_fused_auto_on_the_cpu_runs_unfused():
    """K1 runs only on the card: on the CPU ``fused="auto"`` selects no
    bucket and the table equals the unfused one."""
    off = _run(backend="bucketed")
    auto = _run(backend="bucketed", fused="auto")
    for col, v in off.items():
        np.testing.assert_array_equal(auto[col], v)


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rbridge.run_design_rows(ROWS, b=4)
    path = tmp_path / "panel.rds"
    perf_hrs.write_panel(str(path), perf_hrs.synthetic_panel(1, 16 * 100))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rbridge.run_hrs_sweep([1.0], reps=2, panel_path=str(path))


def test_run_hrs_sweep_equals_eps_sweep(tmp_path):
    cols = perf_hrs.synthetic_panel(2, 16 * 600)
    path = tmp_path / "panel.rds"
    perf_hrs.write_panel(str(path), cols)
    got = rbridge.run_hrs_sweep([0.5, 2.0], reps=4, device="cpu",
                                panel_path=str(path))
    want = hrs.eps_sweep(cols=cols, eps_grid=[0.5, 2.0], reps=4,
                         device="cpu").summary
    assert list(got) == list(want)
    for col, v in want.items():
        np.testing.assert_array_equal(got[col], v, err_msg=col)


def test_validate_bridge_python_half(tmp_path):
    """The R-free slice of r/validate_bridge_torch.R: run the helper as the
    R script does, read its detail_all.rds back with both packages'
    readers, and diff it against the in-process bridge table."""
    out = tmp_path / "detail_all.rds"
    rc = subprocess.run(
        [sys.executable, str(REPO / "r" / "validate_bridge_torch_helper.py"),
         "--out", str(out), "--device", "cpu"],
        capture_output=True, text=True, timeout=600)
    assert rc.returncode == 0, rc.stderr[-800:]
    sys.path.insert(0, str(REPO / "r"))
    try:
        import validate_bridge_torch_helper as helper
    finally:
        sys.path.pop(0)
    table = helper.run_validation_grid(device="cpu")
    assert len(table["repl"]) == len(helper.ROWS) * helper.B
    for cols in (read_rds_table(out), jrds.read_rds_table(str(out))):
        assert list(cols) == list(table)
        for name, v in table.items():
            np.testing.assert_array_equal(
                np.asarray(cols[name].values, dtype=np.float64),
                np.asarray(v, dtype=np.float64), name)


def test_validate_bridge_r_script_wellformed():
    """Smoke-parse r/validate_bridge_torch.R and r/backend_torch.R without
    an R runtime: balanced delimiters outside strings and comments, the
    helper exists, and the recipe names real bridge columns."""
    for name in ("validate_bridge_torch.R", "backend_torch.R"):
        src = (REPO / "r" / name).read_text()
        depth = {"(": 0, "[": 0, "{": 0}
        close_of = {")": "(", "]": "[", "}": "{"}
        in_str = None
        for line in src.splitlines():
            for ch in line:
                if in_str:
                    if ch == in_str:
                        in_str = None
                    continue
                if ch in "'\"":
                    in_str = ch
                elif ch == "#":
                    break
                elif ch in depth:
                    depth[ch] += 1
                elif ch in close_of:
                    depth[close_of[ch]] -= 1
                    assert depth[close_of[ch]] >= 0, (name, line)
            assert in_str is None, (name, line)
        assert all(v == 0 for v in depth.values()), (name, depth)
    src = (REPO / "r" / "validate_bridge_torch.R").read_text()
    assert (REPO / "r" / "validate_bridge_torch_helper.py").exists()
    assert "validate_bridge_torch_helper.py" in src
    assert 'source(file.path("r", "backend_torch.R"))' in src
    assert {"ni_cover", "int_cover", "n", "rho_true", "eps1",
            "eps2"} <= set(ORDER)


def test_run_design_rows_bucket_merge_subg():
    """bucket_merge='eps' through the R seam: ε pairs come from the rows;
    non-bucketed backends and sign rows reject the knob, as the JAX
    bridge does."""
    rows = [{"n": 400, "rho": 0.5, "eps1": 1.0, "eps2": 1.0},
            {"n": 400, "rho": 0.5, "eps1": 1.5, "eps2": 0.5},
            {"n": 600, "rho": 0.2, "eps1": 1.0, "eps2": 1.0}]
    d = _run(rows, dgp="bounded_factor", use_subg=True, backend="bucketed",
             bucket_merge="eps")
    assert len(d["repl"]) == 3 * 16
    assert not np.isnan(d["ni_hat"]).any()
    assert set(d["ni_cover"].tolist()) <= {0.0, 1.0}
    for kw, match in ((dict(use_subg=True, dgp="bounded_factor",
                            bucket_merge="eps"), "bucketed"),
                      (dict(backend="bucketed", bucket_merge="eps"),
                       "subG-only")):
        rws = rows if kw.get("use_subg") else rows[:1]
        with pytest.raises(ValueError, match=match):
            _run(rws, b=4, **kw)
        with pytest.raises(ValueError, match=match):
            jrbridge.run_design_rows(rws, b=4, **kw)
