"""``python -m dpcorr_torch``: the same configurations, defaults and JSON
echo as ``python -m dpcorr``, on the card unless ``--device cpu``."""

import json

import numpy as np
import pytest
import torch

from dpcorr.__main__ import main as jax_main
from dpcorr_torch.__main__ import main
from dpcorr_torch.io.rds import read_rds_table

#: the reference's demo design point (vert-cor.R:449-458), as
#: tests/test_golden_demo.py pins it for the JAX package
DEMO = {"n": 2000, "rho": -0.95, "eps": [0.5, 1.0], "B": 8,
        "dgp": "gaussian", "dgp_args": {"mu": [2.0, 2.0],
                                        "sigma": [2.0, 0.1]},
        "normalise": True, "seed": 2025}


def test_demo_echoes_the_reference_config(capsys):
    main(["demo", "--device", "cpu", "--b", "8"])
    out = json.loads(capsys.readouterr().out)
    assert out["config"] == DEMO
    jax_main(["demo", "--b", "8"])
    want = json.loads(capsys.readouterr().out)
    assert out["config"] == want["config"]
    assert set(out["summary"]) == set(want["summary"]) == {"NI", "INT"}
    for meth in ("NI", "INT"):
        assert set(out["summary"][meth]) == set(want["summary"][meth])
        assert 0.0 <= out["summary"][meth]["coverage"] <= 1.0


@pytest.mark.parametrize("argv", [
    ["demo", "--b", "8"],
    ["demo", "--device", "cuda", "--b", "8"],
    ["grid", "--b", "2", "--backend", "bucketed"],
    ["acceptance", "--b", "8"],
    ["stress", "--b", "2"],
    ["hrs"],
    ["hrs-sweep", "--b", "2"],
])
def test_commands_raise_without_a_card(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_grid_subg_writes_tables_and_no_figures(tmp_path, capsys):
    main(["grid-subg", "--device", "cpu", "--b", "2", "--backend",
          "bucketed", "--bucket-merge", "eps", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "240 replicate rows" in out        # 120 points × 2
    assert "INT" in out and "no figures" in out
    table = read_rds_table(str(tmp_path / "detail_all.rds"))
    assert sorted(set(table["n"].values)) == [2500, 4000, 6000, 9000, 12000]
    with np.load(tmp_path / "summ_all.npz") as s:
        assert len(s["method"]) == 240
    assert not list(tmp_path.glob("*.png"))


def test_stress_and_demo_subg_run_on_the_cpu(capsys):
    main(["stress", "--device", "cpu", "--n", "4096", "--n-chunk", "1024",
          "--b", "2", "--family", "sign"])
    out = json.loads(capsys.readouterr().out)
    assert out["n"] == 4096 and out["stream_n_chunk"] == 1024
    assert 0.0 <= out["summary"]["NI"]["coverage"] <= 1.0
    main(["demo-subg", "--device", "cpu", "--b", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["config"] == {"n": 5500, "rho": 0.6, "eps": [5.0, 1.0],
                             "B": 2}


def test_grid_flags_are_validated():
    with pytest.raises(SystemExit):
        main(["grid", "--device", "cpu", "--backend", "sharded"])
    with pytest.raises(SystemExit):
        main(["grid", "--device", "tpu"])


#: the fields ``python -m dpcorr hrs`` prints (dpcorr/__main__.py:162-173)
HRS_FIELDS = {"n", "private_moments", "lambda", "rho_non_private", "NI",
              "INT_age_to_bmi"}


@pytest.fixture
def panel(tmp_path, monkeypatch):
    """A synthetic HRS panel at the default path's place."""
    from dpcorr_torch import hrs, perf_hrs

    path = tmp_path / "hrs_long_panel.rds"
    cols = perf_hrs.synthetic_panel(3, 16 * 400)
    perf_hrs.write_panel(str(path), cols)
    monkeypatch.setattr(hrs, "DEFAULT_PANEL", str(path))
    return cols


def test_hrs_prints_the_jax_commands_fields(panel, capsys):
    from dpcorr_torch import hrs

    main(["hrs", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == HRS_FIELDS
    want = hrs.point_estimates(cols=panel, device="cpu")
    assert out["n"] == want.n == 172
    assert out["NI"] == want.ni and out["INT_age_to_bmi"] == want.int_
    assert out["rho_non_private"] == want.std.rho_np
    assert out["lambda"] == {"age_z": want.std.lam_age,
                             "bmi_z": want.std.lam_bmi}


def test_hrs_sweep_writes_tables_and_no_figures(panel, tmp_path, capsys):
    from dpcorr_torch import hrs

    out_dir = tmp_path / "out"
    main(["hrs-sweep", "--device", "cpu", "--b", "3", "--out",
          str(out_dir)])
    printed = capsys.readouterr().out
    assert "eps=2.45: dispatched (23/23)" in printed
    assert "no figures" in printed
    assert not list(out_dir.glob("*.png"))
    with np.load(out_dir / "hrs_sweep_runs.npz") as runs:
        assert len(runs["rho_hat"]) == 23 * 2 * 3
        assert runs["method"].dtype.kind == "U"
    want = hrs.eps_sweep(cols=panel, reps=3, device="cpu")
    with np.load(out_dir / "hrs_sweep_summary.npz") as summ:
        assert list(summ.files) == list(want.summary)
        for c in summ.files:
            np.testing.assert_array_equal(summ[c], want.summary[c].astype(
                summ[c].dtype))


@pytest.mark.parametrize("cmd", ["hrs", "hrs-sweep"])
def test_hrs_commands_raise_without_the_panel(cmd, tmp_path, monkeypatch):
    from dpcorr_torch import hrs

    monkeypatch.setattr(hrs, "DEFAULT_PANEL", str(tmp_path / "none.rds"))
    with pytest.raises(FileNotFoundError, match="HRS panel not found"):
        main([cmd, "--device", "cpu"])
