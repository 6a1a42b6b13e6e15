"""``python -m dpcorr_torch``: the same configurations, defaults and JSON
echo as ``python -m dpcorr``, on the card unless ``--device cpu``."""

import json

import numpy as np
import pytest
import torch

from dpcorr.__main__ import main as jax_main
from dpcorr_torch.__main__ import main
from dpcorr_torch.io.rds_py import read_rds_table

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
    assert sorted(set(table["n"])) == [2500, 4000, 6000, 9000, 12000]
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
