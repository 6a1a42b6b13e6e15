"""The port's acceptance campaign against dpcorr.acceptance, on the CPU.

The design points are the JAX package's, field for field; ``build_table``
and ``dumps`` give the same output on the same rows; a coverage run at
b = 64 on the same keys agrees with the JAX package's within 2/b; a tiny
campaign reproduces the degenerate Laplace point exactly.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import dpcorr.acceptance as jacc
from dpcorr.sim import SimConfig as JaxSimConfig
from dpcorr_torch import acceptance
from dpcorr_torch.sim import SimConfig

B = 64


def test_points_equal_jax():
    assert len(acceptance.POINTS) == len(jacc.POINTS) == 6
    for got, want in zip(acceptance.POINTS, jacc.POINTS, strict=True):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert acceptance._SUM_FIELDS == jacc._SUM_FIELDS


def _row(name, ni, int_det, int_mc=None, b=1_000_000):
    def run(int_cov):
        return {"b": b, "seconds": 1.0, "reps_per_sec": 1.0,
                "NI": {"coverage": ni, "mse": 0.1, "ci_length": float("nan")},
                "INT": {"coverage": int_cov, "mse": 0.01, "ci_length": 0.3}}

    row = {"point": name, "regime": "r", "config": {"n": 100},
           "det": run(int_det)}
    if int_mc is not None:
        row["mc"] = run(int_mc)
        row["int_det_mc_diff"] = abs(int_det - int_mc)
        row["ni_det_mc_diff"] = 0.0
    return row


@pytest.mark.parametrize("rows", [
    [_row("a", 0.95, 0.9502, 0.9498), _row("b", 0.949, 0.951)],
    # beyond 1e-3 with det closer to nominal: the attribution branch
    [_row("a", 0.95, 0.9501, 0.9480), _row("b", 0.95, 0.9499, 0.9481)],
    # beyond 1e-3 with mc closer: the criterion fails
    [_row("a", 0.95, 0.9400, 0.9480)],
    [_row("laplace", 0.0, 1.0)],
])
def test_build_table_equals_jax(rows):
    want = jacc.build_table(rows, alpha=0.05, device="d")
    got = acceptance.build_table(rows, alpha=0.05, device="d")
    # dumps: the NaN ci_length is null in both (NaN != NaN in a dict ==)
    assert acceptance.dumps(got) == jacc.dumps(want)
    assert acceptance.dumps(rows) == jacc.dumps(rows)


@pytest.mark.parametrize("name", ["sign_normal", "subg_factor"])
def test_coverage_run_matches_jax(name):
    pt = {p.name: p for p in acceptance.POINTS}[name]
    kw = dict(pt.kwargs, alpha=0.05, chunk_size=32, mixquant_mode="det")
    want = jacc._coverage_run(JaxSimConfig(**kw), B, B // 2)
    got = acceptance._coverage_run(SimConfig(**kw), B, B // 2, device="cpu")
    assert got["b"] == want["b"] == B
    for meth in ("NI", "INT"):
        assert abs(got[meth]["coverage"]
                   - want[meth]["coverage"]) <= 2 / B
        np.testing.assert_allclose(got[meth]["ci_length"],
                                   want[meth]["ci_length"], rtol=0.02)


def test_run_campaign_writes_its_table(tmp_path):
    laplace = [p for p in acceptance.POINTS if p.name == "sign_laplace"]
    out = tmp_path / "acceptance_cpu.json"
    table = acceptance.run_campaign(b=32, block=16, points=laplace,
                                    out=out, device="cpu")
    row = table["points"][0]
    assert row["det"]["b"] == 32
    # k = 1 batch: the NI CI is NaN and covers nothing; INT saturates
    assert row["det"]["NI"]["coverage"] == 0.0
    assert row["det"]["INT"]["coverage"] == 1.0
    assert table["device"] == "cpu" and table["det_mc_pass"]
    on_disk = json.loads(out.read_text())
    assert on_disk["points"][0]["det"]["NI"]["ci_length"] is None
    assert not list(tmp_path.glob("*.tmp"))


def test_campaign_raises_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        acceptance.run_campaign(b=8, points=acceptance.POINTS[:1])
