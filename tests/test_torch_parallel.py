"""The port's sharded backends (dpcorr_torch.parallel) against the local
path and against dpcorr.parallel, on CPU device lists of width 1-4 (the
counterpart of the JAX tests' virtual CPU devices).

Sharding changes the layout, never the numbers: the sharded detail is bit
for bit the local one at every width, B divisible or not, and a
``bucketed-sharded`` grid is bit for bit the ``bucketed`` one. The
summary's f32 sums agree with the f64 sums of the detail, and with the
JAX package's ``psum``'d sums on the same keys, within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

from dpcorr.parallel import backend as jbackend
from dpcorr.parallel import rep_mesh
from dpcorr.parallel import run_summary_sharded as jax_run_summary_sharded
from dpcorr.sim import SimConfig as JaxSimConfig
from dpcorr_torch import grid
from dpcorr_torch.parallel import (
    local_device_count,
    rep_devices,
    run_detail_flat_sharded,
    run_detail_sharded,
    run_summary_sharded,
)
from dpcorr_torch.parallel import backend as sharded
from dpcorr_torch.sim import DETAIL_FIELDS, SimConfig, run_sim_one
from dpcorr_torch.utils import rng

CFG = dict(n=500, rho=0.3, eps1=1.0, eps2=1.0, seed=5)


def test_rep_devices_on_the_cpu():
    assert rep_devices(device="cpu") == [torch.device("cpu")]
    assert rep_devices(4, device="cpu") == [torch.device("cpu")] * 4
    assert local_device_count("cpu") == 1
    with pytest.raises(ValueError, match=">= 1"):
        rep_devices(0, device="cpu")


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SimConfig(**CFG, b=4)
    for call in (rep_devices, local_device_count,
                 lambda: run_detail_sharded(cfg),
                 lambda: run_summary_sharded(cfg),
                 lambda: grid.run_grid(grid.GridConfig(
                     n_grid=(200,), rho_grid=(0.5,), eps_pairs=((1.0, 1.0),),
                     b=2, backend="sharded"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("b", [37, 40])
@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_sharded_detail_bit_equal_to_local(width, b):
    cfg = SimConfig(**CFG, b=b)
    local = run_sim_one(cfg, device="cpu")
    got = run_detail_sharded(cfg, devices=rep_devices(width, "cpu"))
    for f in DETAIL_FIELDS:
        assert got.detail[f].shape == (b,)
        np.testing.assert_array_equal(got.detail[f].numpy(),
                                      local.detail[f].numpy(), err_msg=f)
    assert got.summary == local.summary


def test_flat_sharded_pads_past_the_axis():
    """A bucket shorter than the device list: the modulo gather repeats
    its elements and the padding is cut away."""
    cfg = SimConfig(**CFG, b=3)
    keys = rng.rep_keys(rng.master_key(5), 3)
    rhos = torch.tensor([0.0, 0.3, 0.9])
    want = sharded.sim_mod._run_detail_flat(cfg, keys, rhos)
    got = run_detail_flat_sharded(cfg, keys, rhos, rep_devices(4, "cpu"))
    for g, w in zip(got, want, strict=True):
        assert g.shape == (3,)
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("width", [1, 4])
def test_summary_sums_match_the_detail_and_jax(width):
    """B = 37 over 4 shards pads to 40; the padding adds nothing."""
    cfg = SimConfig(**CFG, b=37)
    sums = sharded.summary_sums(cfg, devices=rep_devices(width, "cpu"))
    detail = {k: v.numpy().astype(np.float64) for k, v in
              run_sim_one(cfg, device="cpu").detail.items()}
    jcfg = JaxSimConfig(**CFG, b=37)
    mesh = rep_mesh(4)
    cfg_norho, keys, _ = jbackend._prep(jcfg, None, mesh)
    jsums = jbackend._summary_fn(cfg_norho, mesh)(
        keys, np.float32(jcfg.rho), np.float32(jcfg.b))
    for meth in ("ni", "int"):
        est = detail[f"{meth}_hat"]
        want = {"sum_hat": est.sum(), "sum_hat2": (est * est).sum(),
                "sum_se2": detail[f"{meth}_se2"].sum(),
                "sum_cover": detail[f"{meth}_cover"].sum(),
                "sum_len": detail[f"{meth}_ci_len"].sum()}
        assert list(sums[meth]) == list(sharded.SUM_NAMES)
        for k, v in want.items():
            np.testing.assert_allclose(sums[meth][k], v, rtol=1e-6,
                                       err_msg=(meth, k))
            np.testing.assert_allclose(sums[meth][k], float(jsums[meth][k]),
                                       rtol=1e-6, err_msg=(meth, k))


def test_summary_matches_local_and_jax_summary():
    cfg = SimConfig(**CFG, b=37)
    got = run_summary_sharded(cfg, devices=rep_devices(3, "cpu"))
    local = run_sim_one(cfg, device="cpu").summary
    jax_summ = jax_run_summary_sharded(JaxSimConfig(**CFG, b=37),
                                       mesh=rep_mesh(4))
    for meth in ("NI", "INT"):
        assert set(got[meth]) == set(jax_summ[meth])
        for k in ("mse", "coverage", "ci_length"):
            np.testing.assert_allclose(got[meth][k], local[meth][k],
                                       rtol=1e-6, err_msg=(meth, k))
            np.testing.assert_allclose(got[meth][k], jax_summ[meth][k],
                                       rtol=1e-6, err_msg=(meth, k))
        for want in (local, jax_summ):
            np.testing.assert_allclose(got[meth]["bias"] + cfg.rho,
                                       want[meth]["bias"] + cfg.rho,
                                       rtol=1e-6)
            # a difference of two sums: 1e-6 of E[ρ̂²] on a small variance
            np.testing.assert_allclose(got[meth]["var"], want[meth]["var"],
                                       rtol=1e-4)


GRID = dict(n_grid=(200, 300), rho_grid=(0.0, 0.5),
            eps_pairs=((1.0, 1.0), (2.0, 1.0)), b=8, seed=3, device="cpu")


@pytest.fixture(scope="module")
def bucketed():
    return grid.run_grid(grid.GridConfig(**GRID, backend="bucketed"))


@pytest.mark.parametrize("width", [1, 3])
def test_bucketed_sharded_bit_equal_to_bucketed(bucketed, width):
    res = grid.run_grid(grid.GridConfig(**GRID, backend="bucketed-sharded"),
                        devices=rep_devices(width, "cpu"))
    assert list(res.detail_all) == list(bucketed.detail_all)
    for col, v in bucketed.detail_all.items():
        np.testing.assert_array_equal(res.detail_all[col], v, err_msg=col)


def test_sharded_grid_bit_equal_to_bucketed(bucketed):
    res = grid.run_grid(grid.GridConfig(**GRID, backend="sharded"),
                        devices=rep_devices(2, "cpu"))
    for col, v in bucketed.detail_all.items():
        np.testing.assert_array_equal(res.detail_all[col], v, err_msg=col)
    # one timings row per point on the per-point backends
    assert len(res.timings["i"]) == 8
