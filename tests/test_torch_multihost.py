"""The port's grid fan-out (dpcorr_torch.parallel.multihost) against the
single-process grid and against dpcorr.parallel.multihost's partition, on
the CPU with two worker processes.

A worker owns whole (n, ε) buckets, so the merged grid is bit for bit the
single-process one, with independent workers and as a gloo group (two
ranks, a barrier, rank 0 merging); a worker's failure fails the run.
"""

import numpy as np
import pytest
import torch

from dpcorr.grid import GridConfig as JaxGridConfig
from dpcorr.parallel.multihost import grid_slice as jax_grid_slice
from dpcorr_torch.grid import GridConfig, run_grid
from dpcorr_torch.parallel.multihost import grid_slice, run_grid_multihost

GCFG = dict(n_grid=(200, 300), rho_grid=(0.0, 0.5),
            eps_pairs=((1.0, 1.0), (2.0, 1.0)), b=8)


def _bit_equal(res, ref):
    assert list(res.detail_all) == list(ref.detail_all)
    for col, v in ref.detail_all.items():
        np.testing.assert_array_equal(res.detail_all[col], v, err_msg=col)
    for col, v in ref.summ_all.items():
        np.testing.assert_array_equal(res.summ_all[col], v, err_msg=col)


class TestGridSlice:
    def test_partition_is_exact_and_matches_jax(self):
        design = GridConfig(**GCFG).design_points()
        jdesign = JaxGridConfig(**GCFG).design_points()
        for n_hosts in (1, 2, 3, 5):
            got = [grid_slice(design, h, n_hosts) for h in range(n_hosts)]
            ids = sorted(i for s in got for i in s["i"].tolist())
            assert ids == design["i"].tolist()  # disjoint and complete
            for h, s in enumerate(got):
                want = jax_grid_slice(jdesign, h, n_hosts)
                for col in want.columns:
                    np.testing.assert_array_equal(s[col], want[col])

    def test_hosts_own_whole_buckets(self):
        design = GridConfig(**GCFG).design_points()
        buckets = [set(zip(s["n"].tolist(), s["eps1"].tolist(),
                           s["eps2"].tolist()))
                   for s in (grid_slice(design, h, 2) for h in range(2))]
        assert buckets[0] and buckets[1]
        assert not (buckets[0] & buckets[1])

    def test_bad_host_id(self):
        design = GridConfig(**GCFG).design_points()
        with pytest.raises(ValueError):
            grid_slice(design, 2, 2)


@pytest.fixture(scope="module")
def single():
    return run_grid(GridConfig(**GCFG, backend="bucketed", device="cpu"))


def test_multihost_matches_single_host(tmp_path, single):
    gcfg = GridConfig(**GCFG, backend="bucketed", device="cpu",
                      out_dir=str(tmp_path / "mh"))
    res = run_grid_multihost(gcfg, n_hosts=2)
    _bit_equal(res, single)
    assert [h["host_id"] for h in res.hosts] == [0, 1]
    assert [h["points"] for h in res.hosts] == [4, 4]
    assert all(h["launches"] == 0 and not h["merged"] for h in res.hosts)


def test_multihost_local_backend_honored(tmp_path, single):
    """backend='local' runs the per-point path in each worker (one cache
    file per point, no bucket) and still merges bit for bit."""
    gcfg = GridConfig(**GCFG, backend="local", device="cpu",
                      out_dir=str(tmp_path / "mh_local"))
    res = run_grid_multihost(gcfg, n_hosts=2)
    _bit_equal(res, single)
    assert len(list((tmp_path / "mh_local").glob("design_*.npz"))) == 8


def test_multihost_requires_out_dir():
    with pytest.raises(ValueError, match="out_dir"):
        run_grid_multihost(GridConfig(**GCFG, device="cpu"), n_hosts=2)


def test_gloo_group_matches_single_host(tmp_path, single):
    """Two ranks of a gloo group on the CPU, each sharding its buckets over
    two device entries (bucketed-sharded); rank 0 merges after the
    barrier."""
    gcfg = GridConfig(**GCFG, backend="bucketed-sharded", device="cpu",
                      out_dir=str(tmp_path / "dist"))
    res = run_grid_multihost(gcfg, n_hosts=2, distributed=True,
                             local_device_count=2)
    assert [h["host_id"] for h in res.hosts] == [0, 1]
    assert all(h["process_count"] == 2 for h in res.hosts)
    assert all(h["local_devices"] == 2 for h in res.hosts)
    assert [h["merged"] for h in res.hosts] == [True, False]
    _bit_equal(res, single)


def test_worker_failure_fails_the_run(tmp_path):
    gcfg = GridConfig(**GCFG, backend="bucketed", device="cpu",
                      dgp="no-such-dgp", out_dir=str(tmp_path / "bad"))
    with pytest.raises(RuntimeError, match="2/2 hosts failed"):
        run_grid_multihost(gcfg, n_hosts=2)


def test_multihost_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_grid_multihost(GridConfig(**GCFG, out_dir=str(tmp_path)),
                           n_hosts=2)
    assert not list(tmp_path.iterdir())
