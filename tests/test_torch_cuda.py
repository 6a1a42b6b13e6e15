"""The port on the card: every pass/fail check of the port on a CUDA
device lives here. The kernels against their plain versions, the
replication pipeline through both bodies and its statistical gates, the
acceptance points against the JAX package's committed coverage, the
sub-Gaussian, streaming, grid and HRS paths against the same keys on the
CPU, and the serving, protocol, stream, fleet, plan and measuring layers
on the card, in process and as ``python -m dpcorr_torch`` processes.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

``python3 chip_smoke.py`` builds the kernels, prints their times and runs
this file.
"""

import dataclasses
import json
import math
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from dpcorr_torch import grid, hrs, perf_hrs, sim
from dpcorr_torch.models.dgp import gen_bounded_factor
from dpcorr_torch.ops import fused_ni, ladder
from dpcorr_torch.utils import rng

#: (n, ε) of each lane-group layout the kernel's sweep branches on:
#: m' = 1, 8, 16 (m = 11, with leftovers), 32, 64, 128, n = 1000 and
#: 20,000, and m' = 8 with leftovers (n = 1500)
GEOMETRIES = [
    (10_000, (4.0, 2.0)),
    (10_000, (1.0, 1.0)),
    (9_000, (1.5, 0.5)),
    (10_000, (0.5, 0.5)),
    (10_000, (0.5, 0.25)),
    (10_000, (0.25, 0.25)),
    (1_000, (1.0, 1.0)),
    (20_000, (1.0, 1.0)),
    (1_500, (1.0, 1.0)),
]
#: (n, ε, compute_int) where the batch noise does not fit beside the
#: planes in shared memory, so the kernel's sweep draws it: m' = 1 and 8
#: at the cap on n (NI and INT), m' = 2, 4, 64, 128
NOISE_IN_SWEEP = [
    (28_000, (4.0, 2.0), False), (25_000, (4.0, 2.0), True),
    (20_000, (2.0, 2.0), False), (20_000, (2.0, 2.0), True),
    (24_000, (1.5, 1.5), False), (24_000, (1.5, 1.5), True),
    (28_000, (1.0, 1.0), False), (25_000, (1.0, 1.0), True),
    (28_000, (0.5, 0.25), False), (28_000, (0.25, 0.25), False),
]
#: every layout in both INT modes, then the noise-in-sweep cases
CASES = [(n, eps, ci) for n, eps in GEOMETRIES
         for ci in (False, True)] + NOISE_IN_SWEEP


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _uniforms(seed, b, n, eps, compute_int, device):
    rows = fused_ni.n_uniform_rows(n, *eps, compute_int)
    u = np.random.default_rng(seed).uniform(1e-7, 1 - 1e-7, (b, rows, 128))
    return torch.from_numpy(u.astype(np.float32)).to(device)


def _within(got, want):
    """Per replication: ΣT_j and ΣT_j² within 1e-4 relative, η̂_INT
    within 1e-5."""
    ok = torch.isclose(got[:, :2], want[:, :2], rtol=1e-4, atol=0.0).all(1)
    return ok & torch.isclose(got[:, 2], want[:, 2], rtol=0.0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["external", "philox"])
@pytest.mark.parametrize("n,eps,compute_int", CASES)
@pytest.mark.parametrize("normalise", [True, False])
@pytest.mark.parametrize("gauss", ["boxmuller", "ndtri"])
def test_kernel_matches_plain(cuda, gauss, normalise, n, eps, compute_int,
                              source):
    """The kernel against its plain version on identical uniforms: for at
    least 99% of replications ΣT_j and ΣT_j² within 1e-4 relative and
    η̂_INT within 1e-5 (the rest: a centered value at a sign tie under
    another rounding). ``external``: random uniforms. ``philox``: the
    in-kernel generator, whose draws ``philox_uniforms`` lays out; both
    modes walk positions in the same order, so in-kernel mode must equal
    external mode on those uniforms bit for bit. In the
    ``NOISE_IN_SWEEP`` cases the kernel draws the batch noise in its
    sweep, from the same words."""
    if (n, eps, compute_int) in NOISE_IN_SWEEP:
        c = fused_ni._Consts(n, *eps, (0.0, 0.0), (1.0, 1.0))
        assert not c.noise_in_smem(compute_int)
    b = 128
    rho = torch.linspace(-0.6, 0.9, b, device=cuda)
    kw = dict(normalise=normalise, compute_int=compute_int, gauss=gauss)
    if source == "external":
        seeds = torch.zeros(b, 2, dtype=torch.int32, device=cuda)
        u = _uniforms(6, b, n, eps, compute_int, cuda)
    else:
        seeds = torch.from_numpy(np.random.default_rng(8).integers(
            -2**31, 2**31, (b, 2), dtype=np.int64).astype(np.int32)).to(cuda)
        u = fused_ni.philox_uniforms(seeds, n, *eps, compute_int, normalise)
    before = fused_ni.KERNEL_LAUNCHES["fused_ni"]
    got = fused_ni.fused_ni_sums(seeds, rho, n, *eps, uniforms=u, **kw)
    torch.cuda.synchronize()
    assert fused_ni.KERNEL_LAUNCHES["fused_ni"] == before + 1
    want = fused_ni.fused_ni_plain(seeds, rho, u, n=n, eps1=eps[0],
                                   eps2=eps[1], **kw)
    assert torch.isfinite(got).all()
    assert _within(got, want).float().mean().item() >= 0.99
    if source == "philox":
        inside = fused_ni.fused_ni_sums(seeds, rho, n, *eps, **kw)
        assert torch.equal(inside, got)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_int", [False, True])
def test_in_kernel_generator_is_seeded(cuda, compute_int):
    """In-kernel Philox: finite, a function of the seed words only."""
    seeds = rng.kernel_seeds(rng.rep_keys(rng.master_key(device=cuda), 512))
    a = fused_ni.fused_ni_sums(seeds.contiguous(), 0.5, 10_000, 1.0, 1.0,
                               compute_int=compute_int)
    b = fused_ni.fused_ni_sums(seeds.contiguous(), 0.5, 10_000, 1.0, 1.0,
                               compute_int=compute_int)
    c = fused_ni.fused_ni_sums((seeds + 1).contiguous(), 0.5, 10_000, 1.0,
                               1.0, compute_int=compute_int)
    assert torch.isfinite(a).all() and torch.equal(a, b)
    assert not torch.equal(a[:, 0], c[:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("compute_int", [False, True])
def test_two_blocks_per_sm_on_the_main_path(cuda, compute_int):
    """n = 10⁴: two replications' planes fit in one SM's shared memory,
    and the registers allow two 512-thread blocks."""
    assert fused_ni.blocks_per_sm(10_000, 1.0, 1.0,
                                  compute_int=compute_int) == 2


@pytest.mark.cuda
def test_wrapper_checks_its_inputs(cuda):
    seeds = torch.zeros(4, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        fused_ni.fused_ni_sums(seeds.long(), 0.5, 1024, 1.0, 1.0)
    with pytest.raises(ValueError, match="shape"):
        fused_ni.fused_ni_sums(seeds, 0.5, 1024, 1.0, 1.0,
                               uniforms=torch.zeros(4, 3, 128, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        fused_ni.fused_ni_sums(torch.zeros(2, 4, dtype=torch.int32,
                                           device=cuda).t(), 0.5, 1024,
                               1.0, 1.0)
    # above the shared-memory cap on the planes the launch takes the
    # variant without them instead of refusing
    before = dict(fused_ni.KERNEL_LAUNCHES)
    out = fused_ni.fused_ni_sums(seeds, 0.5, 40_000, 1.0, 1.0)
    torch.cuda.synchronize()
    assert out.shape == (4, 3) and torch.isfinite(out).all()
    assert fused_ni.KERNEL_LAUNCHES["fused_ni"] == before["fused_ni"] + 1
    assert (fused_ni.KERNEL_LAUNCHES["fused_ni_regen"]
            == before["fused_ni_regen"] + 1)


@pytest.mark.cuda
def test_pipeline_fused_and_unfused_agree(cuda):
    key = rng.master_key(device=cuda)
    stats = []
    for body in (sim.ni_rep_fn(10_000, 0.5, 1.0, 1.0),
                 sim.fused_ni_rep_fn(10_000, 0.5, 1.0, 1.0)):
        pipe = sim.RepBlockPipeline(body, 3, key=key, block_reps=8192,
                                    chunk_size=2048)
        (mse, cover, ci_len), n_reps = pipe.run(1)
        assert pipe.fetches == 1
        assert 0.90 <= cover / n_reps <= 0.99
        stats.append((mse / n_reps, ci_len / n_reps))
    assert abs(stats[1][0] / stats[0][0] - 1) < 0.1
    assert abs(stats[1][1] / stats[0][1] - 1) < 0.05


SUBG = dict(n=4000, rho=0.5, eps1=1.0, eps2=1.0, dgp="bounded_factor",
            use_subg=True)
#: _one_rep bodies held card against CPU, 256 replications each
PARITY = {
    "subg-grid": SUBG,
    "subg-real": dict(SUBG, subg_variant="real"),
    "stream-subg": dict(SUBG, n=40_000, stream_n_chunk=8192),
}


@pytest.mark.cuda
@pytest.mark.parametrize("n,seed", [(4000, 1), (10_000, 98)])
def test_permutation_and_bounded_factor_card_equals_cpu(cuda, n, seed):
    """Integer-exact draws: the card gives the CPU's bits (seed 98 has
    two equal sort keys at n = 10⁴, where the sort's stability decides)."""
    keys = rng.rep_keys(rng.master_key(seed), 64)
    assert torch.equal(rng.permutation(keys.to(cuda), n).cpu(),
                       rng.permutation(keys, n))
    assert torch.equal(gen_bounded_factor(keys.to(cuda), n, 0.5).cpu(),
                       gen_bounded_factor(keys, n, 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PARITY))
def test_one_rep_card_agrees_with_cpu(cuda, name):
    """Every detail field within 1e-5 (the squared errors also 1e-6
    relative) for at least 99% of 256 replications."""
    cfg = sim.SimConfig(**PARITY[name], b=256)
    keys = rng.rep_keys(rng.master_key(), 256)
    card = sim._one_rep(keys.to(cuda), cfg.rho, cfg)
    cpu = sim._one_rep(keys, cfg.rho, cfg)
    ok = torch.ones(256, dtype=torch.bool)
    for field, a, b in zip(sim.DETAIL_FIELDS, card, cpu, strict=True):
        rtol = 1e-6 if field.endswith("se2") else 0.0
        ok &= torch.isclose(a.cpu(), b, rtol=rtol, atol=1e-5)
    assert ok.float().mean().item() >= 0.99


@pytest.mark.cuda
def test_subg_paths_run_on_the_card_by_default(cuda):
    res = sim.run_sim_one(sim.SimConfig(**SUBG, b=4096, chunk_size=2048))
    assert res.detail["ni_hat"].device.type == "cuda"
    assert 0.90 <= res.summary["NI"]["coverage"] <= 0.99
    pipe = sim.RepBlockPipeline(
        lambda k: sim._one_rep(k, 0.5, sim.SimConfig(**SUBG)),
        len(sim.DETAIL_FIELDS), key=rng.master_key(device=cuda),
        block_reps=2048, chunk_size=1024)
    sums, n_reps = pipe.run(2)
    assert pipe.fetches == 1 and n_reps == 4096
    assert 0.90 <= sums[8] / n_reps <= 0.99


#: two (n, ε) buckets of two points each
GRID2 = dict(n_grid=(1000, 2500), rho_grid=(0.0, 0.5),
             eps_pairs=((1.0, 1.0),), b=256, seed=3)


@pytest.mark.cuda
def test_fused_grid_launches_once_per_bucket(cuda, tmp_path):
    """fused="auto" on the card: one kernel launch per bucket, finite
    detail, coverage near the unfused grid's; a rerun loads every point
    from its cache and launches nothing; the unfused grid in the same
    directory loads no fused point and runs them all, and
    ``detail_all.rds`` reads back its table."""
    from dpcorr_torch.io.rds import read_rds_table

    before = fused_ni.KERNEL_LAUNCHES["fused_ni"]
    gc = grid.GridConfig(**GRID2, backend="bucketed", fused="auto",
                         out_dir=str(tmp_path))
    res = grid.run_grid(gc)
    assert fused_ni.KERNEL_LAUNCHES["fused_ni"] == before + 2
    assert res.timings["fused"].all()
    for field in sim.DETAIL_FIELDS:
        assert res.detail_all[field].shape == (4 * 256,)
        assert np.isfinite(res.detail_all[field]).all()
    off = grid.run_grid(grid.GridConfig(**GRID2, backend="bucketed"))
    for meth in ("NI", "INT"):
        rows = res.summ_all["method"] == meth
        assert abs(res.summ_all["coverage"][rows].mean()
                   - off.summ_all["coverage"][rows].mean()) <= 0.05
    again = grid.run_grid(gc)
    assert fused_ni.KERNEL_LAUNCHES["fused_ni"] == before + 2
    assert again.timings["points_run"].sum() == 0
    for col, v in res.detail_all.items():
        np.testing.assert_array_equal(again.detail_all[col], v)
    unfused = grid.run_grid(grid.GridConfig(**GRID2, backend="bucketed",
                                            out_dir=str(tmp_path)))
    assert unfused.timings["points_run"].sum() == 4
    table = read_rds_table(str(tmp_path / "detail_all.rds"))
    assert list(table) == list(unfused.detail_all)
    for col, v in unfused.detail_all.items():
        np.testing.assert_array_equal(table[col].values, v)


@pytest.mark.cuda
def test_witnessed_fused_grid_bit_equal_to_unwatched(cuda):
    """The fused grid under the lock witness (``DPCORR_SYNCWATCH``'s
    wrapper) launches K1 once per bucket as without it, gives the same
    table bit for bit, and the witness saw the run's port locks."""
    from dpcorr_torch.utils import syncwatch

    gc = grid.GridConfig(**GRID2, backend="bucketed", fused="auto")
    want = grid.run_grid(gc)
    before = fused_ni.KERNEL_LAUNCHES["fused_ni"]
    syncwatch.enable()
    try:
        got = grid.run_grid(gc)
        snap = syncwatch.snapshot()
    finally:
        syncwatch.disable()
    assert fused_ni.KERNEL_LAUNCHES["fused_ni"] == before + 2
    assert any(site.startswith("dpcorr_torch/plan/") for site in snap["locks"])
    assert snap["inversions"] == []
    for col, v in want.detail_all.items():
        np.testing.assert_array_equal(got.detail_all[col], v)


@pytest.mark.cuda
def test_unfused_grid_card_agrees_with_cpu(cuda):
    """The unfused bucketed grid launches no kernel, and the card agrees
    with the CPU on the same keys for at least 99% of rows."""
    before = fused_ni.KERNEL_LAUNCHES["fused_ni"]
    card = grid.run_grid(grid.GridConfig(**GRID2, backend="bucketed"))
    assert fused_ni.KERNEL_LAUNCHES["fused_ni"] == before
    cpu = grid.run_grid(grid.GridConfig(**GRID2, backend="bucketed",
                                        device="cpu"))
    ok = np.ones(4 * 256, bool)
    for field in sim.DETAIL_FIELDS:
        rtol = 1e-6 if field.endswith("se2") else 0.0
        ok &= np.isclose(card.detail_all[field], cpu.detail_all[field],
                         rtol=rtol, atol=1e-5)
    assert ok.mean() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("span", [7, 19_433, 65_537, 2**31 - 1])
def test_randint_card_equals_cpu(cuda, span):
    keys = rng.rep_keys(rng.master_key(11), 32)
    assert torch.equal(rng.randint(keys.to(cuda), (4096,), 0, span).cpu(),
                       rng.randint(keys, (4096,), 0, span))


@pytest.fixture(scope="module")
def hrs_panel():
    """The real panel's shape: n = 19,433 in wave 2."""
    return perf_hrs.synthetic_panel(4)


@pytest.mark.cuda
def test_hrs_card_agrees_with_cpu(cuda, hrs_panel):
    """Point estimates within 1e-5 (the λ/geometry block 1e-5 relative,
    k and m equal); sweep and bootstrap rows within 1e-5 for at least 99%
    of rows; the results come back from the card."""
    card = hrs.point_estimates(cols=hrs_panel)
    cpu = hrs.point_estimates(cols=hrs_panel, device="cpu")
    assert card.std.age_z.device.type == "cuda"
    for meth in ("ni", "int_"):
        g, w = getattr(card, meth), getattr(cpu, meth)
        assert list(g) == list(w)
        for f, v in w.items():
            tol = dict(abs=1e-5) if f in ("rho_hat", "ci_low", "ci_high") \
                else dict(rel=1e-5)
            assert g[f] == pytest.approx(v, **tol), (meth, f)
    kw = dict(cols=hrs_panel, eps_grid=[0.25, 2.45], reps=16)
    sweeps = [hrs.eps_sweep(**kw), hrs.eps_sweep(**kw, device="cpu")]
    boots = [hrs.bootstrap(cols=hrs_panel, reps=64),
             hrs.bootstrap(cols=hrs_panel, reps=64, device="cpu")]
    for (a, b), fields in ((sweeps, hrs.SWEEP_FIELDS),
                           (boots, hrs.BOOT_FIELDS)):
        ok = np.ones(len(b.runs[fields[0]]), bool)
        for f in fields:
            ok &= np.isclose(a.runs[f], b.runs[f], rtol=0.0, atol=1e-5)
        assert ok.mean() >= 0.99
    np.testing.assert_array_equal(sweeps[0].runs["eps_corr"],
                                  sweeps[1].runs["eps_corr"])
    assert boots[0].chunk == hrs.boot_chunk_size(64, on_card=True)


ROWS = [{"n": 1000, "rho": r, "eps1": 1.0, "eps2": 1.0} for r in (0.0, 0.5)]


@pytest.mark.cuda
def test_r_seam_fused_bucket_and_backends_on_the_card(cuda):
    """One fused bucket through the R bridge is one K1 launch; the
    unfused backends are bit-equal to each other on the card."""
    from dpcorr_torch import rbridge

    fused_ni.KERNEL_LAUNCHES["fused_ni"] = 0
    fused = rbridge.run_design_rows(ROWS, b=64, backend="bucketed",
                                    fused="auto")
    assert fused_ni.KERNEL_LAUNCHES["fused_ni"] == 1
    assert np.isfinite(fused["ni_hat"]).all()
    local = rbridge.run_design_rows(ROWS, b=64)
    for backend in ("sharded", "bucketed"):
        got = rbridge.run_design_rows(ROWS, b=64, backend=backend)
        for col, v in local.items():
            np.testing.assert_array_equal(got[col], v, err_msg=col)


@pytest.mark.cuda
@pytest.mark.parametrize("distributed", [False, True])
def test_fan_out_workers_launch_k1_on_the_card(cuda, tmp_path, distributed):
    """Two worker processes share the card, independent or as a gloo
    group; their reported K1 launches cover every fused bucket once, one
    rank merges in the group (none of the independent workers), and the
    merge equals run_grid bit for bit."""
    from dpcorr_torch.parallel import run_grid_multihost

    kw = dict(n_grid=(1000, 1500), rho_grid=(0.0, 0.5),
              eps_pairs=((1.0, 1.0),), b=64, backend="bucketed",
              fused="auto")
    want = grid.run_grid(grid.GridConfig(**kw))
    res = run_grid_multihost(grid.GridConfig(**kw, out_dir=str(tmp_path)),
                             n_hosts=2, distributed=distributed)
    assert len(res.hosts) == 2
    assert sum(h["launches"] for h in res.hosts) == 2
    assert sum(h["merged"] for h in res.hosts) == int(distributed)
    for col, v in want.detail_all.items():
        np.testing.assert_array_equal(res.detail_all[col], v, err_msg=col)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [16 * 2000, 16 * 45_234])
def test_native_reader_builds_and_agrees_on_the_cards_host(cuda, tmp_path,
                                                           rows):
    """The native reader against the Python reader on a synthetic panel,
    up to the real one's 723,744 rows: every row read, the same columns,
    metadata, values and NA positions."""
    from dpcorr_torch.io import rds, rds_py

    cols = perf_hrs.synthetic_panel(9, rows)
    path = tmp_path / "panel.rds"
    perf_hrs.write_panel(str(path), cols)
    nat, py = rds.read_native(path), rds_py.read_rds_table(str(path))
    assert list(nat) == list(py)
    assert len(py["wave"].values) == len(nat["wave"].values) == rows
    for name, want in py.items():
        got = nat[name]
        assert (got.kind, got.levels, got.labels, got.label) == \
            (want.kind, want.levels, want.labels, want.label)
        if want.kind == "string":
            assert got.values == want.values
        else:
            np.testing.assert_array_equal(got.values, want.values)


# ---------------------------------------------------------- serving ----
SERVE_FAMILIES = ("ni_sign", "int_sign", "ni_subg", "int_subg")
SERVE_N, SERVE_WIDTHS = 10_000, (1, 2, 5, 64)


@pytest.fixture(scope="module")
def serve_lanes():
    """64 lanes of a ρ = 0.5 Gaussian pair at n = 10⁴, and their keys."""
    g = np.random.default_rng(12)
    z = g.standard_normal((2, 64, SERVE_N), dtype=np.float32)
    ys = (0.5 * z[0] + np.sqrt(0.75) * z[1]).astype(np.float32)
    keys = rng.design_key(rng.master_key(12)[None], torch.arange(64))
    return keys, z[0], ys


def _serve_run(mode, family, b, lanes):
    from dpcorr_torch.models.estimators.registry import serving_entry
    from dpcorr_torch.serve import KernelCache
    from dpcorr_torch.serve.request import KernelKey

    keys, xs, ys = lanes
    cache = KernelCache(shard="off", mode=mode)
    assert cache.device.type == "cuda"
    kk = KernelKey(family, SERVE_N, 1.0, 0.5, 0.05, True)
    got = np.stack(cache.run_batch(kk, keys[:b], xs[:b], ys[:b]), 1)
    single = serving_entry(family, 1.0, 0.5)
    want = np.stack([torch.stack(single(
        keys[i], torch.from_numpy(xs[i]).cuda(),
        torch.from_numpy(ys[i]).cuda())).cpu().numpy() for i in range(b)])
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("b", SERVE_WIDTHS)
@pytest.mark.parametrize("family", SERVE_FAMILIES)
def test_serve_exact_lanes_bit_equal_on_the_card(cuda, serve_lanes,
                                                 family, b):
    """The exact engine on ``cuda``: every lane bit-equal to the direct
    single call on the card."""
    got, want = _serve_run("exact", family, b, serve_lanes)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b", SERVE_WIDTHS)
@pytest.mark.parametrize("family", SERVE_FAMILIES)
def test_serve_vector_lane_contract_on_the_card(cuda, serve_lanes,
                                                family, b):
    """The vector engine's card contract (estimators.registry): within
    1e-5 of the direct call, beyond it on at most 1% of lanes, and the
    same of its lanes at width b against the same lanes at width 64."""
    got, want = _serve_run("vector", family, b, serve_lanes)
    bad = ~np.isclose(got, want, rtol=0.0, atol=1e-5).all(1)
    assert bad.sum() <= 0.01 * b
    wide, _ = _serve_run("vector", family, 64, serve_lanes)
    bad = ~np.isclose(got, wide[:b], rtol=0.0, atol=1e-5).all(1)
    assert bad.sum() <= 0.01 * b


@pytest.mark.cuda
def test_serve_server_defaults_to_the_card(cuda):
    from dpcorr_torch.models.estimators.registry import serving_entry
    from dpcorr_torch.serve import DpcorrServer, EstimateRequest
    from dpcorr_torch.serve import pinned_request_key

    g = np.random.default_rng(5)
    req = EstimateRequest("int_sign", g.standard_normal(500, np.float32),
                          g.standard_normal(500, np.float32), 1.0, 0.5,
                          seed=5)
    srv = DpcorrServer(budget=1e6, max_delay_s=0.001)
    try:
        assert srv.device.type == "cuda"
        resp = srv.estimate(req, timeout=120)
    finally:
        srv.close()
    single = serving_entry("int_sign", 1.0, 0.5)
    want = single(pinned_request_key(rng.master_key(), req, 5),
                  torch.from_numpy(req.x), torch.from_numpy(req.y))
    assert want[0].device.type == "cuda"
    assert (resp.rho_hat, resp.ci_low, resp.ci_high) == \
        tuple(float(v) for v in want)


#: the protocol on the card: the HRS wave-2 width, both ε orders
PROTO_N, PROTO_EPS = 19_433, ((1.0, 0.5), (0.5, 2.0))


@pytest.fixture(scope="module")
def proto_columns():
    g = np.random.default_rng(21)
    z = g.standard_normal((2, PROTO_N), dtype=np.float32)
    return z[0], (0.6 * z[0] + 0.8 * z[1]).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["inproc", "tcp"])
@pytest.mark.parametrize("eps", PROTO_EPS)
@pytest.mark.parametrize("family", SERVE_FAMILIES)
def test_protocol_session_bit_equal_to_serving_entry_on_the_card(
        cuda, proto_columns, family, eps, arm):
    """A two-party session with both parties on the card (replay keys),
    in process or over loopback TCP, is bit-equal to the port's
    monolithic estimator on the card in both roles, and again on a
    repeat."""
    from dpcorr_torch.models.estimators.registry import serving_entry
    from dpcorr_torch.protocol import ProtocolSpec, run_inproc, run_tcp

    x, y = proto_columns
    spec = ProtocolSpec(family=family, n=PROTO_N, eps1=eps[0], eps2=eps[1])
    want = torch.stack(serving_entry(family, *eps)(
        rng.master_key(2025), torch.from_numpy(x).cuda(),
        torch.from_numpy(y).cuda())).cpu().numpy()
    assert want.dtype == np.float32
    run = run_inproc if arm == "inproc" else run_tcp
    for _ in range(2):
        res = run(spec, x, y)
        for role in ("x", "y"):
            r = res[role]
            assert (r.rho_hat, r.ci_low, r.ci_high) == tuple(float(v)
                                                             for v in want)


@pytest.mark.cuda
@pytest.mark.parametrize("family", SERVE_FAMILIES)
def test_finish_batch_exact_bitwise_per_cell_on_the_card(cuda,
                                                         proto_columns,
                                                         family):
    """``finish_batch(engine="exact")`` on the card: every cell bit-equal
    to its own ``finish``; the vector engine within 1e-5."""
    from dpcorr_torch.models.estimators import split_reference as sr

    x, y = proto_columns
    master = rng.master_key(7, device="cuda")
    keys = [rng.party_root(rng.column_root(master, lab), "y")
            for lab in ("a", "b", "c")]
    rels = [sr.party_release(family, rng.column_root(master, lab), "x",
                             col, 1.0, 1.0)
            for lab, col in (("a", x), ("b", y), ("c", -x))]
    cols = [y, x, y]
    got = torch.stack(sr.finish_batch(family, keys, rels, cols, 1.0,
                                      1.0)).cpu().numpy()
    for b in range(3):
        one = torch.stack(sr.finish(family, keys[b], rels[b], cols[b], 1.0,
                                    1.0)).cpu().numpy()
        np.testing.assert_array_equal(got[:, b], one)
    vec = torch.stack(sr.finish_batch(family, keys, rels, cols, 1.0, 1.0,
                                      engine="vector")).cpu().numpy()
    np.testing.assert_allclose(vec, got, atol=1e-5, rtol=0)


# ------------------------------------------------------------ stream ----
STREAM_FAMILIES = ("ni_sign", "ni_subg", "int_sign", "int_subg")


@pytest.fixture(scope="module")
def stream_rows():
    """2¹⁸ rows of a ρ = 0.5 Gaussian pair: four chunks of 65,536."""
    from dpcorr_torch.perf_stream import gaussian_pair

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return gaussian_pair(1 << 18, 2025, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family,normalise",
                         [(f, True) for f in STREAM_FAMILIES]
                         + [("ni_sign", False)])
def test_stream_partitions_byte_equal_on_the_card(cuda, stream_rows,
                                                  family, normalise):
    """Every partition of a 4-chunk window releases the monolith's bytes
    on the card (each chunk computed alone at its fixed shape)."""
    import json

    from dpcorr_torch.stream import sketch

    params = sketch.ReleaseParams(family, 1.0, 0.5, normalise=normalise)
    grid = sketch.grid_for(params, len(stream_rows))
    assert grid.n_chunks == 4
    wkey = sketch.window_key(rng.master_key(2025), "0-2000")
    ref = json.dumps(sketch.release_window(stream_rows, params, wkey,
                                           device=cuda), sort_keys=True)
    class Four:
        device_count = 4

    for shards in ([[0, 2], [1, 3]], [[0], [1, 2, 3]], [[3], [2], [1], [0]],
                   [[1, 3, 0], [2]], sketch.placement_shards(Four(), 4)):
        assert json.dumps(sketch.release_window(
            stream_rows, params, wkey, shards=shards, device=cuda),
            sort_keys=True) == ref, shards


@pytest.mark.cuda
@pytest.mark.parametrize("hit", [1, 2])
@pytest.mark.parametrize("point", ["stream.mid_window", "stream.pre_release",
                                   "stream.post_journal"])
def test_stream_crash_recovery_byte_identical_on_the_card(cuda, tmp_path,
                                                          point, hit):
    """A service on the card crashed at a stream point and resumed from
    its workdir gives the uninterrupted run's feed byte for byte, each
    window charged once."""
    import json

    from dpcorr_torch import chaos
    from dpcorr_torch.stream.service import StreamService
    from dpcorr_torch.stream.windows import WindowSpec

    r = np.random.default_rng(5)
    plan = [(f"b{i}", 0.5 + i, np.round(r.normal(size=(300, 2)), 4).tolist())
            for i in range(8)] + [("hb", 100.0, [])]

    def service(d):
        return StreamService(str(d), WindowSpec(size_s=2.0),
                             STREAM_FAMILIES, 0.4, 0.4, fsync=False,
                             device=cuda)

    def feed(sv):
        for bid, ts, rows in plan:
            sv.ingest(bid, ts, rows)
        return json.dumps(sv.releases(), sort_keys=True), {
            p: v["spent"] for p, v in sv.ledger.snapshot()["parties"].items()}

    ref = service(tmp_path / "ref")
    want, spent = feed(ref)
    ref.close()
    chaos.install(chaos.ChaosPlan(point, hit=hit, mode="raise"))
    try:
        with pytest.raises(chaos.SimulatedCrash):
            feed(service(tmp_path / "crash"))
    finally:
        chaos.clear()
    again = service(tmp_path / "crash")
    got, got_spent = feed(again)
    again.close()
    assert got == want
    assert got_spent == pytest.approx(spent)


@pytest.mark.cuda
def test_fleet_of_lease_mode_servers_bit_equal_on_the_card(cuda, tmp_path):
    """Two lease-mode servers on the card share one budget directory
    behind a front end: every answer equals the direct call on the card
    bit for bit, and the directory's balances equal the charges."""
    import threading

    from dpcorr_torch.models.estimators.registry import serving_entry
    from dpcorr_torch.obs.budget_replay import read_user_balances
    from dpcorr_torch.serve import (
        DpcorrServer,
        EstimateRequest,
        HttpEstimateClient,
        RetryingClient,
        make_http_server,
        pinned_request_key,
        request_charges,
    )
    from dpcorr_torch.serve.fleet import (
        FleetFrontend,
        make_frontend_http_server,
    )

    servers, httpds, urls = [], [], {}
    for name in ("rep-a", "rep-b"):
        srv = DpcorrServer(budget=1e9, max_delay_s=0.001,
                           user_dir=str(tmp_path / "budget"),
                           user_budget=1e9, user_shards=4,
                           instance=name, lease_dir=str(tmp_path / "l"),
                           lease_target=2)
        httpd = make_http_server(srv, port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        servers.append(srv)
        httpds.append(httpd)
        urls[name] = f"http://127.0.0.1:{httpd.server_address[1]}"
    fe_httpd = make_frontend_http_server(
        FleetFrontend(urls, lease_dir=str(tmp_path / "l")))
    threading.Thread(target=fe_httpd.serve_forever, daemon=True).start()
    cli = RetryingClient(HttpEstimateClient(
        f"http://127.0.0.1:{fe_httpd.server_address[1]}", timeout_s=120))
    g = np.random.default_rng(11)
    reqs = [EstimateRequest("ni_sign", *g.standard_normal((2, 2000),
                                                          np.float32),
                            1.0, 0.5, user=f"u{i % 6}", seed=40 + i)
            for i in range(12)]
    try:
        got = [cli.estimate(r, timeout=120) for r in reqs]
    finally:
        fe_httpd.shutdown()
        for h, s in zip(httpds, servers):
            h.shutdown()
            s.close()
    single = serving_entry("ni_sign", 1.0, 0.5)
    for r, resp in zip(reqs, got):
        want = single(pinned_request_key(rng.master_key(), r, r.seed),
                      torch.from_numpy(r.x), torch.from_numpy(r.y))
        assert (resp.rho_hat, resp.ci_low, resp.ci_high) == \
            tuple(float(v) for v in want)
    per = sum(request_charges(reqs[0]).values())
    assert {u: b["l"] for u, b in read_user_balances(
        str(tmp_path / "budget")).items()} == {f"u{i}": 2 * per
                                               for i in range(6)}


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["unfused", "fused"])
def test_mesh_pipeline_bit_equal_to_local_on_the_card(cuda, body):
    """The plan layer's mesh placement over the one card runs the local
    run's chunks: per-rep outputs and sums bit-equal, one fetch and one
    donated block a block each, K1 launched blocks x chunks times on the
    fused body."""
    fn = (sim.fused_ni_rep_fn if body == "fused" else sim.ni_rep_fn)(
        10_000, 0.5, 1.0, 1.0)
    key = rng.master_key(device=cuda)
    runs = {}
    for placement in ("local", "mesh"):
        pipe = sim.RepBlockPipeline(fn, 3, key=key, block_reps=4096,
                                    chunk_size=2048, placement=placement)
        fused_ni.KERNEL_LAUNCHES["fused_ni"] = 0
        (sums, _), moved = _transfers(lambda: pipe.run(2))
        launches = fused_ni.KERNEL_LAUNCHES["fused_ni"]
        assert launches == (4 if body == "fused" else 0)
        assert pipe.fetches == 1
        assert (moved["fetches"], moved["donated_blocks"]) == (1, 2)
        runs[placement] = (sums, [t.cpu() for t in pipe.block_detail(1)])
    assert runs["local"][0] == runs["mesh"][0]
    for a, b in zip(runs["local"][1], runs["mesh"][1]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["ni_sign", "int_sign", "ni_subg",
                                    "int_subg"])
def test_kernel_cache_aot_bit_equal_to_lazy_and_direct(cuda, family):
    from dpcorr_torch.models.estimators.registry import serving_entry
    from dpcorr_torch.serve import warmup
    from dpcorr_torch.serve.kernels import KernelCache
    from dpcorr_torch.serve.request import KernelKey

    kkey = KernelKey(family, 10_000, 1.0, 0.5, 0.05, True)
    z = np.random.default_rng(4).standard_normal((2, 5, 10_000)).astype(
        np.float32)
    keys = rng.rep_keys(rng.master_key(4), 5).numpy()
    on = KernelCache(aot=True)
    on.get(kkey, 8, example_args=warmup.example_args(kkey, 8, "exact"))
    got_on = on.run_batch(kkey, keys, z[0], z[1])
    got_off = KernelCache(aot=False).run_batch(kkey, keys, z[0], z[1])
    single = serving_entry(family, 1.0, 0.5)
    direct = torch.stack([torch.stack(single(
        torch.from_numpy(keys[i]).to(cuda), torch.from_numpy(z[0, i]).to(cuda),
        torch.from_numpy(z[1, i]).to(cuda))) for i in range(5)]).cpu()
    for j in range(3):
        assert got_on[j].tobytes() == got_off[j].tobytes()
        assert got_on[j].tobytes() == direct[:, j].numpy().tobytes()


@pytest.mark.cuda
def test_fused_block_graph_replay_bit_equal(cuda):
    """One fused block (key-tree plus K1) captured into a CUDA graph:
    every replay gives the eager call's bits."""
    body = sim.fused_ni_rep_fn(10_000, 0.5, 1.0, 1.0)
    key = rng.master_key(device=cuda)

    def block():
        return body(rng.rep_keys(rng.design_key(key, 0), 4096))

    eager = [t.clone() for t in block()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        block()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = block()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(static, eager, strict=True):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_preshard_counts_copies_and_mismatches_on_the_card(cuda):
    from dpcorr_torch import plan
    from dpcorr_torch.obs import transfer
    from dpcorr_torch.obs.metrics import Registry

    ctr = transfer.TransferCounters(Registry())
    x = torch.arange(8, dtype=torch.float32)
    (on_card,) = plan.preshard((x,), cuda, ctr)
    assert on_card.device.type == "cuda" and torch.equal(on_card.cpu(), x)
    plan.preshard((on_card,), cuda, ctr)  # already there: not counted
    (back,) = plan.preshard((on_card,), "cpu", ctr)
    assert torch.equal(back, x)
    snap = ctr.snapshot()
    assert (snap["device_put"], snap["device_put_bytes"],
            snap["reshard_mismatch"]) == (2, 64, 1)


@pytest.mark.cuda
def test_chunk_width_changes_unfused_bits_on_the_card(cuda):
    """On the card the unfused main path's last bits depend on how many
    replications are resident (a reduction over n runs in another
    order), which is why ``grid._stamp`` keeps the literal chunk width:
    at n = 10⁴ widths 2 and 64 differ from 256 in some field, within
    1e-5 (a 0/1 cover field may flip at a tie, on ≤ 1% of replications).
    K1's per-replication outputs are bit-equal at every ladder chunk."""
    import dataclasses

    from dpcorr_torch.utils import geometry

    cfg = sim.SimConfig(n=10_000, rho=0.5, eps1=1.0, eps2=1.0, b=256)
    runs = [sim.run_sim_one(dataclasses.replace(cfg, chunk_size=w),
                            device=cuda).detail for w in (2, 64, 256)]
    assert any(not torch.equal(other[f], runs[-1][f])
               for other in runs[:-1] for f in sim.DETAIL_FIELDS)
    for other in runs[:-1]:
        for f in sim.DETAIL_FIELDS:
            gap = (other[f] - runs[-1][f]).abs()
            if f.endswith("_cover"):
                assert (gap > 0).float().mean() <= 0.01, f
            else:
                assert gap.max() <= 1e-5, f
    assert grid._stamp(cfg) != grid._stamp(dataclasses.replace(
        cfg, chunk_size=64))
    key = rng.master_key(device=cuda)
    body = sim.fused_ni_rep_fn(10_000, 0.5, 1.0, 1.0)
    blocks = [sim.RepBlockPipeline(body, 3, key=key, block_reps=1 << 14,
                                   chunk_size=c).block_detail(0)
              for c in geometry.LADDERS["cuda-h100"][0]]
    for other in blocks[:-1]:
        for a, b in zip(other, blocks[-1], strict=True):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_profiled_pipeline_on_the_card(cuda, tmp_path):
    """A profiler syncs the card at its cadence: sums bit-equal to the
    unprofiled run, one fetch, syncs bounded and apart from fetches."""
    from dpcorr_torch.obs import prof, transfer
    from dpcorr_torch.obs.metrics import Registry

    key = rng.master_key(device=cuda)
    body = sim.fused_ni_rep_fn(10_000, 0.5, 1.0, 1.0)
    counters = transfer.TransferCounters(Registry())
    profiler = prof.BlockProfiler(max_syncs=4, registry=Registry(),
                                  artifact_path=str(tmp_path / "p.json"))
    pipes = [sim.RepBlockPipeline(body, 3, key=key, block_reps=4096,
                                  chunk_size=4096, counters=counters,
                                  profiler=p) for p in (None, profiler)]
    plain = pipes[0].run(9)
    before = counters.snapshot()
    assert pipes[1].run(9) == plain
    assert transfer.diff(counters.snapshot(), before)["fetches"] == 1
    (run,) = prof.read_profile(str(tmp_path / "p.json"))["runs"]
    assert run["cadence"] == 2 and run["sync_count"] == 4
    assert run["transfer"]["fetches"] == 1 and run["n_blocks"] == 9
    assert int(profiler.syncs_total.value()) == 4
    assert all(s["seconds"] > 0 for s in run["samples"])


@pytest.mark.cuda
def test_devicemon_series_on_the_card(cuda):
    from dpcorr_torch.obs import devicemon
    from dpcorr_torch.obs.metrics import Registry, parse_exposition

    x = torch.ones(1 << 20, device=cuda)
    reg = Registry()
    mon = devicemon.DeviceMonitor(registry=reg)
    snap = mon.sample()
    assert sorted(snap) == [f"cuda:{i}"
                            for i in range(torch.cuda.device_count())]
    st = snap["cuda:0"]
    assert x.numel() * 4 <= st["bytes_in_use"] <= st["peak_bytes_in_use"]
    assert st["bytes_limit"] == torch.cuda.get_device_properties(
        0).total_memory
    series = parse_exposition(reg.render())
    assert series['dpcorr_device_mem_limit_bytes{device="cuda:0"}'] == \
        st["bytes_limit"]
    assert not any("live_buffer" in k for k in series)


#: (n, ε, compute_int) above the shared-memory cap on the planes, where
#: the kernel's variant without them runs: just above the cap (NI and
#: INT), n = 40,000 and 10⁵ at m' = 8, and 10⁵ at m = m' = 128
ABOVE_CAP = [(28_673, (1.0, 1.0), False), (25_601, (1.0, 1.0), True),
             (40_000, (1.0, 1.0), False), (40_000, (1.0, 1.0), True),
             (100_000, (1.0, 1.0), False), (100_000, (0.25, 0.25), True)]


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["external", "philox"])
@pytest.mark.parametrize("n,eps,compute_int", ABOVE_CAP)
@pytest.mark.parametrize("normalise", [True, False])
@pytest.mark.parametrize("gauss", ["boxmuller", "ndtri"])
def test_kernel_above_cap_matches_plain(cuda, gauss, normalise, n, eps,
                                        compute_int, source):
    """The variant without planes against the plain version, as
    ``test_kernel_matches_plain`` holds the variant with them: ≥ 99% of
    replications within 1e-4 relative (ΣT_j, ΣT_j²) and 1e-5 (η̂_INT), and
    in-kernel mode bit-equal to external mode on ``philox_uniforms``, at
    the same b = 128 (at n = 10⁵ one replication's uniforms take 1.6-2
    MB). ΣT_j can lie near 0, where 1e-4 relative is below an ulp of the
    partial sums: the 1% share absorbs such replications, as it does
    there."""
    c = fused_ni._Consts(n, *eps, (0.0, 0.0), (1.0, 1.0))
    assert not c.planes_kept(compute_int)
    b = 128
    rho = torch.linspace(-0.6, 0.9, b, device=cuda)
    kw = dict(normalise=normalise, compute_int=compute_int, gauss=gauss)
    if source == "external":
        seeds = torch.zeros(b, 2, dtype=torch.int32, device=cuda)
        u = _uniforms(9, b, n, eps, compute_int, cuda)
    else:
        seeds = torch.from_numpy(np.random.default_rng(10).integers(
            -2**31, 2**31, (b, 2), dtype=np.int64).astype(np.int32)).to(cuda)
        u = fused_ni.philox_uniforms(seeds, n, *eps, compute_int, normalise)
    before = dict(fused_ni.KERNEL_LAUNCHES)
    got = fused_ni.fused_ni_sums(seeds, rho, n, *eps, uniforms=u, **kw)
    torch.cuda.synchronize()
    assert fused_ni.KERNEL_LAUNCHES["fused_ni_regen"] == (
        before["fused_ni_regen"] + 1)
    want = fused_ni.fused_ni_plain(seeds, rho, u, n=n, eps1=eps[0],
                                   eps2=eps[1], **kw)
    assert torch.isfinite(got).all()
    assert _within(got, want).float().mean().item() >= 0.99
    if source == "philox":
        inside = fused_ni.fused_ni_sums(seeds, rho, n, *eps, **kw)
        assert torch.equal(inside, got)


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["external", "philox"])
@pytest.mark.parametrize("n,eps", GEOMETRIES)
@pytest.mark.parametrize("compute_int", [False, True])
@pytest.mark.parametrize("normalise", [True, False])
@pytest.mark.parametrize("gauss", ["boxmuller", "ndtri"])
def test_forced_variant_is_bit_equal(cuda, gauss, normalise, compute_int, n,
                                     eps, source):
    """Where the planes fit, the variant without them (forced) gives the
    same bits as the one with them: the same draws, the same pinned
    arithmetic, the same sums in the same order, at every layout."""
    b = 128
    rho = torch.linspace(-0.6, 0.9, b, device=cuda)
    kw = dict(normalise=normalise, compute_int=compute_int, gauss=gauss)
    seeds = torch.from_numpy(np.random.default_rng(11).integers(
        -2**31, 2**31, (b, 2), dtype=np.int64).astype(np.int32)).to(cuda)
    u = (_uniforms(12, b, n, eps, compute_int, cuda)
         if source == "external" else None)
    on_chip = fused_ni.fused_ni_sums(seeds, rho, n, *eps, uniforms=u, **kw)
    before = fused_ni.KERNEL_LAUNCHES["fused_ni_regen"]
    forced = fused_ni.fused_ni_sums(seeds, rho, n, *eps, uniforms=u, **kw,
                                    _regen=True)
    torch.cuda.synchronize()
    assert fused_ni.KERNEL_LAUNCHES["fused_ni_regen"] == before + 1
    assert torch.isfinite(on_chip).all()
    assert torch.equal(forced, on_chip)


#: (n, ε) of the ladder's layouts: the main path's (m' = 8), n = 1000,
#: m = 11 in m' = 16 with leftovers, m' = 1 and m' = 128 (all with L4-L5's
#: planes kept), and n = 40,000 (m' = 8, L4-L5 without planes)
LADDER_KEPT = [(10_000, (1.0, 1.0)), (1_000, (1.0, 1.0)),
               (9_000, (1.5, 0.5)), (10_000, (4.0, 2.0)),
               (10_000, (0.25, 0.25))]
LADDER_GEOMETRIES = LADDER_KEPT + [(40_000, (1.0, 1.0))]


def _ladder_within(got, want, mag):
    """Per replication within 1e-5 of the sum of the terms' magnitudes
    (f32 sums in another order: at most a few ulps of each term)."""
    return (got - want).abs() <= 1e-5 * mag


@pytest.mark.cuda
@pytest.mark.parametrize("n,eps", LADDER_GEOMETRIES)
@pytest.mark.parametrize("level", ladder.KERNEL_LEVELS)
def test_ladder_kernel_matches_plain(cuda, level, n, eps):
    """External mode on random bits against the plain version: every
    replication within 1e-5 × Σ|terms| at L1-L4; at L5, where a sign at a
    tie under another rounding moves the sum by 1/m, at least 99% (K1's
    rule)."""
    b = 128
    bits = torch.from_numpy(np.random.default_rng(13).integers(
        -2**31, 2**31, (b, ladder.bit_rows(n, *eps), 128),
        dtype=np.int64).astype(np.int32)).to(cuda)
    seeds = torch.zeros(b, 2, dtype=torch.int32, device=cuda)
    before = ladder.KERNEL_LAUNCHES["fused_ni_ladder"]
    got = ladder.ladder_sums(seeds, 0.5, n, *eps, level, bits)
    torch.cuda.synchronize()
    assert ladder.KERNEL_LAUNCHES["fused_ni_ladder"] == before + 1
    want = ladder.ladder_plain(bits, 0.5, n, *eps, level)
    mag = ladder.ladder_plain(bits, 0.5, n, *eps, level, magnitude=True)
    assert torch.isfinite(got).all()
    share = _ladder_within(got, want, mag).float().mean().item()
    assert share >= (0.99 if level == 5 else 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,eps", LADDER_GEOMETRIES)
@pytest.mark.parametrize("level", ladder.KERNEL_LEVELS)
def test_ladder_in_kernel_equals_external_on_philox_bits(cuda, level, n,
                                                         eps):
    b = 128
    seeds = torch.from_numpy(np.random.default_rng(14).integers(
        -2**31, 2**31, (b, 2), dtype=np.int64).astype(np.int32)).to(cuda)
    inside = ladder.ladder_sums(seeds, 0.5, n, *eps, level)
    outside = ladder.ladder_sums(seeds, 0.5, n, *eps, level,
                                 ladder.philox_bits(seeds, n, *eps))
    torch.cuda.synchronize()
    assert torch.isfinite(inside).all()
    assert torch.equal(inside, outside)


@pytest.mark.cuda
@pytest.mark.parametrize("n,eps", LADDER_KEPT)
@pytest.mark.parametrize("level", (4, 5))
@pytest.mark.parametrize("external", (False, True))
def test_ladder_forced_variant_without_planes_bit_equal(cuda, level, n, eps,
                                                        external):
    """Where L4-L5's planes fit, the variant that draws each position
    again in the sweep, forced, gives the bits of the one with planes."""
    b = 128
    seeds = torch.from_numpy(np.random.default_rng(15).integers(
        -2**31, 2**31, (b, 2), dtype=np.int64).astype(np.int32)).to(cuda)
    bits = ladder.philox_bits(seeds, n, *eps) if external else None
    assert ladder.planes_kept(n, *eps, level)
    kept = ladder.ladder_sums(seeds, 0.5, n, *eps, level, bits)
    forced = ladder.ladder_sums(seeds, 0.5, n, *eps, level, bits,
                                _regen=True)
    torch.cuda.synchronize()
    assert torch.isfinite(kept).all()
    assert torch.equal(forced, kept)


@pytest.mark.cuda
@pytest.mark.parametrize("level", ladder.KERNEL_LEVELS)
def test_ladder_runs_past_shared_memory(cuda, level):
    """Above K1's cap every level launches (L4-L5 without planes), as the
    bisect's probes do at ``--n 40000``."""
    seeds = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    assert ladder.planes_kept(40_000, 1.0, 1.0, level) is False
    before = ladder.KERNEL_LAUNCHES["fused_ni_ladder"]
    assert torch.isfinite(ladder.ladder_sums(seeds, 0.5, 40_000, 1.0, 1.0,
                                             level)).all()
    assert ladder.KERNEL_LAUNCHES["fused_ni_ladder"] == before + 1


#: a key whose low counter half is 2⁶⁴ − 2: Philox block 2 carries into
#: the high half
RBG_CARRY = [5, 0xFFFFFFFF, 0xFFFFFFFE, 0xFFFFFFFF]


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys,n_words,offset,stride", [
    (257, 20_000, 0, 1), (257, 13, 0, 1), (257, 4, 9, 1), (257, 40, 0, 10),
    (257, 1, 3, 2), (70_000, 4, 9, 1), (3, 1029, 0, 1)])
def test_rbg_bits_kernel_bit_equal_to_plain(cuda, n_keys, n_words, offset,
                                            stride):
    """XLA's Philox words (``ops/rbg.py``) on the card equal the plain
    version's on the CPU, for random keys and the carry-crossing key, rows
    of every length against the kernel's warps and more keys than the
    grid's y extent."""
    from dpcorr_torch.ops import rbg

    keys = torch.from_numpy(np.random.default_rng(21).integers(
        0, 2**32, (n_keys, 4), dtype=np.int64))
    keys[0] = torch.tensor(RBG_CARRY)
    before = rbg.KERNEL_LAUNCHES["rbg_bits"]
    got = rbg.rbg_bits(keys.to(cuda), n_words, offset, stride)
    torch.cuda.synchronize()
    assert rbg.KERNEL_LAUNCHES["rbg_bits"] == before + 1
    want = rbg.rbg_bits_plain(keys, n_words, offset, stride)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["rbg", "unsafe_rbg"])
def test_rbg_key_tree_and_draws_card_equal_cpu(cuda, impl, monkeypatch):
    """The rbg-family key-tree and draws on the card equal the CPU's (the
    unsafe_rbg tree runs through the kernel), and the unfused body's
    per-rep outputs do not depend on the chunk width."""
    from dpcorr_torch.ops import rbg

    monkeypatch.setenv("DPCORR_PRNG", impl)
    cpu = rng.rep_keys(rng.design_key(rng.master_key(7), 3), 64)
    before = rbg.KERNEL_LAUNCHES["rbg_bits"]
    card = rng.rep_keys(rng.design_key(rng.master_key(7, cuda), 3), 64)
    assert torch.equal(card.cpu(), cpu)
    assert torch.equal(rng.split(card, 3).cpu(), rng.split(cpu, 3))
    assert torch.equal(rng.uniform(rng.stream(card, "dgp"), (1000,)).cpu(),
                       rng.uniform(rng.stream(cpu, "dgp"), (1000,)))
    assert torch.equal(rng.kernel_seeds(card).cpu(), rng.kernel_seeds(cpu))
    assert rbg.KERNEL_LAUNCHES["rbg_bits"] > before
    cfg = sim.SimConfig(n=1000, rho=0.5, eps1=1.0, eps2=1.0, b=64)
    narrow = sim.run_sim_one(dataclasses.replace(cfg, chunk_size=7))
    wide = sim.run_sim_one(dataclasses.replace(cfg, chunk_size=64))
    cpu_run = sim.run_sim_one(cfg, device="cpu")
    ok = np.ones(cfg.b, bool)
    for name in sim.DETAIL_FIELDS:
        assert torch.isfinite(wide.detail[name]).all()
        torch.testing.assert_close(narrow.detail[name], wide.detail[name],
                                   rtol=0, atol=1e-5)
        ok &= np.isclose(wide.detail[name].cpu().numpy(),
                         cpu_run.detail[name].numpy(), rtol=0, atol=1e-5)
    assert ok.mean() >= 0.95  # a centered value at a sign tie moves one


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["rbg", "unsafe_rbg"])
def test_rbg_host_chains_equal_the_cards_fold_in(cuda, impl, monkeypatch):
    """Four-word host chains (2¹⁰ data values folded on the master key,
    serve's pinned and boot keys, the stream's window and chunk keys)
    equal the same chains folded on the card, and their bits too;
    unsafe_rbg's device folds launch the kernel."""
    from dpcorr_torch.ops import rbg
    from dpcorr_torch.serve import EstimateRequest, pinned_request_key
    from dpcorr_torch.serve.server import (
        boot_request_key,
        request_digest_words,
    )
    from dpcorr_torch.stream import sketch

    monkeypatch.setenv("DPCORR_PRNG", impl)
    host = rng.master_key(2025)
    card = host.to(cuda)
    x = np.random.default_rng(4).standard_normal((2, 300)).astype(np.float32)
    req = EstimateRequest("ni_subg", x[0], x[1], 1.0, 0.5, seed=9)
    before = rbg.KERNEL_LAUNCHES["rbg_bits"]
    key = rng.design_key(rng.stream(card, "serve/pinned"), 9)
    for w in request_digest_words(req):
        key = rng.design_key(key, w)
    assert torch.equal(key.cpu(), pinned_request_key(host, req, 9))
    wkey = sketch.window_key(host, "0-2000")
    assert torch.equal(rng.stream(card, "stream/0-2000").cpu(), wkey)
    chunks = rng.chunk_key(wkey.to(cuda), torch.arange(40, device=cuda))
    assert torch.equal(chunks.cpu(), torch.stack(
        [rng.chunk_key(wkey, c) for c in range(40)]))
    assert torch.equal(rng.random_bits(chunks, (512,)).cpu(),
                       rng.random_bits(chunks.cpu(), (512,)))
    data = [0, 1, 2**31 - 1, 2**31, 2**32 - 1] + np.random.default_rng(
        22).integers(0, 2**32, 1019).tolist()
    words = tuple(host.tolist())
    folded = torch.tensor([rng.fold_in_words(words, d) for d in data])
    boot = rng.design_key(rng.design_key(rng.stream(card, "serve/boot"),
                                         12345), 77)
    for on_host, on_card in (
            (folded, rng.design_key(card, torch.tensor(data, device=cuda))),
            (boot_request_key(host, 12345, 77), boot)):
        assert np.array_equal(
            torch.as_tensor(on_host).reshape(-1, 4).numpy(),
            on_card.cpu().numpy().reshape(-1, 4))
    assert rbg.KERNEL_LAUNCHES["rbg_bits"] > before


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["rbg", "unsafe_rbg"])
def test_rbg_paths_on_the_card(cuda, impl, monkeypatch):
    """Serving, the stream, the protocol and HRS on rbg-family keys on the
    card: the exact engine bit-equal to the direct call and the vector
    engine within 1e-5 of it, a stream window's
    partitions byte-equal to its monolith, a replay session bit-equal to
    the direct call, HRS point estimates within 1e-5 of the CPU; each
    launches the rbg kernel and not K1."""
    import json

    from dpcorr_torch.models.estimators.registry import serving_entry
    from dpcorr_torch.ops import rbg
    from dpcorr_torch.protocol import ProtocolSpec, run_inproc
    from dpcorr_torch.serve import (
        DpcorrServer,
        EstimateRequest,
        pinned_request_key,
    )
    from dpcorr_torch.stream import sketch

    monkeypatch.setenv("DPCORR_PRNG", impl)
    rbg.KERNEL_LAUNCHES["rbg_bits"] = 0
    k1 = dict(fused_ni.KERNEL_LAUNCHES)
    xy = np.random.default_rng(5).standard_normal((2, 2000)).astype(
        np.float32)
    for mode in ("exact", "vector"):
        srv = DpcorrServer(budget=1e6, max_delay_s=0.001, batch_mode=mode)
        try:
            for i, fam in enumerate(("ni_sign", "int_subg")):
                req = EstimateRequest(fam, xy[0], xy[1], 1.0, 0.5, seed=i)
                got = srv.estimate(req, timeout=120)
                want = serving_entry(fam, 1.0, 0.5)(
                    pinned_request_key(rng.master_key(srv.seed), req, i),
                    torch.from_numpy(xy[0]), torch.from_numpy(xy[1]))
                got = (got.rho_hat, got.ci_low, got.ci_high)
                want = tuple(float(v) for v in want)
                if mode == "exact":
                    assert got == want
                else:  # the vector engine's card contract
                    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        finally:
            srv.close()
    params = sketch.ReleaseParams("int_sign", 0.4, 0.4, target_chunk=512)
    wkey = sketch.window_key(rng.master_key(2025), "0-2000")
    ref = json.dumps(sketch.release_window(xy.T, params, wkey),
                     sort_keys=True)
    n_chunks = sketch.grid_for(params, 2000).n_chunks
    assert json.dumps(sketch.release_window(
        xy.T, params, wkey, shards=[[c] for c in reversed(range(n_chunks))]),
        sort_keys=True) == ref
    spec = ProtocolSpec(family="ni_subg", n=2000, eps1=1.0, eps2=0.5)
    res = run_inproc(spec, xy[0], xy[1])["x"]
    want = serving_entry("ni_subg", 1.0, 0.5)(
        rng.master_key(2025, cuda), torch.from_numpy(xy[0]),
        torch.from_numpy(xy[1]))
    assert (res.rho_hat, res.ci_low, res.ci_high) \
        == tuple(float(v) for v in want)
    cols = perf_hrs.synthetic_panel(3, 96_000)
    card = hrs.point_estimates(cols=cols)
    cpu = hrs.point_estimates(cols=cols, device="cpu")
    for meth in ("ni", "int_"):
        for f in ("rho_hat", "ci_low", "ci_high"):
            assert abs(getattr(card, meth)[f] - getattr(cpu, meth)[f]) \
                <= 1e-5, (meth, f)
    assert rbg.KERNEL_LAUNCHES["rbg_bits"] > 0
    assert dict(fused_ni.KERNEL_LAUNCHES) == k1


def _threefry_words(shape, seed):
    """Random uint32 words in int64, the first with the top bit set."""
    w = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2**32, shape, dtype=np.int64))
    w.view(-1)[:1] = 0xFFFFFFFF
    return w


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys,n_words", [
    (1, 1), (1, 20_000), (2**14, 20_000), (512, 65_536), (2**14, 7),
    (3, 1029), (257, 13), (70_000, 3), (2, 2**17 + 5)])
def test_threefry_bits_kernel_bit_equal_to_plain(cuda, n_keys, n_words):
    """The bits kernel (``ops/threefry.py``) equals its plain version for
    one key, 2¹⁴ (the unfused block's draw) and 512 × 65,536 (a chunk draw
    of the stress study), rows that do not divide
    a thread's words or a block's, more keys than the grid's y extent,
    and keys with the top bit set (the plain version runs on the card at
    the unfused shape, on the CPU otherwise)."""
    from dpcorr_torch.ops import threefry

    keys = _threefry_words((n_keys, 2), n_keys + n_words)
    keys[-1] = torch.tensor([0x80000000, 0xFFFFFFFF])
    before = threefry.KERNEL_LAUNCHES["threefry_bits"]
    got = threefry.threefry_bits(keys.to(cuda), n_words)
    torch.cuda.synchronize()
    assert threefry.KERNEL_LAUNCHES["threefry_bits"] == before + 1
    big = n_keys * n_words > 2**26
    want = threefry.threefry_bits_plain(keys.to(cuda) if big else keys,
                                        n_words)
    assert torch.equal(got, want.to(cuda))


#: the (minval, maxval) pairs the port draws uniforms with (as in
#: tests/test_torch_rng.py): (0, 1), (−1, 1), (nextafter(−1, 0), 1)
UNIFORM_BOUNDS = [(0.0, 1.0), (-1.0, 1.0),
                  (float(np.nextafter(np.float32(-1), np.float32(0))), 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("bounds", UNIFORM_BOUNDS, ids=str)
@pytest.mark.parametrize("n_keys,n_words", [
    (512, 65_536), (2**14, 20_000), (1, 1), (3, 1029), (257, 13),
    (70_000, 3), (2, 2**17 + 5)])
def test_threefry_uniform_kernel_bit_equal_to_plain(cuda, bounds, n_keys,
                                                    n_words):
    """The uniform kernel equals its plain version bit for bit at the
    stress cell's chunk draw (512 × 65,536), the unfused block's draw
    (2¹⁴ × 2·10⁴), rows that do not divide a thread's words or a
    block's, and more keys than the grid's y extent, one launch a call
    (the plain version runs on the card at the large shapes)."""
    from dpcorr_torch.ops import threefry

    keys = _threefry_words((n_keys, 2), n_keys + n_words)
    keys[-1] = torch.tensor([0x80000000, 0xFFFFFFFF])
    before = threefry.KERNEL_LAUNCHES["threefry_uniform"]
    got = threefry.threefry_uniform(keys.to(cuda), n_words, *bounds)
    torch.cuda.synchronize()
    assert threefry.KERNEL_LAUNCHES["threefry_uniform"] == before + 1
    assert got.dtype == torch.float32
    big = n_keys * n_words > 2**26
    want = threefry.threefry_uniform_plain(keys.to(cuda) if big else keys,
                                           n_words, *bounds)
    assert torch.equal(got.view(torch.int32), want.to(cuda).view(
        torch.int32))


@pytest.mark.cuda
def test_uniform_and_its_samplers_on_the_card_equal_the_cpu(cuda):
    """``uniform``, ``bernoulli``, ``laplace`` and ``normal`` on threefry
    keys on the card, each through one uniform launch, against the CPU on
    the same keys: the uniforms and the decisions bit for bit; ``laplace``
    and ``normal`` with the same signs and within ``normal``'s tolerance
    against JAX (tests/test_torch_rng.py), since the card's ``log1p``
    and ``erfinv`` may round their last bits otherwise than the CPU's."""
    from dpcorr_torch.ops import threefry
    from dpcorr_torch.ops.noise import laplace

    cpu = rng.rep_keys(rng.design_key(rng.master_key(13), 2**31 + 9), 300)
    card = cpu.to(cuda)
    draws = {
        "uniform": lambda k: rng.uniform(rng.stream(k, "dgp"), (3, 501),
                                         -1.0, 1.0),
        "bernoulli": lambda k: rng.bernoulli(rng.stream(k, "flips"),
                                             0.7310586, (1001,)),
        "laplace": lambda k: laplace(rng.stream(k, "noise"), (777,), 0.7),
        "normal": lambda k: rng.normal(rng.stream(k, "z"), (2, 999)),
    }
    for name, draw in draws.items():
        before = threefry.KERNEL_LAUNCHES["threefry_uniform"]
        calls = dict(rng.UNIFORM_CALLS)
        got = draw(card)
        assert threefry.KERNEL_LAUNCHES["threefry_uniform"] == before + 1
        assert rng.UNIFORM_CALLS["kernel"] == calls["kernel"] + 1, name
        assert rng.UNIFORM_CALLS["ops"] == calls["ops"], name
        want = draw(cpu)
        if name in ("uniform", "bernoulli"):
            assert torch.equal(got.cpu(), want), name
        else:
            assert torch.equal(torch.sign(got.cpu()), torch.sign(want))
            torch.testing.assert_close(got.cpu(), want, rtol=2e-5,
                                       atol=1e-6, msg=name)


#: operand shapes (k0, k1, x0, x1) for the hash kernel: fold_in of one
#: key over 2²⁰ indices, a key batch by a host scalar, rep streams of a
#: key batch, rbg halves, counters with x0 ≠ 0 everywhere, a 0-d call
HASH_CASES = [
    ((), (), 0, (2**20,)),
    ((2**14,), (2**14,), 0, 1_234_567),
    ((5, 1), (5, 1), 0, (1000,)),
    ((300, 2), (300, 2), 0, (300, 1)),
    ((7, 1, 3), (7, 1, 3), (1, 9, 1), (9, 3)),
    ((), (), 5, 7),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", HASH_CASES, ids=str)
def test_threefry_hash_kernel_bit_equal_to_plain(cuda, case):
    """The hash kernel equals its plain version on strided key words,
    broadcast counters, constants, words with the top bit set and
    counters whose x0 is not 0."""
    from dpcorr_torch.ops import threefry

    kshape = case[0]
    keys = _threefry_words((*kshape, 2), len(kshape))
    ops = [keys[..., 0], keys[..., 1]]
    for i, s in enumerate(case[2:]):
        ops.append(_threefry_words(s, 10 + i) if isinstance(s, tuple)
                   else s)
    card = [o.to(cuda) if isinstance(o, torch.Tensor) else o for o in ops]
    before = threefry.KERNEL_LAUNCHES["threefry_hash"]
    got = threefry.threefry_hash(*card)
    torch.cuda.synchronize()
    assert threefry.KERNEL_LAUNCHES["threefry_hash"] == before + 1
    assert torch.equal(got.cpu(), threefry.threefry_hash_plain(*ops))


@pytest.mark.cuda
def test_threefry_kernels_zero_sizes_launch_nothing(cuda):
    from dpcorr_torch.ops import threefry

    before = dict(threefry.KERNEL_LAUNCHES)
    keys = torch.zeros(4, 2, dtype=torch.int64, device=cuda)
    assert threefry.threefry_bits(keys, 0).shape == (4, 0)
    assert threefry.threefry_bits(keys[:0], 9).shape == (0, 9)
    assert threefry.threefry_hash(keys[:0, 0], keys[:0, 1], 0,
                                  3).shape == (0, 2)
    assert threefry.threefry_uniform(keys, 0).shape == (4, 0)
    assert threefry.threefry_uniform(keys[:0], 9, -1.0, 1.0).shape == (0, 9)
    assert threefry.KERNEL_LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
def test_threefry_key_tree_card_equals_cpu(cuda, impl, monkeypatch):
    """The key-tree's threefry paths on the card (every one through the
    kernels) equal the CPU's: fold_in, rep_keys_slice, split, random_bits,
    uniform, choice, permutation and kernel_seeds, and on rbg keys the
    threefry fold_in of each half."""
    from dpcorr_torch.ops import threefry

    monkeypatch.setenv("DPCORR_PRNG", impl)
    cpu = rng.design_key(rng.master_key(11), 2**31 + 5)
    card = cpu.to(cuda)
    before = dict(threefry.KERNEL_LAUNCHES)
    pairs = {
        "fold_in": (rng.fold_in(card, 0xFFFFFFFF), rng.fold_in(cpu,
                                                             0xFFFFFFFF)),
        "rep_keys_slice": (rng.rep_keys_slice(card, 2**32 - 40, 64),
                           rng.rep_keys_slice(cpu, 2**32 - 40, 64)),
        "split": (rng.split(card, 5), rng.split(cpu, 5)),
        "kernel_seeds": (rng.kernel_seeds(rng.rep_keys(card, 4096)),
                         rng.kernel_seeds(rng.rep_keys(cpu, 4096))),
    }
    if impl == "threefry2x32":
        keys = (rng.rep_keys(card, 300), rng.rep_keys(cpu, 300))
        pairs.update({
            "random_bits": tuple(rng.random_bits(k, (3, 1001))
                                 for k in keys),
            "uniform": tuple(rng.uniform(rng.stream(k, "dgp"), (500,),
                                         -3.0, 5.5) for k in keys),
            "choice": tuple(rng.choice(k, 19_433, (777,)) for k in keys),
            "permutation": tuple(rng.permutation(k[:8], 5000)
                                 for k in keys),
        })
    for name, (got, want) in pairs.items():
        assert torch.equal(got.cpu(), want), name
    assert threefry.KERNEL_LAUNCHES["threefry_hash"] > before[
        "threefry_hash"]
    for entry in ("threefry_bits", "threefry_uniform"):
        assert (threefry.KERNEL_LAUNCHES[entry]
                > before[entry]) == (impl == "threefry2x32"), entry


# ------------------------------------------------------ the main path ----
#: the north star: n = 10⁴ Gaussian pair, ε = (1, 1), ρ = 0.5, α = 0.05
N, EPS, RHO, ALPHA = 10_000, (1.0, 1.0), 0.5, 0.05
#: replications per kernel launch on the main path, and launches a study
FUSED_BLOCK, FUSED_BLOCKS = 1 << 14, 64
UNFUSED_REPS, DETAIL_REPS, INT_REF_REPS = 1 << 16, 1 << 16, 1 << 13


def _run_pipeline(body, block_reps, chunk, n_blocks, key, out_len=3):
    """A warm run, then ``n_blocks`` blocks: one host read per run. Returns
    the sums and their means."""
    pipe = sim.RepBlockPipeline(body, out_len, key=key, block_reps=block_reps,
                                chunk_size=chunk)
    pipe.run(1, start_block=10_000)
    sums, n_reps = pipe.run(n_blocks)
    assert pipe.fetches == 2
    return list(sums), [s / n_reps for s in sums]


def _unfused_and_fused(key):
    """The unfused pipeline over 2¹⁶ replications and the fused one (K1)
    over 2²⁰: (sums, (mse, coverage, ci_length)) of each."""
    unfused = _run_pipeline(sim.ni_rep_fn(N, RHO, *EPS, ALPHA), 1 << 14,
                            1 << 11, UNFUSED_REPS >> 14, key)
    fused = _run_pipeline(sim.fused_ni_rep_fn(N, RHO, *EPS, ALPHA),
                          FUSED_BLOCK, FUSED_BLOCK, FUSED_BLOCKS, key)
    return unfused, fused


@pytest.mark.cuda
def test_main_path_gates_on_the_card(cuda):
    """The north star on the card: coverage in [0.90, 0.99] on the
    unfused pipeline (2¹⁶), the fused one (2²⁰) and ``sim_detail_fused``
    (NI and INT, 2¹⁶); fused against unfused mse and ci_length within 5%
    and coverage within 0.01; fused INT against the unfused
    ``run_sim_one`` (2¹³): coverage within 0.02, ci_length within 5%, mse
    within 15%. K1, the threefry hash and the uniform entry launch; every
    uniform takes the kernel; rbg_bits and the stage ladder (a
    diagnostic) do not launch."""
    from dpcorr_torch.ops import rbg, threefry

    counts = {"fused_ni": fused_ni.KERNEL_LAUNCHES,
              "ladder": ladder.KERNEL_LAUNCHES, "rbg": rbg.KERNEL_LAUNCHES,
              "threefry": threefry.KERNEL_LAUNCHES,
              "uniform": rng.UNIFORM_CALLS}
    before = {k: dict(v) for k, v in counts.items()}
    key = rng.master_key(device=cuda)
    unfused, fused = _unfused_and_fused(key)
    keys = rng.rep_keys(rng.design_key(key, 777), DETAIL_REPS)
    detail = sim.sim_detail_fused(rng.kernel_seeds(keys).contiguous(), RHO,
                                  N, *EPS, alpha=ALPHA)
    torch.cuda.synchronize()
    delta = {k: {e: v[e] - before[k][e] for e in v}
             for k, v in counts.items()}
    assert delta["threefry"]["threefry_hash"] > 0
    assert delta["threefry"]["threefry_uniform"] > 0
    assert delta["uniform"]["ops"] == 0 and delta["uniform"]["kernel"] > 0
    assert delta["rbg"]["rbg_bits"] == 0
    assert delta["ladder"]["fused_ni_ladder"] == 0
    assert delta["fused_ni"]["fused_ni"] > 0
    d = {}
    for field, col in zip(sim.DETAIL_FIELDS, detail, strict=True):
        assert tuple(col.shape) == (DETAIL_REPS,)
        assert torch.isfinite(col).all(), field
        d[field] = col.double().mean().item()
    (_, (u_mse, u_cov, u_len)), (_, (f_mse, f_cov, f_len)) = unfused, fused
    for cov in (u_cov, f_cov, d["ni_cover"], d["int_cover"]):
        assert 0.90 <= cov <= 0.99
    assert abs(f_mse / u_mse - 1.0) <= 0.05
    assert abs(f_len / u_len - 1.0) <= 0.05
    assert abs(f_cov - u_cov) <= 0.01
    ref = sim.run_sim_one(sim.SimConfig(
        n=N, rho=RHO, eps1=EPS[0], eps2=EPS[1], b=INT_REF_REPS, alpha=ALPHA,
        chunk_size=1 << 11)).summary["INT"]
    assert abs(d["int_cover"] - ref["coverage"]) <= 0.02
    assert abs(d["int_ci_len"] / ref["ci_length"] - 1.0) <= 0.05
    assert abs(d["int_se2"] / ref["mse"] - 1.0) <= 0.15


@pytest.mark.cuda
def test_rbg_north_star_on_the_card(cuda, monkeypatch):
    """The north star on rbg keys: unfused NI and INT (2¹⁶) and fused
    (K1, 2²⁰) coverage in [0.90, 0.99]; the fused sums are not the
    threefry run's (the seeds come from the impl); rbg_bits and K1
    launch."""
    from dpcorr_torch.ops import rbg

    key = rng.master_key(device=cuda)
    tf_sums = _run_pipeline(sim.fused_ni_rep_fn(N, RHO, *EPS, ALPHA),
                            FUSED_BLOCK, FUSED_BLOCK, FUSED_BLOCKS, key)[0]
    monkeypatch.setenv("DPCORR_PRNG", "rbg")
    before = (rbg.KERNEL_LAUNCHES["rbg_bits"],
              fused_ni.KERNEL_LAUNCHES["fused_ni"])
    key = rng.master_key(device=cuda)
    cfg = sim.SimConfig(n=N, rho=RHO, eps1=EPS[0], eps2=EPS[1], alpha=ALPHA)
    _, unfused = _run_pipeline(lambda k: sim._one_rep(k, RHO, cfg), 1 << 14,
                               1 << 11, UNFUSED_REPS >> 14, key,
                               out_len=len(sim.DETAIL_FIELDS))
    sums, fused = _run_pipeline(sim.fused_ni_rep_fn(N, RHO, *EPS, ALPHA),
                                FUSED_BLOCK, FUSED_BLOCK, FUSED_BLOCKS, key)
    means = dict(zip(sim.DETAIL_FIELDS, unfused, strict=True))
    for cov in (means["ni_cover"], means["int_cover"], fused[1]):
        assert 0.90 <= cov <= 0.99
    assert sums != tf_sums
    assert rbg.KERNEL_LAUNCHES["rbg_bits"] > before[0]
    assert fused_ni.KERNEL_LAUNCHES["fused_ni"] > before[1]


#: the JAX package's committed coverage at B ≈ 10⁶ for the sub-Gaussian
#: acceptance points (dpcorr/acceptance.py:109-130), copied so that this
#: file reads nothing of the JAX package: benchmarks/results/
#: acceptance_r02.json, points "subg_factor" det and mc (b = 1,015,808),
#: and benchmarks/results/acceptance_r03_subg_real.json, point
#: "subg_real" det (b = 1,048,576)
_NI_FACTOR = {"coverage": 0.9507869597404234, "mse": 0.33798967205709024,
              "ci_length": 1.4930936636463288}
SUBG_ACCEPTANCE = {
    "subg_factor det": ({}, {
        "NI": _NI_FACTOR,
        "INT": {"coverage": 0.9415470246345766, "mse": 0.02039640261641433,
                "ci_length": 0.5391578020588044}}),
    "subg_factor mc": ({"mixquant_mode": "mc"}, {
        "NI": _NI_FACTOR,
        "INT": {"coverage": 0.9396736391129032, "mse": 0.02039640261641433,
                "ci_length": 0.5365214145952656}}),
    "subg_real det": ({"subg_variant": "real"}, {
        "NI": {"coverage": 0.9502944946289062, "mse": 0.3388798236846924,
               "ci_length": 1.492500677704811},
        "INT": {"coverage": 0.9500713348388672, "mse": 0.04646471468731761,
                "ci_length": 0.8032669238746166}}),
}
#: replications of an acceptance point: |Δ coverage| ≤ 0.003 is set for
#: them (fewer would widen the sampling error past it)
ACCEPTANCE_REPS = 1 << 18
#: replications resident per chunk on the materialized subG path
SUBG_CHUNK = 8192


def _subg_point(extra):
    return sim.run_sim_one(sim.SimConfig(
        **SUBG, **extra, b=ACCEPTANCE_REPS, chunk_size=SUBG_CHUNK)).summary


@pytest.fixture(scope="module")
def subg_factor_det():
    """The ``subg_factor det`` acceptance point's summary on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return _subg_point({})


@pytest.mark.cuda
@pytest.mark.parametrize("label", sorted(SUBG_ACCEPTANCE))
def test_subg_acceptance_point_on_the_card(cuda, request, label):
    """Through ``run_sim_one``, 2¹⁸ replications, against the JAX
    package's committed values at B ≈ 10⁶: |Δ coverage| ≤ 0.003,
    ci_length within 1%, mse within 3%, for NI and INT."""
    extra, ref = SUBG_ACCEPTANCE[label]
    summary = (request.getfixturevalue("subg_factor_det") if not extra
               else _subg_point(extra))
    for meth in ("NI", "INT"):
        got, want = summary[meth], ref[meth]
        assert abs(got["coverage"] - want["coverage"]) <= 0.003, meth
        assert abs(got["ci_length"] / want["ci_length"] - 1.0) <= 0.01, meth
        assert abs(got["mse"] / want["mse"] - 1.0) <= 0.03, meth


@pytest.mark.cuda
def test_subg_pipeline_full_width_on_the_card(cuda):
    """``RepBlockPipeline`` over the subG body at n = 12,000,
    ε = (1.5, 0.5), 2¹⁶ replications: one host read a run, NI coverage
    in [0.90, 0.99]."""
    cfg = sim.SimConfig(n=12_000, rho=0.5, eps1=1.5, eps2=0.5,
                        dgp="bounded_factor", use_subg=True)
    _, means = _run_pipeline(lambda k: sim._one_rep(k, cfg.rho, cfg),
                             1 << 14, SUBG_CHUNK, 4,
                             rng.master_key(device=cuda),
                             len(sim.DETAIL_FIELDS))
    assert 0.90 <= dict(zip(sim.DETAIL_FIELDS, means))["ni_cover"] <= 0.99


@pytest.mark.cuda
def test_streaming_subg_at_n_1e6_against_the_materialized_path(
        cuda, subg_factor_det):
    """The streaming subG pair at n = 10⁶ (``stream_n_chunk`` 65,536),
    2048 replications: finite, NI coverage in [0.90, 0.99]. The INT
    receiver clips its products at λ_r = 30, which biases η̂ by about
    −0.031 at every n ≥ 403 (the JAX package's construction), so at
    n = 10⁶ its CI covers ρ rarely; it is held against the materialized
    point at n = 4000 instead: bias within 0.003, ci_length within 2% of
    that point's scaled by √(4000/n)."""
    cfg = sim.SimConfig(**dict(SUBG, n=10**6, stream_n_chunk=65536), b=2048,
                        chunk_size=sim.stress_chunk_size(2048, True))
    res = sim.run_sim_one(cfg)
    for name in sim.DETAIL_FIELDS:
        assert torch.isfinite(res.detail[name]).all(), name
    assert 0.90 <= res.summary["NI"]["coverage"] <= 0.99
    got, mat = res.summary["INT"], subg_factor_det["INT"]
    assert abs(got["bias"] - mat["bias"]) <= 0.003
    scaled = mat["ci_length"] * math.sqrt(SUBG["n"] / cfg.n)
    assert abs(got["ci_length"] / scaled - 1.0) <= 0.02


# ------------------------------------------------------------- the grid ----
#: the reference's grids at their published sizes, B = 250 a point
#: (vert-cor.R:486-499, ver-cor-subG.R:245)
GRID_B = 250
V1 = grid.GridConfig()
V1_POINTS = len(V1.design_points()["n"])
V1_BUCKETS = [(n, eps) for eps in V1.eps_pairs for n in V1.n_grid]


def _transfers(fn):
    """``fn()`` and the process's transfer counters' delta over it."""
    from dpcorr_torch.obs import transfer

    tc = transfer.default_counters()
    before = tc.snapshot()
    out = fn()
    return out, transfer.diff(tc.snapshot(), before)


def _method_means(res, metric):
    s = res.summ_all
    return {m: float(s[metric][s["method"] == m].mean())
            for m in ("NI", "INT")}


def _same_table(got, want):
    """The same columns in order, bit for bit (NaN where NaN), of the
    same dtypes."""
    assert list(got) == list(want)
    for c, w in want.items():
        g = np.asarray(got[c])
        assert g.dtype == w.dtype, c
        assert np.array_equal(g, w, equal_nan=g.dtype.kind == "f"), c


@pytest.fixture(scope="module")
def v1_fused():
    """The reference's v1 sign grid (144 points × 250), bucketed,
    fused on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return grid.run_grid(grid.GridConfig(b=GRID_B, backend="bucketed",
                                         fused="auto"))


@pytest.mark.cuda
def test_v1_grid_fused_against_unfused_on_the_card(cuda, v1_fused):
    """The v1 grid fused: one K1 launch and one fetch through the plan
    executor per (n, ε) bucket, every bucket fused, 144 × 250 finite rows,
    bit-equal to another fused run; unfused: no K1 launch. Per method the
    grid-wide mean coverage of the two within 0.01 and the mean ci_len
    within 2%."""
    before = fused_ni.KERNEL_LAUNCHES["fused_ni"]
    res, moved = _transfers(lambda: grid.run_grid(grid.GridConfig(
        b=GRID_B, backend="bucketed", fused="auto")))
    assert fused_ni.KERNEL_LAUNCHES["fused_ni"] - before == len(V1_BUCKETS)
    assert moved["fetches"] == len(V1_BUCKETS)
    assert res.timings["fused"].all()
    for f in sim.DETAIL_FIELDS:
        assert res.detail_all[f].shape == (V1_POINTS * GRID_B,)
        assert np.isfinite(res.detail_all[f]).all(), f
        assert res.detail_all[f].tobytes() == v1_fused.detail_all[f].tobytes()
    before = fused_ni.KERNEL_LAUNCHES["fused_ni"]
    off = grid.run_grid(grid.GridConfig(b=GRID_B, backend="bucketed",
                                        fused="off"))
    assert fused_ni.KERNEL_LAUNCHES["fused_ni"] == before
    cov_f, cov_o = _method_means(res, "coverage"), _method_means(off,
                                                                "coverage")
    len_f, len_o = _method_means(res, "ci_len"), _method_means(off, "ci_len")
    for m in ("NI", "INT"):
        assert abs(cov_f[m] - cov_o[m]) <= 0.01, m
        assert abs(len_f[m] / len_o[m] - 1.0) <= 0.02, m


@pytest.mark.cuda
@pytest.mark.parametrize("n,eps", V1_BUCKETS)
def test_kernel_on_each_v1_bucket_matches_plain(cuda, n, eps):
    """K1 at a v1 bucket's launch, on that bucket's inputs (its points'
    seeds and ρ per replication, NI + INT), against the plain version on
    the same words (``philox_uniforms``): finite, ≥ 99% of replications
    within tolerance."""
    points = V1.design_points()
    at = ((points["n"] == n) & (points["eps1"] == eps[0])
          & (points["eps2"] == eps[1]))
    design = rng.design_key(rng.master_key(V1.seed, cuda), torch.as_tensor(
        points["i"][at], dtype=torch.int64, device=cuda))
    seeds = rng.kernel_seeds(rng.rep_keys(design, GRID_B)
                             .reshape(-1, 2)).contiguous()
    rhos = torch.as_tensor(points["rho"][at], dtype=torch.float32,
                           device=cuda).repeat_interleave(GRID_B)
    got = fused_ni.fused_ni_sums(seeds, rhos, n, *eps, compute_int=True)
    want = fused_ni.fused_ni_plain(
        seeds, rhos, fused_ni.philox_uniforms(seeds, n, *eps, True), n=n,
        eps1=eps[0], eps2=eps[1], compute_int=True)
    assert torch.isfinite(got).all()
    assert _within(got, want).float().mean().item() >= 0.99


@pytest.mark.cuda
def test_subg_grid_bucket_merge_on_the_card(cuda):
    """The reference's subG grid (120 points, n = 2500-12,000, B = 250),
    ε-merged and not: per method the mean coverage within 0.01."""
    kw = dict(n_grid=(2500, 4000, 6000, 9000, 12000), dgp="bounded_factor",
              use_subg=True, b=GRID_B, backend="bucketed")
    cov = {merge: _method_means(grid.run_grid(grid.GridConfig(
        **kw, bucket_merge=merge)), "coverage") for merge in ("eps", "off")}
    for m in ("NI", "INT"):
        assert abs(cov["eps"][m] - cov["off"][m]) <= 0.01, m


#: the JAX package's committed coverage at B = 1,015,808 for the sign
#: acceptance points (dpcorr/acceptance.py:89-108), copied from
#: benchmarks/results/acceptance_r02.json
SIGN_ACCEPTANCE = {
    "sign_normal": {"NI": 0.949646980531754, "INT": 0.9497798796622984,
                    "INT mc": 0.9479015719506049},
    "sign_low_eps": {"NI": 0.9485453944052419, "INT": 0.9497326266381049},
    "sign_laplace": {"NI": 0.0, "INT": 1.0},
}


@pytest.mark.cuda
def test_sign_acceptance_points_on_the_card(cuda):
    """The sign acceptance points at 2¹⁸ replications through
    ``run_campaign``, against the JAX package's committed coverage:
    within 0.003, ``sign_laplace`` exactly, and the det-vs-mc criterion
    passes."""
    from dpcorr_torch import acceptance

    points = [p for p in acceptance.POINTS if p.name in SIGN_ACCEPTANCE]
    table = acceptance.run_campaign(b=ACCEPTANCE_REPS, points=points)
    assert sorted(r["point"] for r in table["points"]) == sorted(
        SIGN_ACCEPTANCE)
    for row in table["points"]:
        got = {"NI": row["det"]["NI"]["coverage"],
               "INT": row["det"]["INT"]["coverage"]}
        if "mc" in row:
            got["INT mc"] = row["mc"]["INT"]["coverage"]
        for k, want in SIGN_ACCEPTANCE[row["point"]].items():
            if row["point"] == "sign_laplace":
                assert got[k] == want, (row["point"], k)
            assert abs(got[k] - want) <= 0.003, (row["point"], k)
    assert table["det_mc_pass"]


@pytest.mark.cuda
def test_r_seam_v1_grid_bit_equal_to_run_grid_on_the_card(cuda, v1_fused):
    """``rbridge.run_design_rows`` over the v1 grid's 144 rows, B = 250,
    bucketed, fused: one K1 launch per bucket, the reference's column
    order and dtypes, bit-equal to ``run_grid``'s fused table."""
    from dpcorr_torch import rbridge

    design = V1.design_points()
    rows = [{"n": int(n), "rho": float(r), "eps1": float(e1),
             "eps2": float(e2)} for n, r, e1, e2 in zip(
                 design["n"], design["rho"], design["eps1"], design["eps2"])]
    before = fused_ni.KERNEL_LAUNCHES["fused_ni"]
    detail = rbridge.run_design_rows(rows, b=GRID_B, backend="bucketed",
                                     fused="auto")
    assert fused_ni.KERNEL_LAUNCHES["fused_ni"] - before == len(V1_BUCKETS)
    order = ["repl", *sim.DETAIL_FIELDS, "n", "rho_true", "eps1", "eps2"]
    assert list(detail) == order
    for c in order:
        kind = ("i8" if c in ("repl", "n") else "f8"
                if c in ("rho_true", "eps1", "eps2") else "f4")
        assert detail[c].dtype == np.dtype(kind), c
    _same_table(detail, v1_fused.detail_all)


@pytest.mark.cuda
def test_grid_above_the_cap_on_the_card(cuda):
    """The v1 sign grid cut to one bucket above K1's cap on the planes
    (n = 40,000, ε = (1, 1), 8 ρ × 250): fused, one K1 launch, of the
    variant without planes, where the earlier gate (``fits_on_chip``)
    sent the bucket unfused; unfused, none. Coverage in [0.90, 0.99] per
    method and arm; the arms' mean ρ̂ − ρ within 4 Monte-Carlo standard
    errors."""
    n, eps = 40_000, (1.0, 1.0)
    assert not fused_ni.fits_on_chip(n, *eps, compute_int=True)
    err = {}
    for fused in ("auto", "off"):
        before = dict(fused_ni.KERNEL_LAUNCHES)
        res = grid.run_grid(grid.GridConfig(
            n_grid=(n,), eps_pairs=(eps,), b=GRID_B, backend="bucketed",
            fused=fused))
        moved = {k: v - before[k] for k, v in fused_ni.KERNEL_LAUNCHES.items()}
        assert moved == ({"fused_ni": 1, "fused_ni_regen": 1}
                         if fused == "auto" else
                         {"fused_ni": 0, "fused_ni_regen": 0})
        d = res.detail_all
        for m in ("ni_cover", "int_cover"):
            assert 0.90 <= float(d[m].mean()) <= 0.99, (fused, m)
        err[fused] = d["ni_hat"] - d["rho_true"]
    ef, eo = err["auto"], err["off"]
    se = math.sqrt(ef.var(ddof=1) / len(ef) + eo.var(ddof=1) / len(eo))
    assert abs(ef.mean() - eo.mean()) <= 4 * se


@pytest.mark.cuda
def test_summary_sharded_matches_detail_on_the_card(cuda):
    """``run_summary_sharded`` at the north-star point (2¹⁴ reps) against
    the detail of ``run_detail_sharded`` on the same key: the f32 sums and
    the mean fields within 1e-6 relative, the variance (a difference of
    two sums) within 1e-3."""
    from dpcorr_torch.parallel import backend as sharded

    cfg = sim.SimConfig(n=N, rho=RHO, eps1=EPS[0], eps2=EPS[1], b=1 << 14,
                        alpha=ALPHA, chunk_size=1 << 11)
    key = rng.design_key(rng.master_key(device=cuda), 4242)
    summ = sharded.run_summary_sharded(cfg, key)
    sums = sharded.summary_sums(cfg, key)
    det = sharded.run_detail_sharded(cfg, key)
    want = sim.summarize(det.detail, RHO)
    host = {k: v.cpu().numpy().astype(np.float64)
            for k, v in det.detail.items()}
    for meth in ("ni", "int"):
        est = host[f"{meth}_hat"]
        ref = {"sum_hat": est.sum(), "sum_hat2": (est * est).sum(),
               "sum_se2": host[f"{meth}_se2"].sum(),
               "sum_cover": host[f"{meth}_cover"].sum(),
               "sum_len": host[f"{meth}_ci_len"].sum()}
        for k, v in ref.items():
            assert abs(sums[meth][k] / v - 1.0) <= 1e-6, (meth, k)
        got, w = summ[meth.upper()], want[meth.upper()]
        for k in ("mse", "coverage", "ci_length"):
            assert abs(got[k] / w[k] - 1.0) <= 1e-6, (meth, k)
        assert abs((got["bias"] + RHO) / (w["bias"] + RHO) - 1) <= 1e-6
        assert abs(got["var"] / w["var"] - 1.0) <= 1e-3, meth


# -------------------------------------------------------------- HRS ----
HRS_SWEEP_EPS, HRS_SWEEP_REPS, HRS_BOOT_REPS = 23, 200, 10_000


@pytest.fixture(scope="module")
def hrs_full_panel():
    """A synthetic panel of the real one's shape (723,744 rows, 16 waves,
    19,433 complete cases in wave 2), seed 0."""
    return perf_hrs.synthetic_panel(0)


def _rows_within(got, want, fields, atol=1e-5):
    ok = np.ones(len(want[fields[0]]), dtype=bool)
    for f in fields:
        ok &= np.isclose(got[f], want[f], rtol=0.0, atol=atol)
    return float(ok.mean())


def _hrs_gates(sweep, boot):
    """Per method the mean CI length at the largest ε below that at the
    smallest, and the mean ρ̂ over the three largest ε within 0.05 of the
    non-private ρ; the NI bootstrap's [q025, q975] contains it."""
    runs, rho_np = sweep.runs, sweep.rho_np
    eps = np.asarray(runs["eps_corr"])
    top3 = np.sort(np.unique(eps))[-3:]
    method = np.asarray(runs["method"])
    length = (np.asarray(runs["ci_high"], np.float64)
              - np.asarray(runs["ci_low"], np.float64))
    rho_hat = np.asarray(runs["rho_hat"], np.float64)
    for meth in ("NI", "INT"):
        m = method == meth
        assert (length[m & (eps == eps.max())].mean()
                < length[m & (eps == eps.min())].mean()), meth
        assert abs(rho_hat[m & np.isin(eps, top3)].mean() - rho_np) <= 0.05
    ni = boot.summary["ni"]
    assert ni["q025"] <= rho_np <= ni["q975"]


@pytest.mark.cuda
def test_hrs_sweep_and_bootstrap_gates_on_the_card(cuda, hrs_full_panel,
                                                  tmp_path):
    """The ε-sweep at the reference size (23 ε × 200 replications × 2
    methods, real-data-sims.R:345-346) under a tracer: one
    ``hrs.eps_sweep`` root with 23 ``hrs.dispatch`` and 23 ``hrs.fetch``
    children; the bootstrap at 10,000 replications (BASELINE.md config
    4); every value finite; the statistics gates."""
    from dpcorr_torch.obs import trace as obs_trace

    cols = hrs_full_panel
    spans_path = str(tmp_path / "spans.jsonl")
    obs_trace.configure(spans_path)
    try:
        sweep = hrs.eps_sweep(cols=cols, reps=HRS_SWEEP_REPS)
    finally:
        obs_trace.configure(None)
    spans = obs_trace.read_spans(spans_path)
    assert len(sweep.runs["rho_hat"]) == 2 * HRS_SWEEP_EPS * HRS_SWEEP_REPS
    roots = [sp for sp in spans if sp["name"] == "hrs.eps_sweep"]
    assert len(roots) == 1
    for name in ("hrs.dispatch", "hrs.fetch"):
        assert sum(sp["name"] == name and sp["parent_id"]
                   == roots[0]["span_id"] for sp in spans) == HRS_SWEEP_EPS
    boot = hrs.bootstrap(cols=cols, reps=HRS_BOOT_REPS)
    for res in (sweep.runs, boot.runs):
        for k, v in res.items():
            if k != "method":
                assert np.isfinite(v).all(), k
    _hrs_gates(sweep, boot)


def _point_diff(card_pt, cpu_pt):
    """Largest |card − CPU| on ρ̂ and the CI ends, largest relative gap
    on the λ/geometry block, and whether k and m are equal."""
    ci = aux = 0.0
    geometry = True
    for meth in ("ni", "int_"):
        got, want = getattr(card_pt, meth), getattr(cpu_pt, meth)
        assert set(got) == set(want)
        ci = max(ci, *(abs(got[f] - want[f])
                       for f in ("rho_hat", "ci_low", "ci_high")))
        aux = max(aux, *(abs(got[f] / want[f] - 1.0) for f in want
                         if f not in ("rho_hat", "ci_low", "ci_high")
                         and want[f]), 0.0)
        geometry &= all(got[f] == want[f] for f in ("k", "m") if f in want)
    return ci, aux, geometry


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["rbg", "unsafe_rbg"])
def test_hrs_on_rbg_keys_on_the_card(cuda, hrs_full_panel, impl,
                                     monkeypatch):
    """HRS at the panel's shape on rbg-family keys: the point estimates
    card against CPU (ρ̂ and CI ends within 1e-5, the λ/geometry block
    1e-5 relative, k and m equal); on rbg also the sweep cut to 3 ε ×
    200 × 2 and the bootstrap cut to 1,000, card against CPU on the
    first 8 sweep replications and 16 bootstrap replications (≥ 99% of
    rows within 1e-5) and the statistics gates. rbg_bits launches, K1
    does not."""
    from dpcorr_torch.ops import rbg

    monkeypatch.setenv("DPCORR_PRNG", impl)
    cols = hrs_full_panel
    before = (rbg.KERNEL_LAUNCHES["rbg_bits"], dict(fused_ni.KERNEL_LAUNCHES))
    ci, aux, geometry = _point_diff(hrs.point_estimates(cols=cols),
                                    hrs.point_estimates(cols=cols,
                                                        device="cpu"))
    assert ci <= 1e-5 and aux <= 1e-5 and geometry
    if impl == "rbg":
        eps = (1.25, 2.35, 2.45)
        sweep = hrs.eps_sweep(cols=cols, eps_grid=eps, reps=HRS_SWEEP_REPS)
        boot = hrs.bootstrap(cols=cols, reps=1_000)
        first = sweep.runs["rep"] <= 8
        cpu_sweep = hrs.eps_sweep(cols=cols, eps_grid=eps, reps=8,
                                  device="cpu")
        cpu_boot = hrs.bootstrap(cols=cols, reps=16, device="cpu")
        assert _rows_within({f: v[first] for f, v in sweep.runs.items()},
                            cpu_sweep.runs, hrs.SWEEP_FIELDS) >= 0.99
        assert _rows_within({f: v[:16] for f, v in boot.runs.items()},
                            cpu_boot.runs, hrs.BOOT_FIELDS) >= 0.99
        _hrs_gates(sweep, boot)
    assert rbg.KERNEL_LAUNCHES["rbg_bits"] > before[0]
    assert dict(fused_ni.KERNEL_LAUNCHES) == before[1]


# ------------------------------------------------------- measurement ----
@pytest.mark.cuda
def test_fastnorm_card_agrees_with_cpu(cuda):
    """``fastnorm.gen_gaussian_bm`` at n = 10⁶ on the card: shape
    (n, 2), within 1e-5 of the CPU per element on the same key, sample
    correlation within 0.005 of ρ = 0.5."""
    from dpcorr_torch.ops import fastnorm

    key = rng.stream(rng.master_key(), "fastnorm")
    xy = fastnorm.gen_gaussian_bm(key.to(cuda), 10**6, 0.5)
    cpu = fastnorm.gen_gaussian_bm(key, 10**6, 0.5)
    assert tuple(xy.shape) == (10**6, 2)
    assert (xy.cpu() - cpu).abs().max().item() <= 1e-5
    assert abs(torch.corrcoef(xy.double().T)[0, 1].item() - 0.5) <= 0.005


@pytest.mark.cuda
def test_profiling_trace_names_k1_on_the_card(cuda, tmp_path):
    """A ``profiling.trace`` of one fused block: its CUDA events hold K1's
    kernel once, and the tracer holds one ``profiler.trace`` span. The
    warm block runs under a profiler session of its own: the first
    session on the card can lose its first few dozen activity records."""
    from torch.profiler import ProfilerActivity, profile

    from dpcorr_torch.obs import trace
    from dpcorr_torch.utils import profiling

    pipe = sim.RepBlockPipeline(sim.fused_ni_rep_fn(N, RHO, *EPS, ALPHA), 3,
                                key=rng.master_key(device=cuda),
                                block_reps=FUSED_BLOCK,
                                chunk_size=FUSED_BLOCK)
    with profile(activities=[ProfilerActivity.CUDA]):
        pipe.run(1, start_block=20_000)
        torch.cuda.synchronize()
    spans = str(tmp_path / "spans.jsonl")
    trace.configure(spans)
    try:
        with profiling.trace(str(tmp_path / "trace")):
            pipe.run(1, start_block=20_001)
    finally:
        trace.configure(None)
    events = json.loads((tmp_path / "trace" / profiling.TRACE_FILE)
                        .read_text())["traceEvents"]
    k1 = [e for e in events if e.get("cat") == "kernel"
          and "fused_ni_kernel" in e.get("name", "")]
    assert len(k1) == 1
    assert sum(s["name"] == "profiler.trace"
               for s in trace.read_spans(spans)) == 1


# ---------------------------------------------- serving on the card ----
REPO = Path(__file__).resolve().parents[1]
SERVE_EPS, HRS_N = (1.0, 0.5), 19_433
SERVE_MAX_BATCH, SERVE_MAX_DELAY_S = 64, 0.005


def _repo_env() -> dict:
    """This process's environment with the checkout first on
    ``PYTHONPATH`` and no crash plan, for ``python -m dpcorr_torch``
    processes."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env.pop("DPCORR_CHAOS", None)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _banner_of(proc, deadline_s: float) -> dict:
    """The first stdout line of a ``python -m dpcorr_torch`` process, as
    JSON; fails with its stderr if it ends or misses the deadline."""
    box = []
    t = threading.Thread(target=lambda: box.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(deadline_s)
    if not box or not box[0]:
        proc.kill()
        _, err = proc.communicate(timeout=30)
        pytest.fail(f"no banner within {deadline_s} s: {err[-2000:]}")
    return json.loads(box[0])


def _http_status(url: str) -> tuple:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _post_json(url: str, payload: dict) -> tuple:
    """POST a JSON body; (status, headers, decoded body), errors
    included."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _serve_requests(family, count, n, seed0, **kw):
    """``count`` pinned requests of one family: a ρ = 0.5 Gaussian pair of
    length n each, from numpy seeds ``seed0 + i`` (also each request's
    pinned noise seed)."""
    from dpcorr_torch.serve import EstimateRequest

    out = []
    for i in range(count):
        z = np.random.default_rng(seed0 + i).standard_normal(
            (2, n), dtype=np.float32)
        y = (0.5 * z[0] + math.sqrt(0.75) * z[1]).astype(np.float32)
        out.append(EstimateRequest(family, z[0], y, *SERVE_EPS,
                                   seed=seed0 + i, **kw))
    return out


def _drive(client, reqs, threads):
    """Closed loop: ``threads`` client threads, each sending its share of
    ``reqs`` one after another. Returns the answers as an (N, 3) float64
    array."""
    out = [None] * len(reqs)
    errors = []

    def worker(c):
        try:
            for i in range(c, len(reqs), threads):
                out[i] = client.estimate(reqs[i], timeout=600)
        except BaseException as e:  # re-raised on the driving thread
            errors.append(e)
    ts = [threading.Thread(target=worker, args=(c,)) for c in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=900)
    if errors:
        raise errors[0]
    assert not any(t.is_alive() for t in ts)
    assert all(r is not None for r in out)
    return np.array([[r.rho_hat, r.ci_low, r.ci_high] for r in out])


def _direct_answers(reqs, device):
    """The port's direct single call on each request's pinned key-tree
    address, (N, 3) float64."""
    from dpcorr_torch.models.estimators.registry import serving_entry
    from dpcorr_torch.serve import pinned_request_key

    master = rng.master_key(rng.MASTER_SEED)
    out = []
    for r in reqs:
        single = serving_entry(r.family, r.eps1, r.eps2, device=device)
        out.append(torch.stack(single(
            pinned_request_key(master, r, r.seed), torch.from_numpy(r.x),
            torch.from_numpy(r.y))))
    return torch.stack(out).cpu().double().numpy()


def _ledger_matches(srv, admitted, events):
    """The spend equals Σ ``request_charges`` of the admitted requests,
    and the audit trail replays to the ledger's state."""
    from dpcorr_torch.obs.audit import replay
    from dpcorr_torch.serve import request_charges

    want: dict = {}
    for r in admitted:
        for party, eps in request_charges(r).items():
            want[party] = want.get(party, 0.0) + eps
    spent = {p: v["spent"]
             for p, v in srv.ledger.snapshot()["parties"].items()}
    replayed = {p: v for p, v in replay(events).items() if v or p in spent}
    for p in set(want) | set(spent):
        assert math.isclose(spent.get(p, 0.0), want.get(p, 0.0),
                            rel_tol=1e-12, abs_tol=1e-9), p
        assert replayed.get(p, 0.0) == spent.get(p, 0.0), p


@pytest.mark.cuda
def test_serve_http_front_end_on_the_card(cuda, tmp_path):
    """A card server behind its HTTP front end with a warm set:
    ``/readyz`` 503 until it is resident, then 200; ``/healthz`` 200;
    answers bit-equal to the direct call on the card; an over-budget
    request 403 and charge-free; ``/stats`` and ``/metrics`` agree; the
    spend equals Σ charges and the file trail replays to it. A full queue
    (``max_queue`` 2) answers 429 with the charge refunded, and the
    drained requests are not answered. K1 does not launch."""
    from dpcorr_torch.obs.audit import AuditTrail, read_events
    from dpcorr_torch.obs.metrics import parse_exposition
    from dpcorr_torch.serve import (
        BudgetExceededError,
        DpcorrServer,
        HttpEstimateClient,
        ServerClosedError,
        ServerOverloadedError,
        make_http_server,
    )

    k1 = dict(fused_ni.KERNEL_LAUNCHES)
    reqs = _serve_requests("ni_sign", 8, N, 1_000_000)
    want = _direct_answers(reqs, cuda)
    audit = str(tmp_path / "audit.jsonl")
    srv = DpcorrServer(budget=1e12, ledger_path=str(tmp_path / "led.json"),
                       audit=audit, per_party_budget={"tiny": 1.0},
                       warmup=f"ni_sign:{N}:{SERVE_EPS[0]}:{SERVE_EPS[1]}"
                              f":auto", warmup_autostart=False,
                       max_batch=SERVE_MAX_BATCH,
                       max_delay_s=SERVE_MAX_DELAY_S, device=cuda)
    httpd = make_http_server(srv, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        cold = _http_status(f"{base}/readyz")[0]
        srv.start_warmup()
        assert srv.wait_ready(120)
        assert (cold, _http_status(f"{base}/readyz")[0]) == (503, 200)
        assert _http_status(f"{base}/healthz") == (200, '{"ok": true}')
        client = HttpEstimateClient(base, timeout_s=300.0)
        np.testing.assert_array_equal(_drive(client, reqs, 4), want)
        tiny = _serve_requests("ni_sign", 1, N, 31_000_000,
                               party_x="tiny")[0]
        with pytest.raises(BudgetExceededError):
            client.estimate(tiny)
        assert srv.ledger.spent("tiny") == 0.0
        code, stats_body = _http_status(f"{base}/stats")
        snap = json.loads(stats_body)
        code_m, text = _http_status(f"{base}/metrics")
        series = parse_exposition(text)
        assert (code, code_m) == (200, 200)
        pairs = {
            "dpcorr_serve_requests_total": snap["requests_total"],
            "dpcorr_serve_batches_flushed_total": snap["batches_flushed"],
            "dpcorr_serve_kernel_compiles_total": snap["kernel_compiles"],
            'dpcorr_serve_requests_refused_total{reason="budget"}':
                snap["requests_refused_budget"],
            "dpcorr_serve_latency_seconds_count":
                snap["batched_requests"] + snap["unbatched_requests"],
            'dpcorr_ledger_spent_eps{party="party-x"}':
                snap["ledger"]["parties"]["party-x"]["spent"]}
        for k, v in pairs.items():
            assert series.get(k) == v, k
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    _ledger_matches(srv, reqs, read_events(audit))
    trail = AuditTrail()
    bp = DpcorrServer(budget=1e12, max_batch=1024, max_delay_s=30.0,
                      max_queue=2, audit=trail, device=cuda)
    httpd = make_http_server(bp, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    held = _serve_requests("ni_sign", 3, N, 32_000_000)
    try:
        futs = [bp.submit(r) for r in held[:2]]
        spent = bp.ledger.spent("party-x")
        client = HttpEstimateClient(
            f"http://127.0.0.1:{httpd.server_address[1]}", timeout_s=60.0)
        with pytest.raises(ServerOverloadedError):
            client.estimate(held[2])
        assert bp.ledger.spent("party-x") == spent
    finally:
        httpd.shutdown()
        httpd.server_close()
        bp.close()
    for f in futs:
        with pytest.raises(ServerClosedError):
            f.result(timeout=60)
    _ledger_matches(bp, [], trail.events())
    assert dict(fused_ni.KERNEL_LAUNCHES) == k1


@pytest.mark.cuda
def test_serve_hrs_width_exact_on_the_card(cuda):
    """``ni_sign`` and ``int_sign`` at the HRS wave-2 width (n = 19,433)
    through an exact server on the card: in the 32,768 n-bucket with
    exact-n kernel keys, bit-equal to the direct call; the spend equals
    Σ charges and the trail replays to it."""
    from dpcorr_torch.obs.audit import AuditTrail
    from dpcorr_torch.serve import DpcorrServer, InProcessClient
    from dpcorr_torch.serve.request import bucket_key

    reqs = [r for j, fam in enumerate(("ni_sign", "int_sign"))
            for r in _serve_requests(fam, 4, HRS_N, 7_000_000 + 100_000 * j)]
    assert {bucket_key(r).n_pad for r in reqs} == {32_768}
    trail = AuditTrail()
    srv = DpcorrServer(budget=1e12, max_batch=SERVE_MAX_BATCH,
                       max_delay_s=SERVE_MAX_DELAY_S, audit=trail,
                       device=cuda)
    try:
        got = _drive(InProcessClient(srv), reqs, 8)
        ns = {e["n"] for e in srv.cache.manifest()
              if e["family"] in ("ni_sign", "int_sign")}
        _ledger_matches(srv, reqs, trail.events())
    finally:
        srv.close()
    assert HRS_N in ns
    np.testing.assert_array_equal(got, _direct_answers(reqs, cuda))


@pytest.mark.cuda
def test_serve_card_agrees_with_cpu(cuda):
    """16 requests per family at n = 10⁴ through a CPU server and a card
    server: within 1e-5 on ≥ 99% of them."""
    from dpcorr_torch.serve import DpcorrServer, InProcessClient

    reqs = [r for j, fam in enumerate(SERVE_FAMILIES)
            for r in _serve_requests(fam, 16, N, 40_000_000 + 100_000 * j)]
    out = {}
    for dev in ("cpu", cuda):
        srv = DpcorrServer(budget=1e12, max_batch=SERVE_MAX_BATCH,
                           max_delay_s=SERVE_MAX_DELAY_S, device=dev)
        try:
            out[str(dev)] = _drive(InProcessClient(srv), reqs, 8)
        finally:
            srv.close()
    ok = np.isclose(out[str(cuda)], out["cpu"], rtol=0.0, atol=1e-5).all(1)
    assert ok.mean() >= 0.99


@pytest.mark.cuda
def test_serve_user_directory_on_the_card(cuda, tmp_path):
    """A card server with a budget directory behind its HTTP front end,
    32 pinned requests over 8 users (four each, all four families, dyadic
    ε: each request 1.0 per party and 2.0 for its user, user budget 6.0):
    every answer bit-equal to the direct call, each user's fourth request
    403 at the user level, party and directory spends exact, the audit
    replay equal to both."""
    from dpcorr_torch.obs.audit import read_events, replay_levels
    from dpcorr_torch.obs.budget_replay import read_user_balances
    from dpcorr_torch.serve import (
        BudgetExceededError,
        DpcorrServer,
        HttpEstimateClient,
        make_http_server,
    )

    users = 8
    eps = {"ni_sign": (0.5, 0.5), "int_sign": (0.5, 0.5),
           "ni_subg": (1.0, 1.0), "int_subg": (1.0, 1.0)}
    reqs = []
    for i in range(4 * users):
        fam = SERVE_FAMILIES[i % 4]
        r = _serve_requests(fam, 1, N, 14_000_000 + i)[0]
        reqs.append(dataclasses.replace(r, eps1=eps[fam][0],
                                        eps2=eps[fam][1],
                                        user=f"user{i // 4:02d}"))
    want = _direct_answers(reqs, cuda)
    audit, user_dir = str(tmp_path / "audit.jsonl"), str(tmp_path / "users")
    srv = DpcorrServer(budget=1000.0, audit=audit, user_dir=user_dir,
                       user_budget=6.0, user_shards=8, batch_mode="exact",
                       max_batch=SERVE_MAX_BATCH,
                       max_delay_s=SERVE_MAX_DELAY_S, device=cuda)
    httpd = make_http_server(srv, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    client = HttpEstimateClient(
        f"http://127.0.0.1:{httpd.server_address[1]}", timeout_s=600.0)
    got, refused = {}, []
    try:
        for i, r in enumerate(reqs):
            try:
                a = client.estimate(r)
                got[i] = (a.rho_hat, a.ci_low, a.ci_high)
            except BudgetExceededError as e:
                refused.append((i, e.level))
        spent = {p: v["spent"]
                 for p, v in srv.ledger.snapshot()["parties"].items()}
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    assert sorted(i for i, _ in refused) == [4 * u + 3 for u in range(users)]
    assert {lv for _, lv in refused} == {"user"}
    answered = sorted(got)
    np.testing.assert_array_equal(np.array([got[i] for i in answered]),
                                  want[answered])
    n_ok = len(answered)
    assert spent == {"party-x": float(n_ok), "party-y": float(n_ok)}
    bal = {u: b["l"] for u, b in read_user_balances(user_dir).items()}
    assert bal == {f"user{u:02d}": 6.0 for u in range(users)}
    levels = replay_levels(read_events(audit))
    assert levels["party"] == spent and levels["user"] == bal


# ------------------------------------------------------- the fleet ----
class _FleetCell:
    """Supervised ``python -m dpcorr_torch serve --device cuda`` replicas
    over one leased budget directory, behind a ``FleetFrontend`` on an
    HTTP port of its own, with a background readiness poller."""

    def __init__(self, d: Path, names, shards, lease_ttl_s):
        from dpcorr_torch.serve.fleet import (
            FleetFrontend,
            ReplicaSpec,
            Supervisor,
            make_frontend_http_server,
        )

        self.d, self.names = d, names
        self.lease_dir = str(d / "leases")
        target = -(-shards // len(names))
        specs = [ReplicaSpec(name=nm, argv=[
            sys.executable, "-m", "dpcorr_torch", "serve", "--port", "0",
            "--instance", nm, "--device", "cuda", "--budget", "1e9",
            "--ledger", str(d / f"{nm}_ledger.json"),
            "--audit", str(d / f"{nm}_audit.jsonl"),
            "--user-dir", str(d / "budget"),
            "--user-shards", str(shards), "--user-budget", "1e9",
            "--lease-dir", self.lease_dir,
            "--lease-ttl-s", str(lease_ttl_s),
            "--lease-target", str(target), "--max-batch", "8",
            "--max-delay-ms", "5"], env=_repo_env(),
            stderr_path=str(d / f"{nm}.log")) for nm in names]
        self.fe = FleetFrontend({}, lease_dir=self.lease_dir,
                                cooldown_s=0.5, table_ttl_s=0.25)
        self.sup = Supervisor(specs, banner_deadline_s=240.0,
                              on_up=lambda name, url, banner:
                              self.fe.set_replica(name, url))
        self.httpd = make_frontend_http_server(self.fe)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self._stop = threading.Event()

    def start(self) -> None:
        self.sup.start()
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        deadline = time.monotonic() + 240
        while True:
            ready = self.fe.poll_ready()
            if len(ready) == len(self.names) and all(ready.values()):
                break
            assert time.monotonic() < deadline, f"never ready: {ready}"
            time.sleep(0.1)

        def health():
            while not self._stop.is_set():
                try:
                    self.fe.poll_ready()
                except Exception:  # a replica down mid-poll: poll again
                    pass
                self._stop.wait(0.25)
        threading.Thread(target=health, daemon=True).start()

    def collector(self):
        from dpcorr_torch.obs.fleet import FleetCollector

        return FleetCollector(self.sup.urls())

    def admitted(self) -> dict:
        """Per-replica ``dpcorr_serve_requests_total`` out of the
        collector's merged (instance-labelled) registry."""
        from dpcorr_torch.obs.fleet import families_to_flat

        snap = self.collector().scrape(timeout_s=30)
        assert not snap.errors()
        flat = families_to_flat(snap.merged())
        return {n: flat[f'dpcorr_serve_requests_total{{instance="{n}"}}']
                for n in self.names}

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self.sup.stop()


def _fleet_drive(url, reqs, policy, clients, kill=None):
    """``clients`` threads send ``reqs`` through the front end with a
    ``RetryingClient``; every request must end in a response. ``kill`` =
    (after, fn): ``fn()`` runs once ``after`` requests have succeeded.
    Returns the responses and their completion times."""
    from dpcorr_torch.serve import HttpEstimateClient, RetryingClient

    cli = RetryingClient(HttpEstimateClient(url, timeout_s=120.0), policy)
    out, done_at = [None] * len(reqs), [0.0] * len(reqs)
    errors, lock, fired, done = [], threading.Lock(), threading.Event(), [0]

    def worker(c):
        for i in range(c, len(reqs), clients):
            try:
                out[i] = cli.estimate(reqs[i], timeout=120.0)
            except Exception as e:  # counted and failed below
                errors.append(f"#{i}: {type(e).__name__}: {e}")
                continue
            with lock:
                done_at[i] = time.perf_counter()
                done[0] += 1
                due = (kill is not None and not fired.is_set()
                       and done[0] >= kill[0])
                if due:
                    fired.set()
            if due:
                kill[1]()
    ts = [threading.Thread(target=worker, args=(c,)) for c in range(clients)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    assert not errors and all(r is not None for r in out), errors[:3]
    return out, done_at


@pytest.mark.cuda
def test_fleet_failover_conserves_budget_on_the_card(cuda, tmp_path):
    """Two supervised serve replicas on the card over one leased budget
    directory (16 users, 4 shards, lease TTL 1.5 s) behind a front end:
    client successes equal Σ of the replicas' ``requests_total`` deltas
    in the merged registry; answers bit-equal to the direct call on the
    card. One replica SIGKILLed during the second phase of traffic: every
    request still succeeds, the supervisor restarts it once with the same
    argv, each of its shards is re-leased live at a higher epoch, the
    merged trails' replay, the on-disk user balances and Σ charges agree
    binary-exact, and each survivor's trail replays to its ledger."""
    from dpcorr_torch.obs.audit import read_events
    from dpcorr_torch.obs.budget_replay import fold_levels, read_user_balances
    from dpcorr_torch.obs.fleet import conservation, fleet_replay
    from dpcorr_torch.obs.fleet import ledger_parties
    from dpcorr_torch.serve import RetryPolicy, request_charges
    from dpcorr_torch.serve.fleet import lease_table

    shards, ttl, per_phase, clients = 4, 1.5, 24, 4
    users = [f"user-{u}" for u in range(16)]

    def requests(count, seed0):
        return [dataclasses.replace(r, user=users[i % len(users)])
                for i, r in enumerate(_serve_requests(
                    "ni_sign", count, N, seed0, party_x="fleet-x",
                    party_y="fleet-y"))]
    steady = RetryPolicy(max_attempts=6, base_delay_s=0.05, max_delay_s=1.0,
                         deadline_s=120.0)
    failover = RetryPolicy(max_attempts=40, base_delay_s=0.1,
                           max_delay_s=1.0, deadline_s=240.0)
    warm, b_reqs, c_reqs = (requests(len(users), 700_000),
                            requests(per_phase, 800_000),
                            requests(per_phase, 900_000))
    k1 = dict(fused_ni.KERNEL_LAUNCHES)
    fleet = _FleetCell(tmp_path, ["rep-0", "rep-1"], shards, ttl)
    victim = fleet.names[-1]
    try:
        fleet.start()
        _fleet_drive(fleet.url, warm, steady, clients)
        before = fleet.admitted()
        b_out, _ = _fleet_drive(fleet.url, b_reqs, steady, clients)
        after = fleet.admitted()
        assert sum(after[n] - before[n] for n in fleet.names) == per_phase
        np.testing.assert_array_equal(
            np.array([[r.rho_hat, r.ci_low, r.ci_high] for r in b_out]),
            _direct_answers(b_reqs, cuda))
        table0 = lease_table(fleet.lease_dir)
        victim_shards = sorted(s for s, r in table0.items()
                               if r.get("owner") == victim)
        assert victim_shards
        epochs0 = {s: table0[s]["epoch"] for s in victim_shards}
        _fleet_drive(fleet.url, c_reqs, failover, clients,
                     kill=(per_phase // 3, lambda: fleet.sup.kill(victim)))
        fleet.sup.wait_restarted(victim, 1, timeout_s=240.0)
        time.sleep(2 * ttl)
        table1 = lease_table(fleet.lease_dir)
        now = time.time()
        for s in victim_shards:
            rec = table1.get(s, {})
            assert rec.get("owner") is not None, s
            assert rec["epoch"] > epochs0[s] and rec["expires_at"] > now, s
        launched = fleet.sup.launched[victim]
        assert fleet.sup.restarts.get(victim) == 1
        assert len(launched) == 2 and launched[0] == launched[1]
        stats = fleet.collector().scrape(timeout_s=30).stats()
    finally:
        fleet.stop()
    trails = {n: read_events(str(tmp_path / f"{n}_audit.jsonl"))
              for n in fleet.names}
    merged = sorted((ev for evs in trails.values() for ev in evs),
                    key=lambda ev: ev["ts"])
    replayed = fold_levels(fleet_replay({"fleet": merged})["fleet"])["user"]
    disk = {u: rec["l"]
            for u, rec in read_user_balances(str(tmp_path / "budget")).items()}
    sent: dict = {}
    for r in warm + b_reqs + c_reqs:
        sent[r.user] = sent.get(r.user, 0) + 1
    user_eps = sum(request_charges(c_reqs[0]).values())
    assert replayed == disk == {u: k * user_eps for u, k in sent.items()}

    def party_only(events):
        return [{**ev, "charges": ch} for ev in events
                if (ch := {p: e for p, e in ev["charges"].items()
                           if not p.startswith(("user/", "global/"))})]
    survivors = [n for n in fleet.names if n != victim]
    cons = conservation({n: party_only(trails[n]) for n in survivors},
                        {n: ledger_parties(stats[n]) for n in survivors})
    assert cons["ok"], cons["mismatches"]
    assert dict(fused_ni.KERNEL_LAUNCHES) == k1


@pytest.mark.cuda
def test_chaos_command_on_the_card(cuda, tmp_path):
    """``python -m dpcorr_torch chaos --device cuda`` on one case (the
    ledger killed after it persists, the y role): bit-identical to its
    uninterrupted reference with each role's ε spent once. The other
    crash points' recovery is device-independent and held on the CPU
    (``tests/test_torch_chaos.py``, ``tests/test_torch_budget_dir.py``,
    ``tests/test_torch_federation.py``)."""
    point, role = "ledger.post_persist", "y"
    proc = subprocess.run(
        [sys.executable, "-m", "dpcorr_torch", "chaos", "--device", "cuda",
         "--points", point, "--roles", role, "--n", str(N), "--timeout",
         "1", "--case-timeout", "120", "--workdir", str(tmp_path)],
        cwd=REPO, env=_repo_env(), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, (proc.stdout[-1500:], proc.stderr[-1500:])
    doc = json.loads(proc.stdout)
    assert doc["ok"] and doc["device"] == "cuda", doc
    assert doc["cases"][0]["ok"], doc


# ------------------------------------------- the plan layer processes ----
@pytest.mark.cuda
@pytest.mark.parametrize("aot", ["on", "off"])
def test_serve_process_aot_on_the_card(cuda, tmp_path, aot):
    """``python -m dpcorr_torch serve --aot on | off`` on the card with a
    warm set (``ni_sign`` at n = 10⁴, every batch width to 64): ready,
    answers bit-equal to the direct call, and compile series that match
    the flag (a count above 0 with ``on``; 0 and no recompile with
    ``off``)."""
    from dpcorr_torch.obs.metrics import parse_exposition
    from dpcorr_torch.serve import HttpEstimateClient

    reqs = _serve_requests("ni_sign", 4, N, 50_000_000)
    want = _direct_answers(reqs, cuda)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dpcorr_torch", "serve", "--port", "0",
         "--device", "cuda", "--aot", aot, "--warmup",
         f"ni_sign:{N}:{SERVE_EPS[0]}:{SERVE_EPS[1]}:auto",
         "--budget", "1e12", "--ledger", str(tmp_path / "led.json"),
         "--max-batch", str(SERVE_MAX_BATCH),
         "--max-delay-ms", str(SERVE_MAX_DELAY_S * 1e3)],
        cwd=REPO, env=_repo_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        base = f"http://127.0.0.1:{_banner_of(proc, 240)['serving']['port']}"
        deadline = time.monotonic() + 120
        while _http_status(f"{base}/readyz")[0] != 200:
            assert time.monotonic() < deadline, "never ready"
            time.sleep(0.005)
        client = HttpEstimateClient(base, timeout_s=300.0)
        got = np.array([[a.rho_hat, a.ci_low, a.ci_high]
                        for a in (client.estimate(r) for r in reqs)])
        stats = json.loads(_http_status(f"{base}/stats")[1])
        series = parse_exposition(_http_status(f"{base}/metrics")[1])
    finally:
        proc.terminate()
        proc.communicate(timeout=60)
    np.testing.assert_array_equal(got, want)
    warm = series.get("dpcorr_compile_seconds_count", 0.0)
    assert (aot == "on") == (warm > 0)
    if aot == "off":
        assert not any(stats["recompiles"].values())


# ------------------------------------------ the operator's tools ----
#: ``python -m dpcorr_torch`` in a process that cannot import torch (the
#: operator's tools compute nothing on a device)
_NO_TORCH = ("import sys; sys.modules['torch'] = None; "
             "from dpcorr_torch.__main__ import main; main(sys.argv[1:])")


def _tool_env() -> dict:
    env = _repo_env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _obs_tool(*argv, rc=0):
    """One ``obs`` command in a process that sees no card and cannot
    import torch; fails unless it exits with ``rc``."""
    proc = subprocess.run([sys.executable, "-c", _NO_TORCH, "obs", *argv],
                          cwd=REPO, env=_tool_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == rc, (argv, proc.stdout[-1500:],
                                   proc.stderr[-1500:])
    return proc


def _watch(ck, *sources, rc=0):
    """``obs watch --once --json`` over ``sources`` from checkpoint
    ``ck``; the kinds of the violations it printed."""
    out = _obs_tool("watch", "--checkpoint", ck, *sources, "--once",
                    "--json", rc=rc).stdout
    return {json.loads(line)["violation"]["kind"]
            for line in out.splitlines() if line.startswith('{"violation"')}


def _dup_first_charge(path) -> None:
    with open(path) as fh:
        first = next(ln for ln in fh if '"kind": "charge"' in ln)
    with open(path, "a") as fh:
        fh.write(first)


@pytest.mark.cuda
def test_obs_tools_over_a_serve_process_on_the_card(cuda, tmp_path):
    """One ``serve`` process on the card with ``--audit``, ``--trace``,
    ``--flight-recorder`` and a ledger, 16 requests over ``ni_sign`` and
    ``int_sign``, under the tools (each a process that sees no card and
    cannot import torch): ``obs top --once`` shows ``/stats``'s request
    count and ε spent; ``obs top --fleet`` with a dead second target
    shows it DOWN; ``obs budget`` spends what the ledger holds; ``POST
    /obs/trigger`` slo_page answers 200 and dumps, a bogus reason 400;
    ``obs dump --trace-id`` rebuilds one request's span chain, cost
    record and ε trail; ``obs chrome`` writes one event per span. ``obs
    watch --once`` over the trail and the URL finds nothing; a copy with
    a duplicated charge line is caught and not raised again on a rerun;
    a live ``obs watch`` over a copy catches a duplicated charge and the
    serve dumps ``sentinel_violation``."""
    from dpcorr_torch.obs.trace import read_spans
    from dpcorr_torch.serve import HttpEstimateClient

    files = {k: str(tmp_path / f"serve_{k}")
             for k in ("ledger.json", "audit.jsonl", "trace.jsonl",
                       "dump.json")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dpcorr_torch", "serve", "--port", "0",
         "--device", "cuda", "--instance", "r0", "--budget", "1e12",
         "--ledger", files["ledger.json"], "--audit", files["audit.jsonl"],
         "--trace", files["trace.jsonl"],
         "--flight-recorder", files["dump.json"],
         "--max-batch", str(SERVE_MAX_BATCH),
         "--max-delay-ms", str(SERVE_MAX_DELAY_S * 1e3)],
        cwd=REPO, env=_repo_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        base = f"http://127.0.0.1:{_banner_of(proc, 240)['serving']['port']}"
        reqs = (_serve_requests("ni_sign", 8, N, 60_000_000)
                + _serve_requests("int_sign", 8, N, 61_000_000))
        vals = _drive(HttpEstimateClient(base, timeout_s=300.0), reqs, 8)
        assert vals.shape == (len(reqs), 3) and np.isfinite(vals).all()
        stats = json.loads(_http_status(f"{base}/stats")[1])
        spent = {p: v["spent"] for p, v in stats["ledger"]["parties"].items()}
        assert stats["requests_total"] == len(reqs)
        frame = _obs_tool("top", "--url", base, "--once").stdout
        for want in (f"traffic     : {stats['requests_total']} admitted",
                     f"party-x={spent['party-x']:.4g}/",
                     f"party-y={spent['party-y']:.4g}/"):
            assert want in frame, frame
        dead = f"http://127.0.0.1:{_free_port()}"
        fleet = _obs_tool("top", "--fleet", f"r0={base},r1={dead}",
                          "--once").stdout
        assert "1/2 instances up" in fleet
        assert any(ln.startswith("r1") and "DOWN" in ln
                   for ln in fleet.splitlines()), fleet
        replayed = json.loads(_obs_tool("budget", "--audit",
                                        files["audit.jsonl"],
                                        "--json").stdout)
        assert replayed["spent"] == spent
        code, _h, body = _post_json(f"{base}/obs/trigger", {
            "reason": "slo_page", "detail": {"objective": "card-test"}})
        assert (code, body) == (200, {"dumped": files["dump.json"],
                                      "armed": True})
        assert json.loads(Path(files["dump.json"]).read_text())[
            "reason"] == "slo_page"
        assert _post_json(f"{base}/obs/trigger",
                          {"reason": "bogus"})[0] == 400
        spans = read_spans(files["trace.jsonl"])
        tid = next(sp["trace_id"] for sp in spans
                   if sp["name"] == "serve.request")
        story = json.loads(_obs_tool("dump", files["dump.json"],
                                     "--trace-id", tid, "--json").stdout)
        assert story["spans"] and story["spans"][0]["name"] == "serve.request"
        assert (story["cost"] or {}).get("trace_id") == tid
        assert story["audit"]
        assert story["eps_net"] == story["cost"]["eps_charged"]
        chrome = str(tmp_path / "chrome.json")
        _obs_tool("chrome", "--trace", files["trace.jsonl"], "--out", chrome)
        events = [e for e in json.loads(Path(chrome).read_text())[
            "traceEvents"] if e["ph"] == "X"]
        assert len(events) == len(spans)
        # the sentinel over the live service's files
        assert not _watch(str(tmp_path / "all.ck.json"), "--audit",
                          f"r0={files['audit.jsonl']}", "--url",
                          f"r0={base}")
        copy = str(tmp_path / "dup.jsonl")
        Path(copy).write_text(Path(files["audit.jsonl"]).read_text())
        ck = str(tmp_path / "dup.ck.json")
        _watch(ck, "--audit", f"r0={copy}")
        _dup_first_charge(copy)
        assert "double-charged-artifact" in _watch(ck, "--audit",
                                                   f"r0={copy}", rc=1)
        assert not _watch(ck, "--audit", f"r0={copy}")
        live = str(tmp_path / "live.jsonl")
        Path(live).write_text(Path(files["audit.jsonl"]).read_text())
        live_ck = tmp_path / "live.ck.json"
        watcher = subprocess.Popen(
            [sys.executable, "-c", _NO_TORCH, "obs", "watch",
             "--checkpoint", str(live_ck), "--audit", f"r0={live}",
             "--url", f"r0={base}", "--interval", "0.5", "--json"],
            cwd=REPO, env=_tool_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            _banner_of(watcher, 60)
            deadline = time.monotonic() + 30
            while not live_ck.exists():
                assert time.monotonic() < deadline, "never polled"
                time.sleep(0.01)
            box = []

            def first_violation():
                for line in watcher.stdout:
                    if line.startswith('{"violation"'):
                        box.append(json.loads(line))
                        return
            threading.Thread(target=first_violation, daemon=True).start()
            _dup_first_charge(live)
            deadline = time.monotonic() + 30
            dumped = False
            while not (dumped and box):
                assert time.monotonic() < deadline, (box, dumped)
                dumped = json.loads(Path(files["dump.json"]).read_text())[
                    "reason"] == "sentinel_violation"
                time.sleep(0.005)
        finally:
            watcher.terminate()
            watcher.communicate(timeout=60)
        assert box[0]["violation"]["kind"] in ("double-charged-artifact",
                                               "wal-regression")
    finally:
        proc.terminate()
        proc.communicate(timeout=60)


# ------------------------------------- the protocol and the federation ----
PROTO_SEED = 2025
PROTO_FAULT = {"drop": 0.10, "delay_s": 0.050, "duplicate": 0.05}
FED_PARTIES = [("p0", ["a", "b"]), ("p1", ["c"]), ("p2", ["d"])]


def _session_bits(res) -> tuple:
    """Both roles' (ρ̂, lo, hi), which must agree."""
    bx = (res["x"].rho_hat, res["x"].ci_low, res["x"].ci_high)
    assert bx == (res["y"].rho_hat, res["y"].ci_low, res["y"].ci_high)
    return bx


def _direct_bits(family, eps, x, y, device) -> tuple:
    """The port's monolithic estimator on the session's master key."""
    from dpcorr_torch.models.estimators.registry import serving_entry

    out = serving_entry(family, *eps, device=device)(
        rng.master_key(PROTO_SEED), torch.from_numpy(x), torch.from_numpy(y))
    return tuple(float(v) for v in torch.stack(out).cpu().numpy())


@pytest.mark.cuda
def test_protocol_faulted_tcp_sessions_on_the_card(cuda, proto_columns):
    """Every family at both ε orders over TCP with faults (drop 0.10,
    delay 50 ms, duplicate 0.05, benchmarks/protocol_load.py's, ack
    timeout 0.5 s): bit-equal to the direct call on the card, and the
    faulted channel retransmits."""
    from dpcorr_torch.protocol import ProtocolSpec, run_tcp

    x, y = proto_columns
    retries = 0
    for family in SERVE_FAMILIES:
        for eps in PROTO_EPS:
            res = run_tcp(ProtocolSpec(family=family, n=PROTO_N,
                                       eps1=eps[0], eps2=eps[1]),
                          x, y, fault=PROTO_FAULT, timeout_s=0.5)
            assert _session_bits(res) == _direct_bits(family, eps, x, y,
                                                      cuda), (family, eps)
            retries += sum(r.stats["total_retries"] for r in res.values())
    assert retries > 0


@pytest.mark.cuda
@pytest.mark.parametrize("family", SERVE_FAMILIES)
def test_protocol_hardened_session_on_the_card(cuda, proto_columns, family):
    """``"hardened"`` noise keys give finite results, and a ρ̂ other than
    replay's (a CI end clamped at ±1 may coincide)."""
    from dpcorr_torch.protocol import ProtocolSpec, run_inproc

    x, y = proto_columns
    hard = _session_bits(run_inproc(ProtocolSpec(
        family=family, n=PROTO_N, eps1=1.0, eps2=0.5,
        noise_mode="hardened"), x, y))
    assert np.isfinite(hard).all()
    assert hard[0] != _direct_bits(family, (1.0, 0.5), x, y, cuda)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("eps", PROTO_EPS)
@pytest.mark.parametrize("family", SERVE_FAMILIES)
def test_protocol_session_card_agrees_with_cpu(cuda, proto_columns, family,
                                               eps):
    """A session on the CPU against the same session on the card: within
    1e-5 (subG also 2.5e-7 relative); a sign family may miss only where a
    privately centered value lies within 1e-5 of 0."""
    from dpcorr_torch.models.estimators.ni_sign import l_clip_for
    from dpcorr_torch.ops.standardize import priv_center
    from dpcorr_torch.protocol import ProtocolSpec, run_inproc

    x, y = proto_columns
    spec = ProtocolSpec(family=family, n=PROTO_N, eps1=eps[0], eps2=eps[1])
    card = _session_bits(run_inproc(spec, x, y))
    got = _session_bits(run_inproc(spec, x, y, device="cpu"))
    rtol = 2.5e-7 if family.endswith("subg") else 0.0
    if np.isclose(got, card, rtol=rtol, atol=1e-5).all():
        return
    assert family.endswith("sign"), (got, card)
    key = rng.master_key(PROTO_SEED)
    tie = False
    for role, col, e in (("x", x, eps[0]), ("y", y, eps[1])):
        c = priv_center(rng.stream(key, f"{family}/std_{role}"),
                        torch.from_numpy(col), e, l_clip_for(PROTO_N))
        tie |= bool((c.abs() < 1e-5).any())
    assert tie, (got, card)


def _party_cmd(role, family, eps, port, d: Path):
    return [sys.executable, "-m", "dpcorr_torch", "party", "--role", role,
            "--port", str(port), "--n", str(PROTO_N), "--family", family,
            "--eps1", str(eps[0]), "--eps2", str(eps[1]),
            "--seed", str(PROTO_SEED), "--data", str(d / f"{role}.npy"),
            "--ledger", str(d / f"ledger.{role}.json"),
            "--audit", str(d / f"audit.{role}.jsonl"),
            "--journal", str(d / f"journal.{role}.json"),
            "--transcript", str(d / f"transcript.{role}.jsonl"),
            "--connect-timeout", "180", "--recv-timeout", "180",
            "--timeout", "1.0"]


@pytest.mark.cuda
@pytest.mark.parametrize("family,eps,kill", [
    ("int_sign", (0.5, 2.0), None),
    ("ni_sign", (1.0, 0.5), "point=gate.post_charge,hit=1")])
def test_party_processes_on_the_card(cuda, proto_columns, tmp_path, family,
                                     eps, kill):
    """Two ``python -m dpcorr_torch party`` processes on the card, each
    with its journal, ledger, audit trail and transcript (at ε = (0.5,
    2.0) y sends): both results bit-equal to the direct call on the card,
    every transcript clean and balanced, each role's ε charged once. With
    ``kill``, y dies at ``gate.post_charge`` (``DPCORR_CHAOS``, exit 42)
    and is restarted with the same command line."""
    from dpcorr_torch import chaos
    from dpcorr_torch.obs.audit import read_events
    from dpcorr_torch.protocol import ProtocolSpec
    from dpcorr_torch.protocol.scan import ledger_balance, scan_transcript

    x, y = proto_columns
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "y.npy", y)
    port = _free_port()
    env, procs, cmds = _repo_env(), {}, {}
    for role in ("y", "x"):
        cmds[role] = _party_cmd(role, family, eps, port, tmp_path)
        role_env = dict(env)
        if kill and role == "y":
            role_env["DPCORR_CHAOS"] = kill
        procs[role] = subprocess.Popen(
            cmds[role], cwd=REPO, env=role_env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    if kill:
        _out, err = procs["y"].communicate(timeout=300)
        assert procs["y"].returncode == chaos.EXIT_CODE, err[-2000:]
        procs["y"] = subprocess.Popen(
            cmds["y"], cwd=REPO, env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
    want = _direct_bits(family, eps, x, y, cuda)
    spec = ProtocolSpec(family=family, n=PROTO_N, eps1=eps[0], eps2=eps[1],
                        seed=PROTO_SEED)
    for role, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (role, err[-2000:])
        res = json.loads(out.split("\n", 1)[1])["result"]
        assert (res["rho_hat"], res["ci_low"], res["ci_high"]) == want, role
        path = str(tmp_path / f"transcript.{role}.jsonl")
        rep = scan_transcript(path, raw_x=x, raw_y=y)
        assert rep["ok"], rep["violations"]
        bal = ledger_balance(path, read_events(
            str(tmp_path / f"audit.{role}.jsonl")))
        assert bal["ok"], bal
        spent = json.loads((tmp_path / f"ledger.{role}.json")
                           .read_text())["spent"]
        for party, eps_role in spec.charges_for(role).items():
            assert abs(spent.get(party, 0.0) - eps_role) <= 1e-12, (role,
                                                                  party)


def _fed_data(x, y) -> dict:
    """The federation's four columns: a and b the pair, c and d
    equicorrelated at 0.3 from a numpy generator."""
    z = np.random.default_rng(PROTO_SEED).standard_normal((3, len(x)))
    c = (np.sqrt(0.3) * z[0] + np.sqrt(0.7) * z[1]).astype(np.float32)
    d = (np.sqrt(0.3) * z[0] + np.sqrt(0.7) * z[2]).astype(np.float32)
    return {"a": x, "b": y, "c": c, "d": d}


def _cells(results) -> dict:
    """Every party's cells, which must agree where two hold one."""
    cells: dict = {}
    for res in results.values():
        for key, val in res.cells.items():
            assert cells.setdefault(key, val) == val, key
    return cells


def _cells_equal_two_party_runs(plan, data, cells):
    from dpcorr_torch.protocol import run_inproc

    for i, j in plan.cells():
        ref = run_inproc(plan.cell_spec(i, j), data[plan.label(i)],
                         data[plan.label(j)])["x"]
        got = cells[f"{i},{j}"]
        assert (got["rho_hat"], got["ci_low"], got["ci_high"]) == (
            ref.rho_hat, ref.ci_low, ref.ci_high), (i, j)


@pytest.mark.cuda
@pytest.mark.parametrize("family", SERVE_FAMILIES)
def test_federation_on_the_card(cuda, proto_columns, family):
    """The 3-party, 4-column plan of benchmarks/protocol_load.py --matrix
    in process and over TCP: the same cells, each bit-equal to its
    independent two-party run on the card; ε spent at ``optimal_eps``
    per party, below the naive total; K1 does not launch."""
    from dpcorr_torch.protocol.federation import (
        run_federation_inproc,
        run_federation_tcp,
    )
    from dpcorr_torch.protocol.matrix import FederationPlan
    from dpcorr_torch.serve.ledger import PrivacyLedger

    k1 = dict(fused_ni.KERNEL_LAUNCHES)
    data = _fed_data(*proto_columns)
    plan = FederationPlan(family=family, n=PROTO_N, eps=1.0,
                          parties=FED_PARTIES, seed=PROTO_SEED)
    ledgers = {p: PrivacyLedger(1e6) for p, _ in FED_PARTIES}
    cells = _cells(run_federation_inproc(plan, data, ledgers=ledgers))
    assert _cells(run_federation_tcp(plan, data)) == cells
    _cells_equal_two_party_runs(plan, data, cells)
    spent = {p: led.spent(p) for p, led in ledgers.items()}
    for p, e in plan.party_eps().items():
        assert abs(spent[p] - e) <= 1e-9, p
    assert sum(spent.values()) < plan.naive_eps()
    assert dict(fused_ni.KERNEL_LAUNCHES) == k1


@pytest.mark.cuda
def test_federation_crash_resume_on_the_card(cuda, proto_columns, tmp_path):
    """A raise-mode crash of p0 at ``federation.pre_release`` on the card,
    resumed from its journal: every cell as the uninterrupted run's, each
    party's ε spent once."""
    from dpcorr_torch import chaos
    from dpcorr_torch.protocol import InProcTransport
    from dpcorr_torch.protocol.federation import (
        make_federation_parties,
        run_federation_inproc,
    )
    from dpcorr_torch.protocol.matrix import FederationPlan
    from dpcorr_torch.serve.ledger import PrivacyLedger

    data = _fed_data(*proto_columns)
    plan = FederationPlan(family="ni_sign", n=PROTO_N, eps=1.0,
                          parties=FED_PARTIES, seed=PROTO_SEED)
    ref = _cells(run_federation_inproc(plan, data))

    def ledgers():
        return {p: PrivacyLedger(1e6, path=str(tmp_path / f"led.{p}.json"))
                for p, _ in FED_PARTIES}

    endpoints = {lk: InProcTransport() for lk in plan.links()}
    fast = dict(timeout_s=0.1, max_retries=400)
    parties = make_federation_parties(plan, data, ledgers=ledgers(),
                                      endpoints=endpoints,
                                      journal_dir=str(tmp_path), **fast)
    results, errors = {}, {}

    def run(name, party):
        try:
            results[name] = party.run()
        except BaseException as e:  # SimulatedCrash is one
            errors[name] = e

    chaos.install(chaos.ChaosPlan("federation.pre_release", mode="raise",
                                  thread_name="party-p0"))
    threads = {n: threading.Thread(target=run, args=(n, p),
                                   name=f"party-{n}")
               for n, p in parties.items()}
    try:
        for t in threads.values():
            t.start()
        threads["p0"].join(timeout=120)
    finally:
        chaos.clear()
    assert isinstance(errors.pop("p0", None), chaos.SimulatedCrash)
    fresh = make_federation_parties(plan, data, ledgers=ledgers(),
                                    endpoints=endpoints,
                                    journal_dir=str(tmp_path), **fast)
    rerun = threading.Thread(target=run, args=("p0", fresh["p0"]),
                             name="party-p0")
    rerun.start()
    rerun.join(timeout=120)
    for t in threads.values():
        t.join(timeout=120)
    assert not errors
    assert _cells(results) == ref
    final = ledgers()
    for p, e in plan.party_eps().items():
        assert abs(final[p].spent(p) - e) <= 1e-9, p


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["rbg", "unsafe_rbg"])
def test_rbg_protocol_on_the_card(cuda, proto_columns, impl, monkeypatch):
    """On rbg keys a replay session per family (on unsafe_rbg, int_subg)
    bit-equal to the direct call on the card; on rbg a hardened session
    unlike replay's, and a 3-column federation plan whose every cell is
    its independent session's; rbg_bits launches, K1 does not."""
    from dpcorr_torch.ops import rbg
    from dpcorr_torch.protocol import ProtocolSpec, run_inproc
    from dpcorr_torch.protocol.federation import run_federation_inproc
    from dpcorr_torch.protocol.matrix import FederationPlan

    monkeypatch.setenv("DPCORR_PRNG", impl)
    x, y = proto_columns
    eps = PROTO_EPS[0]
    before = (rbg.KERNEL_LAUNCHES["rbg_bits"], dict(fused_ni.KERNEL_LAUNCHES))
    families = SERVE_FAMILIES if impl == "rbg" else ("int_subg",)
    got = {}
    for family in families:
        got[family] = _session_bits(run_inproc(ProtocolSpec(
            family=family, n=PROTO_N, eps1=eps[0], eps2=eps[1]), x, y))
        assert got[family] == _direct_bits(family, eps, x, y, cuda), family
    if impl == "rbg":
        hard = _session_bits(run_inproc(ProtocolSpec(
            family="ni_subg", n=PROTO_N, eps1=eps[0], eps2=eps[1],
            noise_mode="hardened"), x, y))
        assert np.isfinite(hard).all() and hard[0] != got["ni_subg"][0]
        data = {"a": x, "b": y, "c": _fed_data(x, y)["c"]}
        plan = FederationPlan(family="int_subg", n=PROTO_N, eps=1.0,
                              parties=[("p0", ["a"]), ("p1", ["b"]),
                                       ("p2", ["c"])], seed=PROTO_SEED)
        _cells_equal_two_party_runs(
            plan, data, _cells(run_federation_inproc(plan, data)))
    assert rbg.KERNEL_LAUNCHES["rbg_bits"] > before[0]
    assert dict(fused_ni.KERNEL_LAUNCHES) == before[1]


# ------------------------------------------------------ the stream ----
@pytest.fixture(scope="module")
def stress_rows():
    """10⁶ rows of a ρ = 0.5 Gaussian pair on the key-tree (the stress
    study's width)."""
    from dpcorr_torch.perf_stream import STREAM_SEED, STRESS_ROWS, gaussian_pair

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return gaussian_pair(STRESS_ROWS, STREAM_SEED, "cuda")


@pytest.fixture(scope="module")
def stream_plan():
    """stream_load.py's plan (4 windows of 10 batches, then a heartbeat)
    over a 4,000-row Gaussian pair."""
    from dpcorr_torch.perf_stream import STREAM_SEED, batch_plan, gaussian_pair

    return batch_plan(gaussian_pair(4000, STREAM_SEED, "cpu"))


def _stream_service(workdir, device, **kw):
    """A service at benchmarks/stream_load.py's settings (2 s tumbling
    windows, ε = 0.4 for both parties, normalise on) over all four
    families; the CLI's budget and seed."""
    from dpcorr_torch.perf_stream import STREAM_EPS, STREAM_SEED, WINDOW_S
    from dpcorr_torch.stream.service import StreamService
    from dpcorr_torch.stream.windows import WindowSpec

    args = dict(normalise=True, budget=100.0, seed=STREAM_SEED,
                device=device)
    args.update(kw)
    return StreamService(str(workdir), WindowSpec(size_s=WINDOW_S),
                         SERVE_FAMILIES, STREAM_EPS, STREAM_EPS, **args)


def _feed_service(sv, plan) -> None:
    """Send every batch in order, swallowing refusals as a client
    would; a simulated crash propagates."""
    from dpcorr_torch.stream.service import StreamOverloadedError
    from dpcorr_torch.stream.windows import LateRecordError

    for bid, ts, rows in plan:
        try:
            sv.ingest(bid, ts, rows)
        except (LateRecordError, StreamOverloadedError):
            continue


def _spent(snapshot) -> dict:
    return {p: v["spent"] for p, v in snapshot["parties"].items()}


def _eps_exact(spent, windows) -> None:
    """Each party spent ``windows`` × its per-window charge, and no
    reserved principal beyond those asked for."""
    from dpcorr_torch.perf_stream import stream_charges

    want = {p: windows * v for p, v in stream_charges().items()}
    parties = {p: v for p, v in spent.items()
               if not p.startswith(("user/", "global/"))}
    assert set(parties) == set(want)
    for p, e in want.items():
        assert abs(parties[p] - e) <= 1e-9, p


def _staged_release(xy, params, wkey, device, moments=None):
    """``release_window`` in its stages on ``device``: pass A and the
    window's moments (unless given), the estimate pass and the finisher.
    Returns (moments, release)."""
    from dpcorr_torch.stream import sketch

    if moments is None:
        grid_ = sketch.grid_for(params, len(xy))
        pass_a = sketch.sketch_window(xy, params, wkey, "pass_a",
                                      device=device)
        moments = sketch.moments_for_window(pass_a, params, grid_, wkey,
                                            device)
    est = sketch.sketch_window(xy, params, wkey, "estimate",
                               moments=moments, device=device)
    return moments, sketch.release_from_sketch(est, params, wkey, device)


def _release_within(got, want, family) -> bool:
    """(ρ̂, lo, hi) within atol 1e-5 (subG also rtol 2.5e-7)."""
    g = np.array([got[k] for k in ("rho", "lo", "hi")])
    w = np.array([want[k] for k in ("rho", "lo", "hi")])
    tol = 1e-5 + (2.5e-7 * np.abs(w) if family.endswith("subg") else 0.0)
    return bool((np.abs(g - w) <= tol).all())


def _sign_ties(xy, mo) -> int:
    """Rows whose centered value lies within 1e-5 of 0 in either column:
    the only rows whose sign can follow the moments' last bits."""
    lc = np.float32(mo["l_clip"])
    cx = (np.clip(xy[:, 0], -lc, lc) - np.float32(mo["mu_x"])) \
        * np.float32(mo["inv_x"])
    cy = (np.clip(xy[:, 1], -lc, lc) - np.float32(mo["mu_y"])) \
        * np.float32(mo["inv_y"])
    return int(((np.abs(cx) < 1e-5) | (np.abs(cy) < 1e-5)).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("family", SERVE_FAMILIES)
def test_stream_release_card_agrees_with_cpu(cuda, stress_rows, family):
    """A window's release at n = 10⁶ on the card and the CPU, within atol
    1e-5 (subG also rtol 2.5e-7). A normalised family's staged release is
    ``release_window``'s; its moments on the card agree with the CPU's
    (1e-6 relative and absolute, ``priv_standardize``'s tolerance), and
    the CPU's release from the card's moments agrees with the card's; the
    CPU's release from its own moments may miss only where a centered
    value lies within 1e-5 of 0. The sign families lie near ρ = 0.5 with
    ρ̂ inside their CI."""
    from dpcorr_torch.perf_stream import RELEASE_EPS, STREAM_SEED
    from dpcorr_torch.stream import sketch

    xy = stress_rows
    wkey = sketch.window_key(rng.master_key(STREAM_SEED), "0-2000")
    params = sketch.ReleaseParams(family, *RELEASE_EPS)
    card = sketch.release_window(xy, params, wkey, device=cuda)
    ties = 0
    if params.needs_moments:
        mo_card, staged = _staged_release(xy, params, wkey, cuda)
        assert json.dumps(staged, sort_keys=True) == json.dumps(
            card, sort_keys=True)
        mo_cpu, cpu = _staged_release(xy, params, wkey, "cpu")
        for k in ("mu_x", "inv_x", "mu_y", "inv_y"):
            assert abs(mo_card[k] - mo_cpu[k]) <= 1e-6 + 1e-6 * abs(
                mo_cpu[k]), k
        _mo, same = _staged_release(xy, params, wkey, "cpu",
                                    moments=mo_card)
        assert _release_within(card, same, family)
        ties = _sign_ties(xy, mo_cpu)
    else:
        cpu = sketch.release_window(xy, params, wkey, device="cpu")
    assert _release_within(card, cpu, family) or ties
    if family in ("ni_sign", "int_sign"):
        assert abs(card["rho"] - 0.5) < 0.05
        assert card["lo"] <= card["rho"] <= card["hi"]


@pytest.mark.cuda
@pytest.mark.parametrize("impl,family",
                         [("rbg", f) for f in SERVE_FAMILIES]
                         + [("unsafe_rbg", "ni_sign")])
def test_rbg_stream_window_on_the_card(cuda, impl, family, monkeypatch):
    """One window on rbg-family keys at the HRS wave-2 width (the raw age
    and BMI pair), stream_load.py's ε and associativity chunk (512 rows):
    two partitions byte-equal to the monolith on the card, and the card
    within the stream's card-against-CPU tolerance of the CPU (a
    normalised sign family's CPU release taken from the card's moments
    where the signs follow their last bits); rbg_bits launches, K1 does
    not."""
    from dpcorr_torch.ops import rbg
    from dpcorr_torch.perf_stream import STREAM_EPS, STREAM_SEED, hrs_pair
    from dpcorr_torch.stream import sketch

    monkeypatch.setenv("DPCORR_PRNG", impl)
    xy = hrs_pair()
    before = (rbg.KERNEL_LAUNCHES["rbg_bits"], dict(fused_ni.KERNEL_LAUNCHES))
    wkey = sketch.window_key(rng.master_key(STREAM_SEED), "0-2000")
    params = sketch.ReleaseParams(family, STREAM_EPS, STREAM_EPS,
                                  target_chunk=512)
    card = sketch.release_window(xy, params, wkey, device=cuda)
    ids = list(range(sketch.grid_for(params, len(xy)).n_chunks))
    for shards in ([ids[0::2], ids[1::2]], [[c] for c in reversed(ids)]):
        assert json.dumps(sketch.release_window(
            xy, params, wkey, shards=shards, device=cuda),
            sort_keys=True) == json.dumps(card, sort_keys=True)
    within = _release_within(card, sketch.release_window(
        xy, params, wkey, device="cpu"), family)
    if not within and params.needs_moments and family.endswith("sign"):
        mo_card, _ = _staged_release(xy, params, wkey, cuda)
        within = _release_within(card, _staged_release(
            xy, params, wkey, "cpu", moments=mo_card)[1], family)
    assert within
    assert rbg.KERNEL_LAUNCHES["rbg_bits"] > before[0]
    assert dict(fused_ni.KERNEL_LAUNCHES) == before[1]


def _flip_byte(path) -> None:
    with open(path, "r+b") as fh:
        fh.seek(3)
        fh.write(b"X")


def _rewind_release(path) -> None:
    with open(path) as fh:
        entry = json.loads(fh.readline())
    entry.update(window_id="rewound", charge_id="rewound", release_seq=1)
    with open(path, "a") as fh:
        fh.write(json.dumps(entry) + "\n")


@pytest.mark.cuda
def test_stream_http_service_on_the_card(cuda, stream_plan, tmp_path):
    """A card service behind its HTTP front end takes the plan from one
    client: every release equals ``release_window`` on the window's rows
    under its key on the card; each party spent 4 × its per-window
    charge and the audit replay equals the ledger; a resent batch spends
    nothing; a late batch gets 400 with the watermark; a service with a
    small ``max_pending_rows`` answers 429 with ``Retry-After``. ``obs
    watch --once`` over the workdir finds nothing; copies with a WAL byte
    flipped and a release seq rewound are caught as ``wal-regression``
    and not raised again on a rerun. K1 does not launch."""
    import shutil
    import urllib.request

    from dpcorr_torch.obs.audit import read_events, replay_levels
    from dpcorr_torch.perf_stream import STREAM_EPS, STREAM_SEED, plan_windows
    from dpcorr_torch.stream import sketch
    from dpcorr_torch.stream.http import make_stream_http_server

    plan = stream_plan
    k1 = dict(fused_ni.KERNEL_LAUNCHES)
    workdir = tmp_path / "svc"
    sv = _stream_service(workdir, cuda)
    httpd = make_stream_http_server(sv, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for bid, ts, rows in plan:
            code, _h, ack = _post_json(f"{base}/ingest", {
                "batch_id": bid, "ts": ts, "rows": rows})
            assert code == 200, (bid, ack)
        with urllib.request.urlopen(f"{base}/releases?since=0",
                                    timeout=60) as resp:
            feed = json.loads(resp.read())["releases"]
        spent = _spent(sv.ledger.snapshot())
        code, _h, ack = _post_json(f"{base}/ingest", {
            "batch_id": plan[0][0], "ts": plan[0][1], "rows": plan[0][2]})
        assert code == 200 and ack["deduped"]
        assert _spent(sv.ledger.snapshot()) == spent
        code, _h, late = _post_json(f"{base}/ingest", {
            "batch_id": "late", "ts": 1.0, "rows": [[1.0, 2.0]]})
        assert code == 400 and late.get("refused") == "late"
        assert late.get("watermark") == sv.manager.watermark
    finally:
        httpd.shutdown()
        httpd.server_close()
        sv.close()
    windows = plan_windows(plan)
    assert [e["window_id"] for e in feed] == sorted(
        windows, key=lambda w: int(w.split("-")[0]))
    master = rng.master_key(STREAM_SEED)
    for entry in feed:
        wkey = sketch.window_key(master, entry["window_id"])
        for family in SERVE_FAMILIES:
            params = sketch.ReleaseParams(family, STREAM_EPS, STREAM_EPS,
                                          normalise=True)
            assert entry["releases"][family] == sketch.release_window(
                windows[entry["window_id"]], params, wkey, device=cuda)
    _eps_exact(spent, len(feed))
    levels = replay_levels(read_events(str(workdir / "audit.jsonl")))
    assert levels["party"] == spent
    assert not levels["user"] and not levels["global"]
    small = _stream_service(tmp_path / "small", cuda, max_pending_rows=100)
    httpd = make_stream_http_server(small, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        code, headers, _body = _post_json(
            f"http://127.0.0.1:{httpd.server_address[1]}/ingest",
            {"batch_id": plan[0][0], "ts": plan[0][1], "rows": plan[0][2]})
    finally:
        httpd.shutdown()
        httpd.server_close()
        small.close()
    assert code == 429 and int(headers.get("Retry-After", "0")) >= 1
    assert dict(fused_ni.KERNEL_LAUNCHES) == k1
    assert not _watch(str(tmp_path / "all.ck.json"), "--stream",
                      f"s={workdir}")
    for label, fault in (("flip", lambda c: _flip_byte(c / "wal.jsonl")),
                         ("rewind",
                          lambda c: _rewind_release(c / "releases.jsonl"))):
        copy = tmp_path / label
        shutil.copytree(workdir, copy)
        ck = str(tmp_path / f"{label}.ck.json")
        _watch(ck, "--stream", f"s={copy}")
        fault(copy)
        assert "wal-regression" in _watch(ck, "--stream", f"s={copy}", rc=1)
        assert not _watch(ck, "--stream", f"s={copy}")


@pytest.mark.cuda
def test_stream_process_killed_and_restarted_on_the_card(cuda, stream_plan,
                                                         tmp_path):
    """``python -m dpcorr_torch stream`` on the card killed at
    ``stream.pre_release`` (hit 2, exit 42) mid-send, restarted with the
    same command line while the client resends: the feed byte-identical
    to an uninterrupted service's, ε exact."""
    import urllib.error
    import urllib.request

    from dpcorr_torch import chaos
    from dpcorr_torch.perf_stream import STREAM_EPS, STREAM_SEED, WINDOW_S

    plan = stream_plan
    ref = _stream_service(tmp_path / "ref", cuda)
    try:
        _feed_service(ref, plan)
        want = json.dumps(ref.releases(), sort_keys=True)
    finally:
        ref.close()
    cmd = [sys.executable, "-m", "dpcorr_torch", "stream", "--workdir",
           str(tmp_path / "proc"), "--port", "0", "--window-s",
           str(WINDOW_S), "--families", ",".join(SERVE_FAMILIES),
           "--eps1", str(STREAM_EPS), "--eps2", str(STREAM_EPS),
           "--normalise", "on", "--budget", "100", "--seed",
           str(STREAM_SEED)]

    def start(chaos_spec):
        env = _repo_env()
        if chaos_spec:
            env["DPCORR_CHAOS"] = chaos_spec
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
        return proc, _banner_of(proc, 240)["streaming"]

    proc, banner = start("point=stream.pre_release,hit=2,mode=exit")
    died = False
    for bid, ts, rows in plan:
        try:
            _post_json(f"http://127.0.0.1:{banner['port']}/ingest",
                       {"batch_id": bid, "ts": ts, "rows": rows})
        except (urllib.error.URLError, ConnectionError, OSError):
            died = True
            break
    assert proc.wait(timeout=120) == chaos.EXIT_CODE and died
    proc.communicate(timeout=60)
    proc, banner = start(None)
    base = f"http://127.0.0.1:{banner['port']}"
    try:
        for bid, ts, rows in plan:
            code, _h, ack = _post_json(f"{base}/ingest", {
                "batch_id": bid, "ts": ts, "rows": rows})
            assert code == 200, (bid, ack)
        with urllib.request.urlopen(f"{base}/releases?since=0",
                                    timeout=60) as resp:
            feed = json.dumps(json.loads(resp.read())["releases"],
                              sort_keys=True)
        with urllib.request.urlopen(f"{base}/stats", timeout=60) as resp:
            stats = json.loads(resp.read())
    finally:
        proc.terminate()
        proc.communicate(timeout=60)
    assert feed == want
    _eps_exact(_spent(stats["ledger"]), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["user_renewing", "user_refused",
                                   "global"])
def test_stream_budgets_on_the_card(cuda, stream_plan, tmp_path, label):
    """The stream's budget levels on the card. ``user_renewing``: a user
    budget of two windows' user leg, the directory's period the hop, so
    every window opens a fresh user window: all four release, three
    renewals, lifetime 4 legs. ``user_refused``: a user budget below one
    window's leg: every window refused at the user level, nothing spent
    at any level. ``global``: a global budget of two windows: the third
    and fourth refused at the global level, charge-free."""
    from dpcorr_torch.obs.budget_replay import read_user_balances
    from dpcorr_torch.perf_stream import stream_charges

    leg = sum(stream_charges().values())
    kw, released, level = {
        "user_renewing": ({"user": "u1", "user_budget": 2 * leg}, 4, None),
        "user_refused": ({"user": "u1", "user_budget": 0.5 * leg}, 0,
                         "user"),
        "global": ({"global_budget": 2 * leg}, 2, "global")}[label]
    sv = _stream_service(tmp_path, cuda, **kw)
    try:
        _feed_service(sv, stream_plan)
        st = sv.stats()
        refusals = sv.ledger.refusals_by_level()
        spent = _spent(sv.ledger.snapshot())
    finally:
        sv.close()
    assert st["released"] == released
    assert len(st["refused"]) == 4 - released
    if level is not None:
        assert refusals[level] == 4 - released
    if released:
        _eps_exact(spent, released)
    else:
        assert all(v == 0.0 for v in spent.values()), spent
    if "global_budget" in kw:
        assert spent.get("global/total") == 2 * leg
    if "user" in kw:
        bal = read_user_balances(str(tmp_path / "budget_dir")).get("u1", {})
        assert abs(bal.get("l", 0.0) - released * leg) <= 1e-9
        if released:
            assert st["budget_dir"]["counters"]["renewals"] == released - 1


@pytest.mark.cuda
def test_stream_mesh_placement_on_the_card(cuda, stream_plan, tmp_path):
    """The stream service under a mesh placement over the one card gives
    the local placement's journal bytes, two windows."""
    from dpcorr_torch.perf_stream import batch_plan, plan_windows

    rows = np.concatenate(list(plan_windows(stream_plan).values())[:1])
    plan = batch_plan(rows, windows=2)
    out = {}
    for placement in ("local", "mesh"):
        sv = _stream_service(tmp_path / placement, cuda, placement=placement)
        try:
            _feed_service(sv, plan)
            entries = sv.journal.entries()
        finally:
            sv.close()
        out[placement] = (len(entries), json.dumps(entries, sort_keys=True))
    assert out["local"][0] == 2
    assert out["local"] == out["mesh"]


# ------------------------------------------------ the measuring layer ----
@pytest.mark.cuda
def test_doctor_probe_on_the_card(cuda):
    """``python -m dpcorr_torch doctor --probe --json`` in its own process:
    verdict ok, the probe names the card, ``nvcc`` found with sm_90a,
    K1's library current in ``_build/`` (nothing stale of it), no
    strays."""
    from dpcorr_torch.ops import _build

    _build.build_all(["fused_ni"])
    out = subprocess.run([sys.executable, "-m", "dpcorr_torch", "doctor",
                          "--probe", "--json"], cwd=REPO, env=_repo_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    probe, cache, nvcc = (rep["device_probe"], rep["compile_cache"],
                          rep["nvcc"])
    assert rep["verdict"] == "ok" and probe.get("ok"), rep
    assert probe.get("device") == torch.cuda.get_device_name(0)
    assert nvcc["found"] and nvcc["sm_90a"], nvcc
    assert cache["current"].get("fused_ni"), cache
    assert not any(s.startswith("fused_ni-") for s in cache["stale"]), cache
    assert not rep["stray_workers"], rep["stray_workers"]


@pytest.mark.cuda
def test_geometry_autotune_on_the_card(cuda, tmp_path, monkeypatch):
    """``autotune`` of the fused (K1) and unfused main-path pipelines and
    of ``grid-sign`` at n = 1000 into a work-directory cache: each a
    winner from probes (K1 launched by the fused family only), then
    read back from the cache with no probe; ``obs geometry --json`` lists
    the three for the card; ``geometry="auto"`` takes the tuned chunk at
    n = 1000 and the default elsewhere, and its unfused v1 grid is the
    pinned one's: bit-equal under one stamp when the tuned chunk is the
    default, else within 1e-5 under another stamp."""
    from dpcorr_torch.grid import _rows
    from dpcorr_torch.utils import geometry
    from dpcorr_torch.utils.device import device_kind

    monkeypatch.setenv("DPCORR_GEOMETRY_CACHE", str(tmp_path / "geo.json"))
    geometry._MEMO.clear()
    kind, key = device_kind(), rng.master_key(device=cuda)
    grid_n = V1.n_grid[0]
    grid_cfg = sim.SimConfig(n=grid_n, rho=RHO, eps1=EPS[0], eps2=EPS[1])
    families = {
        "ni-sign-fused": (sim.fused_ni_rep_fn(N, RHO, *EPS, ALPHA), 3, N),
        "ni-sign": (sim.ni_rep_fn(N, RHO, *EPS, ALPHA), 3, N),
        "grid-sign": (lambda k: sim._one_rep(k, RHO, grid_cfg), 12, grid_n),
    }
    tuned = {}
    try:
        for fam, (body, out_len, n) in families.items():
            runner = geometry.pipeline_runner(body, out_len, key=key)
            before = fused_ni.KERNEL_LAUNCHES["fused_ni"]
            geo = geometry.autotune(fam, n, runner, device_kind=kind,
                                    eps_pairs=[EPS])
            launches = fused_ni.KERNEL_LAUNCHES["fused_ni"] - before
            probes = runner.probes
            geometry._MEMO.clear()
            again = geometry.autotune(fam, n, runner, device_kind=kind,
                                      eps_pairs=[EPS])
            assert geo.source == "autotune" and again.source == "cache"
            assert runner.probes == probes
            assert (again.chunk_size, again.block_reps) == (
                geo.chunk_size, geo.block_reps)
            assert (launches > 0) == (fam == "ni-sign-fused"), fam
            tuned[fam] = geo.chunk_size
        ls = subprocess.run([sys.executable, "-m", "dpcorr_torch", "obs",
                             "geometry", "--json"], cwd=REPO,
                            env=_repo_env(), capture_output=True, text=True,
                            timeout=120)
        assert ls.returncode == 0, ls.stderr[-2000:]
        listed = {e["family"]: e for e in json.loads(ls.stdout)["entries"]}
        assert sorted(listed) == sorted(families)
        assert all(e["device_kind"] == kind for e in listed.values())
        gcfg = grid.GridConfig(b=GRID_B, backend="bucketed",
                               geometry="auto")
        chunks = {r.n: gcfg.sim_config(r).chunk_size
                  for r in _rows(gcfg.design_points())}
        assert chunks == {n: tuned["grid-sign"] if n == grid_n
                          else gcfg.chunk_size for n in gcfg.n_grid}
        res = grid.run_grid(gcfg)
        off = grid.run_grid(grid.GridConfig(b=GRID_B, backend="bucketed"))
        row = next(r for r in _rows(gcfg.design_points()) if r.n == grid_n)
        same_stamp = (grid._stamp(grid.GridConfig().sim_config(row))
                      == grid._stamp(gcfg.sim_config(row)))
        if tuned["grid-sign"] == gcfg.chunk_size:
            assert same_stamp
            _same_table(res.detail_all, off.detail_all)
        else:  # the unfused body's last bits follow the width
            assert not same_stamp
            for f in sim.DETAIL_FIELDS:
                assert np.abs(res.detail_all[f].astype(np.float64)
                              - off.detail_all[f]).max() <= 1e-5, f
    finally:
        geometry._MEMO.clear()


# --------------------------------------------------- the stage ladder ----
@pytest.mark.cuda
@pytest.mark.parametrize("level", ["center", "matmul"])
def test_bisect_probe_above_the_cap_on_the_card(cuda, level):
    """The bisect's probes in process above K1's cap on the planes
    (n = 40,000): ok and finite."""
    from dpcorr_torch import bisect

    res = bisect.probe_level(level, n=40_000)
    assert res["ok"] and res["finite"], res


@pytest.mark.cuda
def test_bisect_process_on_the_card(cuda, tmp_path):
    """``python -m dpcorr_torch.bisect --start matmul`` as a process on
    the card: exit 0, health OK, the probes of L5-L7 ok and finite in
    order, no culprit, not wedged; the ladder launched once at L5 and K1
    once in each of L6-L7, as the probes report. The lower levels' probes
    run in process (``test_bisect_probe_above_the_cap_on_the_card``, the
    ladder tests)."""
    from dpcorr_torch.bisect import LEVELS

    out = tmp_path / "bisect.json"
    proc = subprocess.run([sys.executable, "-m", "dpcorr_torch.bisect",
                           "--start", "matmul", "--out", str(out)],
                          cwd=REPO, env=_repo_env(), capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-2000:])
    report = json.loads(out.read_text())
    probes = report["probes"]
    results = [p["result"] for p in probes]
    assert report["culprit"] is None and not report["wedged"]
    assert report["health"].startswith("HEALTH-OK")
    assert [p["level"] for p in probes] == LEVELS[LEVELS.index("matmul"):]
    assert all(isinstance(r, dict) and r["ok"] and r["finite"]
               for r in results), results
    assert [r["launches"] for r in results] == [1, 1, 1]


@pytest.mark.cuda
def test_obs_provenance_over_a_federation_on_the_card(cuda, proto_columns,
                                                     tmp_path):
    """The 3-party, 4-column federation (``ni_sign``, ε = 1) in process on
    the card with ledgers, audit trails, transcripts, journals and a
    scrape endpoint per party, under the tools (processes that see no
    card and cannot import torch): ``obs provenance`` finds no divergence
    and a total equal to ``optimal_eps()`` float for float; a copy with
    one charge amount halved exits 1 naming ``tampered-charge`` and the
    party; ``obs top --federation --once`` shows every party's cells
    done; ``obs watch --once`` over the transcripts and journals finds
    nothing."""
    import shutil

    from dpcorr_torch.obs.audit import AuditTrail
    from dpcorr_torch.obs.endpoint import start_obs_server
    from dpcorr_torch.protocol.federation import (
        _drive_parties,
        make_federation_parties,
    )
    from dpcorr_torch.protocol.matrix import FederationPlan
    from dpcorr_torch.serve.ledger import PrivacyLedger

    k1 = dict(fused_ni.KERNEL_LAUNCHES)
    d = tmp_path / "fed"
    d.mkdir()
    x, y = proto_columns
    plan = FederationPlan(family="ni_sign", n=len(x), eps=1.0,
                          parties=FED_PARTIES, seed=PROTO_SEED)
    ledgers = {p: PrivacyLedger(1e6, path=str(d / f"ledger.{p}.json"),
                                audit=AuditTrail(str(d / f"audit.{p}.jsonl")))
               for p, _ in FED_PARTIES}
    parties = make_federation_parties(plan, _fed_data(x, y), ledgers=ledgers,
                                      transcript_dir=str(d),
                                      journal_dir=str(d), device=cuda)
    servers = {n: start_obs_server(p.registry, stats_fn=p.stats_snapshot)
               for n, p in parties.items()}
    try:
        _drive_parties(parties)
        targets = ",".join(f"{n}=http://127.0.0.1:{port}"
                           for n, (_srv, port) in sorted(servers.items()))
        frame = _obs_tool("top", "--federation", targets, "--once").stdout
    finally:
        for srv, _port in servers.values():
            srv.shutdown()
    plan_path = tmp_path / "plan.json"
    plan_path.write_text(json.dumps({"plan": plan.to_public()}))
    audits = [a for p, _ in FED_PARTIES
              for a in ("--audit", f"{p}={d}/audit.{p}.jsonl")]
    doc = json.loads(_obs_tool("provenance", "--plan", str(plan_path),
                               "--transcript-dir", str(d), *audits,
                               "--journal-dir", str(d), "--json").stdout)
    assert doc["ok"] and not doc["divergences"], doc["divergences"]
    assert doc["eps"]["total"] == plan.optimal_eps()
    bad = tmp_path / "tampered"
    shutil.copytree(d, bad)
    victim = sorted(f for f in os.listdir(bad)
                    if f.startswith(plan.fed) and f.endswith(".p0.jsonl"))[0]
    lines = [json.loads(ln) for ln in (bad / victim).read_text()
             .splitlines()]
    hit = next(e for e in lines
               if e.get("dir") == "send" and e.get("eps", 0) > 0)
    hit["eps"] = hit["eps"] / 2
    (bad / victim).write_text("".join(json.dumps(e) + "\n" for e in lines))
    text = _obs_tool("provenance", "--plan", str(plan_path),
                     "--transcript-dir", str(bad),
                     *[a.replace(str(d), str(bad)) for a in audits],
                     "--journal-dir", str(bad), rc=1).stdout
    assert "DIVERGENCE [tampered-charge] party=p0" in text
    expect = {n: p.stats_snapshot()["cells_done"]
              for n, p in parties.items()}
    cells = len(plan.cells())
    rows = {ln.split()[0]: ln.split()[1] for ln in frame.splitlines()
            if ln.split() and ln.split()[0] in expect}
    assert "3/3 parties up" in frame and "DISAGREE" not in frame, frame
    assert rows == {n: f"{k}/{cells}" for n, k in expect.items()}, frame
    assert f"cells {sum(expect.values())} done (matrix {cells})" in frame
    assert not _watch(str(tmp_path / "fed.ck.json"), "--transcripts",
                      f"fed={d}", "--journals", f"fed={d}")
    assert dict(fused_ni.KERNEL_LAUNCHES) == k1


#: ``python -m dpcorr_torch`` that prints its K1 launch count last
_COUNTED = ("import json, sys\n"
            "from dpcorr_torch.__main__ import main\n"
            "try:\n"
            "    main(sys.argv[1:])\n"
            "finally:\n"
            "    from dpcorr_torch.ops import fused_ni\n"
            "    print(json.dumps({'k1_launches': "
            "fused_ni.KERNEL_LAUNCHES['fused_ni']}))\n")


@pytest.mark.cuda
def test_witnessed_processes_on_the_card(cuda, v1_fused, tmp_path):
    """Processes on the card under the lock witness (``DPCORR_SYNCWATCH=1``,
    one ``DPCORR_SYNCWATCH_DIR``): ``grid --fused auto`` on the v1 grid
    (its table bit-equal to the unwatched run, one K1 launch per bucket);
    a ``serve --user-dir`` process under concurrent HTTP requests over 8
    users, then SIGINT (exit 0); one ``chaos`` case (``ni_sign``, victim
    x killed at ``budget.mid_compaction``) bit-identical to its
    reference. Every watched process leaves its artifact (the killed
    victim from its crash hook), the artifacts wrap port lock sites, and
    ``lint --witness`` over them exits 0 in a process that cannot import
    torch."""
    import glob
    import signal

    from dpcorr_torch import report
    from dpcorr_torch.serve import HttpEstimateClient
    from dpcorr_torch.utils.syncwatch import ARTIFACT_PREFIX

    wdir = tmp_path / "witness"
    wdir.mkdir()
    env = _repo_env()
    env.update(DPCORR_SYNCWATCH="1", DPCORR_SYNCWATCH_DIR=str(wdir))
    chaos_proc = subprocess.Popen(
        [sys.executable, "-m", "dpcorr_torch", "chaos", "--device", "cuda",
         "--families", "ni_sign", "--points", "budget.mid_compaction",
         "--roles", "x", "--n", str(N), "--timeout", "1", "--case-timeout",
         "120", "--workdir", str(tmp_path / "chaos")], cwd=REPO, env=env,
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out_dir = tmp_path / "grid"
        grid_proc = subprocess.Popen(
            [sys.executable, "-c", _COUNTED, "grid", "--fused", "auto",
             "--backend", "bucketed", "--b", str(GRID_B), "--device", "cuda",
             "--out", str(out_dir)], cwd=REPO, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        out, err = grid_proc.communicate(timeout=900)
        assert grid_proc.returncode == 0, err[-2000:]
        launches = json.loads(out.strip().splitlines()[-1])
        assert launches["k1_launches"] == len(V1_BUCKETS)
        _same_table(report.read_tables(str(out_dir))["detail"],
                    v1_fused.detail_all)
        serve = subprocess.Popen(
            [sys.executable, "-m", "dpcorr_torch", "serve", "--port", "0",
             "--device", "cuda", "--budget", "1e12", "--user-dir",
             str(tmp_path / "users"), "--user-budget", "1e12",
             "--max-batch", str(SERVE_MAX_BATCH),
             "--max-delay-ms", str(SERVE_MAX_DELAY_S * 1e3)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            base = (f"http://127.0.0.1:"
                    f"{_banner_of(serve, 240)['serving']['port']}")
            reqs = [r for f, seed0 in (("ni_sign", 70_000_000),
                                       ("int_sign", 71_000_000))
                    for u in range(8)
                    for r in _serve_requests(f, 1, N, seed0 + u,
                                             user=f"user{u:02d}")]
            vals = _drive(HttpEstimateClient(base, timeout_s=300.0), reqs, 8)
            assert np.isfinite(vals).all()
        finally:
            serve.send_signal(signal.SIGINT)
            _, err = serve.communicate(timeout=120)
        assert serve.returncode == 0, err[-2000:]
        out, err = chaos_proc.communicate(timeout=600)
        assert chaos_proc.returncode == 0, (out[-1500:], err[-1500:])
        doc = json.loads(out)
        assert doc["ok"] and doc["cases"][0]["ok"], doc
    finally:
        if chaos_proc.poll() is None:
            chaos_proc.kill()
            chaos_proc.communicate()
    arts = [json.loads(Path(p).read_text()) for p in sorted(glob.glob(
        str(wdir / f"{ARTIFACT_PREFIX}*.json")))]
    pids = {a["pid"] for a in arts}
    for proc in (grid_proc, serve, chaos_proc):
        assert proc.pid in pids, proc.args[:4]
    parties = [a for a in arts if "party" in a["argv"]]
    assert len(parties) == 3  # x, y, and x restarted
    assert sum(a["end"] == "chaos:budget.mid_compaction"
               for a in parties) == 1
    assert any(a["locks"] for a in arts)
    lint = subprocess.run([sys.executable, "-c", _NO_TORCH, "lint",
                           "--witness", str(wdir), "--json"], cwd=REPO,
                          env=_tool_env(), capture_output=True, text=True,
                          timeout=300)
    assert lint.returncode == 0, (lint.stdout[-3000:], lint.stderr[-1500:])
