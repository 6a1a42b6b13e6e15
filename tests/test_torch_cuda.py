"""The port on the card: the CUDA kernel against its plain version, the
replication pipeline through both bodies, the sub-Gaussian and
streaming paths against the same keys on the CPU, and the design grid's
fused and unfused buckets.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

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
    from its cache and launches nothing."""
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
def test_fan_out_workers_launch_k1_on_the_card(cuda, tmp_path):
    """Two worker processes share the card; their reported K1 launches
    cover every fused bucket once and the merge equals run_grid."""
    from dpcorr_torch.parallel import run_grid_multihost

    kw = dict(n_grid=(1000, 1500), rho_grid=(0.0, 0.5),
              eps_pairs=((1.0, 1.0),), b=64, backend="bucketed",
              fused="auto")
    want = grid.run_grid(grid.GridConfig(**kw))
    res = run_grid_multihost(grid.GridConfig(**kw, out_dir=str(tmp_path)),
                             n_hosts=2)
    assert sum(h["launches"] for h in res.hosts) == 2
    for col, v in want.detail_all.items():
        np.testing.assert_array_equal(res.detail_all[col], v, err_msg=col)


@pytest.mark.cuda
def test_native_reader_builds_and_agrees_on_the_cards_host(cuda, tmp_path):
    from dpcorr_torch.io import rds, rds_py

    cols = perf_hrs.synthetic_panel(9, 16 * 2000)
    path = tmp_path / "panel.rds"
    perf_hrs.write_panel(str(path), cols)
    nat, py = rds.read_native(path), rds_py.read_rds_table(str(path))
    assert list(nat) == list(py)
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
@pytest.mark.parametrize("eps", PROTO_EPS)
@pytest.mark.parametrize("family", SERVE_FAMILIES)
def test_protocol_session_bit_equal_to_serving_entry_on_the_card(
        cuda, proto_columns, family, eps):
    """A two-party session with both parties on the card (replay keys) is
    bit-equal to the port's monolithic estimator on the card."""
    from dpcorr_torch.models.estimators.registry import serving_entry
    from dpcorr_torch.protocol import ProtocolSpec, run_inproc

    x, y = proto_columns
    spec = ProtocolSpec(family=family, n=PROTO_N, eps1=eps[0], eps2=eps[1])
    res = run_inproc(spec, x, y)
    want = torch.stack(serving_entry(family, *eps)(
        rng.master_key(2025), torch.from_numpy(x).cuda(),
        torch.from_numpy(y).cuda())).cpu().numpy()
    assert want.dtype == np.float32
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
    for shards in ([[0, 2], [1, 3]], [[0], [1, 2, 3]], [[3], [2], [1], [0]],
                   [[1, 3, 0], [2]]):
        assert json.dumps(sketch.release_window(
            stream_rows, params, wkey, shards=shards, device=cuda),
            sort_keys=True) == ref, shards


@pytest.mark.cuda
@pytest.mark.parametrize("point,hit", [("stream.mid_window", 2),
                                       ("stream.pre_release", 1),
                                       ("stream.post_journal", 2)])
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
    run's chunks: per-rep outputs and sums bit-equal, one fetch each, K1
    launched blocks x chunks times on the fused body."""
    fn = (sim.fused_ni_rep_fn if body == "fused" else sim.ni_rep_fn)(
        10_000, 0.5, 1.0, 1.0)
    key = rng.master_key(device=cuda)
    runs = {}
    for placement in ("local", "mesh"):
        pipe = sim.RepBlockPipeline(fn, 3, key=key, block_reps=4096,
                                    chunk_size=2048, placement=placement)
        fused_ni.KERNEL_LAUNCHES["fused_ni"] = 0
        sums, _ = pipe.run(2)
        launches = fused_ni.KERNEL_LAUNCHES["fused_ni"]
        assert launches == (4 if body == "fused" else 0)
        assert pipe.fetches == 1
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
    every replay gives the eager call's bits (chip_smoke.py phase 16f)."""
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
