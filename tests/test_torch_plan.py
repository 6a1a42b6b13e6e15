"""The port's plan/executor layer (``dpcorr_torch.plan``) and its
consumers, on the CPU, against ``dpcorr.plan`` and the port's own
direct calls.

1. **Mechanics** — placement names and padding, the multihost seam,
   preshard counting, the unit cache and ``evict``, exactly one counted
   fetch per plan, mesh dispatch over contiguous shards.
2. **Mesh pipeline** — ``sim.RepBlockPipeline(placement="mesh")`` over
   1, 2 and 4 CPU entries: per-rep outputs bit-equal to the local
   placement, sums within 1e-5 (a different f32 reduction tree), one
   fetch per run; the local placement bit-equal to the direct chunked
   computation the pipeline replaced; the fused body through K1's plain
   version; JAX's mesh pipeline on the virtual CPU mesh within the
   tolerances of ``tests/test_torch_sim.py``.
3. **Consumers** — the grid fetches once per bucket that ran (fused
   buckets through K1's plain version bit-equal to the direct call),
   the sharded twin places through ``preshard``, ``finish_batch``
   builds one unit per signature, the stream releases byte-equal under
   a mesh placement and counts its transfers.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpcorr.sim as jsim
from dpcorr import plan as jplan
from dpcorr.parallel.mesh import rep_mesh
from dpcorr.utils import rng as jrng
from dpcorr_torch import grid, plan, sim
from dpcorr_torch.obs import transfer
from dpcorr_torch.obs.metrics import Registry
from dpcorr_torch.ops import fused_ni
from dpcorr_torch.utils import compile as compile_mod
from dpcorr_torch.utils import rng

BLOCK_REPS, CHUNK = 16, 4
FAMILY_CFGS = {
    "sign": sim.SimConfig(n=192, rho=0.35, eps1=1.0, eps2=1.0),
    "subg": sim.SimConfig(n=192, rho=0.35, eps1=2.0, eps2=1.5,
                          dgp="bounded_factor", use_subg=True),
}


def _rep_fn(cfg):
    def rep(keys):
        row = sim._one_rep(keys, cfg.rho, cfg)
        return (row[0], row[1], row[8], row[9])  # ni_hat, int_hat, covers

    return rep


def _own():
    return transfer.TransferCounters(Registry())


def _pipe(cfg, placement="local", devices=None, counters=None, **kw):
    return sim.RepBlockPipeline(
        _rep_fn(cfg), 4, key=rng.master_key(7), block_reps=BLOCK_REPS,
        chunk_size=CHUNK, placement=placement, devices=devices,
        counters=counters if counters is not None else _own(),
        device="cpu", **kw)


def _cpus(n):
    return [torch.device("cpu")] * n


def _bits(tensors):
    return [t.numpy().tobytes() for t in tensors]


# ------------------------------------------------------- placements ----
def test_resolve_placement_names_and_passthrough():
    lp = plan.resolve_placement("local", device="cpu")
    assert lp.name == "local" and lp.device_count == 1
    assert lp.mesh_shape() is None and lp.devices == [torch.device("cpu")]
    mp = plan.resolve_placement("mesh", devices=_cpus(2))
    assert mp.name == "mesh" and mp.device_count == 2
    assert mp.mesh_shape() == {"rep": 2}
    assert plan.resolve_placement(mp) is mp
    assert plan.resolve_placement(None).name == "local"
    assert plan.MeshPlacement(n_devices=3, device="cpu").devices == _cpus(3)
    with pytest.raises(ValueError):
        plan.resolve_placement("quantum")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan.LocalPlacement().data_sharding()  # no card here: raises


def test_mesh_placement_pads_to_device_multiple():
    mp = plan.MeshPlacement(_cpus(4))
    assert mp.pad(1) == 4 and mp.pad(4) == 4 and mp.pad(5) == 8
    assert plan.LocalPlacement("cpu").pad(5) == 5
    assert jplan.MeshPlacement(rep_mesh(4)).pad(5) == mp.pad(5)


def test_multihost_is_a_seam_not_an_implementation():
    mh = plan.resolve_placement("multihost")
    assert mh.device_count == 0
    with pytest.raises(NotImplementedError, match="init_distributed"):
        mh.data_sharding()
    with pytest.raises(NotImplementedError):
        mh.pad(8)


def test_preshard_counts_placements():
    """A copy onto another device counts one put and its bytes; a tensor
    already there passes through uncounted (the meta device stands in
    for a card here)."""
    ctr = _own()
    x = np.arange(8, dtype=np.float32)
    (placed,) = plan.preshard((x,), torch.device("meta"), ctr)
    assert placed.device.type == "meta" and placed.shape == (8,)
    snap = ctr.snapshot()
    assert (snap["device_put"], snap["device_put_bytes"]) == (1, 32)
    plan.preshard((placed,), "meta", ctr)
    (same,) = plan.preshard((torch.from_numpy(x),), "cpu", ctr)
    assert ctr.snapshot() == snap and np.shares_memory(same.numpy(), x)
    # a device list splits the leading axis into contiguous shards
    (pieces,) = plan.preshard((torch.arange(6),), _cpus(3), ctr)
    assert [p.tolist() for p in pieces] == [[0, 1], [2, 3], [4, 5]]
    assert ctr.snapshot()["reshard_mismatch"] == 0


def test_put_and_put_ints_count_as_preshard_does():
    """The per-tensor path loops use (the stream's chunks and keys)
    tallies what ``preshard`` counts, and the flush adds it: one put and
    its bytes per copy, nothing for a tensor already on its device or a
    key made on the host."""
    from dpcorr_torch.plan.placement import (
        CopyTally,
        canonical_device,
        put,
        put_ints,
    )

    ctr, tally = _own(), CopyTally()
    meta = canonical_device("meta")
    x = torch.arange(4, dtype=torch.float32)
    placed = put(x, meta, tally)
    assert placed.device == meta and put(placed, meta, tally) is placed
    key = put_ints((5, 7), meta, tally)
    assert key.dtype == torch.int64 and key.shape == (2,)
    host = put_ints((5, 7), canonical_device("cpu"), tally)
    assert host.tolist() == [5, 7]
    assert ctr.snapshot()["device_put"] == 0  # nothing until the flush
    tally.flush(ctr)
    snap = ctr.snapshot()
    assert (snap["device_put"], snap["device_put_bytes"]) == (2, 32)
    tally.flush(ctr)  # the flush cleared the tally
    assert ctr.snapshot() == snap


# --------------------------------------------------------- executor ----
def test_executor_unit_cache_evict_and_causes():
    reg = Registry()
    ex = plan.Executor("local", device="cpu", counters=_own(),
                       observer=compile_mod.CompileObserver(reg))
    builds = []

    def build():
        builds.append(1)
        return lambda x: x + 1.0

    sig = {"kernel": "inc"}
    u1 = ex.prepare(("t", "inc"), build, signature=sig)
    assert ex.prepare(("t", "inc"), build, signature=sig) is u1
    ex.evict(("t", "inc"))
    u3 = ex.prepare(("t", "inc"), build, signature=sig)
    assert u3 is not u1 and len(builds) == 2 and u3.built
    rc = reg.get("dpcorr_compile_recompile_total")
    assert rc.value(cause="new-signature") == 1
    assert rc.value(cause="cache-evict") == 1
    assert reg.get("dpcorr_compile_seconds").snapshot()["count"] == 2
    assert reg.get("dpcorr_compile_total").value(result="aot") == 2
    out = ex.dispatch(u3, (torch.zeros(2),))
    assert out.tolist() == [1.0, 1.0]


def test_lazy_unit_builds_and_counts_nothing():
    reg = Registry()
    ex = plan.Executor("local", device="cpu", counters=_own(),
                       observer=compile_mod.CompileObserver(reg))
    unit = ex.lazy_unit(lambda x: 2 * x, key="lazy")
    assert not unit.built
    assert ex.dispatch(unit, (torch.ones(3),)).tolist() == [2.0] * 3
    assert reg.get("dpcorr_compile_seconds").snapshot()["count"] == 0
    assert not any(reg.get("dpcorr_compile_recompile_total").value(cause=c)
                   for c in compile_mod.RECOMPILE_CAUSES)


def test_fetch_counts_exactly_one():
    ctr = _own()
    ex = plan.Executor("local", device="cpu", counters=ctr)
    host = ex.fetch([torch.arange(3), (torch.ones(2),)])
    assert ctr.snapshot()["fetches"] == 1
    assert host[0].tolist() == [0, 1, 2] and host[1][0].tolist() == [1, 1]


def test_mesh_dispatch_runs_each_shard_and_joins_in_order():
    ex = plan.Executor("mesh", devices=_cpus(4), counters=_own())
    seen = []

    def unit(x, y):
        seen.append(x.tolist())
        return x * 10, y + x

    a, b = ex.dispatch(ex.lazy_unit(unit), (torch.arange(8),
                                            torch.ones(8, dtype=torch.int64)))
    assert seen == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert a.tolist() == [10 * i for i in range(8)]
    assert b.tolist() == [1 + i for i in range(8)]
    with pytest.raises(ValueError, match="pad it to 8"):
        ex.dispatch(ex.lazy_unit(unit), (torch.arange(6), torch.ones(6)))


# ---------------------------------------------- mesh rep pipeline ------
def test_mesh_rejects_indivisible_block_reps():
    with pytest.raises(ValueError, match="split evenly"):
        sim.RepBlockPipeline(
            _rep_fn(FAMILY_CFGS["sign"]), 4, key=rng.master_key(7),
            block_reps=10, chunk_size=CHUNK, placement="mesh",
            devices=_cpus(4), device="cpu")
    with pytest.raises(ValueError, match="'local' and 'mesh'"):
        _pipe(FAMILY_CFGS["sign"], placement="multihost")


@pytest.mark.parametrize("fam", sorted(FAMILY_CFGS))
@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_mesh_block_detail_bit_equal_to_local(fam, n_dev):
    cfg = FAMILY_CFGS[fam]
    local = _pipe(cfg)
    mesh = _pipe(cfg, placement="mesh", devices=_cpus(n_dev))
    assert mesh.placement.device_count == n_dev
    assert _bits(local.block_detail(0)) == _bits(mesh.block_detail(0))


@pytest.mark.parametrize("fam", sorted(FAMILY_CFGS))
def test_mesh_run_sums_match_local_to_tolerance(fam):
    cfg = FAMILY_CFGS[fam]
    s_local, n_local = _pipe(cfg).run(2)
    s_mesh, n_mesh = _pipe(cfg, placement="mesh", devices=_cpus(4)).run(2)
    assert n_local == n_mesh == 2 * BLOCK_REPS
    np.testing.assert_allclose(s_mesh, s_local, rtol=1e-5, atol=1e-5)
    s_one, _ = _pipe(cfg, placement="mesh", devices=_cpus(1)).run(2)
    assert s_one == s_local  # one device: the same sum, bit for bit


def test_mesh_run_is_single_fetch_and_in_place():
    ctr = _own()
    pipe = _pipe(FAMILY_CFGS["sign"], placement="mesh", devices=_cpus(4),
                 counters=ctr)
    before = ctr.snapshot()
    pipe.run(3)
    delta = transfer.diff(ctr.snapshot(), before)
    assert delta == {"donated_blocks": 3, "donation_unused": 0,
                     "fetches": 1, "device_put": 0, "device_put_bytes": 0,
                     "reshard_mismatch": 0}
    assert pipe.fetches == 1


def test_mesh_sums_deterministic_and_resume_addresses_match_local():
    cfg = FAMILY_CFGS["sign"]
    a, _ = _pipe(cfg, placement="mesh", devices=_cpus(4)).run(2)
    b, _ = _pipe(cfg, placement="mesh", devices=_cpus(4)).run(2)
    assert a == b
    local = _pipe(cfg)
    mesh = _pipe(cfg, placement="mesh", devices=_cpus(2))
    assert _bits(local.block_detail(3)) == _bits(mesh.block_detail(3))
    assert mesh.run(1, start_block=3)[0] == pytest.approx(
        local.run(1, start_block=3)[0], rel=1e-5, abs=1e-5)


def test_local_pipeline_bit_equal_to_the_direct_computation():
    """The executor changed nothing on the local placement: each block is
    the chunked body over ``rep_keys(design_key(key, i))`` summed into f32
    accumulators, as the pipeline computed it before the plan layer."""
    cfg = FAMILY_CFGS["subg"]
    got, _ = _pipe(cfg).run(3, start_block=2)
    acc = torch.zeros(4)
    for i in range(2, 5):
        keys = rng.rep_keys(rng.design_key(rng.master_key(7), i), BLOCK_REPS)
        acc += torch.stack(sim.chunked(_rep_fn(cfg), keys, CHUNK)).sum(1)
    assert got == tuple(float(v) for v in acc)


def test_aot_pipeline_warms_once_and_keeps_the_sums():
    reg = Registry()
    cfg = FAMILY_CFGS["sign"]
    ctr = _own()
    pipe = _pipe(cfg, aot=True, counters=ctr,
                 observer=compile_mod.CompileObserver(reg))
    assert reg.get("dpcorr_compile_seconds").snapshot()["count"] == 1
    assert ctr.snapshot()["fetches"] == 0  # the warm run reads nothing
    assert pipe.run(2) == _pipe(cfg).run(2)


def _fused_body(n, rho, eps):
    """The fused replication body through K1's plain version: the
    kernel's in-kernel draws laid out as external uniforms."""
    _, k = sim.batch_geometry(n, *eps)

    def body(keys):
        seeds = rng.kernel_seeds(keys).contiguous()
        u = fused_ni.philox_uniforms(seeds, n, *eps)
        out = fused_ni.fused_ni_sums(seeds, rho, n, *eps, uniforms=u)
        return sim._metrics(fused_ni.ni_result(out[:, 0], out[:, 1], k,
                                               0.05), rho)

    return body


@pytest.mark.parametrize("n_dev", [1, 2])
def test_fused_body_through_the_executor(n_dev):
    body = _fused_body(600, 0.5, (1.0, 1.0))
    kw = dict(key=rng.master_key(3), block_reps=8, chunk_size=4,
              device="cpu", counters=_own())
    local = sim.RepBlockPipeline(body, 3, **kw)
    mesh = sim.RepBlockPipeline(body, 3, placement="mesh",
                                devices=_cpus(n_dev), **kw)
    assert _bits(local.block_detail(1)) == _bits(mesh.block_detail(1))
    direct = body(rng.rep_keys(rng.design_key(rng.master_key(3), 1), 8))
    assert _bits(local.block_detail(1)) == _bits(direct)
    np.testing.assert_allclose(mesh.run(2)[0], local.run(2)[0], rtol=1e-6)


def _jax_rep(cfg):
    jcfg = jsim.SimConfig(n=cfg.n, rho=cfg.rho, eps1=cfg.eps1,
                          eps2=cfg.eps2, dgp=cfg.dgp, use_subg=cfg.use_subg)

    def rep(k):
        row = jsim._one_rep(k, jnp.float32(cfg.rho), jcfg)
        return (row[0], row[1], row[8], row[9])

    return rep


@pytest.mark.parametrize("fam", sorted(FAMILY_CFGS))
def test_mesh_pipeline_matches_jax_mesh(fam):
    """Numpy-seeded root and ρ through both packages' mesh pipelines
    (JAX on two virtual CPU devices, the port on two CPU entries): sums
    within 1e-4 relative + 1e-5 absolute, per-rep outputs within 1e-5 on
    at least 98% of replications (``tests/test_torch_sim.py``'s
    tolerances)."""
    seed = int(np.random.default_rng(21).integers(1 << 20))
    rho = float(np.float32(np.random.default_rng(22).uniform(0.1, 0.5)))
    cfg = dataclasses.replace(FAMILY_CFGS[fam], rho=rho)
    jpipe = jsim.RepBlockPipeline(
        _jax_rep(cfg), 4, key=jrng.master_key(seed), block_reps=BLOCK_REPS,
        chunk_size=CHUNK, placement="mesh", mesh=rep_mesh(2), aot=False)
    pipe = sim.RepBlockPipeline(
        _rep_fn(cfg), 4, key=rng.master_key(seed), block_reps=BLOCK_REPS,
        chunk_size=CHUNK, placement="mesh", devices=_cpus(2), device="cpu",
        counters=_own())
    want, _ = jpipe.run(2, start_block=1)
    got, _ = pipe.run(2, start_block=1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    ok = np.ones(BLOCK_REPS, bool)
    for g, w in zip(pipe.block_detail(2), jpipe.block_detail(2)):
        ok &= np.isclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    assert ok.mean() >= 0.98


# -------------------------------------------------------- consumers ----
GRID = dict(n_grid=(200, 400), rho_grid=(0.0, 0.5),
            eps_pairs=((1.0, 1.0), (1.5, 0.5)), b=8, seed=11)


def test_grid_fetches_once_per_bucket_that_ran(tmp_path):
    tc = transfer.default_counters()
    kw = dict(GRID, backend="bucketed", device="cpu", out_dir=str(tmp_path))
    before = tc.snapshot()
    first = grid.run_grid(grid.GridConfig(**kw))
    assert transfer.diff(tc.snapshot(), before)["fetches"] == 4
    before = tc.snapshot()
    again = grid.run_grid(grid.GridConfig(**kw, resume=True))
    assert transfer.diff(tc.snapshot(), before)["fetches"] == 0
    for col, v in first.detail_all.items():
        np.testing.assert_array_equal(again.detail_all[col], v)


def test_sharded_grid_places_through_preshard():
    tc = transfer.default_counters()
    before = tc.snapshot()
    res = grid.run_grid(grid.GridConfig(**GRID, backend="bucketed-sharded",
                                        device="cpu"), devices=_cpus(3))
    assert transfer.diff(tc.snapshot(), before)["fetches"] == 4
    ref = grid.run_grid(grid.GridConfig(**GRID, backend="bucketed",
                                        device="cpu"))
    for col, v in ref.detail_all.items():
        np.testing.assert_array_equal(res.detail_all[col], v)


def test_fused_grid_buckets_through_the_plain_kernel(monkeypatch):
    """Every bucket fused on the CPU, K1 run as its plain version on the
    in-kernel draws: each bucket's detail is bit-equal to the direct
    ``sim_detail_fused`` on the same seeds, one fetch per bucket."""
    real = sim.sim_detail_fused
    calls = []

    def plain(seeds, rhos, n, eps1, eps2, **kw):
        calls.append(n)
        return real(seeds, rhos, n, eps1, eps2, uniforms=fused_ni
                    .philox_uniforms(seeds, n, eps1, eps2, compute_int=True),
                    **kw)

    monkeypatch.setattr(grid, "_fused_bucket_ok", lambda gcfg, cfg: "sign")
    monkeypatch.setattr(sim, "sim_detail_fused", plain)
    tc = transfer.default_counters()
    before = tc.snapshot()
    gcfg = grid.GridConfig(**GRID, backend="bucketed", fused="auto",
                           device="cpu")
    res = grid.run_grid(gcfg)
    assert transfer.diff(tc.snapshot(), before)["fetches"] == 4
    assert res.timings["fused"].all() and len(calls) == 4
    design, b = gcfg.design_points(), GRID["b"]
    master = rng.master_key(GRID["seed"])
    for n in GRID["n_grid"]:
        for e1, e2 in GRID["eps_pairs"]:
            pts = np.flatnonzero((design["n"] == n) & (design["eps1"] == e1)
                                 & (design["eps2"] == e2))
            keys = rng.rep_keys(rng.design_key(
                master, torch.from_numpy(design["i"][pts])), b).reshape(-1, 2)
            rhos = torch.tensor(design["rho"][pts],
                                dtype=torch.float32).repeat_interleave(b)
            want = plain(rng.kernel_seeds(keys).contiguous(), rhos, n, e1,
                         e2, device="cpu")
            rows = (pts[:, None] * b + np.arange(b)).ravel()
            for f, w in zip(sim.DETAIL_FIELDS, want, strict=True):
                assert res.detail_all[f][rows].tobytes() == \
                    w.numpy().tobytes(), f


@pytest.mark.parametrize("engine", ["exact", "vector"])
def test_finish_batch_one_unit_per_signature(engine):
    from dpcorr_torch.models.estimators import split_reference as sr

    x, y = np.random.default_rng(5).standard_normal((2, 300)).astype(
        np.float32)
    root = rng.master_key(5)
    keys = [rng.fold_in(root, j) for j in range(3)]
    rels = [sr.party_release("ni_sign", rng.fold_in(root, 10 + j), "y", y,
                             1.0, 0.5, device="cpu") for j in range(3)]
    ex = sr._plan_executor(torch.device("cpu"))
    n_units = len(ex._units)
    got = sr.finish_batch("ni_sign", keys, rels, [x] * 3, 1.0, 0.5,
                          engine=engine, device="cpu")
    again = sr.finish_batch("ni_sign", keys, rels, [x] * 3, 1.0, 0.5,
                            engine=engine, device="cpu")
    assert len(ex._units) == n_units + 1
    assert _bits(got) == _bits(again)
    if engine == "exact":
        direct = [sr.finish("ni_sign", k, r, x, 1.0, 0.5, device="cpu")
                  for k, r in zip(keys, rels)]
        want = [torch.stack([d[j] for d in direct]) for j in range(3)]
        assert _bits(got) == _bits(want)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_mesh_release_bit_equal_to_monolithic(n_dev):
    from dpcorr_torch.stream import sketch as sk

    params = sk.ReleaseParams(family="ni_sign", eps1=1.0, eps2=1.0,
                              target_chunk=64)
    xy = np.random.default_rng(3).normal(size=(300, 2)).astype(np.float32)
    wkey = sk.window_key(rng.master_key(12), "w-place")
    mp = plan.MeshPlacement(_cpus(n_dev))
    shards = sk.placement_shards(mp, sk.grid_for(params, 300).n_chunks)
    assert len(shards) == n_dev
    meshed = sk.release_window(xy, params, wkey, placement=mp, device="cpu")
    assert meshed == sk.release_window(xy, params, wkey, device="cpu")


def test_stream_service_placement_and_transfer_counts(tmp_path):
    """A service under a mesh placement (two CPU entries) releases the
    local service's bytes; each pass reads the host once."""
    from dpcorr_torch.stream.service import StreamService
    from dpcorr_torch.stream.windows import WindowSpec

    xy = np.random.default_rng(8).normal(size=(200, 2)).astype(np.float32)
    out, deltas = {}, {}
    for name, placement in (("local", "local"),
                            ("mesh", plan.MeshPlacement(_cpus(2)))):
        sv = StreamService(str(tmp_path / name), WindowSpec(size_s=1.0),
                           ["ni_sign", "int_subg"], 1.0, 0.5,
                           placement=placement, device="cpu")
        tc = transfer.default_counters()
        before = tc.snapshot()
        sv.ingest("b0", 0.5, xy.tolist())
        sv.ingest("b1", 5.0, [[0.0, 0.0]])  # closes the first window
        deltas[name] = transfer.diff(tc.snapshot(), before)
        out[name] = [e["releases"] for e in sv.journal.entries()]
        sv.close()
    assert out["mesh"] == out["local"] and len(out["local"]) == 1
    # ni_sign: pass A, moments, estimate, release; int_subg: estimate and
    # release. 200 rows are one chunk, so the mesh's partition is one shard
    # and reads as often as the local release
    assert deltas["local"]["fetches"] == deltas["mesh"]["fetches"] == 6
