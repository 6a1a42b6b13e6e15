"""The key-tree's rbg and unsafe_rbg implementations against jax.random.

Key words, raw bits and f32 uniforms are integer-exact, so the port's
rbg-family key-trees and draws must be bit-equal to JAX's *unbatched*
results (``jax.random.bits`` on one key at a time): the port draws each
key's own stream, where JAX's ``vmap`` of ``rng_bit_generator`` draws a
batch from its first key (pinned below). Normals go through
torch.erfinv: within 2e-5 relative, as the threefry tests hold them.
Estimators on top agree with the JAX package's unbatched replication to
1e-5 absolute (sign ties aside). Also: the process impl
(``DPCORR_PRNG``), the grid's stamp and resume, the kernel's plain
version, and the Monte-Carlo path's entry points honouring a non-default
impl (the other paths: ``tests/test_torch_rbg_paths.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpcorr.sim as jsim
from dpcorr.utils import rng as jrng
from dpcorr_torch import acceptance, chaos, grid, interop, parallel, rbridge
from dpcorr_torch import sim
from dpcorr_torch.models.dgp import normal
from dpcorr_torch.ops import rbg as rbg_op
from dpcorr_torch.parallel import multihost
from dpcorr_torch.utils import rng

RBG = ("rbg", "unsafe_rbg")
CARRY = [5, 0xFFFFFFFF, 0xFFFFFFFE, 0xFFFFFFFF]
SIGN_GRID = dict(n_grid=(200,), rho_grid=(0.0, 0.5), eps_pairs=((1.0, 1.0),),
                 b=8, seed=11)


@pytest.fixture(params=RBG)
def impl(request, monkeypatch):
    monkeypatch.setenv("DPCORR_PRNG", request.param)
    return request.param


@pytest.fixture
def rbg_env(monkeypatch):
    monkeypatch.setenv("DPCORR_PRNG", "rbg")


def _words(jax_keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(jax_keys)).astype(np.int64)


def _jbits(jk, shape) -> np.ndarray:
    return np.asarray(jax.random.bits(jk, shape)).astype(np.int64)


# ------------------------------------------------------------ key-tree ----

@pytest.mark.parametrize("seed", [0, 2025, 2**31 - 1, 2**32 + 7])
def test_master_key_bit_equal(impl, seed):
    jk = jrng.master_key(seed & 0xFFFFFFFF, impl=impl)
    np.testing.assert_array_equal(rng.master_key(seed).numpy(), _words(jk))
    np.testing.assert_array_equal(rng.master_key(seed, impl=impl).numpy(),
                                  _words(jk))


@pytest.mark.parametrize("design,name", [(0, "dgp"),
                                         (123456, "int_sign/flips")])
def test_key_tree_bit_equal(impl, design, name):
    jm, pm = jrng.master_key(2025, impl=impl), rng.master_key(2025)
    jd, pd = jrng.design_key(jm, design), rng.design_key(pm, design)
    np.testing.assert_array_equal(pd.numpy(), _words(jd))
    np.testing.assert_array_equal(rng.chunk_key(pm, design).numpy(),
                                  _words(jrng.chunk_key(jm, design)))
    js, ps = jrng.stream(jd, name), rng.stream(pd, name)
    np.testing.assert_array_equal(ps.numpy(), _words(js))
    np.testing.assert_array_equal(rng.split(ps, 5).numpy(),
                                  _words(jax.random.split(js, 5)))
    for role in ("x", "y"):
        for mode in ("replay", "hardened"):
            np.testing.assert_array_equal(
                rng.party_root(ps, role, mode).numpy(),
                _words(jrng.party_root(js, role, mode)))
    np.testing.assert_array_equal(
        rng.column_root(ps, "age").numpy(),
        _words(jrng.column_root(js, "age")))


@pytest.mark.parametrize("start", [0, 1000])
def test_rep_keys_bit_equal_to_unbatched_fold_in(impl, start):
    jm, pm = jrng.master_key(9, impl=impl), rng.master_key(9)
    want = np.stack([_words(jax.random.fold_in(jm, start + b))
                     for b in range(6)])
    np.testing.assert_array_equal(
        rng.rep_keys_slice(pm, start, 6).numpy(), want)
    if start == 0:
        np.testing.assert_array_equal(rng.rep_keys(pm, 6).numpy(), want)
    # a batch of keys: each one's stream in one call
    batch = rng.design_key(pm, torch.tensor([3, 0, 41]))
    got = rng.rep_keys_slice(batch, start, 4)
    for p, i in enumerate((3, 0, 41)):
        jd = jax.random.fold_in(jm, i)
        np.testing.assert_array_equal(got[p].numpy(), np.stack(
            [_words(jax.random.fold_in(jd, start + b)) for b in range(4)]))


def test_rbg_halves_are_threefry_keys(rbg_env):
    """rbg's fold_in and split are threefry on each half: both halves of a
    key equal the threefry key at the same address."""
    key = rng.stream(rng.design_key(rng.master_key(3), 5), "ni")
    tf = rng.stream(rng.design_key(rng.master_key(3, impl="threefry2x32"),
                                   5), "ni")
    np.testing.assert_array_equal(key[:2].numpy(), tf.numpy())
    np.testing.assert_array_equal(key[2:].numpy(), tf.numpy())


# ---------------------------------------------------------------- bits ----

@pytest.mark.parametrize("shape", [(), (1,), (10,), (3, 5), (4096,)])
def test_bits_and_uniform_bit_equal(impl, shape):
    jk = jrng.stream(jrng.design_key(jrng.master_key(2025, impl=impl), 7),
                     "ni")
    pk = rng.stream(rng.design_key(rng.master_key(2025), 7), "ni")
    np.testing.assert_array_equal(rng.random_bits(pk, shape).numpy(),
                                  _jbits(jk, shape))
    for lo, hi in ((0.0, 1.0), (-3.0, 5.5)):
        ju = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
        pu = rng.uniform(pk, shape, lo, hi).numpy()
        np.testing.assert_array_equal(pu.view(np.int32), ju.view(np.int32))


def test_bits_of_a_carry_crossing_key(impl):
    """The low counter half at 2⁶⁴ − 2: blocks 2 on carry into the high
    half."""
    jk = jax.random.wrap_key_data(jnp.array(CARRY, jnp.uint32), impl=impl)
    pk = interop.keys_from_jax_data(np.array(CARRY, np.uint32))
    np.testing.assert_array_equal(rng.random_bits(pk, (40,)).numpy(),
                                  _jbits(jk, (40,)))
    np.testing.assert_array_equal(
        rbg_op.rbg_bits(pk[None], 40).numpy()[0], _jbits(jk, (40,)))


def test_batched_bits_are_per_key(impl):
    jks = jax.random.split(jrng.master_key(4, impl=impl), 5)
    pks = interop.keys_from_jax_data(np.asarray(jax.random.key_data(jks)))
    got = rng.random_bits(pks.reshape(5, 1, -1), (3, 7)).numpy()
    for i in range(5):
        np.testing.assert_array_equal(got[i, 0], _jbits(jks[i], (3, 7)))


def test_jax_vmap_draws_from_the_first_key_the_port_does_not(impl):
    """JAX's batching rule for rng_bit_generator: vmapped bits of B keys
    equal the first key's draw of shape (B, *s). The port draws per key."""
    jks = jax.random.split(jrng.master_key(6, impl=impl), 4)
    vm = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (9,)))(jks))
    np.testing.assert_array_equal(vm, np.asarray(jax.random.bits(jks[0],
                                                                 (4, 9))))
    per = np.stack([_jbits(jks[i], (9,)) for i in range(4)])
    assert not np.array_equal(vm.astype(np.int64), per)
    np.testing.assert_array_equal(vm[0].astype(np.int64), per[0])
    pks = interop.keys_from_jax_data(np.asarray(jax.random.key_data(jks)))
    np.testing.assert_array_equal(rng.random_bits(pks, (9,)).numpy(), per)


def test_normal_within_tolerance(impl):
    jk = jrng.stream(jrng.master_key(1, impl=impl), "dgp")
    pk = rng.stream(rng.master_key(1), "dgp")
    jz = np.asarray(jax.random.normal(jk, (1 << 14, 2), jnp.float32))
    pz = normal(pk, (1 << 14, 2)).numpy()
    assert (np.sign(pz) == np.sign(jz)).all()
    np.testing.assert_allclose(pz, jz, rtol=2e-5, atol=1e-6)


def test_samplers_bit_equal(impl):
    jk = jrng.stream(jrng.master_key(8, impl=impl), "int")
    pk = rng.stream(rng.master_key(8), "int")
    np.testing.assert_array_equal(rng.permutation(pk, 300).numpy(),
                                  np.asarray(jax.random.permutation(jk, 300)))
    np.testing.assert_array_equal(
        rng.randint(pk, (50,), -3, 70000).numpy(),
        np.asarray(jax.random.randint(jk, (50,), -3, 70000)))
    np.testing.assert_array_equal(
        rng.bernoulli(pk, 0.3, (64,)).numpy(),
        np.asarray(jax.random.bernoulli(jk, 0.3, (64,))))


@pytest.mark.parametrize("offset,stride,words", [(0, 1, 13), (9, 1, 4),
                                                 (0, 10, 12), (3, 2, 1)])
def test_plain_generator_blocks(offset, stride, words):
    """The plain version's block b is Philox on counter start + offset +
    b·stride: unsafe_rbg's fold_in block and split blocks are slices of
    the key's own draw."""
    keys = torch.tensor([CARRY, [0, 7, 0, 7]], dtype=torch.int64)
    full = rbg_op.rbg_bits_plain(keys, 4 * (offset + stride * 4))
    got = rbg_op.rbg_bits(keys, words, offset, stride)
    blocks = full.reshape(2, -1, 4)[:, offset::stride].reshape(2, -1)
    np.testing.assert_array_equal(got.numpy(), blocks[:, :words].numpy())
    assert rbg_op.rbg_bits(keys, 0).shape == (2, 0)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError, match="int64"):
        rbg_op.rbg_bits(torch.zeros(2, 4, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match=r"\(K, 4\)"):
        rbg_op.rbg_bits(torch.zeros(2, 2, dtype=torch.int64), 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        rbg_op.rbg_bits(torch.zeros(2, 4, dtype=torch.int64,
                                    device="meta"), 4)


# --------------------------------------------- impls, tags and refusals ----

def test_impl_tag_follows_the_process_impl(monkeypatch):
    monkeypatch.delenv("DPCORR_PRNG", raising=False)
    assert rng.impl_tag() == "threefry2x32-torch"
    assert rng.master_key().shape == (2,)
    for name in ("threefry2x32", *RBG):
        monkeypatch.setenv("DPCORR_PRNG", name)
        assert rng.impl_tag() == f"{name}-torch"
    monkeypatch.setenv("DPCORR_PRNG", "")
    assert rng.impl_tag() == "threefry2x32-torch"


def test_unknown_impls_and_the_rbg_mismatch_raise(monkeypatch):
    monkeypatch.delenv("DPCORR_PRNG", raising=False)
    with pytest.raises(ValueError, match="unknown PRNG impl"):
        rng.master_key(impl="philox")
    with pytest.raises(ValueError, match="read as 'rbg'"):
        rng.master_key(impl="unsafe_rbg")
    assert rng.master_key(impl="rbg").shape == (4,)
    with pytest.raises(ValueError, match="read as 'rbg'"):
        rng.keys_from_data(np.zeros(4, np.uint32), impl="unsafe_rbg")
    with pytest.raises(ValueError, match="4 words"):
        rng.keys_from_data(np.zeros(2, np.uint32), impl="rbg")
    with pytest.raises(ValueError, match="2 .threefry2x32. or 4"):
        rng.keys_from_data(np.zeros(3, np.uint32))
    monkeypatch.setenv("DPCORR_PRNG", "unsafe_rbg")
    with pytest.raises(ValueError, match="read as 'unsafe_rbg'"):
        rng.master_key(impl="rbg")
    assert rng.master_key(impl="threefry2x32").shape == (2,)
    monkeypatch.setenv("DPCORR_PRNG", "bogus")
    with pytest.raises(ValueError, match="unknown PRNG impl 'bogus'"):
        rng.master_key()
    with pytest.raises(ValueError, match="unknown PRNG impl"):
        rng.impl_tag()


def test_key_data_round_trip_four_words(impl):
    jk = jrng.rep_keys(jrng.master_key(9, impl=impl), 3)
    words = np.asarray(jax.random.key_data(jk))
    pk = interop.keys_from_jax_data(words)
    np.testing.assert_array_equal(rng.keys_from_data(words, impl).numpy(),
                                  words.astype(np.int64))
    np.testing.assert_array_equal(rng.key_data(pk).numpy(),
                                  words.astype(np.int64))
    np.testing.assert_array_equal(interop.keys_to_jax_data(pk), words)
    back = jrng.keys_from_data(jnp.asarray(interop.keys_to_jax_data(pk)),
                               impl)
    np.testing.assert_array_equal(_words(back), words.astype(np.int64))
    np.testing.assert_array_equal(rng.keys_from_data(words).numpy(),
                                  words.astype(np.int64))


def test_kernel_seeds_come_from_the_impl(impl, monkeypatch):
    """Four-word keys draw their two seed words through their own
    generator (the JAX package's seeds are drawn through the impl too),
    never their threefry halves; two-word keys keep their words."""
    jm = jrng.master_key(5, impl=impl)
    keys = rng.rep_keys(rng.master_key(5), 4)
    seeds = rng.kernel_seeds(keys)
    assert seeds.dtype == torch.int32 and seeds.shape == (4, 2)
    want = np.stack([_jbits(jrng.stream(jax.random.fold_in(jm, i),
                                        "fused_ni/seed"), (2,))
                     for i in range(4)])
    np.testing.assert_array_equal(seeds.numpy().view(np.uint32), want)
    monkeypatch.delenv("DPCORR_PRNG")
    tf = rng.rep_keys(rng.master_key(5), 4)
    tf_seeds = rng.kernel_seeds(tf)
    np.testing.assert_array_equal(
        tf_seeds.numpy().view(np.uint32),
        rng.stream(tf, "fused_ni/seed").numpy().astype(np.uint32))
    assert not np.array_equal(tf_seeds.numpy(), seeds.numpy())


# ------------------------------------------------- the Monte-Carlo path ----

def test_one_rep_matches_jax_unbatched(impl):
    kw = dict(n=1024, rho=0.5, eps1=1.0, eps2=1.0, b=16)
    jm = jrng.master_key(5, impl=impl)
    one = jax.jit(lambda k: jsim._one_rep(k, jnp.float32(0.5),
                                          jsim.SimConfig(**kw)))
    want = np.stack([np.asarray(one(jax.random.fold_in(jm, b)))
                     for b in range(16)], 1)
    got = np.stack([v.numpy() for v in sim._one_rep(
        rng.rep_keys(rng.master_key(5), 16), 0.5, sim.SimConfig(**kw))])
    ok = np.isclose(got, want, rtol=0, atol=1e-5).all(0)
    assert ok.mean() >= 15 / 16


def test_sign_pipeline_rbg_in_the_band_in_both_packages(rbg_env):
    """Mirror of tests/test_sim.py's rbg run: b = 400, n = 2000; the JAX
    package's vmapped draws and the port's per-key draws are different
    replications, so the check is statistical."""
    b = 400
    lo, hi = 0.95 - 3.5 * np.sqrt(0.95 * 0.05 / b), 1.0
    kw = dict(n=2000, rho=0.5, eps1=1.0, eps2=1.0, b=b)
    want = jsim.run_sim_one(jsim.SimConfig(**kw),
                            key=jrng.master_key(impl="rbg"))
    got = sim.run_sim_one(sim.SimConfig(**kw), device="cpu")
    tf = sim.run_sim_one(sim.SimConfig(**kw),
                         key=rng.master_key(impl="threefry2x32"),
                         device="cpu")
    for res in (want, got):
        for meth in ("NI", "INT"):
            assert lo <= res.summary[meth]["coverage"] <= min(hi, 0.99 +
                                                               0.01)
            assert abs(res.summary[meth]["bias"]) < 0.06
    assert not np.array_equal(got.detail["ni_hat"].numpy(),
                              tf.detail["ni_hat"].numpy())


def test_results_do_not_depend_on_chunk_width(impl):
    kw = dict(n=200, rho=0.5, eps1=1.0, eps2=1.0, b=9)
    a = sim.run_sim_one(sim.SimConfig(**kw, chunk_size=2), device="cpu")
    b = sim.run_sim_one(sim.SimConfig(**kw, chunk_size=7), device="cpu")
    for name in sim.DETAIL_FIELDS:
        torch.testing.assert_close(a.detail[name], b.detail[name], rtol=0,
                                   atol=0)


def test_rep_block_pipeline_impl(impl, monkeypatch):
    kw = dict(n=300, rho=0.5, eps1=1.0, eps2=1.0, b=8)
    body = sim.ni_rep_fn(300, 0.5, 1.0, 1.0)
    key = rng.master_key(3)
    pipe = sim.RepBlockPipeline(body, 3, key=key, block_reps=8,
                                chunk_size=3, device="cpu", aot=True)
    assert pipe.impl == impl
    wide = sim.RepBlockPipeline(body, 3, key=key, block_reps=8,
                                chunk_size=8, device="cpu")
    for x, y in zip(pipe.block_detail(1), wide.block_detail(1)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    sums, n = pipe.run(2)
    keys = torch.cat([rng.rep_keys(rng.design_key(key, i), 8)
                      for i in range(2)])
    want = [float(v.sum()) for v in body(keys)]
    np.testing.assert_allclose(sums, want, rtol=1e-5)
    assert n == 16
    with pytest.raises(ValueError, match="4 words"):
        sim.RepBlockPipeline(body, 3, key=key, block_reps=8, chunk_size=8,
                             device="cpu", impl="threefry2x32")
    with pytest.raises(ValueError, match="read as"):
        sim.RepBlockPipeline(body, 3, key=key, block_reps=8, chunk_size=8,
                             device="cpu", impl=[i for i in RBG
                                                 if i != impl][0])
    del kw


def test_grid_stamps_and_resume_refuses_to_mix(impl, tmp_path,
                                               monkeypatch):
    out = str(tmp_path)
    first = grid.run_grid(grid.GridConfig(**SIGN_GRID, device="cpu",
                                          backend="bucketed", out_dir=out))
    with np.load(tmp_path / "design_00000.npz") as d:
        assert str(d["config_stamp"]).endswith(f"|prng={impl}-torch")
    local = grid.run_grid(grid.GridConfig(**SIGN_GRID, device="cpu",
                                          backend="local"))
    for col, v in first.detail_all.items():
        np.testing.assert_array_equal(local.detail_all[col], v)
    # a resume under threefry loads none of these points
    monkeypatch.delenv("DPCORR_PRNG")
    again = grid.run_grid(grid.GridConfig(**SIGN_GRID, device="cpu",
                                          backend="bucketed", out_dir=out))
    assert again.timings["points_run"].sum() == 2
    fresh = grid.run_grid(grid.GridConfig(**SIGN_GRID, device="cpu",
                                          backend="bucketed"))
    for col, v in fresh.detail_all.items():
        np.testing.assert_array_equal(again.detail_all[col], v)
    assert not np.array_equal(fresh.detail_all["ni_hat"],
                              first.detail_all["ni_hat"])


def test_fan_out_and_r_seam_honour_the_impl(rbg_env, tmp_path):
    gcfg = grid.GridConfig(**SIGN_GRID, device="cpu", backend="bucketed",
                           out_dir=str(tmp_path))
    assert multihost.run_grid_host(gcfg, 0, 1) == 2
    merged = grid.run_grid(gcfg)
    assert merged.timings["points_run"].sum() == 0
    plain = grid.run_grid(grid.GridConfig(**SIGN_GRID, device="cpu"))
    rows = [{"n": 200, "rho": r, "eps1": 1.0, "eps2": 1.0}
            for r in (0.0, 0.5)]
    seam = rbridge.run_design_rows(rows, b=8, seed=11, device="cpu")
    for col, v in plain.detail_all.items():
        np.testing.assert_array_equal(merged.detail_all[col], v)
        np.testing.assert_array_equal(seam[col], v)
    cfg = sim.SimConfig(n=200, rho=0.5, eps1=1.0, eps2=1.0, b=8, seed=4)
    shard = parallel.run_detail_sharded(cfg, device="cpu",
                                        devices=[torch.device("cpu")] * 2)
    one = sim.run_sim_one(cfg, device="cpu")
    for name in sim.DETAIL_FIELDS:
        torch.testing.assert_close(shard.detail[name], one.detail[name],
                                   rtol=0, atol=0)


def test_acceptance_campaign_runs_on_the_impl(rbg_env):
    cfg = sim.SimConfig(n=200, rho=0.5, eps1=1.0, eps2=1.0, b=8,
                        chunk_size=8)
    out = acceptance._coverage_run(cfg, 16, 8, device="cpu")
    key = rng.master_key(cfg.seed)
    assert key.shape == (4,)
    rows = [sim._one_rep(rng.rep_keys(rng.design_key(key, i), 8), 0.5, cfg)
            for i in range(2)]
    cover = torch.cat([r[sim.DETAIL_FIELDS.index("ni_cover")]
                       for r in rows]).mean()
    assert out["b"] == 16
    assert out["NI"]["coverage"] == pytest.approx(float(cover), abs=1e-6)


# ------------------------------------------------- small parity gaps ----

def test_summary_rows_match_jax():
    kw = dict(n=300, rho=0.5, eps1=1.0, eps2=1.0, b=16)
    res = sim.run_sim_one(sim.SimConfig(**kw), device="cpu")
    got = res.summary_rows()
    want = jsim.SimResult({}, res.summary, None).summary_rows()
    assert got == want
    assert [list(r) for r in got] == [["method", "mse", "bias", "var",
                                       "coverage", "ci_length"]] * 2
    assert [r["method"] for r in got] == ["NI", "INT"]


def test_active_faults_match_jax():
    from dpcorr import chaos as jchaos

    chaos.clear_faults()
    jchaos.clear_faults()
    try:
        assert chaos.active_faults() == [] == jchaos.active_faults()
        for spec in ("point=serve.kernel_slow,mode=sleep,delay_ms=40",
                     "point=serve.kernel,mode=fail,times=3"):
            chaos.install_fault(chaos.fault_from_spec(spec))
            jchaos.install_fault(jchaos.fault_from_spec(spec))
        got, want = chaos.active_faults(), jchaos.active_faults()
        fields = ("point", "mode", "times", "delay_s", "after")
        assert [[getattr(p, f) for f in fields] for p in got] == \
            [[getattr(p, f) for f in fields] for p in want]
        got.clear()
        assert len(chaos.active_faults()) == 2  # a copy
    finally:
        chaos.clear_faults()
        jchaos.clear_faults()


def test_rep_mesh_is_rep_devices():
    from dpcorr.parallel import rep_mesh as jax_rep_mesh

    assert parallel.rep_mesh(device="cpu") == parallel.rep_devices(
        device="cpu") == [torch.device("cpu")]
    assert parallel.rep_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    assert jax_rep_mesh(1).axis_names == ("rep",)
