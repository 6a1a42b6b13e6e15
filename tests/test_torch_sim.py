"""The port's replication path as a whole against dpcorr.sim.

Same master key, same per-replication addresses: the port's per-rep
detail agrees with the JAX simulator field by field (1e-5 absolute for
at least 98% of replications on the Gaussian sign path, where the rest
are centered values at a sign tie, and 99% on the sub-Gaussian
families, the other DGPs and the streaming bodies), and the block
pipeline's sums agree on the bench body and the subG body. Also: the
port imports nothing of JAX or the JAX package, and its entry points
raise without a device instead of running on the CPU.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpcorr.sim as jsim
from dpcorr.models.dgp import gen_gaussian as jax_gen
from dpcorr.models.estimators import ci_ni_signbatch as jax_ci_ni
from dpcorr.utils import rng as jrng
from dpcorr_torch import sim
from dpcorr_torch.models.estimators import k_pad_for
from dpcorr_torch.ops import fused_ni
from dpcorr_torch.utils import rng

REPO = pathlib.Path(__file__).resolve().parents[1]
N, RHO = 1024, 0.5


def _close_fraction(got: dict, want: dict) -> float:
    ok = np.ones(len(want["ni_hat"]), bool)
    for name in sim.DETAIL_FIELDS:
        ok &= np.isclose(got[name].numpy(), np.asarray(want[name]), rtol=0,
                         atol=1e-5)
    return ok.mean()


@pytest.mark.parametrize("eps,dgp_args", [
    ((1.0, 1.0), ()),
    ((1.5, 0.5), (("mu", (0.5, -0.25)), ("sigma", (2.0, 0.5)))),
])
def test_one_rep_detail_matches_jax(eps, dgp_args):
    kw = dict(n=N, rho=RHO, eps1=eps[0], eps2=eps[1], b=64, chunk_size=32,
              dgp_args=dgp_args)
    want = jsim.run_sim_one(jsim.SimConfig(**kw))
    got = sim.run_sim_one(sim.SimConfig(**kw), device="cpu")
    assert _close_fraction(got.detail, want.detail) >= 0.98
    for meth in ("NI", "INT"):
        g, w = got.summary[meth], want.summary[meth]
        se = np.sqrt(w["var"] / 64)
        assert abs(g["bias"] - w["bias"]) < se
        assert abs(g["mse"] - w["mse"]) < 0.1 * w["mse"]
        assert abs(g["coverage"] - w["coverage"]) <= 2 / 64
        assert abs(g["ci_length"] - w["ci_length"]) < 0.02 * w["ci_length"]


def test_results_do_not_depend_on_chunk_width():
    cfg = dict(n=N, rho=RHO, eps1=1.0, eps2=1.0, b=20)
    a = sim.run_sim_one(sim.SimConfig(chunk_size=20, **cfg), device="cpu")
    b = sim.run_sim_one(sim.SimConfig(chunk_size=1, **cfg), device="cpu")
    c = sim.run_sim_one(sim.SimConfig(chunk_size=7, **cfg), device="cpu")
    for name in sim.DETAIL_FIELDS:
        torch.testing.assert_close(a.detail[name], b.detail[name], rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(a.detail[name], c.detail[name], rtol=0,
                                   atol=1e-6)


def _jax_bench_rep(key):
    xy = jax_gen(jrng.stream(key, "dgp"), N, jnp.float32(RHO))
    r = jax_ci_ni(jrng.stream(key, "ni"), xy[:, 0], xy[:, 1], 1.0, 1.0,
                  alpha=0.05)
    cover = ((RHO >= r.ci_low) & (RHO <= r.ci_high)).astype(jnp.float32)
    return (r.rho_hat - RHO) ** 2, cover, r.ci_high - r.ci_low


def test_rep_block_pipeline_matches_jax():
    jpipe = jsim.RepBlockPipeline(_jax_bench_rep, 3, key=jrng.master_key(),
                                  block_reps=48, chunk_size=16, aot=False)
    want, n_want = jpipe.run(2, start_block=1)
    pipe = sim.RepBlockPipeline(sim.ni_rep_fn(N, RHO, 1.0, 1.0), 3,
                                key=rng.master_key(), block_reps=48,
                                chunk_size=16, device="cpu")
    got, n_got = pipe.run(2, start_block=1)
    assert n_got == n_want == 96
    assert pipe.fetches == 1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # per-rep outputs of a block, at the same addresses
    jd = jpipe.block_detail(2)
    pd = pipe.block_detail(2)
    ok = np.ones(48, bool)
    for g, w in zip(pd, jd):
        ok &= np.isclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    assert ok.mean() >= 0.98


def test_pipeline_marks_its_stages():
    """``sim.stage`` around the block's stages: host seconds per stage
    inside ``stage_host_seconds``, a ``torch.profiler`` range per stage
    while the profiler records, nothing otherwise; the sums are the same
    either way."""
    pipe = sim.RepBlockPipeline(sim.ni_rep_fn(N, RHO, 1.0, 1.0), 3,
                                key=rng.master_key(), block_reps=16,
                                chunk_size=8, device="cpu")
    plain = pipe.run(2)
    with sim.stage_host_seconds() as seconds:
        timed = pipe.run(2)
    assert timed == plain
    # the key-tree's own range (the unfused body draws outside any stage)
    # and the run's one read are timed too
    assert set(seconds) == {"rep_keys", "accumulate", "keytree",
                            "host_read"}
    assert all(v > 0 for v in seconds.values())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pipe.run(1)
    names = [ev.name for ev in prof.events() if ev.name in sim.FUSED_STAGES]
    # keys for this block and the next; two chunks' copies and one add
    assert sorted(names) == ["accumulate"] * 3 + ["rep_keys"] * 2
    with sim.stage("rep_keys") as inside:
        assert inside is None


def _imports(path: pathlib.Path, in_functions: bool = True):
    """Modules ``path`` imports; with ``in_functions=False`` only those
    imported outside any function body."""
    tree = ast.parse(path.read_text(), filename=str(path))
    skip = set()
    if not in_functions:
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                skip.update(id(n) for n in ast.walk(fn))
    for node in ast.walk(tree):
        if id(node) in skip:
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


#: the one exemption: the figures import matplotlib inside the functions
#: that draw (the card's machine has none and draws nothing)
FIGURES = REPO / "dpcorr_torch" / "report.py"


def test_port_imports_neither_jax_nor_dpcorr():
    """Nor pandas or matplotlib, which the card's machine does not have;
    ``report.py`` may import matplotlib inside a function only."""
    files = sorted((REPO / "dpcorr_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py",
              REPO / "r" / "validate_bridge_torch_helper.py"]
    assert len(files) > 10
    assert REPO / "dpcorr_torch" / "grid.py" in files
    assert REPO / "dpcorr_torch" / "serve" / "server.py" in files
    assert REPO / "dpcorr_torch" / "chaos.py" in files
    for mod in ("utils/geometry.py", "utils/roofline.py",
                "utils/profiling.py", "utils/doctor.py", "obs/prof.py",
                "obs/devicemon.py", "obs/hlo.py", "obs/trajectory.py",
                "obs/console.py", "obs/provenance.py", "obs/sentinel.py"):
        assert REPO / "dpcorr_torch" / mod in files
    assert FIGURES in files
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "dpcorr", "pandas"), \
                (path, mod)
            if path != FIGURES:
                assert top != "matplotlib", (path, mod)
        if path == FIGURES:
            assert "matplotlib" in {m.split(".")[0] for m in _imports(path)}
            assert "matplotlib" not in {
                m.split(".")[0] for m in _imports(path, in_functions=False)}


def test_entry_points_raise_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = sim.SimConfig(n=N, rho=RHO, eps1=1.0, eps2=1.0, b=4)
    seeds = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.run_sim_one(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.RepBlockPipeline(sim.ni_rep_fn(N, RHO, 1.0, 1.0), 3,
                             key=rng.master_key(), block_reps=4,
                             chunk_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.sim_detail_fused(seeds, RHO, N, 1.0, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fused_ni.ni_sign_fused(seeds, RHO, N, 1.0, 1.0)


@pytest.mark.parametrize("kw", [dict(use_subg=True),
                                dict(stream_n_chunk=256),
                                dict(dgp="bounded_factor"),
                                dict(mixquant_mode="mc")])
def test_sim_config_runs_every_path(kw):
    """Every path of the JAX simulator is ported now: each of these once
    refused configurations constructs and runs a b = 4 design point."""
    cfg = sim.SimConfig(n=N, rho=RHO, eps1=1.0, eps2=1.0, b=4, **kw)
    res = sim.run_sim_one(cfg, device="cpu")
    for name in sim.DETAIL_FIELDS:
        assert res.detail[name].shape == (4,)
        assert torch.isfinite(res.detail[name]).all()


@pytest.mark.parametrize("kw,match", [
    (dict(subg_variant="other"), "subg_variant"),
    (dict(use_subg=True, subg_variant="real", stream_n_chunk=256),
     "streaming"),
])
def test_sim_config_refuses_what_jax_refuses(kw, match):
    for mod in (jsim, sim):
        with pytest.raises(ValueError, match=match):
            mod.SimConfig(n=N, rho=RHO, eps1=1.0, eps2=1.0, **kw)


#: the JAX pipeline test's subG configurations (tests/test_pipeline.py),
#: the other DGPs under the sign pair, and the streaming bodies
SUBG = dict(n=400, rho=0.5, eps1=1.0, eps2=1.0, dgp="bounded_factor",
            use_subg=True)
DETAIL_CONFIGS = {
    "subg-grid": SUBG,
    "subg-real": dict(SUBG, subg_variant="real"),
    "subg-grid-mc": dict(SUBG, eps1=1.5, eps2=0.5, mixquant_mode="mc"),
    "subg-real-mc": dict(SUBG, subg_variant="real", mixquant_mode="mc",
                         eta1=0.8),
    "mix_gaussian": dict(SUBG, use_subg=False, dgp="mix_gaussian"),
    "bernoulli": dict(SUBG, use_subg=False, dgp="bernoulli",
                      mixquant_mode="mc"),
    "stream-subg": dict(SUBG, n=4096, stream_n_chunk=1024),
    "stream-sign": dict(SUBG, n=4096, use_subg=False, dgp="gaussian",
                        stream_n_chunk=1024),
}


def _detail_close(got: dict, want: dict) -> np.ndarray:
    """Per replication: every field within 1e-5 absolute. The squared
    errors ``*_se2`` = (ρ̂−ρ)² magnify ρ̂'s last bits by 2|ρ̂−ρ|, which
    reaches 10 for NI subG at n = 400, so they also get 1e-6 relative."""
    ok = np.ones(len(want["ni_hat"]), bool)
    for name in sim.DETAIL_FIELDS:
        rtol = 1e-6 if name.endswith("se2") else 0.0
        ok &= np.isclose(got[name].numpy(), np.asarray(want[name]),
                         rtol=rtol, atol=1e-5)
    return ok


@pytest.mark.parametrize("name", sorted(DETAIL_CONFIGS))
def test_one_rep_detail_matches_jax_every_family(name):
    kw = dict(DETAIL_CONFIGS[name], b=128, chunk_size=64)
    want = jsim.run_sim_one(jsim.SimConfig(**kw))
    got = sim.run_sim_one(sim.SimConfig(**kw), device="cpu")
    assert _detail_close(got.detail, want.detail).mean() >= 0.99


@pytest.mark.parametrize("variant", ["grid", "real"])
def test_eps_merged_body_matches_jax(variant):
    """Per-replication ε with k_pad (the grid's ε-merged body): one call
    over replications at four ε pairs."""
    cfg = sim.SimConfig(**dict(SUBG, subg_variant=variant, b=64))
    jcfg = jsim.SimConfig(**dict(SUBG, subg_variant=variant, b=64, rho=0.0,
                                 seed=0))
    e1 = np.tile(np.array([2.0, 1.5, 1.0, 1.1547], np.float32), 16)
    e2 = np.tile(np.array([1.0, 0.5, 1.0, 1.1547], np.float32), 16)
    rhos = np.linspace(0.05, 0.9, 64).astype(np.float32)
    k_pad = k_pad_for(cfg.n, set((e1 * e2).tolist()))
    jkeys = jrng.rep_keys(jrng.master_key(), 64)
    want = jsim._run_detail_flat_eps(jcfg, jkeys, jnp.asarray(rhos),
                                     jnp.asarray(e1), jnp.asarray(e2), k_pad)
    got = sim._one_rep(rng.rep_keys(rng.master_key(), 64),
                       torch.from_numpy(rhos), cfg,
                       eps=(torch.from_numpy(e1), torch.from_numpy(e2)),
                       k_pad=k_pad)
    ok = _detail_close(dict(zip(sim.DETAIL_FIELDS, got)),
                       dict(zip(sim.DETAIL_FIELDS, want)))
    assert ok.mean() >= 0.99
    two = rng.rep_keys(rng.master_key(), 2)
    with pytest.raises(ValueError, match="sub-Gaussian"):
        sim._one_rep(two, 0.5, sim.SimConfig(n=64, rho=0.5, eps1=1.0,
                                             eps2=1.0),
                     eps=(torch.ones(2), torch.ones(2)))
    with pytest.raises(ValueError, match="streaming"):
        sim._one_rep(two, 0.5, sim.SimConfig(**SUBG, stream_n_chunk=128),
                     eps=(torch.ones(2), torch.ones(2)))


def test_rep_block_pipeline_matches_jax_on_the_subg_body():
    jcfg = jsim.SimConfig(**dict(SUBG, rho=0.0, seed=0))
    jpipe = jsim.RepBlockPipeline(
        lambda k: jsim._one_rep(k, jnp.float32(0.5), jcfg),
        len(jsim.DETAIL_FIELDS), key=jrng.master_key(), block_reps=48,
        chunk_size=16, aot=False)
    want, _ = jpipe.run(2, start_block=1)
    cfg = sim.SimConfig(**SUBG)
    pipe = sim.RepBlockPipeline(lambda k: sim._one_rep(k, 0.5, cfg),
                                len(sim.DETAIL_FIELDS),
                                key=rng.master_key(), block_reps=48,
                                chunk_size=16, device="cpu")
    got, n_reps = pipe.run(2, start_block=1)
    assert n_reps == 96 and pipe.fetches == 1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    pd = dict(zip(sim.DETAIL_FIELDS, pipe.block_detail(2)))
    jd = dict(zip(jsim.DETAIL_FIELDS, jpipe.block_detail(2)))
    assert _detail_close(pd, jd).mean() >= 0.99


def test_stress_body_matches_jax_at_full_n():
    """BASELINE.md config 5 itself, n = 10⁶ with n_chunk = 65536, four
    replications: the streaming subG pair agrees with the JAX package's.
    The receiver's clip at λ_r = 30 biases the INT estimate by about
    −0.03 at any n, and at n = 10⁶ its CI is 0.034 wide: both packages
    miss ρ here, replication by replication."""
    kw = dict(SUBG, n=10**6, stream_n_chunk=65536, b=4, chunk_size=4)
    want = jsim.run_sim_one(jsim.SimConfig(**kw))
    got = sim.run_sim_one(sim.SimConfig(**kw), device="cpu")
    assert _detail_close(got.detail, want.detail).all()
    assert got.summary["NI"]["coverage"] == want.summary["NI"]["coverage"]
    assert got.summary["INT"]["coverage"] == want.summary["INT"]["coverage"]
    assert -0.04 < got.summary["INT"]["bias"] < -0.02


def test_stress_chunk_size_policy():
    assert sim.stress_chunk_size(2048, on_card=True) == \
        sim.STRESS_CHUNK_CARD
    assert sim.stress_chunk_size(8, on_card=True) == 8
    assert sim.stress_chunk_size(256, on_card=False) == 1


def test_subg_and_streaming_entry_points_raise_without_a_device(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in (SUBG, dict(SUBG, stream_n_chunk=256)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sim.run_sim_one(sim.SimConfig(**dict(kw, b=4)))
