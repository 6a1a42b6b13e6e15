"""The port's replication path as a whole against dpcorr.sim.

Same master key, same per-replication addresses: the port's per-rep
detail agrees with the JAX simulator field by field (1e-5 absolute for
at least 98% of replications; the rest are centered values at a sign
tie), and the block pipeline's sums agree on the bench body. Also: the
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
    assert set(seconds) == {"rep_keys", "accumulate"}
    assert all(v > 0 for v in seconds.values())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pipe.run(1)
    names = [ev.name for ev in prof.events() if ev.name in sim.FUSED_STAGES]
    # keys for this block and the next; two chunks' copies and one add
    assert sorted(names) == ["accumulate"] * 3 + ["rep_keys"] * 2
    with sim.stage("rep_keys") as inside:
        assert inside is None


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_dpcorr():
    files = sorted((REPO / "dpcorr_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "dpcorr"), (path, mod)


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
def test_sim_config_refuses_unported_paths(kw):
    with pytest.raises(NotImplementedError):
        sim.SimConfig(n=N, rho=RHO, eps1=1.0, eps2=1.0, **kw)
