"""The port's build-ahead layer (``dpcorr_torch.utils.compile``) and its
consumers, on the CPU, against ``dpcorr.utils.compile``.

- ``SingleFlight`` under a thread race: one build per key, errors to
  every waiter, a retry after a failure; importable from
  ``serve.kernels`` as before.
- The series: names, kinds and buckets equal to the JAX package's; the
  causes ``new-signature`` and ``cache-evict`` counted; a lazy unit
  counts nothing.
- The serving cache: ``aot`` on and off bit-equal to each other and to
  the direct call; warm runs behind ``/readyz`` that spend no ε, flush
  nothing and take no key from the admission counter; no build on the
  request path once warm.
- The stream's chunk kernels built once into the service's registry.
"""

import argparse
import threading
import time

import numpy as np
import pytest
import torch

import dpcorr.obs.transfer as jtransfer
import dpcorr.utils.compile as jcompile
from dpcorr.obs.metrics import Registry as JRegistry
from dpcorr_torch.models.estimators.registry import serving_entry
from dpcorr_torch.obs import trace as obs_trace
from dpcorr_torch.obs import transfer
from dpcorr_torch.obs.metrics import Registry, default_registry
from dpcorr_torch.serve import EstimateRequest
from dpcorr_torch.serve import kernels as kernels_mod
from dpcorr_torch.serve import warmup as warmup_mod
from dpcorr_torch.serve.kernels import KernelCache
from dpcorr_torch.serve.request import KernelKey
from dpcorr_torch.serve.server import DpcorrServer
from dpcorr_torch.serve.stats import ServeStats
from dpcorr_torch.utils import compile as compile_mod
from dpcorr_torch.utils import rng

FAMILIES = ("ni_sign", "int_sign", "ni_subg", "int_subg")
N = 128


def _series(registry) -> dict:
    out = {}
    for m in registry.metrics():
        out[m.name] = (m.kind, tuple(getattr(m, "buckets", ())),
                       tuple(getattr(m, "labelnames", ())))
    return out


# ----------------------------------------------------- single flight ----
def test_single_flight_dedup_and_error_retry():
    sf = compile_mod.SingleFlight()
    gate, builds, results = threading.Event(), [], []

    def build():
        builds.append(1)
        gate.wait(5)
        return "unit"

    threads = [threading.Thread(target=lambda: results.append(
        sf.do("k", build))) for _ in range(8)]
    for t in threads:
        t.start()
    while sf.inflight_count() == 0:
        time.sleep(0.001)
    time.sleep(0.05)
    gate.set()
    for t in threads:
        t.join(5)
    assert len(builds) == 1
    assert sorted(r[1] for r in results) == [False] * 7 + [True]
    assert {r[0] for r in results} == {"unit"}
    assert sf.inflight_count() == 0

    def boom():
        raise ValueError("bad build")

    with pytest.raises(ValueError, match="bad build"):
        sf.do("k2", boom)
    assert sf.do("k2", lambda: 7) == (7, True)  # cleared: a fresh retry


def test_single_flight_moved_but_importable_where_it_was():
    assert kernels_mod.SingleFlight is compile_mod.SingleFlight


def test_kernel_cache_race_one_build_per_key():
    cache = KernelCache(device="cpu")
    builds = []
    gate = threading.Event()

    def hook(sig):
        builds.append(sig)
        gate.wait(5)

    cache._compile_hook = hook
    kkey = KernelKey("ni_sign", N, 1.0, 0.5, 0.05, True)
    out = []
    threads = [threading.Thread(target=lambda: out.append(
        cache.get(kkey, 4)[0])) for _ in range(6)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    gate.set()
    for t in threads:
        t.join(5)
    assert len(builds) == 1 and len({id(f) for f in out}) == 1
    snap = cache.stats.snapshot()
    assert snap["kernel_compiles"] == 1
    assert snap["kernel_compile_dedup"] == 5
    assert snap["recompiles"]["new-signature"] == 1


# ------------------------------------------------------------ series ----
def test_series_names_kinds_and_buckets_match_jax():
    ours, theirs = Registry(), JRegistry()
    compile_mod.CompileObserver(ours)
    jcompile.CompileObserver(theirs)
    transfer.TransferCounters(ours)
    jtransfer.TransferCounters(theirs)
    assert _series(ours) == _series(theirs)
    assert compile_mod.COMPILE_BUCKETS == jcompile.COMPILE_BUCKETS
    assert compile_mod.RECOMPILE_CAUSES == jcompile.RECOMPILE_CAUSES
    assert set(transfer.TransferCounters(Registry()).snapshot()) == set(
        jtransfer.TransferCounters(JRegistry()).snapshot())
    assert compile_mod.signature_key({"b": 2, "a": "x"}) == \
        jcompile.signature_key({"b": 2, "a": "x"})


def test_default_registry_is_process_wide():
    assert default_registry() is default_registry()
    assert transfer.default_counters().registry is default_registry()
    assert compile_mod.CompileObserver().registry is default_registry()


def test_causes_new_signature_cache_evict_and_lazy():
    """Eviction from the serving cache's LRU makes the next build of the
    signature a ``cache-evict``; a cache with ``aot`` off builds lazy
    units and counts no cause and no seconds."""
    stats = ServeStats()
    cache = KernelCache(stats=stats, max_kernels=1, device="cpu")
    a = KernelKey("ni_sign", N, 1.0, 0.5, 0.05, True)
    b = KernelKey("ni_subg", N, 1.0, 0.5, 0.05, True)
    for kkey in (a, b, a):
        cache.get(kkey, 1)
    assert stats.snapshot()["recompiles"] == {
        "new-signature": 2, "cache-evict": 1, "jit-fallback": 0}
    assert stats.registry.get("dpcorr_compile_seconds").snapshot()[
        "count"] == 3
    lazy_stats = ServeStats()
    lazy = KernelCache(stats=lazy_stats, aot=False, device="cpu")
    fn, _ = lazy.get(a, 1)
    assert not fn.built
    assert lazy_stats.snapshot()["recompiles"] == {
        "new-signature": 0, "cache-evict": 0, "jit-fallback": 0}
    assert lazy_stats.snapshot()["kernel_compiles"] == 1
    assert lazy_stats.registry.get("dpcorr_compile_seconds").snapshot()[
        "count"] == 0


def test_aot_compile_warm_run_metrics_and_span(tmp_path):
    path = tmp_path / "spans.jsonl"
    tracer = obs_trace.Tracer(str(path))
    reg = Registry()
    obs = compile_mod.CompileObserver(reg, tracer=tracer)
    calls = []

    def unit(x):
        calls.append(x.shape)
        return x * 2

    fn = compile_mod.aot_compile(lambda: unit, (torch.ones(3),),
                                 signature={"kernel": "double", "n": 3},
                                 observer=obs)
    assert fn is unit and calls == [(3,)]
    tracer.close()
    (span,) = obs_trace.read_spans(str(path))
    assert span["name"] == "kernel.compile"
    assert span["attrs"] == {"kernel": "double", "n": 3, "aot": True,
                             "warm": True, "cause": "new-signature"}
    assert reg.get("dpcorr_compile_inflight").value() == 0
    assert reg.get("dpcorr_compile_total").value(result="aot") == 1


def test_failed_warm_run_raises_and_caches_nothing():
    reg = Registry()
    from dpcorr_torch import plan

    ex = plan.Executor("local", device="cpu",
                       observer=compile_mod.CompileObserver(reg))

    def bad(x):
        raise RuntimeError("warm run failed")

    with pytest.raises(RuntimeError, match="warm run failed"):
        ex.prepare("k", lambda: bad, (torch.ones(1),))
    assert "k" not in ex._units
    assert reg.get("dpcorr_compile_inflight").value() == 0
    assert reg.get("dpcorr_compile_seconds").snapshot()["count"] == 0


def test_host_and_mesh_shardings():
    assert compile_mod.host_sharding("cpu") == torch.device("cpu")
    devs = [torch.device("cpu")] * 3
    assert compile_mod.mesh_shardings(devs) == (devs, torch.device("cpu"))
    with pytest.raises(ValueError):
        compile_mod.mesh_shardings([])


# ----------------------------------------------------------- serving ----
def _lanes(b: int, seed: int):
    z = np.random.default_rng(seed).standard_normal((2, b, N)).astype(
        np.float32)
    keys = rng.rep_keys(rng.master_key(seed), b)
    return keys.numpy(), z[0], z[1]


@pytest.mark.parametrize("family", FAMILIES)
def test_aot_bit_equal_to_lazy_and_to_the_direct_call(family):
    kkey = KernelKey(family, N, 1.0, 0.5, 0.05, True)
    keys, xs, ys = _lanes(5, 3)
    ex_args = warmup_mod.example_args(kkey, 8, "exact")
    on = KernelCache(aot=True, device="cpu")
    on.get(kkey, 8, example_args=ex_args)  # built and warmed
    off = KernelCache(aot=False, device="cpu")
    got_on = on.run_batch(kkey, keys, xs, ys)
    got_off = off.run_batch(kkey, keys, xs, ys)
    single = serving_entry(family, 1.0, 0.5, device="cpu")
    direct = [torch.stack(single(torch.from_numpy(keys[i]),
                                 torch.from_numpy(xs[i]),
                                 torch.from_numpy(ys[i]))).numpy()
              for i in range(5)]
    for j in range(3):
        assert got_on[j].tobytes() == got_off[j].tobytes()
        assert got_on[j].tobytes() == np.array(
            [d[j] for d in direct], np.float32).tobytes()


def test_vector_engine_aot_bit_equal_to_lazy():
    kkey = KernelKey("ni_sign", N, 1.0, 0.5, 0.05, True)
    keys, xs, ys = _lanes(6, 4)
    on = KernelCache(mode="vector", device="cpu")
    on.get(kkey, 8, example_args=warmup_mod.example_args(kkey, 8, "vector"))
    off = KernelCache(mode="vector", aot=False, device="cpu")
    for a, b in zip(on.run_batch(kkey, keys, xs, ys),
                    off.run_batch(kkey, keys, xs, ys)):
        assert a.tobytes() == b.tobytes()


def test_run_batch_is_one_counted_fetch():
    tc = transfer.default_counters()
    cache = KernelCache(device="cpu")
    kkey = KernelKey("int_subg", N, 1.0, 0.5, 0.05, True)
    before = tc.snapshot()
    cache.run_batch(kkey, *_lanes(3, 5))
    assert transfer.diff(tc.snapshot(), before)["fetches"] == 1


def test_example_args_shapes():
    kkey = KernelKey("ni_sign", 300, 1.0, 0.5, 0.05, True)
    keys, xs, ys = warmup_mod.example_args(kkey, 16, "vector")
    assert keys.shape == (16, 2) and not keys.any()
    assert xs.shape == ys.shape == (16, 300) and xs.dtype == np.float32
    assert warmup_mod.example_args(kkey, 16, "exact")[1].shape == (1, 300)


@pytest.mark.parametrize("aot", [True, False])
def test_warmup_spends_nothing_and_no_build_on_the_request_path(aot):
    """The warm set is resident before ``/readyz`` turns 200; with aot on
    each signature ran once. Neither arm spends ε, flushes a batch or
    takes a key from the admission counter; the first request builds
    nothing and its answer is the direct call's."""
    spec = f"ni_sign:{N}:1.0:0.5:1,2,4"
    srv = DpcorrServer(budget=10.0, warmup=spec, warmup_autostart=False,
                       aot=aot, max_delay_s=0.001, device="cpu")
    try:
        assert srv.readiness()["ready"] is False
        srv.start_warmup()
        assert srv.wait_ready(60)
        snap = srv.stats.snapshot()
        assert snap["kernel_compiles"] == 3
        count = srv.stats.registry.get("dpcorr_compile_seconds").snapshot()[
            "count"]
        assert count == (3 if aot else 0)
        assert snap["recompiles"]["new-signature"] == (3 if aot else 0)
        assert snap["batches_flushed"] == 0
        assert srv.ledger.spent("party-x") == 0.0
        assert next(srv._req_counter) == 0
        z = np.random.default_rng(9).standard_normal((2, N)).astype(
            np.float32)
        req = EstimateRequest("ni_sign", z[0], z[1], 1.0, 0.5, seed=77)
        res = srv.submit(req).result(timeout=60)
        assert srv.stats.snapshot()["kernel_compiles"] == 3
        from dpcorr_torch.serve.server import pinned_request_key

        want = serving_entry("ni_sign", 1.0, 0.5, device="cpu")(
            pinned_request_key(srv._master, req, 77), torch.from_numpy(z[0]),
            torch.from_numpy(z[1]))
        assert np.float32(res.rho_hat) == want[0].numpy()
        assert np.float32(res.ci_high) == want[2].numpy()
    finally:
        srv.close()


def test_serve_aot_flag_echoes_as_jax(tmp_path):
    from test_torch_cli import _banner

    ours = _banner(["dpcorr_torch", "serve", "--aot", "off", "--device",
                    "cpu"], tmp_path, "serving")
    theirs = _banner(["dpcorr", "serve", "--aot", "off"], tmp_path,
                     "serving")
    assert ours["aot"] == theirs["aot"] == "off"


# ------------------------------------------------------------ stream ----
def test_stream_kernels_build_once_into_the_service_registry(tmp_path):
    from dpcorr_torch.stream import sketch
    from dpcorr_torch.stream.service import StreamService
    from dpcorr_torch.stream.windows import WindowSpec

    sketch._KERNELS.clear()
    sv = StreamService(str(tmp_path / "w"), WindowSpec(size_s=1.0),
                       ["ni_sign", "int_sign"], 1.0, 0.5, device="cpu")
    try:
        xy = np.random.default_rng(2).normal(size=(150, 2)).tolist()
        sv.ingest("a", 0.5, xy)
        sv.ingest("b", 1.5, xy)  # closes the first window
        seconds = sv.registry.get("dpcorr_compile_seconds")
        # pass A at each family's chunk grid, the NI and the INT chunk
        # kernels: built once each
        assert seconds.snapshot()["count"] == 4
        assert sorted(k[0] for k in sketch._KERNELS) == [
            "int_sign.sign_norm", "ni.sign_norm", "pass_a", "pass_a"]
        sv.ingest("c", 5.0, [[0.0, 0.0]])  # the same shapes again
        assert len(sv.journal.entries()) == 2
        assert seconds.snapshot()["count"] == 4
        rc = sv.registry.get("dpcorr_compile_recompile_total")
        assert rc.value(cause="new-signature") == 4
    finally:
        sv.close()


@pytest.mark.parametrize("spec,count", [(None, None), ("local", 1),
                                        ("mesh", 1)])
def test_stream_placement_flags(spec, count):
    from dpcorr_torch.__main__ import _stream_placement

    args = argparse.Namespace(placement=spec, mesh_devices=None)
    got = _stream_placement(args, "cpu")
    assert (got is None) if spec is None else (
        got.name == spec and got.device_count == count)
    args = argparse.Namespace(placement="mesh", mesh_devices=3)
    assert _stream_placement(args, "cpu").devices == [torch.device("cpu")] * 3
