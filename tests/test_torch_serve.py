"""The port's serving stack (``dpcorr_torch.serve``) against ``dpcorr.serve``.

Two kinds of test, on the CPU at small sizes (n = 96-500, a few lanes):

- the JAX package's ``tests/test_serve.py``, case by case, on the port's
  server: ledger accounting, the exact engine's bit-equality with the
  direct single call, the kernel cache, backpressure, stats, the HTTP
  front end, idempotency, tracing and the audit trail;
- the two packages side by side on the same numpy-seeded inputs: request
  keys bit-equal (pinned and boot subtrees), ``serving_entry`` per
  family within the estimator tests' tolerances (1e-5 absolute on ρ̂
  and the CI ends; a sign-family row may differ beyond that only where
  a privately centered value lies within 1e-5 of 0, as in
  ``tests/test_torch_estimators.py``; subG rows also within 2.5e-7
  relative, as in ``tests/test_torch_subg.py``), the same request
  through both servers, the ε-ledger file read both ways, and the stats
  snapshot's key set.

The reference of the bit-equality tests is always the port's *direct*
single-request call — ``serving_entry`` on the request's key-tree
address — which the ``exact`` engine must match bit for bit.
"""

import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpcorr.serve as jserve
from dpcorr.models.estimators.registry import serving_entry as jax_entry
from dpcorr.ops.standardize import priv_center as jax_priv_center
from dpcorr.utils import rng as jrng
from dpcorr_torch import interop
from dpcorr_torch.models.estimators.registry import (
    FAMILIES,
    batch_engine,
    serving_entry,
)
from dpcorr_torch.obs.audit import (
    AuditTrail,
    read_events,
    replay,
    replay_levels,
)
from dpcorr_torch.obs.metrics import CONTENT_TYPE, Registry, parse_exposition
from dpcorr_torch.obs.trace import Tracer, read_spans
from dpcorr_torch.serve import (
    BudgetExceededError,
    DpcorrServer,
    EstimateRequest,
    InProcessClient,
    KernelCache,
    PrivacyLedger,
    ServerClosedError,
    ServerOverloadedError,
    ServeStats,
    make_http_server,
    pinned_request_key,
    request_charges,
)
from dpcorr_torch.serve import server as server_mod
from dpcorr_torch.serve import warmup as warmup_mod
from dpcorr_torch.serve.kernels import pad_batch
from dpcorr_torch.serve.request import bucket_key, kernel_key, pad_n
from dpcorr_torch.serve.stats import percentiles
from dpcorr_torch.utils import rng

#: agreement with the JAX package: the estimator tests' bounds
ATOL, SUBG_RTOL, TIE = 1e-5, 2.5e-7, 1e-5


def _mk_req(n=96, family="ni_sign", seed=None, i=0, **kw):
    rs = np.random.RandomState(100 + i)
    return EstimateRequest(family, rs.randn(n).astype(np.float32),
                           rs.randn(n).astype(np.float32),
                           1.0, 0.5, seed=seed, **kw)


def _jreq(req):
    """The same request as a ``dpcorr.serve`` request."""
    return jserve.EstimateRequest(
        req.family, req.x, req.y, req.eps1, req.eps2, party_x=req.party_x,
        party_y=req.party_y, alpha=req.alpha, normalise=req.normalise,
        seed=req.seed, idempotency_key=req.idempotency_key,
        priority=req.priority, deadline_s=req.deadline_s)


def _server(**kw):
    kw.setdefault("budget", 1e6)
    kw.setdefault("max_delay_s", 0.001)
    kw.setdefault("shard", "off")
    return DpcorrServer(device="cpu", **kw)


def _direct(server, req):
    """The reference answer: the port's direct single-request call on
    the request's key-tree address (the pinned subtree)."""
    single = serving_entry(req.family, req.eps1, req.eps2, alpha=req.alpha,
                           normalise=req.normalise, device="cpu")
    key = pinned_request_key(rng.master_key(server.seed), req, req.seed)
    return tuple(float(v) for v in single(key, torch.from_numpy(req.x),
                                          torch.from_numpy(req.y)))


def _lanes(b, n, seed=3):
    rs = np.random.RandomState(seed)
    xs = rs.randn(b, n).astype(np.float32)
    ys = rs.randn(b, n).astype(np.float32)
    keys = rng.design_key(rng.master_key(11)[None], torch.arange(b))
    return keys, xs, ys


def _get(url):
    with urllib.request.urlopen(url) as r:
        return r.status, json.load(r)


def _start_http(srv):
    httpd = make_http_server(srv, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


# ---------------------------------------------------------------- units ----

def test_pad_n_buckets():
    assert pad_n(2) == 64          # floor
    assert pad_n(64) == 64
    assert pad_n(65) == 128
    assert pad_n(500) == 512
    assert pad_n(512) == 512
    assert pad_n(513) == 1024
    assert pad_n(19_433) == 32_768  # the HRS wave-2 width


def test_pad_batch():
    assert [pad_batch(b) for b in (1, 2, 3, 4, 5, 13, 16, 17)] == \
        [1, 2, 4, 4, 8, 16, 16, 32]


def test_request_validation():
    with pytest.raises(ValueError, match="unknown estimator family"):
        _mk_req(family="nope")
    with pytest.raises(ValueError, match="equal-length"):
        EstimateRequest("ni_sign", np.zeros(8, np.float32),
                        np.zeros(9, np.float32), 1.0, 1.0)
    with pytest.raises(ValueError, match="eps must be positive"):
        EstimateRequest("ni_sign", np.zeros(8, np.float32),
                        np.zeros(8, np.float32), 0.0, 1.0)
    with pytest.raises(ValueError, match="at least two"):
        EstimateRequest("ni_sign", np.zeros(1, np.float32),
                        np.zeros(1, np.float32), 1.0, 1.0)


def test_bucket_vs_kernel_key():
    a, b = _mk_req(n=400, i=0), _mk_req(n=500, i=1)
    assert bucket_key(a) == bucket_key(b)      # both pad to 512
    assert kernel_key(a) != kernel_key(b)      # exact n differs
    c = _mk_req(n=400, family="int_sign", i=2)
    assert bucket_key(a) != bucket_key(c)
    # the same keys as the JAX package's
    assert tuple(bucket_key(a)) == tuple(jserve.bucket_key(_jreq(a)))
    assert tuple(kernel_key(c)) == tuple(jserve.kernel_key(_jreq(c)))


# --------------------------------------------------------------- ledger ----

def test_request_charges_composition():
    # sign family + normalise: private centering doubles each side's spend
    r = _mk_req(family="ni_sign", party_x="a", party_y="b")
    assert request_charges(r) == {"a": 2.0, "b": 1.0}
    # subG families clip with data-independent bounds: spend once
    r = _mk_req(family="ni_subg", party_x="a", party_y="b")
    assert request_charges(r) == {"a": 1.0, "b": 0.5}
    # same party on both sides accumulates
    r = _mk_req(family="int_sign", party_x="a", party_y="a")
    assert request_charges(r) == {"a": 3.0}
    r = _mk_req(family="ni_sign", normalise=False, party_x="a", party_y="b")
    assert request_charges(r) == {"a": 1.0, "b": 0.5}
    for fam in FAMILIES:
        r = _mk_req(family=fam, party_x="a", party_y="b")
        assert request_charges(r) == jserve.request_charges(_jreq(r))


def test_ledger_arithmetic_and_refusal():
    led = PrivacyLedger(budget=5.0)
    led.charge({"a": 2.0, "b": 1.0})
    led.charge({"a": 2.0})
    assert led.spent("a") == pytest.approx(4.0)
    assert led.remaining("a") == pytest.approx(1.0)
    # exact landing on the cap is admitted (strict >)
    led.charge({"a": 1.0})
    assert led.remaining("a") == pytest.approx(0.0)
    with pytest.raises(BudgetExceededError) as ei:
        led.charge({"a": 1e-6})
    assert ei.value.party == "a"
    # refused charge must not partially mutate any party (all-or-nothing)
    before_b = led.spent("b")
    with pytest.raises(BudgetExceededError):
        led.charge({"b": 0.5, "a": 1.0})
    assert led.spent("b") == before_b


def test_ledger_per_party_override():
    led = PrivacyLedger(budget=100.0, per_party={"tight": 1.0})
    led.charge({"tight": 1.0, "loose": 50.0})
    with pytest.raises(BudgetExceededError):
        led.charge({"tight": 0.1})
    led.charge({"loose": 50.0})


def test_ledger_persistence_across_restart(tmp_path):
    path = str(tmp_path / "ledger.json")
    led = PrivacyLedger(budget=3.0, path=path)
    led.charge({"a": 2.0})
    # simulated crash + restart: a fresh process loads the spend table
    led2 = PrivacyLedger(budget=3.0, path=path)
    assert led2.spent("a") == pytest.approx(2.0)
    led2.charge({"a": 1.0})
    # the same query again would double-spend — must refuse
    with pytest.raises(BudgetExceededError):
        led2.charge({"a": 1.0})
    # third incarnation still sees the full spend
    led3 = PrivacyLedger(budget=3.0, path=path)
    assert led3.spent("a") == pytest.approx(3.0)
    state = json.load(open(path))
    assert state["version"] == 1 and state["spent"]["a"] == pytest.approx(3.0)


def test_ledger_persist_is_write_ahead(tmp_path):
    """The spend is on disk before charge() returns — a crash after a
    successful charge can never resurrect the budget."""
    path = str(tmp_path / "ledger.json")
    led = PrivacyLedger(budget=10.0, path=path)
    led.charge({"a": 4.0})
    on_disk = json.load(open(path))["spent"]["a"]
    assert on_disk == pytest.approx(4.0)


def test_ledger_rejects_unknown_state_version(tmp_path):
    path = tmp_path / "ledger.json"
    path.write_text(json.dumps({"version": 99, "spent": {}}))
    with pytest.raises(ValueError, match="version"):
        PrivacyLedger(budget=1.0, path=str(path))


def test_ledger_quarantines_a_corrupt_file(tmp_path):
    from dpcorr_torch.serve.ledger import LedgerCorruptError

    path = tmp_path / "ledger.json"
    path.write_text("{not json")
    (tmp_path / "ledger.json.tmp.1").write_text("stale")
    with pytest.raises(LedgerCorruptError, match="corrupt"):
        PrivacyLedger(budget=1.0, path=str(path))
    assert not path.exists()
    assert (tmp_path / "ledger.json.corrupt").exists()
    assert not (tmp_path / "ledger.json.tmp.1").exists()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ledger_file_read_by_the_other_package(tmp_path, writer):
    """A ledger file written by either package is read by the other with
    the same remaining budget and the same refusal."""
    path = str(tmp_path / "ledger.json")
    a, b = ((jserve.PrivacyLedger, PrivacyLedger) if writer == "jax"
            else (PrivacyLedger, jserve.PrivacyLedger))
    led = a(budget=3.0, path=path, per_party={"p": 2.5})
    led.charge({"p": 1.5, "q": 0.75}, charge_id="req:one")
    led.charge({"q": 1.25})
    led.refund({"q": 0.5})
    other = b(budget=3.0, path=path, per_party={"p": 2.5})
    for party in ("p", "q"):
        assert other.remaining(party) == led.remaining(party)
    assert other.snapshot() == led.snapshot()
    # the same charge id dedups in the reader too
    other.charge({"p": 1.5}, charge_id="req:one")
    assert other.spent("p") == 1.5
    for ledger in (led, other):
        with pytest.raises((BudgetExceededError,
                            jserve.BudgetExceededError)) as ei:
            ledger.charge({"p": 1.25})
        assert (ei.value.party, ei.value.spent) == ("p", 1.5)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_server_budget_carried_across_packages(tmp_path, first):
    """Budget spent in one package's server, the file reopened by the
    other's: the remaining budget and the next refusal match."""
    path = str(tmp_path / "ledger.json")
    req = _mk_req(seed=1)
    budget = 2 * request_charges(req)["party-x"]
    kw = dict(budget=1e6, ledger_path=path, max_delay_s=0.001,
              shard="off", per_party_budget={"party-x": budget})

    def port_server():
        return DpcorrServer(device="cpu", **kw)

    def jax_server():
        return jserve.DpcorrServer(**kw)

    make = {"jax": (jax_server, _jreq), "port": (port_server, lambda r: r)}
    mk1, conv1 = make[first]
    mk2, conv2 = make["port" if first == "jax" else "jax"]
    s1 = mk1()
    try:
        s1.estimate(conv1(req), timeout=60)
        left = s1.ledger.remaining("party-x")
    finally:
        s1.close()
    s2 = mk2()
    try:
        assert s2.ledger.remaining("party-x") == left
        s2.estimate(conv2(_mk_req(seed=2)), timeout=60)  # still fits
        with pytest.raises((BudgetExceededError,
                            jserve.BudgetExceededError)):
            s2.estimate(conv2(_mk_req(seed=3)), timeout=60)
        assert s2.ledger.remaining("party-x") == pytest.approx(0.0)
    finally:
        s2.close()


# ---------------------------------------------------------------- stats ----

def test_percentiles_nearest_rank():
    vals = list(range(1, 101))
    p = percentiles(vals)
    assert p == {"p50": 50, "p99": 99}
    assert percentiles([]) == {}
    assert percentiles([7.0]) == {"p50": 7.0, "p99": 7.0}


def test_stats_fill_ratio_and_snapshot():
    st = ServeStats()
    assert st.batch_fill_ratio() == 0.0
    st.flushed(8, batched=True)
    st.flushed(1, batched=False)
    assert st.batch_fill_ratio() == pytest.approx(4.5)
    snap = st.snapshot(ledger_snapshot={"budget_default": 1.0,
                                        "parties": {}})
    assert snap["batches_flushed"] == 2
    assert snap["flush_size_max"] == 8
    assert snap["ledger"]["budget_default"] == 1.0


def test_serve_stats_frame():
    from dpcorr_torch.report import serve_stats_frame

    st = ServeStats()
    st.admitted()
    st.flushed(4, batched=True)
    st.observe_latency(0.01)
    df = serve_stats_frame(st.snapshot(
        ledger_snapshot={"budget_default": 2.0,
                         "parties": {"a": {"spent": 1.0, "budget": 2.0,
                                           "remaining": 1.0}}}))
    metrics = dict(zip(df["metric"], df["value"]))
    assert metrics["requests_total"] == 1
    assert metrics["ledger.parties.a.spent"] == 1.0
    assert metrics["latency_s.p50"] == pytest.approx(0.01)


def test_stats_snapshot_has_the_jax_key_set():
    """The server's ``/stats`` snapshot has the JAX server's keys, and so
    do its nested groups (the budget directory and fleet keys aside,
    which neither server emits without those options)."""
    req = _mk_req(seed=1)
    srv, jsrv = _server(), jserve.DpcorrServer(budget=1e6, shard="off",
                                               max_delay_s=0.001)
    try:
        srv.estimate(req, timeout=60)
        jsrv.estimate(_jreq(req), timeout=60)
        got, want = srv.stats_snapshot(), jsrv.stats_snapshot()
    finally:
        srv.close()
        jsrv.close()
    assert set(got) == set(want)
    for k in ("refused", "shed", "abandoned", "slo", "costs", "ledger",
              "breaker", "latency_s", "recompiles"):
        assert set(got[k]) == set(want[k]), k
    assert got["ledger"] == want["ledger"]
    assert got["recompiles"]["new-signature"] == 1


# -------------------------------------------------------------- kernels ----

def test_kernel_cache_counts_compiles_and_hits():
    cache = KernelCache(shard="off", device="cpu")
    kk = kernel_key(_mk_req(n=64))
    f1, _ = cache.get(kk, 4)
    f2, _ = cache.get(kk, 4)
    assert f1 is f2
    assert cache.stats.kernel_compiles == 1
    assert cache.stats.kernel_hits == 1
    # different padded width = different signature
    cache.get(kk, 8)
    assert cache.stats.kernel_compiles == 2


def test_kernel_cache_rejects_bad_modes():
    with pytest.raises(ValueError, match="shard"):
        KernelCache(shard="maybe", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        KernelCache(mode="fast", device="cpu")
    with pytest.raises(ValueError, match="max_kernels"):
        KernelCache(max_kernels=0, device="cpu")


def test_kernel_cache_lru_bounded():
    """Signatures include the exact n, so an n-sweeping client would
    grow the cache without bound; the LRU cap holds it at max_kernels
    and the live count is a stats gauge."""
    cache = KernelCache(shard="off", max_kernels=2, device="cpu")
    kks = [kernel_key(_mk_req(n=64 + j)) for j in range(3)]
    for kk in kks:
        cache.get(kk, 4)
    assert len(cache._fns) == 2
    assert cache.stats.kernel_cache_size == 2
    # kks[0] was evicted (least recently used) → re-get rebuilds,
    # displacing kks[1]; cache is now [kks[2], kks[0]]
    compiles = cache.stats.kernel_compiles
    cache.get(kks[0], 4)
    assert cache.stats.kernel_compiles == compiles + 1
    assert (kks[1], 4, 1) not in cache._fns
    # a hit refreshes recency: touching kks[2] makes kks[0] the LRU,
    # so the next insert evicts kks[0] and keeps kks[2]
    hits = cache.stats.kernel_hits
    cache.get(kks[2], 4)
    assert cache.stats.kernel_hits == hits + 1
    cache.get(kernel_key(_mk_req(n=200)), 4)
    assert (kks[0], 4, 1) not in cache._fns
    assert (kks[2], 4, 1) in cache._fns
    assert cache.stats.snapshot()["kernel_cache_size"] == 2
    # the rebuild after eviction is attributed to it
    rc = cache.stats.snapshot()["recompiles"]
    assert rc == {"new-signature": 4, "cache-evict": 1, "jit-fallback": 0}


def test_kernel_cache_single_flight_under_a_thread_race():
    """Concurrent misses on one signature build once; the followers wait
    on the leader and count as dedups, not as builds or hits."""
    cache = KernelCache(shard="off", device="cpu")
    builds = []
    gate = threading.Event()

    def hook(sig):
        builds.append(sig)
        gate.wait(5.0)  # hold the build open while the others arrive

    cache._compile_hook = hook
    kk = kernel_key(_mk_req(n=96))
    out = []
    ts = [threading.Thread(target=lambda: out.append(cache.get(kk, 8)))
          for _ in range(6)]
    for t in ts:
        t.start()
    deadline = time.monotonic() + 5.0
    while cache._flight.inflight_count() == 0 and time.monotonic() < deadline:
        time.sleep(0.001)
    time.sleep(0.05)
    gate.set()
    for t in ts:
        t.join(timeout=10.0)
        assert not t.is_alive()
    assert len(builds) == 1
    assert len({id(fn) for fn, _ in out}) == 1
    st = cache.stats
    assert st.kernel_compiles == 1
    assert st.kernel_compile_dedup + st.kernel_hits == 5


@pytest.mark.parametrize("family", FAMILIES)
def test_exact_batch_bit_identical_to_direct(family):
    """The exact engine's lanes — b = 5, padded width 8, truncated to 5 —
    are bit-identical to the direct single call for EVERY family."""
    n, b = 96, 5
    single = serving_entry(family, 1.0, 0.5, device="cpu")
    cache = KernelCache(shard="off", mode="exact", device="cpu")
    kk = kernel_key(_mk_req(n=n, family=family))
    keys, xs, ys = _lanes(b, n)
    out = cache.run_batch(kk, keys, xs, ys)
    assert out[0].shape == (b,)
    assert (kk, 8, 1) in cache._fns
    for i in range(b):
        ref = tuple(float(v) for v in single(keys[i], torch.from_numpy(xs[i]),
                                             torch.from_numpy(ys[i])))
        got = tuple(float(out[j][i]) for j in range(3))
        assert got == ref, (family, i)


@pytest.mark.parametrize("family", FAMILIES)
def test_vector_batch_bit_identical_on_the_cpu_and_width_invariant(family):
    """The vector engine on the CPU: every lane bit-identical to the
    direct call (registry contract on the CPU), padding included (b = 5
    pads to 8), and lanes bit-identical across widths."""
    n, b = 96, 8
    single = serving_entry(family, 1.0, 0.5, device="cpu")
    cache = KernelCache(shard="off", mode="vector", device="cpu")
    kk = kernel_key(_mk_req(n=n, family=family))
    keys, xs, ys = _lanes(b, n)
    full = cache.run_batch(kk, keys, xs, ys)
    for i in range(b):
        ref = tuple(float(v) for v in single(keys[i], torch.from_numpy(xs[i]),
                                             torch.from_numpy(ys[i])))
        assert tuple(float(full[j][i]) for j in range(3)) == ref
    for w in (2, 5):
        part = cache.run_batch(kk, keys[:w], xs[:w], ys[:w])
        for j in range(3):
            np.testing.assert_array_equal(part[j], full[j][:w])


@pytest.mark.parametrize("mode", ["exact", "vector"])
def test_sharded_batch_bit_identical(mode):
    """With the lane axis split over a device list of two, each engine's
    lanes still match the direct call bit for bit."""
    n, b = 96, 8
    single = serving_entry("ni_sign", 1.0, 0.5, device="cpu")
    cache = KernelCache(mode=mode, device="cpu",
                        devices=[torch.device("cpu")] * 2)
    kk = kernel_key(_mk_req(n=n))
    keys, xs, ys = _lanes(b, n)
    assert cache._n_shards(pad_batch(b)) == 2
    assert cache._n_shards(1) == 1  # a singleton stays on one device
    out = cache.run_batch(kk, keys, xs, ys)
    assert (kk, 8, 2) in cache._fns
    for i in range(b):
        ref = tuple(float(v) for v in single(keys[i], torch.from_numpy(xs[i]),
                                             torch.from_numpy(ys[i])))
        assert tuple(float(out[j][i]) for j in range(3)) == ref
    # an odd width splits unevenly and keeps lane order
    odd = cache.run_batch(kk, keys[:3], xs[:3], ys[:3])
    for j in range(3):
        np.testing.assert_array_equal(odd[j], out[j][:3])


def test_batch_engine_rejects_unknown_engines():
    with pytest.raises(ValueError, match="engine"):
        batch_engine(lambda k, x, y: None, "fast")


# ------------------------------------------------ against the JAX package --

def test_pinned_request_key_bit_equal_to_jax():
    master = rng.master_key(rng.MASTER_SEED)
    jmaster = jrng.master_key(rng.MASTER_SEED)
    for fam in FAMILIES:
        for seed in (0, 7, 2**31 - 1):
            for i in (0, 3):
                req = _mk_req(n=120 + i, family=fam, seed=seed, i=i)
                got = pinned_request_key(master, req, seed)
                want = jserve.pinned_request_key(jmaster, _jreq(req), seed)
                np.testing.assert_array_equal(
                    interop.keys_to_jax_data(got),
                    np.asarray(jax.random.key_data(want)))
    assert server_mod.request_digest_words(req) == \
        jserve.server.request_digest_words(_jreq(req))


def test_boot_subtree_keys_bit_equal_to_jax():
    srv = _server(seed=99)
    jsrv = jserve.DpcorrServer(budget=1.0, shard="off", seed=99)
    try:
        jsrv._boot_nonce = srv._boot_nonce
        for counter in (0, 1, 17, 4096):
            req = _mk_req(seed=None, i=counter % 3)
            got = srv._request_key(req, counter)
            want = jsrv._request_key(_jreq(req), counter)
            np.testing.assert_array_equal(
                interop.keys_to_jax_data(got),
                np.asarray(jax.random.key_data(want)))
    finally:
        srv.close()
        jsrv.close()


def _sign_near_tie(fam, key_words, x, y, eps, n):
    """Does any privately centered value of this row sit within TIE of 0
    (a sign that a different f32 summation order may flip)?"""
    prefix = "ni_sign" if fam == "ni_sign" else "int_sign"
    l_clip = float(np.sqrt(2.0 * np.log(n)))
    k = jax.random.wrap_key_data(jnp.asarray(key_words))
    cx = jax_priv_center(jrng.stream(k, f"{prefix}/std_x"), jnp.asarray(x),
                         eps[0], l_clip)
    cy = jax_priv_center(jrng.stream(k, f"{prefix}/std_y"), jnp.asarray(y),
                         eps[1], l_clip)
    return bool((np.abs(np.asarray(cx)) < TIE).any()
                or (np.abs(np.asarray(cy)) < TIE).any())


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", [96, 500])
def test_serving_entry_matches_jax(family, n):
    """The port's serving callable against ``dpcorr``'s on 16 lanes of the
    same data and keys, within the estimator tests' tolerances."""
    b, eps = 16, (1.0, 0.5)
    keys, xs, ys = _lanes(b, n, seed=n)
    words = interop.keys_to_jax_data(keys)
    single = serving_entry(family, *eps, device="cpu")
    got = np.stack([t.numpy() for t in single(keys, torch.from_numpy(xs),
                                              torch.from_numpy(ys))], 1)
    jsingle = jax.jit(jax_entry(family, *eps))
    want = np.stack([np.asarray([float(v) for v in jsingle(
        jax.random.wrap_key_data(jnp.asarray(words[i])), xs[i], ys[i])])
        for i in range(b)])
    rtol = SUBG_RTOL if family.endswith("subg") else 0.0
    bad = ~np.isclose(got, want, rtol=rtol, atol=ATOL).all(1)
    for i in np.flatnonzero(bad):
        assert family.endswith("sign") and _sign_near_tie(
            family, words[i], xs[i], ys[i], eps, n), (family, i)
    assert bad.sum() <= 1


def test_same_request_through_both_servers():
    """One pinned request per family through each package's server: the
    same key, the same charges, the estimate within tolerance."""
    srv = _server()
    jsrv = jserve.DpcorrServer(budget=1e6, max_delay_s=0.001, shard="off")
    try:
        for i, fam in enumerate(FAMILIES):
            req = _mk_req(n=300, family=fam, seed=40 + i, i=i)
            got = srv.estimate(req, timeout=60)
            want = jsrv.estimate(_jreq(req), timeout=60)
            rtol = SUBG_RTOL if fam.endswith("subg") else 0.0
            np.testing.assert_allclose(
                [got.rho_hat, got.ci_low, got.ci_high],
                [want.rho_hat, want.ci_low, want.ci_high],
                rtol=rtol, atol=ATOL)
            assert got.cost["eps_charged"] == want.cost["eps_charged"]
        assert srv.ledger.snapshot() == jsrv.ledger.snapshot()
    finally:
        srv.close()
        jsrv.close()


# --------------------------------------------------------------- server ----

def test_server_raises_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DpcorrServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KernelCache()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_entry("ni_sign", 1.0, 1.0)


def test_server_estimate_matches_direct_call():
    srv = _server()
    try:
        req = _mk_req(seed=42)
        resp = srv.estimate(req)
        assert _direct(srv, req) == (resp.rho_hat, resp.ci_low, resp.ci_high)
        assert resp.seed == 42 and resp.batch_size == 1
    finally:
        srv.close()


def test_server_concurrent_load_coalesces_and_bit_matches():
    """An in-process load drive: concurrent clients, one bucket; asserts
    fill ratio > 1 and every response bit-identical to the direct call."""
    n_req, n_clients = 96, 8
    srv = _server(max_batch=32, max_delay_s=0.05, max_queue=4 * n_req)
    cli = InProcessClient(srv)
    reqs = [_mk_req(seed=i, i=i) for i in range(n_req)]
    out: dict[int, object] = {}
    lock = threading.Lock()
    per = n_req // n_clients

    def worker(c):
        futs = [(i, cli.submit(reqs[i]))
                for i in range(c * per, (c + 1) * per)]
        for i, f in futs:
            r = f.result(timeout=120)
            with lock:
                out[i] = r
    try:
        ts = [threading.Thread(target=worker, args=(c,))
              for c in range(n_clients)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        srv.close()
    assert len(out) == n_req
    snap = cli.stats()
    assert snap["batch_fill_ratio"] > 1.0
    assert snap["batched_requests"] > 0
    for i in range(n_req):
        r = out[i]
        assert _direct(srv, reqs[i]) == (r.rho_hat, r.ci_low, r.ci_high), i


def test_server_refuses_over_budget_first_query():
    """The first query that would overdraw is refused; earlier ones all
    admitted. Distinct seeds per query: identical pinned requests would
    dedupe through the idempotency cache and never re-charge."""
    req = _mk_req(seed=1)  # ni_sign+normalise: spends 2*eps1 on party_x
    charges = request_charges(req)
    budget = 3 * charges["party-x"]
    srv = _server(per_party_budget={"party-x": budget})
    try:
        for s in range(3):
            srv.estimate(_mk_req(seed=s + 1))
        with pytest.raises(BudgetExceededError):
            srv.estimate(_mk_req(seed=4))
        snap = srv.stats_snapshot()
        assert snap["requests_total"] == 3
        assert snap["requests_refused_budget"] == 1
        assert snap["ledger"]["parties"]["party-x"]["remaining"] == \
            pytest.approx(0.0)
    finally:
        srv.close()


def test_server_refusal_spends_nothing():
    req = _mk_req(seed=1)
    srv = _server(per_party_budget={"party-x": 0.5})
    try:
        with pytest.raises(BudgetExceededError):
            srv.submit(req)
        assert srv.ledger.spent("party-x") == 0.0
        assert srv.ledger.spent("party-y") == 0.0
    finally:
        srv.close()


def test_server_ledger_survives_restart(tmp_path):
    path = str(tmp_path / "ledger.json")
    req = _mk_req(seed=1)
    budget = 2 * request_charges(req)["party-x"]
    srv = _server(ledger_path=path, per_party_budget={"party-x": budget})
    srv.estimate(req)
    srv.close()  # "crash" after one answered query
    srv2 = _server(ledger_path=path, per_party_budget={"party-x": budget})
    try:
        srv2.estimate(_mk_req(seed=2))  # second query still fits
        with pytest.raises(BudgetExceededError):
            srv2.estimate(_mk_req(seed=3))  # would double-spend — refused
    finally:
        srv2.close()


def test_idempotent_replay_no_second_charge_or_launch():
    """Retrying a pinned request returns the ORIGINAL response object with
    zero additional ledger charge and zero additional launches — proven
    by the counters, not just by value equality."""
    srv = _server()
    try:
        r1 = srv.estimate(_mk_req(seed=7))
        spent = srv.ledger.spent("party-x")
        flushes = srv.stats.batches_flushed
        admitted = srv.stats.requests_total
        r2 = srv.estimate(_mk_req(seed=7))  # same bytes, same seed
        assert r2 is r1  # the cached object itself — byte-identical
        assert srv.ledger.spent("party-x") == pytest.approx(spent)
        assert srv.stats.batches_flushed == flushes  # no kernel ran
        assert srv.stats.requests_total == admitted  # never re-admitted
        assert srv.stats.idempotent_hits_completed == 1
    finally:
        srv.close()


def test_idempotent_inflight_duplicates_share_future():
    """A duplicate arriving while the original is still queued attaches
    to the same future: one charge, one launch, both callers answered."""
    srv = _server(max_batch=2, max_delay_s=30.0)
    try:
        f1 = srv.submit(_mk_req(seed=11))
        spent = srv.ledger.spent("party-x")
        f2 = srv.submit(_mk_req(seed=11))
        assert f2 is f1
        assert srv.stats.idempotent_hits_inflight == 1
        assert srv.ledger.spent("party-x") == pytest.approx(spent)
        # a second DISTINCT request fills the size-2 bucket → flush
        srv.submit(_mk_req(seed=12, i=1))
        assert f1.result(timeout=60) is f2.result(timeout=60)
    finally:
        srv.close()


def test_idempotency_scoped_by_charged_parties():
    """Same bytes, same seed, different billed party: a different ledger
    operation, never deduped."""
    srv = _server()
    try:
        srv.estimate(_mk_req(seed=7))
        srv.estimate(_mk_req(seed=7, party_x="alice"))
        assert srv.stats.idempotent_hits_completed == 0
        assert srv.ledger.spent("party-x") > 0.0
        assert srv.ledger.spent("alice") > 0.0
    finally:
        srv.close()


def test_idempotency_key_matches_jax():
    """The default retry identity of a pinned request is the JAX server's,
    so a ledger file shared by the two dedups the same charge ids."""
    srv = _server()
    jsrv = jserve.DpcorrServer(budget=1.0, shard="off")
    try:
        for req in (_mk_req(seed=3), _mk_req(seed=3, party_x="a"),
                    _mk_req(idempotency_key="job-9")):
            assert srv._idem_key(req) == jsrv._idem_key(_jreq(req))
        assert srv._idem_key(_mk_req()) is None
    finally:
        srv.close()
        jsrv.close()


def test_explicit_idempotency_key_on_assigned_stream():
    """Unpinned requests have no default retry identity (every submission
    is deliberately a fresh draw), but an explicit client key makes
    retries safe; without one, resubmission charges and draws again."""
    srv = _server()
    try:
        r1 = srv.estimate(_mk_req(idempotency_key="job-1"))
        r2 = srv.estimate(_mk_req(idempotency_key="job-1"))
        assert r2 is r1
        spent = srv.ledger.spent("party-x")
        a = srv.estimate(_mk_req())
        b = srv.estimate(_mk_req())
        assert a.seed != b.seed  # fresh streams, not a replay
        assert srv.ledger.spent("party-x") > spent
    finally:
        srv.close()


def test_http_idempotent_retry_byte_identical():
    """POSTing the same pinned request twice returns byte-identical
    bodies, with the stats endpoint counting one admission and one
    idempotent hit."""
    srv = _server()
    httpd, base = _start_http(srv)
    req = _mk_req(seed=5)
    body = json.dumps({"family": "ni_sign", "x": req.x.tolist(),
                       "y": req.y.tolist(), "eps1": 1.0, "eps2": 0.5,
                       "seed": 5}).encode()

    def post():
        with urllib.request.urlopen(urllib.request.Request(
                f"{base}/estimate", data=body,
                headers={"Content-Type": "application/json"})) as r:
            assert r.status == 200
            return r.read()
    try:
        first, second = post(), post()
        assert first == second
        _, snap = _get(f"{base}/stats")
        assert snap["requests_total"] == 1
        assert snap["idempotent_hits_completed"] == 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()


def test_overload_shed_refunds_budget():
    """A 429 must not consume ε: the charge lands before the enqueue, so
    a queue-refused request gets its spend reversed."""
    srv = _server(max_batch=1024, max_delay_s=30.0, max_queue=2)
    try:
        futs = [srv.submit(_mk_req(seed=i)) for i in range(2)]
        spent_before = srv.ledger.spent("party-x")
        for _ in range(3):  # repeated sheds refund every time
            with pytest.raises(ServerOverloadedError):
                srv.submit(_mk_req(seed=99))
        assert srv.ledger.spent("party-x") == pytest.approx(spent_before)
        assert srv.stats.requests_refused_overload == 3
        # admitted counter counts only successfully enqueued requests
        assert srv.stats.requests_total == 2
    finally:
        srv.close()
    # close() drains the still-queued requests as explicit refusals and
    # reverses their charges — nothing silently hangs, nothing is spent
    for f in futs:
        with pytest.raises(ServerClosedError):
            f.result(timeout=60)
    assert srv.ledger.spent("party-x") == pytest.approx(0.0)


def test_ledger_refund_reverses_and_clamps(tmp_path):
    path = str(tmp_path / "ledger.json")
    led = PrivacyLedger(budget=3.0, path=path)
    led.charge({"a": 2.0, "b": 1.0})
    led.refund({"a": 2.0})
    assert led.spent("a") == pytest.approx(0.0)
    assert led.spent("b") == pytest.approx(1.0)
    # the reversal is persisted like a charge
    led2 = PrivacyLedger(budget=3.0, path=path)
    assert led2.spent("a") == pytest.approx(0.0)
    # over-refund clamps at zero (errs toward privacy) and negative
    # refunds are rejected outright
    led.refund({"b": 5.0})
    assert led.spent("b") == 0.0
    with pytest.raises(ValueError, match="negative refund"):
        led.refund({"a": -1.0})


def test_coalescer_backpressure_sheds_load():
    # a delay window far longer than the test: nothing flushes while we
    # overfill the queue
    srv = _server(max_batch=1024, max_delay_s=30.0, max_queue=4)
    try:
        futs = [srv.submit(_mk_req(seed=i)) for i in range(4)]
        with pytest.raises(ServerOverloadedError):
            srv.submit(_mk_req(seed=99))
        assert srv.stats.requests_refused_overload == 1
    finally:
        srv.close()  # close drains: pending become refusals + refunds
    for f in futs:
        with pytest.raises(ServerClosedError):
            f.result(timeout=60)
    assert srv.ledger.spent("party-x") == pytest.approx(0.0)
    assert srv.stats.snapshot()["shed"]["closed"] == 4


def test_server_assigns_seeds_when_unpinned():
    srv = _server()
    try:
        r1 = srv.estimate(_mk_req(seed=None, i=0))
        r2 = srv.estimate(_mk_req(seed=None, i=0))
        # distinct admission-counter seeds → distinct noise draws on
        # identical data
        assert r1.seed != r2.seed
        assert r1.rho_hat != r2.rho_hat
    finally:
        srv.close()


def test_assigned_streams_differ_across_restarts():
    """The counter restarts at 0 on every boot while the ledger does not —
    without the per-boot nonce the first unpinned query of every
    incarnation would reuse one noise stream."""
    req = _mk_req(seed=None, i=0)
    rhos = []
    for _ in range(2):  # two "boots" of the same configuration
        srv = _server()
        try:
            r = srv.estimate(req)
            assert r.seed == 0  # same counter seed both times ...
            rhos.append(r.rho_hat)
        finally:
            srv.close()
    assert rhos[0] != rhos[1]  # ... but independent noise streams


def test_pinned_seed_bound_to_request_content():
    """A repeated pinned seed over DIFFERENT data draws independent noise,
    while the identical request stays exactly replayable — across server
    incarnations."""
    a, b = _mk_req(seed=7, i=0), _mk_req(seed=7, i=1)
    master = rng.master_key(rng.MASTER_SEED)
    ka = pinned_request_key(master, a, 7)
    kb = pinned_request_key(master, b, 7)
    assert not torch.equal(ka, kb)
    srv = _server()
    try:
        ra, rb = srv.estimate(a), srv.estimate(b)
    finally:
        srv.close()
    assert ra.rho_hat != rb.rho_hat
    srv2 = _server()
    try:
        ra2 = srv2.estimate(a)
    finally:
        srv2.close()
    assert (ra.rho_hat, ra.ci_low, ra.ci_high) == \
        (ra2.rho_hat, ra2.ci_low, ra2.ci_high)


def test_pinned_and_assigned_subtrees_disjoint():
    """A client pinning seed k and the server assigning counter seed k
    must not share a stream."""
    req = _mk_req(seed=3, i=0)
    master = rng.master_key(rng.MASTER_SEED)
    pinned = pinned_request_key(master, req, 3)
    srv = _server()
    try:
        unpinned = srv._request_key(_mk_req(seed=None, i=0), 3)
    finally:
        srv.close()
    assert not torch.equal(pinned, unpinned)


# ----------------------------------------------------------------- HTTP ----

def test_http_endpoints_smoke():
    srv = _server(per_party_budget={"tiny": 0.1})
    httpd, base = _start_http(srv)

    def post(payload, expect):
        try:
            with urllib.request.urlopen(urllib.request.Request(
                    f"{base}/estimate", data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"})) as r:
                assert r.status == expect
                return json.load(r)
        except urllib.error.HTTPError as e:
            assert e.code == expect
            return json.load(e)

    try:
        assert _get(f"{base}/healthz") == (200, {"ok": True})
        req = _mk_req(seed=5)
        body = {"family": "ni_sign", "x": req.x.tolist(),
                "y": req.y.tolist(), "eps1": 1.0, "eps2": 0.5, "seed": 5}
        got = post(body, 200)
        assert _direct(srv, req) == (got["rho_hat"], got["ci_low"],
                                     got["ci_high"])
        # invalid request → 400
        post({"family": "nope", "x": [1, 2], "y": [1, 2],
              "eps1": 1, "eps2": 1}, 400)
        # over-budget party → 403
        refused = post(dict(body, party_x="tiny"), 403)
        assert refused["refused"] == "budget"
        _, snap = _get(f"{base}/stats")
        assert snap["requests_total"] == 1
        assert snap["requests_refused_budget"] == 1
        assert "ledger" in snap
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{base}/nope")
        assert ei.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()


def test_http_client_round_trips_a_budget_refusal():
    """``HttpEstimateClient`` maps 200 to a response and 403 back to the
    typed refusal, and the refused request spends nothing."""
    from dpcorr_torch.serve import HttpEstimateClient

    srv = _server(per_party_budget={"tiny": 0.1})
    httpd, base = _start_http(srv)
    client = HttpEstimateClient(base, timeout_s=30.0)
    try:
        req = _mk_req(seed=5)
        got = client.estimate(req)
        assert (got.rho_hat, got.ci_low, got.ci_high) == _direct(srv, req)
        with pytest.raises(BudgetExceededError) as ei:
            client.estimate(_mk_req(seed=6, party_x="tiny"))
        assert (ei.value.party, ei.value.budget) == ("tiny", 0.1)
        assert srv.ledger.spent("tiny") == 0.0
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()


def test_readyz_gates_on_the_warm_set(tmp_path):
    """``/readyz`` is 503 until the warmup signatures are resident, then
    200; on close the resident set is written as a manifest that the
    next boot (of either package) replays."""
    manifest = str(tmp_path / "warm.json")
    srv = _server(warmup="ni_sign:96:1.0:0.5:1,4;int_subg:200:1.0:0.5:2",
                  warmup_manifest=manifest, warmup_autostart=False)
    httpd, base = _start_http(srv)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{base}/readyz")
        assert ei.value.code == 503
        assert json.load(ei.value)["state"] == "pending"
        srv.start_warmup()
        assert srv.wait_ready(30.0)
        code, body = _get(f"{base}/readyz")
        assert code == 200 and body["warmed"] == body["total"] == 3
        assert srv.stats.kernel_compiles == 3
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    sigs = warmup_mod.load_manifest(manifest)
    assert len(sigs) == 3
    assert jserve.load_manifest(manifest) == sigs
    assert warmup_mod.signatures_to_keys(sigs) == [
        (tuple(k), b) for k, b in
        jserve.signatures_to_keys(jserve.load_manifest(manifest))]


def test_warmup_spec_parses_as_in_jax():
    spec = "ni_sign:500:1.0:0.5:auto;int_subg:1000:1.0:1.0:1,64:0.1:0"
    assert warmup_mod.parse_warmup_spec(spec, 16) == \
        jserve.parse_warmup_spec(spec, 16)
    with pytest.raises(ValueError, match="bad --warmup entry"):
        warmup_mod.parse_warmup_spec("ni_sign:500", 16)


def test_cli_serve_banner_and_estimate(tmp_path):
    """``python -m dpcorr_torch serve --port 0`` binds, prints the serving
    banner and answers ``POST /estimate``."""
    ledger = str(tmp_path / "ledger.json")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dpcorr_torch", "serve", "--device", "cpu",
         "--port", "0", "--ledger", ledger, "--max-delay-ms", "1"],
        stdout=subprocess.PIPE, text=True)
    try:
        banner = json.loads(proc.stdout.readline())["serving"]
        assert banner["device"] == "cpu" and banner["ledger"] == ledger
        assert banner["instance"] == f"serve-{banner['port']}"
        base = f"http://127.0.0.1:{banner['port']}"
        req = _mk_req(seed=5)
        body = json.dumps({"family": "ni_sign", "x": req.x.tolist(),
                           "y": req.y.tolist(), "eps1": 1.0, "eps2": 0.5,
                           "seed": 5}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"{base}/estimate", data=body), timeout=60) as r:
            got = json.load(r)
        srv_seed = rng.MASTER_SEED

        class _S:
            seed = srv_seed
        assert (got["rho_hat"], got["ci_low"], got["ci_high"]) == \
            _direct(_S, req)
        assert json.load(open(ledger))["spent"]["party-x"] == 2.0
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# ----------------------------------------------------- telemetry (obs) ----

def test_metrics_endpoint_matches_stats():
    """GET /metrics serves Prometheus text whose counters agree
    numerically with the GET /stats snapshot — both views read the same
    registry."""
    srv = _server()
    httpd, base = _start_http(srv)
    try:
        for i in range(3):
            srv.estimate(_mk_req(seed=i, i=i), timeout=60)
        with urllib.request.urlopen(f"{base}/metrics") as r:
            assert r.headers["Content-Type"] == CONTENT_TYPE
            text = r.read().decode()
        _, snap = _get(f"{base}/stats")
        series = parse_exposition(text)
        assert "# TYPE dpcorr_serve_requests_total counter" in text
        assert series["dpcorr_serve_requests_total"] == \
            snap["requests_total"]
        assert series["dpcorr_serve_batches_flushed_total"] == \
            snap["batches_flushed"]
        assert series["dpcorr_serve_kernel_compiles_total"] == \
            snap["kernel_compiles"]
        assert series["dpcorr_serve_latency_seconds_count"] == \
            snap["batched_requests"] + snap["unbatched_requests"]
        # the ledger publishes into the same registry (server wiring)
        assert series['dpcorr_ledger_events_total{kind="charge"}'] == 3.0
        assert series['dpcorr_ledger_spent_eps{party="party-x"}'] == \
            snap["ledger"]["parties"]["party-x"]["spent"]
        assert series[
            'dpcorr_compile_recompile_total{cause="new-signature"}'] == \
            snap["recompiles"]["new-signature"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()


def test_snapshot_latency_histogram_additive():
    """snapshot() keeps the latency_s percentiles from the reservoir and
    adds the bucketed histogram view."""
    st = ServeStats()
    st.observe_latency(0.003)
    st.observe_latency(0.3)
    snap = st.snapshot()
    assert snap["latency_s"]["p50"] in (0.003, 0.3)
    hist = snap["latency_histogram"]
    assert hist["count"] == 2
    assert hist["sum"] == pytest.approx(0.303)
    assert hist["buckets"]["0.005"] == 1  # cumulative: only the 3ms obs
    assert hist["buckets"]["0.5"] == 2


def test_trace_chain_links_request_to_flush(tmp_path):
    """A single trace ID links one request's span chain from admission
    through ledger charge to kernel flush."""
    path = str(tmp_path / "spans.jsonl")
    srv = _server(tracer=Tracer(path))
    try:
        resp = srv.estimate(_mk_req(seed=0), timeout=60)
    finally:
        srv.close()
    spans = read_spans(path)
    by_name = {s["name"]: s for s in spans}
    root = by_name["serve.request"]
    chain = {s["name"] for s in spans if s["trace_id"] == root["trace_id"]}
    assert {"serve.request", "serve.admit", "serve.ledger.charge",
            "serve.enqueue", "serve.flush", "serve.kernel"} <= chain
    # tree shape: admit under root, charge under admit, flush under root
    assert by_name["serve.admit"]["parent_id"] == root["span_id"]
    assert by_name["serve.ledger.charge"]["parent_id"] == \
        by_name["serve.admit"]["span_id"]
    assert by_name["serve.flush"]["parent_id"] == root["span_id"]
    assert by_name["serve.kernel"]["parent_id"] == \
        by_name["serve.flush"]["span_id"]
    # the root closes at respond with the end-to-end latency
    assert root["attrs"]["latency_s"] == pytest.approx(resp.latency_s)
    # client thread vs coalescer flush thread, one trace across both
    assert by_name["serve.flush"]["thread"] == "dpcorr-serve-flush"
    assert root["thread"] != by_name["serve.flush"]["thread"]


def test_refused_request_span_ends_with_reason(tmp_path):
    path = str(tmp_path / "spans.jsonl")
    srv = _server(per_party_budget={"tiny": 0.01}, tracer=Tracer(path))
    try:
        with pytest.raises(BudgetExceededError):
            srv.submit(_mk_req(seed=0, party_x="tiny"))
    finally:
        srv.close()
    roots = [s for s in read_spans(path) if s["name"] == "serve.request"]
    assert roots and roots[0]["attrs"]["refused"] == "budget"


def test_audit_trail_replays_to_ledger_state(tmp_path):
    """The per-party ε spend is reproducible from the audit trail alone —
    replay(trail) == ledger snapshot, in the port's replay and the JAX
    package's — and every event carries the request's trace ID."""
    from dpcorr.obs import replay as jax_replay

    audit = str(tmp_path / "audit.jsonl")
    srv = _server(per_party_budget={"tiny": 0.01},
                  tracer=Tracer(str(tmp_path / "spans.jsonl")), audit=audit)
    try:
        for i in range(3):
            srv.estimate(_mk_req(seed=i, i=i), timeout=60)
        with pytest.raises(BudgetExceededError):
            srv.submit(_mk_req(seed=9, party_x="tiny"))
        ledger_snap = srv.ledger.snapshot()
    finally:
        srv.close()
    events = read_events(audit)
    assert [e["kind"] for e in events] == ["charge"] * 3 + ["refusal"]
    assert all(e["trace_id"] for e in events)
    spent = replay(events)
    assert jax_replay(events) == spent
    assert set(spent) == set(ledger_snap["parties"])
    for p, s in spent.items():
        assert s == pytest.approx(ledger_snap["parties"][p]["spent"])
    # the refusal event names the violating party and its standing
    refusal = events[-1]
    assert refusal["party"] == "tiny" and refusal["budget"] == 0.01


def test_overload_refund_lands_in_audit():
    """A backpressure-shed request leaves a charge+refund pair sharing one
    trace ID: net-zero spend, fully auditable."""
    trail = AuditTrail()
    srv = _server(max_queue=1, max_batch=1024, max_delay_s=30.0,
                  audit=trail)
    try:
        fut = srv.submit(_mk_req(seed=0, i=0))  # fills the queue
        with pytest.raises(ServerOverloadedError):
            srv.submit(_mk_req(seed=1, i=1))
    finally:
        srv.close()  # refuse-drains the queued request (second refund)
    with pytest.raises(ServerClosedError):
        fut.result(timeout=60)
    events = trail.events()
    kinds = [e["kind"] for e in events]
    assert kinds == ["charge", "charge", "refund", "refund"]
    assert [e.get("reason") for e in events[2:]] == ["overload", "closed"]
    spent = replay(events)
    for p, s in spent.items():
        assert s == pytest.approx(0.0)


def test_ledger_registry_publishes_spend():
    r = Registry()
    led = PrivacyLedger(2.0, registry=r)
    led.charge({"a": 1.5})
    led.refund({"a": 0.5})
    with pytest.raises(BudgetExceededError):
        led.charge({"a": 1.5})
    g = r.get("dpcorr_ledger_spent_eps")
    assert g.value(party="a") == pytest.approx(1.0)
    c = r.get("dpcorr_ledger_events_total")
    assert (c.value(kind="charge"), c.value(kind="refund"),
            c.value(kind="refusal")) == (1.0, 1.0, 1.0)


def test_flight_recorder_dump_reconstructs_a_request(tmp_path):
    """With a recorder attached, a dump holds the request's spans, cost
    record and audit events; the JAX package's reader accepts it."""
    from dpcorr.obs.recorder import read_dump as jax_read_dump
    from dpcorr_torch.obs import recorder

    rec = recorder.FlightRecorder(str(tmp_path / "dump.json"))
    srv = _server(tracer=Tracer(None), audit=AuditTrail())
    srv.attach_recorder(rec)
    try:
        srv.estimate(_mk_req(seed=4), timeout=60)
        path = recorder.trigger("cli", why="test")
    finally:
        srv.close()
        recorder.install(None)
        rec.detach_logging("dpcorr")
    doc = recorder.read_dump(path)
    assert jax_read_dump(path)["reason"] == "cli"
    trace_id = next(sp["trace_id"] for sp in doc["spans"]
                    if sp["name"] == "serve.request")
    story = recorder.reconstruct(doc, trace_id)
    assert story["eps_net"] == {"party-x": 2.0, "party-y": 1.0}
    assert story["cost"]["eps_charged"] == {"party-x": 2.0, "party-y": 1.0}
    assert story["spans"][0]["name"] == "serve.request"


# ------------------------------------------------- per-user budgets ----

def test_user_folds_into_the_idempotency_key_as_jax_does():
    """The user routes a budget leg: it is folded into the pinned
    request's idempotency key (as JAX folds it) but not into its noise
    key, so the same query from two users is two charges of one stream."""
    srv = _server()
    jsrv = jserve.DpcorrServer(budget=1e6, max_delay_s=0.001, shard="off")
    try:
        for user in (None, "alice", "bob"):
            req = _mk_req(seed=7, user=user)
            jreq = jserve.EstimateRequest(
                req.family, req.x, req.y, req.eps1, req.eps2, seed=7,
                user=user)
            assert srv._idem_key(req) == jsrv._idem_key(jreq)
            assert pinned_request_key(rng.master_key(0), req, 7).tolist() \
                == pinned_request_key(rng.master_key(0), _mk_req(seed=7),
                                      7).tolist()
        assert srv._idem_key(_mk_req(seed=7, user="alice")) \
            != srv._idem_key(_mk_req(seed=7))
        with pytest.raises(ValueError, match="user"):
            _mk_req(seed=7, user=3)
    finally:
        srv.close()
        jsrv.close()


def test_user_dir_server_charges_every_level_and_refuses_at_user(tmp_path):
    """Per-user admission: the user leg is the request's total party ε;
    a request past the user's budget is a 403 at the user level over
    HTTP, spends nothing at any level and is answered by no kernel; the
    directory is read alike by the JAX package."""
    from dpcorr.obs.budget_replay import read_user_balances as jread

    from dpcorr_torch.obs.budget_replay import read_user_balances

    audit = str(tmp_path / "audit.jsonl")
    srv = _server(user_dir=str(tmp_path / "users"), user_budget=6.0,
                  user_shards=4, global_budget=100.0, audit=audit)
    httpd, base = _start_http(srv)
    try:
        for s in range(2):  # ni_sign + normalise: 2.0 + 1.0 per request
            got = srv.estimate(_mk_req(seed=s + 1, user="alice"))
            assert (got.rho_hat, got.ci_low, got.ci_high) \
                == _direct(srv, _mk_req(seed=s + 1))
        spent = dict(srv.ledger.snapshot()["parties"])
        req = _mk_req(seed=9, user="alice")
        body = json.loads(json.dumps(
            {"family": req.family, "x": req.x.tolist(),
             "y": req.y.tolist(), "eps1": 1.0, "eps2": 0.5, "seed": 9,
             "user": "alice"}))
        code = None
        try:
            urllib.request.urlopen(urllib.request.Request(
                f"{base}/estimate", data=json.dumps(body).encode()),
                timeout=60)
        except urllib.error.HTTPError as e:
            code, err = e.code, json.loads(e.read())
        assert code == 403 and err["level"] == "user" \
            and err["party"] == "user/alice"
        assert srv.ledger.snapshot()["parties"] == spent
        assert srv.ledger.spent("user/alice") == pytest.approx(6.0)
        assert srv.ledger.spent("global/total") == pytest.approx(6.0)
        srv.estimate(_mk_req(seed=3, user="bob"))  # another user: admitted
        snap = srv.stats_snapshot()
        assert snap["budget_dir"]["refusals_by_level"]["user"] == 1
        assert snap["budget_dir"]["shards"] == 4
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    bal = read_user_balances(str(tmp_path / "users"))
    assert {u: b["l"] for u, b in bal.items()} == {"alice": 6.0,
                                                   "bob": 3.0}
    assert jread(str(tmp_path / "users")) == bal
    levels = replay_levels(read_events(audit))
    assert levels["user"] == {"alice": 6.0, "bob": 3.0}
    assert levels["global"] == {"global/total": 9.0}


def test_request_json_carries_the_user():
    from dpcorr_torch.serve import request_to_json
    from dpcorr_torch.serve.server import _request_from_json

    req = _mk_req(seed=4, user="carol")
    back = _request_from_json(json.loads(json.dumps(request_to_json(req))))
    assert back.user == "carol" and back.seed == 4
    assert _request_from_json(json.loads(json.dumps(request_to_json(
        _mk_req(seed=4))))).user is None


def test_global_budget_alone_caps_the_server():
    srv = _server(global_budget=4.5)
    try:
        srv.estimate(_mk_req(seed=1))  # 2.0 + 1.0 = 3.0 global
        with pytest.raises(BudgetExceededError) as ei:
            srv.estimate(_mk_req(seed=2))
        assert ei.value.level == "global"
        assert srv.ledger.spent("party-x") == pytest.approx(2.0)
        assert "budget_dir" not in srv.stats_snapshot()
    finally:
        srv.close()


@pytest.mark.parametrize("seed", [2**32 + 5, -1])
def test_out_of_range_pinned_seed_refused_before_the_charge(seed, tmp_path):
    """A pinned seed outside [0, 2³²) cannot be folded into the key-tree:
    both packages refuse the request before the ledger charge, in process
    (``OverflowError``) and over HTTP (the same status), with the ledger
    and the audit trail unchanged and seed 5's noise never served."""
    audit = str(tmp_path / "audit.jsonl")
    srv = _server(audit=audit)
    jsrv = jserve.DpcorrServer(budget=1e6, max_delay_s=0.001, shard="off")
    req = _mk_req(seed=seed)
    try:
        with pytest.raises(OverflowError):
            srv.submit(req)
        with pytest.raises(OverflowError):
            jsrv.submit(_jreq(req))
        assert srv.ledger.spent("party-x") == 0.0
        assert srv.ledger.spent("party-y") == 0.0
        assert read_events(audit) == []
        body = json.dumps({"family": "ni_sign", "x": req.x.tolist(),
                           "y": req.y.tolist(), "eps1": 1.0, "eps2": 0.5,
                           "seed": seed}).encode()
        codes = []
        for server in (srv, jsrv):
            make = make_http_server if server is srv else \
                jserve.make_http_server
            httpd = make(server, host="127.0.0.1", port=0)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            try:
                urllib.request.urlopen(urllib.request.Request(
                    f"http://127.0.0.1:{httpd.server_address[1]}/estimate",
                    data=body, headers={"Content-Type": "application/json"}))
            except urllib.error.HTTPError as e:
                codes.append((e.code, json.load(e)["error"].split(":")[0]))
            finally:
                httpd.shutdown()
                httpd.server_close()
        assert codes[0] == codes[1] == (500, "OverflowError")
        assert srv.ledger.snapshot() == jsrv.ledger.snapshot()
        assert srv.ledger.spent("party-x") == 0.0
        assert read_events(audit) == []
        assert srv.stats.snapshot()["requests_total"] == 0
    finally:
        srv.close()
        jsrv.close()


# ------------------------------------------------- POST /obs/trigger ----

def _page(instance):
    from dpcorr_torch.obs.slo import Alert

    return Alert(objective="latency", instance=instance, severity="page",
                 previous="ok", burn_short=20.0, burn_long=15.0,
                 window=("page", 300.0, 3600.0, 14.4), at=0.0)


def test_slo_page_over_http_dumps_the_serve_replica(tmp_path):
    """A burn-rate page sent through ``obs.slo.http_trigger_hook`` to a
    ``serve`` replica with a flight recorder installed dumps that
    recorder, inside the replica, with ``slo_page`` in its history."""
    from dpcorr_torch.obs import recorder
    from dpcorr_torch.obs.slo import http_trigger_hook

    rec = recorder.FlightRecorder(str(tmp_path / "dump.json"))
    srv = _server(audit=AuditTrail())
    srv.attach_recorder(rec)
    httpd, base = _start_http(srv)
    try:
        srv.estimate(_mk_req(seed=4), timeout=60)
        http_trigger_hook({"r0": base})(_page("r0"))
        assert rec.reasons == ["slo_page"]
        doc = recorder.read_dump(rec.path)
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
        recorder.install(None)
        rec.detach_logging("dpcorr")
    assert doc["reason"] == "slo_page"
    assert doc["detail"]["instance"] == "r0"
    assert doc["detail"]["objective"] == "latency"
    assert [e["kind"] for e in doc["audit"]] == ["charge"]


def _post_raw(url, blob):
    try:
        with urllib.request.urlopen(urllib.request.Request(
                url, data=blob,
                headers={"Content-Type": "application/json"})) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_obs_trigger_codes_and_bodies_match_jax(tmp_path):
    """The route's answers against the JAX server's on the same bodies:
    200 ``{"dumped", "armed"}`` for a known reason (with and without a
    recorder installed), 400 naming an unknown reason or a non-object
    ``detail``, 404 for any other POST route."""
    from dpcorr.obs import recorder as jrecorder
    from dpcorr_torch.obs import recorder

    bodies = [
        ({"reason": "slo_page", "detail": {"objective": "o"}}, True),
        ({"reason": "sentinel_violation"}, True),
        ({"reason": "bogus"}, True),
        ({"reason": "cli", "detail": [1, 2]}, True),
        ({"reason": "cli"}, False),
    ]
    answers = {}
    for pkg, mod, make, srv in (
            ("port", recorder, make_http_server, _server()),
            ("jax", jrecorder, jserve.make_http_server,
             jserve.DpcorrServer(budget=1e6, max_delay_s=0.001,
                                 shard="off"))):
        rec = mod.FlightRecorder(str(tmp_path / f"{pkg}.json"))
        httpd = make(srv, host="127.0.0.1", port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        got = []
        try:
            for body, armed in bodies:
                mod.install(rec if armed else None)
                code, doc = _post_raw(f"{base}/obs/trigger",
                                      json.dumps(body).encode())
                if "dumped" in doc:
                    doc["dumped"] = doc["dumped"] is not None
                got.append((code, doc))
            got.append(_post_raw(f"{base}/obs/trigger", b"{not json"))
            got.append(_post_raw(f"{base}/nope", b"{}"))
            got.append(rec.reasons)
        finally:
            mod.install(None)
            httpd.shutdown()
            httpd.server_close()
            srv.close()
        answers[pkg] = got
    port = answers["port"]
    assert [c for c, _ in port[:7]] == [200, 200, 400, 400, 200, 400, 404]
    assert port[0][1] == {"dumped": True, "armed": True}
    assert port[4][1] == {"dumped": False, "armed": False}
    assert port[2][1] == {"error": "unknown trigger reason 'bogus'"}
    assert port[7] == ["slo_page", "sentinel_violation"]
    port[5][1]["error"] = answers["jax"][5][1]["error"] = "<decode error>"
    assert port == answers["jax"]


def test_obs_trigger_refuses_a_body_that_is_not_an_object():
    """A JSON body that is not an object gets a 400 (the JAX handler's
    ``body.get`` raises there and the connection drops unanswered)."""
    srv = _server()
    httpd, base = _start_http(srv)
    try:
        code, doc = _post_raw(f"{base}/obs/trigger", b"[1, 2]")
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    assert code == 400 and "object has no attribute 'get'" in doc["error"]
