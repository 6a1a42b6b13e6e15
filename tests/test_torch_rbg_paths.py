"""HRS, serving and the fleet, the stream, the protocol and the
federation on the rbg and unsafe_rbg key-trees, against ``dpcorr`` under
the same ``DPCORR_PRNG``, on the CPU at small sizes: a synthetic HRS
panel of 2,578 wave-2 cases (96,000 rows), n ≤ 2000 elsewhere.

The HRS panel is that large because the DP standardization's second
moment is noisy at small n: at 172 or 430 cases many seeds draw it below
μ² in every impl, σ̂ comes out 0 in both packages and the z-scores of
order 10⁹; under rbg the default seed does so up to 1,718 cases. At 2,578
cases both rbg-family impls give a proper σ̂ at the default seed, as
they do at the real panel's 19,433.

What is held, and how closely:

- keys, bit for bit: the host-word chains (``rng.fold_in_words`` on four
  words, the serving layer's request keys, the stream's window keys),
  the protocol's party and column roots, and the host Philox against the
  kernel's plain version;
- estimates against the JAX package within the existing threefry tests'
  tolerances: 1e-5 absolute on ρ̂ and the CI ends, subG rows also
  2.5e-7 relative, a sign-family row beyond that only where a privately
  centered value lies within 1e-5 of 0 (``tests/test_torch_serve.py``'s
  rule); stream releases within ``test_release_and_chunk_stats_match_
  jax``'s; HRS rows within ``tests/test_torch_hrs.py``'s 1e-5 (they
  measure within 1e-6);
- within the port, bit for bit: the exact engine, a replay session and
  the federation's exact finisher against the direct single call, stream
  partitions against the monolith, a restarted stream service against
  its first run, the bootstrap at two chunk widths.

Where the JAX package vmaps over keys (serve's vector engine, the
federation's vector finisher, the HRS sweep and bootstrap, and under
unsafe_rbg ``rep_keys`` itself), its batching rule for
``rng_bit_generator`` draws the whole batch from the first key. The port
draws per key, so its rows are held against JAX's *unbatched* call on
each row's key, and its summaries against the vmapped run within the
Monte-Carlo band; the divergence itself is pinned where it shows.
"""

import dataclasses
import json
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpcorr.protocol as jproto
import dpcorr.serve as jserve
from dpcorr import hrs as jhrs
from dpcorr.models.estimators import split_reference as jsr
from dpcorr.models.estimators.common import k_pad_for
from dpcorr.ops.standardize import priv_center as jax_priv_center
from dpcorr.stream import sketch as jsketch
from dpcorr.utils import rng as jrng
from dpcorr_torch import hrs, perf_hrs
from dpcorr_torch.models.estimators import split_reference as sr
from dpcorr_torch.models.estimators.registry import serving_entry
from dpcorr_torch.ops import rbg as rbg_op
from dpcorr_torch.protocol import ProtocolSpec, ReliableChannel, run_inproc
from dpcorr_torch.protocol.federation import run_federation_inproc
from dpcorr_torch.protocol.matrix import FederationPlan
from dpcorr_torch.protocol.party import Party
from dpcorr_torch.serve import DpcorrServer, EstimateRequest, KernelCache
from dpcorr_torch.serve import pinned_request_key
from dpcorr_torch.serve.fleet.supervisor import ReplicaSpec, Supervisor
from dpcorr_torch.serve.ledger import PrivacyLedger
from dpcorr_torch.serve.request import kernel_key
from dpcorr_torch.serve.server import boot_request_key
from dpcorr_torch.stream import sketch
from dpcorr_torch.stream.service import Releaser, StreamService
from dpcorr_torch.stream.sketch import ReleaseParams
from dpcorr_torch.stream.windows import Window, WindowSpec
from dpcorr_torch.utils import rng

RBG = ("rbg", "unsafe_rbg")
FAMILIES = ("ni_sign", "int_sign", "ni_subg", "int_subg")
#: the low counter half at 2⁶⁴ − 2 (tests/test_torch_rbg.py's key)
CARRY = [5, 0xFFFFFFFF, 0xFFFFFFFE, 0xFFFFFFFF]
#: agreement with the JAX package: the estimator tests' bounds
ATOL, SUBG_RTOL, TIE = 1e-5, 2.5e-7, 1e-5
HRS_ROWS = 96_000
HRS_EPS = [0.45, 1.85]
HRS_REPS = 3
CFG, JCFG = hrs.HrsConfig(), jhrs.HrsConfig()


@pytest.fixture(params=RBG)
def impl(request, monkeypatch):
    monkeypatch.setenv("DPCORR_PRNG", request.param)
    # the JAX package's stream kernels are cached on their statics, not
    # on the key impl: a kernel compiled for rbg keys refuses unsafe_rbg
    monkeypatch.setattr(jsketch, "_KERNELS", {})
    return request.param


def _jkey(words, impl):
    """A port key's words as a JAX key of ``impl``."""
    return jax.random.wrap_key_data(
        jnp.asarray(np.asarray(words, np.int64).astype(np.uint32)),
        impl=impl)


def _jwords(jkey) -> list:
    return np.asarray(jax.random.key_data(jkey)).astype(np.int64).tolist()


def _sign_near_tie(family, words, x, y, eps, impl) -> bool:
    """Does a privately centered value of either column sit within TIE of
    0 (a sign another f32 summation order may flip)?"""
    if not family.endswith("sign"):
        return False
    prefix = "ni_sign" if family == "ni_sign" else "int_sign"
    k = _jkey(words, impl)
    l_clip = float(np.sqrt(2.0 * np.log(len(x))))
    cx = jax_priv_center(jrng.stream(k, f"{prefix}/std_x"), jnp.asarray(x),
                         eps[0], l_clip)
    cy = jax_priv_center(jrng.stream(k, f"{prefix}/std_y"), jnp.asarray(y),
                         eps[1], l_clip)
    return bool((np.abs(np.asarray(cx)) < TIE).any()
                or (np.abs(np.asarray(cy)) < TIE).any())


def _agrees(family, got, want, words, x, y, eps, impl) -> bool:
    rtol = SUBG_RTOL if family.endswith("subg") else 0.0
    return bool(np.isclose(got, want, rtol=rtol, atol=ATOL).all()) \
        or _sign_near_tie(family, words, x, y, eps, impl)


def _columns(n, rho=0.6, seed=99):
    r = np.random.default_rng(seed)
    xy = r.multivariate_normal([0.0, 0.0], [[1.0, rho], [rho, 1.0]],
                               size=n)
    return (np.asarray(xy[:, 0], np.float32),
            np.asarray(xy[:, 1], np.float32))


# ----------------------------------------------------------- host keys ----

@pytest.mark.parametrize("data", [
    0, 1, 2**31, 2**32 - 1, np.int64(-1), np.float64(3.7),
    rng.stream_index("serve/pinned")],
    ids=["0", "1", "2^31", "2^32-1", "int64(-1)", "float64(3.7)", "crc32"])
def test_fold_in_words_bit_equal_to_jax(impl, data):
    """Four host words folded as the process impl reads them, bit-equal to
    ``jax.random.fold_in`` and to the port's tensor ``fold_in``; a chain of
    three folds stays equal."""
    for seed in (0, 2025, 2**32 - 1):
        jk, pk = jrng.master_key(seed), rng.master_key(seed)
        words = tuple(pk.tolist())
        got, jk = rng.fold_in_words(words, data), jax.random.fold_in(jk, data)
        assert len(got) == 4
        assert list(got) == _jwords(jk)
        assert list(got) == rng.fold_in(pk, data).tolist()
        for d in (7, data, 2**31 - 1):
            got, jk = rng.fold_in_words(got, d), jax.random.fold_in(jk, d)
        assert list(got) == _jwords(jk)


@pytest.mark.parametrize("offset", [0, 9])
@pytest.mark.parametrize("key", [CARRY, [0, 2**31, 0, 2**31]],
                         ids=["carry", "fold-seed"])
def test_host_philox_equals_the_plain_generator(offset, key):
    """The host Philox (the third implementation) against the kernel's
    plain version, across the 128-bit counter's carry."""
    want = rbg_op.rbg_bits_plain(torch.tensor([key], dtype=torch.int64),
                                 4 * 5, offset)[0].tolist()
    assert list(rng._philox_words(key, 5, offset)) == want


def test_fold_in_words_takes_two_or_four_words(monkeypatch):
    monkeypatch.delenv("DPCORR_PRNG", raising=False)
    two = tuple(rng.master_key(3).tolist())
    assert rng.fold_in_words(two, 5) == tuple(
        rng.fold_in(rng.master_key(3), 5).tolist())
    for words in ((1, 2, 3), (1,), (1, 2, 3, 4, 5)):
        with pytest.raises(ValueError, match="2 .threefry2x32. or 4"):
            rng.fold_in_words(words, 5)
    with pytest.raises(OverflowError):
        rng.fold_in_words((0, 1, 0, 1), 2**32)


def test_a_key_of_the_other_rbg_impl_still_raises(impl):
    """Four words carry no impl: the impl the process would not read them
    as is refused where it is named, as before."""
    other = [i for i in RBG if i != impl][0]
    with pytest.raises(ValueError, match=f"read as '{impl}'"):
        rng.master_key(5, impl=other)
    with pytest.raises(ValueError, match=f"read as '{impl}'"):
        rng.keys_from_data(np.zeros((3, 4), np.uint32), impl=other)


# --------------------------------------------------------------- serve ----

def _mk_req(n=96, family="ni_sign", seed=None, i=0):
    rs = np.random.RandomState(100 + i)
    return EstimateRequest(family, rs.randn(n).astype(np.float32),
                           rs.randn(n).astype(np.float32), 1.0, 0.5,
                           seed=seed)


def _jreq(req):
    return jserve.EstimateRequest(req.family, req.x, req.y, req.eps1,
                                  req.eps2, seed=req.seed)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_request_keys_bit_equal_to_jax(impl, seed):
    master, jmaster = rng.master_key(2025), jrng.master_key(2025)
    for i, fam in enumerate(FAMILIES):
        req = _mk_req(n=120 + i, family=fam, seed=seed, i=i)
        got = pinned_request_key(master, req, seed)
        assert got.shape == (4,)
        assert got.tolist() == _jwords(
            jserve.pinned_request_key(jmaster, _jreq(req), seed))
    for nonce, counter in ((seed, 0), (12345, seed), (2**31 - 1, 4096)):
        want = jrng.design_key(jrng.design_key(
            jrng.stream(jmaster, "serve/boot"), nonce), counter)
        assert boot_request_key(master, nonce, counter).tolist() \
            == _jwords(want)


def _lanes(b, n, seed=3):
    rs = np.random.RandomState(seed)
    xs = rs.randn(b, n).astype(np.float32)
    ys = rs.randn(b, n).astype(np.float32)
    keys = rng.design_key(rng.master_key(11)[None], torch.arange(b))
    return keys, xs, ys


@pytest.mark.parametrize("family", FAMILIES)
def test_exact_engine_matches_jax(impl, family):
    """The port's exact engine (lane by lane) against the JAX package's
    (``lax.map``, a scan: each lane draws from its own key) on the same
    four-word keys: every lane bit-equal to the port's direct call and
    within the estimator tolerance of JAX's lane."""
    n, b, eps = 500, 5, (1.0, 0.5)
    keys, xs, ys = _lanes(b, n)
    kk = kernel_key(_mk_req(n=n, family=family))
    got = KernelCache(shard="off", mode="exact", device="cpu").run_batch(
        kk, keys, xs, ys)
    jkeys = _jkey(keys.numpy(), impl)
    want = jserve.KernelCache(shard="off", mode="exact").run_batch(
        kk, jkeys, xs, ys)
    single = serving_entry(family, *eps, device="cpu")
    bad = 0
    for i in range(b):
        direct = tuple(float(v) for v in single(
            keys[i], torch.from_numpy(xs[i]), torch.from_numpy(ys[i])))
        lane = tuple(float(got[j][i]) for j in range(3))
        assert lane == direct, i
        ok = _agrees(family, lane, [float(want[j][i]) for j in range(3)],
                     keys[i].numpy(), xs[i], ys[i], eps, impl)
        assert ok, (family, i)
        bad += not np.isclose(lane, [want[j][i] for j in range(3)],
                              atol=ATOL).all()
    assert bad <= 1


def test_vector_lanes_are_per_key_where_jax_vmap_is_not(impl):
    """The port's vector engine: every lane bit-equal to the exact
    engine's (the CPU contract), because each lane draws from its own key.
    JAX's vector engine (``jax.vmap``) draws all lanes from lane 0's key:
    its lane 0 agrees with its exact engine, lanes 1 and up do not."""
    n, b = 300, 6
    keys, xs, ys = _lanes(b, n, seed=5)
    kk = kernel_key(_mk_req(n=n, family="ni_subg"))
    vec = KernelCache(shard="off", mode="vector", device="cpu").run_batch(
        kk, keys, xs, ys)
    exact = KernelCache(shard="off", mode="exact", device="cpu").run_batch(
        kk, keys, xs, ys)
    for j in range(3):
        np.testing.assert_array_equal(vec[j], exact[j])
    jkeys = _jkey(keys.numpy(), impl)
    jvec = jserve.KernelCache(shard="off", mode="vector").run_batch(
        kk, jkeys, xs, ys)
    jexact = jserve.KernelCache(shard="off", mode="exact").run_batch(
        kk, jkeys, xs, ys)
    np.testing.assert_allclose(jvec[0][:1], jexact[0][:1], atol=ATOL)
    np.testing.assert_allclose(exact[0], jexact[0], rtol=SUBG_RTOL,
                               atol=ATOL)
    assert not np.isclose(jvec[0][1:], jexact[0][1:], atol=1e-3).any()


def test_server_answers_replays_and_charges_once(impl):
    """``DpcorrServer`` on rbg-family keys: a pinned request equals the
    direct call on its key, its replay is identical and charges nothing
    more, a server-seeded request answers on a boot-subtree key."""
    srv = DpcorrServer(budget=100.0, max_delay_s=0.001, shard="off",
                       device="cpu")
    try:
        req = _mk_req(n=200, family="int_subg", seed=42)
        key = pinned_request_key(rng.master_key(srv.seed), req, 42)
        assert key.shape == (4,)
        direct = tuple(float(v) for v in serving_entry(
            "int_subg", 1.0, 0.5, device="cpu")(
                key, torch.from_numpy(req.x), torch.from_numpy(req.y)))
        first = srv.estimate(req, timeout=60)
        assert (first.rho_hat, first.ci_low, first.ci_high) == direct
        spent = srv.ledger.snapshot()
        again = srv.estimate(_mk_req(n=200, family="int_subg", seed=42),
                             timeout=60)
        assert (again.rho_hat, again.ci_low, again.ci_high) == direct
        assert srv.ledger.snapshot() == spent
        free = srv.estimate(_mk_req(n=200, family="ni_sign", i=1),
                            timeout=60)
        assert np.isfinite([free.rho_hat, free.ci_low, free.ci_high]).all()
        assert free.seed is not None
        assert srv._request_key(_mk_req(), 3).tolist() \
            == boot_request_key(rng.master_key(srv.seed), srv._boot_nonce,
                                3).tolist()
        assert srv.ledger.snapshot() != spent
    finally:
        srv.close()


# --------------------------------------------------------------- fleet ----

def test_supervisor_replicas_inherit_the_impl(impl, tmp_path):
    """A ``Supervisor`` builds under the impl and its replicas run it: the
    replica here reports the ``DPCORR_PRNG`` it was started with."""
    script = ("import json, os, sys, time; print(json.dumps({'serving': "
              "{'port': 1, 'prng': os.environ.get('DPCORR_PRNG')}}), "
              "flush=True); sys.stdin.read()")
    banners = {}
    sup = Supervisor([ReplicaSpec("r0", [sys.executable, "-c", script],
                                  cwd=str(tmp_path))],
                     restart=False, banner_deadline_s=60.0,
                     on_up=lambda name, url, b: banners.__setitem__(name, b))
    try:
        sup.start()
        assert banners["r0"]["serving"]["prng"] == impl
    finally:
        sup.stop()


# -------------------------------------------------------------- stream ----

def _rows(n, seed=0):
    r = np.random.default_rng(seed)
    xy = np.clip(r.normal(size=(n, 2)), -3.0, 3.0)
    xy[:, 1] = 0.6 * xy[:, 0] + 0.8 * xy[:, 1]
    return xy.astype(np.float32)


def _close(label, got, want, subg):
    """``test_release_and_chunk_stats_match_jax``'s release tolerance."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 1e-5 + (2.5e-7 * np.abs(want) if subg else 0.0)
    assert (np.abs(got - want) <= tol).all(), (label, got, want)


def test_window_key_bit_equal_to_jax(impl):
    for seed, wid in ((0, "0-10000"), (77, "w"), (2**33 + 5, "7500-17500")):
        got = sketch.window_key(rng.master_key(seed), wid)
        assert got.shape == (4,)
        assert got.tolist() == _jwords(jsketch.window_key(
            jrng.master_key(seed & 0xFFFFFFFF), wid))


@pytest.mark.parametrize("family", ("ni_sign", "ni_subg", "int_sign",
                                    "int_subg"))
def test_release_matches_jax_and_partitions_are_byte_equal(impl, family):
    """n = 2000 at chunk 512 (stream_load.py's --assoc shape): the release
    within the stream tests' tolerance of JAX's, and two partitions of the
    chunks byte-equal to the monolith."""
    xy = _rows(2000, seed=11)
    ours = ReleaseParams(family, 0.9, 0.7, target_chunk=512)
    theirs = jsketch.ReleaseParams(family, 0.9, 0.7, target_chunk=512)
    wkey = sketch.window_key(rng.master_key(5), "0-2000")
    jkey = jsketch.window_key(jrng.master_key(5), "0-2000")
    got = sketch.release_window(xy, ours, wkey, device="cpu")
    want = jsketch.release_window(xy, theirs, jkey)
    assert {k: v for k, v in got.items() if k not in ("rho", "lo", "hi")} \
        == {k: v for k, v in want.items() if k not in ("rho", "lo", "hi")}
    _close(family, [got[k] for k in ("rho", "lo", "hi")],
           [want[k] for k in ("rho", "lo", "hi")], family.endswith("subg"))
    ids = list(range(sketch.grid_for(ours, 2000).n_chunks))
    ref = json.dumps(got, sort_keys=True)
    for shards in ([ids[0::2], ids[1::2]], [[c] for c in reversed(ids)]):
        assert json.dumps(sketch.release_window(
            xy, ours, wkey, shards=shards, device="cpu"),
            sort_keys=True) == ref
    # a window's noise is drawn under the impl, not its threefry halves
    tf = sketch.window_key(rng.master_key(5, impl="threefry2x32"), "0-2000")
    assert json.dumps(sketch.release_window(xy, ours, tf, device="cpu"),
                      sort_keys=True) != ref


BATCHES = [
    ("b1", 1.0, [[0.5, 0.4], [-0.2, 0.3], [1.0, -1.0], [0.1, 0.2]]),
    ("b2", 4.0, [[0.3, 0.3], [-0.4, -0.5], [0.8, 0.9], [-1.0, 0.7]]),
    ("b3", 12.0, [[0.2, -0.2], [0.6, 0.5], [-0.7, -0.6], [0.9, 0.1]]),
    ("hb", 50.0, []),
]


def _service(workdir):
    return StreamService(str(workdir), WindowSpec(size_s=10.0),
                         ("ni_sign", "int_subg"), 0.8, 0.8, normalise=True,
                         budget=10.0, seed=7, fsync=False, device="cpu")


def test_stream_service_restart_gives_byte_equal_releases(impl, tmp_path):
    """A workdir run, then a restart of the same workdir with every batch
    resent: the journaled windows are served, byte-equal, charged once;
    a fresh ``Releaser`` recomputes the first window's releases exactly."""
    sv = _service(tmp_path)
    for bid, ts, rows in BATCHES:
        sv.ingest(bid, ts, rows)
    first = json.dumps(sv.releases(), sort_keys=True)
    spent = sv.ledger.snapshot()
    sv.close()
    again = _service(tmp_path)
    for bid, ts, rows in BATCHES:
        again.ingest(bid, ts, rows)
    assert json.dumps(again.releases(), sort_keys=True) == first
    assert again.ledger.snapshot() == spent
    again.close()
    entry = json.loads(first)[0]
    rows = np.asarray([r for _b, _ts, rs in BATCHES[:2] for r in rs],
                      np.float32)
    win = Window((0.0, 10.0))
    win.add(rows)
    assert win.id == entry["window_id"]
    out = Releaser(7, ("ni_sign", "int_subg"), 0.8, 0.8, True,
                   device="cpu").release(win)
    assert json.dumps(out["releases"], sort_keys=True) \
        == json.dumps(entry["releases"], sort_keys=True)


# ----------------------------------------------------------------- HRS ----

@pytest.fixture(scope="module")
def cols():
    return perf_hrs.synthetic_panel(3, HRS_ROWS)


def _jax_std(cols):
    _, age, bmi = hrs.extract_wave(cols, "2")
    return jhrs.standardize(age, bmi, JCFG)


def _port_std(jstd):
    """The JAX package's standardized data as the port's."""
    return hrs.Standardized(
        torch.from_numpy(np.array(jstd.age_z)),
        torch.from_numpy(np.array(jstd.bmi_z)),
        *(getattr(jstd, f.name) for f in dataclasses.fields(jstd)[2:]))


def test_standardize_and_point_estimates_match_jax(impl, cols):
    """``standardize(key=)`` on a four-word key draws JAX's noise: the DP
    moments the noise is added to (μ̂ and m̂₂ = σ̂² + μ̂²) within
    ``tests/test_torch_hrs.py``'s 1e-5 relative (they measure within
    2e-7), ρ_np within its 1e-6; the same data under threefry gives other
    moments. σ̂, λ and the z-scores inherit the cancellation in
    √(m̂₂ − μ̂²), up to 2.3e-5 relative here under rbg, and are held
    under threefry by ``tests/test_torch_hrs.py``. From the same
    standardized data, the point estimates within 1e-6 per row."""
    _, age, bmi = hrs.extract_wave(cols, "2")
    key = rng.master_key(CFG.seed)
    assert key.shape == (4,)
    std = hrs.standardize(age, bmi, CFG, key=key, device="cpu")
    jstd = jhrs.standardize(age, bmi, JCFG, key=jrng.master_key(CFG.seed))
    for v in ("age", "bmi"):
        mu, sd = getattr(std, f"{v}_mean"), getattr(std, f"{v}_sd")
        jmu, jsd = getattr(jstd, f"{v}_mean"), getattr(jstd, f"{v}_sd")
        assert sd > 0.0 and jsd > 0.0
        assert mu == pytest.approx(jmu, rel=1e-5), v
        assert sd * sd + mu * mu == pytest.approx(jsd * jsd + jmu * jmu,
                                                  rel=1e-5), v
    assert std.rho_np == pytest.approx(jstd.rho_np, abs=1e-6)
    tf = hrs.standardize(age, bmi, CFG, key=rng.master_key(
        CFG.seed, impl="threefry2x32"), device="cpu")
    assert abs(tf.age_mean - std.age_mean) > 1e-3
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hrs, "standardize", lambda *a, **k: _port_std(jstd))
        got = hrs.point_estimates(CFG, cols=cols, device="cpu")
    want = jhrs.point_estimates(JCFG, cols=cols)
    for meth in ("ni", "int_"):
        g, w = getattr(got, meth), getattr(want, meth)
        assert list(g) == list(w)
        for f in ("rho_hat", "ci_low", "ci_high"):
            assert g[f] == pytest.approx(w[f], abs=1e-6, rel=0.0), (meth, f)
    assert (got.ni["k"], got.ni["m"]) == (want.ni["k"], want.ni["m"])


def test_sweep_rows_equal_jax_unbatched_and_summary_in_band(impl, cols):
    """Each sweep row against JAX's sweep kernel called on that row's key
    alone (a batch of one draws from its own key); the port's per-(method,
    ε) means against JAX's vmapped sweep within the Monte-Carlo band."""
    jstd = _jax_std(cols)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hrs, "standardize", lambda *a, **k: _port_std(jstd))
        ours = hrs.eps_sweep(CFG, cols=cols, eps_grid=HRS_EPS,
                             reps=HRS_REPS, device="cpu")
    n = len(jstd.age_z)
    k_pad = k_pad_for(n, [e * e for e in HRS_EPS])
    arrays = (jstd.age_z, jstd.bmi_z)
    master = rng.master_key(CFG.seed)
    for i, eps in enumerate(HRS_EPS):
        k_eps = rng.design_key(master, i)
        lam_recv = float(jhrs.lambda_receiver_from_noise(
            jstd.lam_age, jstd.lam_bmi, eps, 1.0 / n))
        for meth, name in (("NI", "hrs/sweep/ni"), ("INT", "hrs/sweep/int")):
            keys = rng.rep_keys(rng.stream(k_eps, name), HRS_REPS)
            sel = (ours.runs["method"] == meth) \
                & (ours.runs["eps_corr"] == eps)
            for r in range(HRS_REPS):
                jk = _jkey(keys[r:r + 1].numpy(), impl)
                if meth == "NI":
                    out = jhrs._sweep_ni_kernel(
                        jk, arrays, jnp.float32(eps), jstd.lam_age,
                        jstd.lam_bmi, JCFG.alpha, k_pad)
                else:
                    out = jhrs._sweep_int_kernel(
                        jk, arrays, jnp.float32(eps), jstd.lam_age,
                        jstd.lam_bmi, jnp.float32(lam_recv),
                        jnp.float32(1.0 / n), JCFG.mixquant_mode,
                        JCFG.alpha)
                want = [float(np.asarray(v)[0]) for v in out]
                got = [ours.runs[f][sel][r] for f in hrs.SWEEP_FIELDS]
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4,
                                           err_msg=f"{meth} {eps} {r}")
    jsumm = jhrs.eps_sweep(JCFG, cols=cols, eps_grid=HRS_EPS, reps=HRS_REPS)
    jruns = jsumm.attrs["runs"]
    for meth in ("NI", "INT"):
        for eps in HRS_EPS:
            a = ours.runs["rho_hat"][(ours.runs["method"] == meth)
                                     & (ours.runs["eps_corr"] == eps)]
            b = jruns["rho_hat"][(jruns["method"] == meth)
                                 & (jruns["eps_corr"] == eps)].to_numpy()
            band = 4.0 * np.sqrt((a.var(ddof=1) + b.var(ddof=1))
                                 / HRS_REPS) + 1e-6
            assert abs(a.mean() - b.mean()) <= band, (meth, eps)


def test_bootstrap_rows_equal_jax_unbatched_and_chunk_free(impl, cols):
    """Each bootstrap row against JAX's bootstrap kernel on that row's key
    alone, the summary within the band of JAX's vmapped run, and the rows
    independent of the chunk width."""
    jstd = _jax_std(cols)
    reps = 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hrs, "standardize", lambda *a, **k: _port_std(jstd))
        ours = hrs.bootstrap(CFG, cols=cols, reps=reps, chunk=3,
                             device="cpu")
        whole = hrs.bootstrap(CFG, cols=cols, reps=reps, chunk=reps,
                              device="cpu")
    for f in hrs.BOOT_FIELDS:
        np.testing.assert_array_equal(ours.runs[f], whole.runs[f])
    n = len(jstd.age_z)
    lam_recv = float(jhrs.lambda_receiver_from_noise(
        jstd.lam_age, jstd.lam_bmi, JCFG.eps_corr, 1.0 / n))
    keys = rng.rep_keys(rng.stream(rng.master_key(CFG.seed), "hrs/boot"),
                        reps)
    for r in range(reps):
        out = jhrs._bootstrap_kernel(
            _jkey(keys[r:r + 1].numpy(), impl), (jstd.age_z, jstd.bmi_z),
            JCFG.eps_corr, jstd.lam_age, jstd.lam_bmi, lam_recv, 1.0 / n,
            JCFG.alpha, JCFG.mixquant_mode, 1)
        want = [float(np.asarray(v)[0]) for v in out]
        got = [ours.runs[f][r] for f in hrs.BOOT_FIELDS]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0.0,
                                   err_msg=str(r))
    jboot = jhrs.bootstrap(JCFG, cols=cols, reps=reps, chunk=reps)
    for meth in ("ni", "int"):
        a = ours.runs[f"{meth}_hat"]
        b = jboot[f"{meth}_hat"].to_numpy()
        band = 4.0 * np.sqrt((a.var(ddof=1) + b.var(ddof=1)) / reps) + 1e-6
        assert abs(a.mean() - b.mean()) <= band, meth


def test_hrs_cli_runs_on_the_impl(impl, cols, tmp_path, monkeypatch,
                                  capsys):
    from dpcorr_torch.__main__ import main

    path = tmp_path / "hrs_long_panel.rds"
    perf_hrs.write_panel(str(path), cols)
    monkeypatch.setattr(hrs, "DEFAULT_PANEL", str(path))
    main(["hrs", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    want = hrs.point_estimates(cols=cols, device="cpu")
    assert out["n"] == want.n == 2578
    assert out["NI"] == want.ni and out["INT_age_to_bmi"] == want.int_


# ------------------------------------------------------------ protocol ----

@pytest.mark.parametrize("mode", ["replay", "hardened"])
def test_party_and_column_roots_bit_equal_to_jax(impl, mode):
    for seed in (0, 2025, 2**31 + 5):
        for label in ("", "a", "bmi"):
            key, jkey = rng.master_key(seed), jrng.master_key(seed)
            if label:
                key = rng.column_root(key, label)
                jkey = jrng.column_root(jkey, label)
                assert key.tolist() == _jwords(jkey)
            for role in ("x", "y"):
                assert rng.party_root(key, role, mode).tolist() \
                    == _jwords(jrng.party_root(jkey, role, mode))


@pytest.mark.parametrize("family", FAMILIES)
def test_replay_session_bit_equal_to_serving_entry(impl, family):
    """A replay session's answer is the port's direct call on the master
    key bit for bit, on both roles, and within tolerance of JAX's
    session."""
    x, y = _columns(1500)
    eps = (1.0, 0.5)
    spec = ProtocolSpec(family=family, n=len(x), eps1=eps[0], eps2=eps[1])
    res = run_inproc(spec, x, y, device="cpu")
    key = rng.master_key(2025)
    direct = tuple(float(np.float32(v)) for v in serving_entry(
        family, *eps, device="cpu")(key, torch.from_numpy(x),
                                    torch.from_numpy(y)))
    for role in ("x", "y"):
        r = res[role]
        assert (r.rho_hat, r.ci_low, r.ci_high) == direct
    jres = jproto.run_inproc(jproto.ProtocolSpec(family=family, n=len(x),
                                                 eps1=eps[0], eps2=eps[1]),
                             x, y)["x"]
    assert _agrees(family, direct, (jres.rho_hat, jres.ci_low,
                                    jres.ci_high), key.numpy(), x, y, eps,
                   impl)


def test_hardened_session_differs_from_replay(impl):
    x, y = _columns(1000)
    kw = dict(family="ni_subg", n=len(x), eps1=1.0, eps2=1.0)
    replay = run_inproc(ProtocolSpec(**kw), x, y, device="cpu")["x"]
    hard = run_inproc(ProtocolSpec(noise_mode="hardened", **kw), x, y,
                      device="cpu")
    assert (hard["x"].rho_hat, hard["x"].ci_low) \
        == (hard["y"].rho_hat, hard["y"].ci_low)
    assert hard["x"].rho_hat != replay.rho_hat
    assert np.isfinite([hard["x"].rho_hat, hard["x"].ci_low,
                        hard["x"].ci_high]).all()


def test_mixed_jax_and_port_session_over_tcp(impl):
    """A JAX party (y, listening) and a port party (x, dialing) hold one
    session over loopback TCP: both roles get the same answer, within
    tolerance of the JAX-only session."""
    from dpcorr.protocol import transport as jtransport
    from dpcorr.serve.ledger import PrivacyLedger as JPrivacyLedger
    from dpcorr_torch.protocol.transport import tcp_connect

    x, y = _columns(1000)
    eps = (1.0, 0.5)
    kw = dict(family="ni_sign", n=len(x), eps1=eps[0], eps2=eps[1])
    srv, port = jtransport.tcp_listen("127.0.0.1", 0)
    links = {}
    acceptor = threading.Thread(target=lambda: links.__setitem__(
        "y", jtransport.tcp_accept(srv, timeout_s=30.0)))
    acceptor.start()
    links["x"] = tcp_connect("127.0.0.1", port, timeout_s=30.0)
    acceptor.join()
    srv.close()
    parties = [
        Party("x", x, ProtocolSpec(**kw), ReliableChannel(links["x"],
                                                          timeout_s=5.0),
              PrivacyLedger(100.0), device="cpu"),
        jproto.Party("y", y, jproto.ProtocolSpec(**kw),
                     jproto.ReliableChannel(links["y"], timeout_s=5.0),
                     JPrivacyLedger(100.0))]
    results, errors = {}, {}

    def drive(p):
        try:
            results[p.role] = p.run()
        except BaseException as e:  # re-raised below
            errors[p.role] = e

    threads = [threading.Thread(target=drive, args=(p,)) for p in parties]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        for link in links.values():
            link.close()
    assert not errors, errors
    got = (results["x"].rho_hat, results["x"].ci_low, results["x"].ci_high)
    assert got == (results["y"].rho_hat, results["y"].ci_low,
                   results["y"].ci_high)
    want = jproto.run_inproc(jproto.ProtocolSpec(**kw), x, y)["x"]
    assert _agrees("ni_sign", got, (want.rho_hat, want.ci_low,
                                    want.ci_high),
                   rng.master_key(2025).numpy(), x, y, eps, impl)


# ---------------------------------------------------------- federation ----

PARTIES = [("p0", ["a", "b"]), ("p1", ["c"]), ("p2", ["d"])]


def _fed_data(plan, rho=0.6):
    k = plan.k
    cov = np.full((k, k), rho)
    np.fill_diagonal(cov, 1.0)
    xy = np.random.default_rng(plan.seed).multivariate_normal(
        np.zeros(k), cov, size=plan.n)
    return {lab: np.asarray(xy[:, i], np.float32)
            for i, (_owner, lab) in enumerate(plan.columns())}


@pytest.mark.parametrize("family", FAMILIES)
def test_federation_exact_finisher_per_cell(impl, family):
    """Three cells with three finisher keys: the port's exact
    ``finish_batch`` is bit-equal per cell to ``finish``, and within
    tolerance of JAX's exact ``finish_batch``; the port's vector finisher
    agrees with its exact one (1e-6, the federation tests' bound), while
    JAX's vector lanes 1 and 2 draw from lane 0's key (shown on
    ``int_subg``, whose finisher draws the most)."""
    plan = FederationPlan(family=family, n=512, eps=1.0, parties=PARTIES)
    data = _fed_data(plan)

    def root(lab, side):
        return rng.party_root(rng.column_root(rng.master_key(plan.seed),
                                              lab), side, "replay")

    labels = ["a", "b", "c"]
    rels = [sr.party_release(family, root(lab, "x"), "x", data[lab], 1.0,
                             1.0, device="cpu") for lab in labels]
    keys = [root(f"fin/{lab}", "y") for lab in labels]
    cols = [data["d"]] * 3
    got = sr.finish_batch(family, keys, rels, cols, 1.0, 1.0, device="cpu")
    jkeys = [_jkey(k.numpy(), impl) for k in keys]
    jrels = [{k: jnp.asarray(np.asarray(v)) for k, v in r.items()}
             for r in rels]
    want = jsr.finish_batch(family, jkeys, jrels, cols, 1.0, 1.0)
    for b in range(3):
        one = sr.finish(family, keys[b], rels[b], cols[b], 1.0, 1.0,
                        device="cpu")
        cell = tuple(float(got[j][b]) for j in range(3))
        assert cell == tuple(float(v) for v in one)
        jcell = [float(np.asarray(want[j])[b]) for j in range(3)]
        rtol = SUBG_RTOL if family.endswith("subg") else 0.0
        assert np.isclose(cell, jcell, rtol=rtol, atol=ATOL).all() \
            or family.endswith("sign"), (b, cell, jcell)
    vec = sr.finish_batch(family, keys, rels, cols, 1.0, 1.0,
                          engine="vector", device="cpu")
    np.testing.assert_allclose(torch.stack(vec).numpy(),
                               torch.stack(list(got)).numpy(), atol=1e-6,
                               rtol=0)
    if family == "int_subg":  # the NI finishers draw nothing
        jvec = jsr.finish_batch(family, jkeys, jrels, cols, 1.0, 1.0,
                                engine="vector")
        lanes = np.asarray(jvec[0])
        assert lanes[0] == pytest.approx(float(np.asarray(want[0])[0]),
                                         abs=ATOL)
        assert not np.isclose(lanes[1:], np.asarray(want[0])[1:],
                              atol=1e-7).all()


def test_federation_matrix_equals_independent_sessions(impl):
    """The whole federation in process (a ``FederationParty`` per party on
    its own thread): every cell bit-equal to its independent two-party
    session."""
    plan = FederationPlan(family="ni_subg", n=512, eps=1.0, parties=PARTIES)
    data = _fed_data(plan)
    results = run_federation_inproc(plan, data, device="cpu")
    cells = {}
    for res in results.values():
        cells.update(res.cells)
    assert sorted(cells) == [f"{i},{j}" for i, j in plan.cells()]
    for i, j in plan.cells():
        ref = run_inproc(plan.cell_spec(i, j), data[plan.label(i)],
                         data[plan.label(j)], device="cpu")["x"]
        got = cells[f"{i},{j}"]
        assert (got["rho_hat"], got["ci_low"], got["ci_high"]) \
            == (ref.rho_hat, ref.ci_low, ref.ci_high), (i, j)

