"""The port's stream service (``dpcorr_torch.stream``) against
``dpcorr.stream``: event-time windows, mergeable sketches, the WAL and the
release journal, the crash-exact release sequence and the HTTP front end.

- Windows: the same spans, ids, watermark, closable sets, late refusals
  and reclosed skips as JAX's on the scripted sequences of
  ``tests/test_stream.py``.
- Sketches: ``window_key`` bit-equal to JAX's; per-chunk stats and
  releases within the card-against-CPU tolerance of
  ``tests/test_torch_cuda.py::test_stream_release_card_agrees_with_cpu``
  (atol 1e-5, subG also rtol 2.5e-7); every shard partition
  byte-equal to the port's own monolith.
- Durability: the WAL and the journal write JAX's bytes, each package
  replays the other's files, and a workdir written by either service is
  resumed by the other with no journaled window recomputed and no
  charge repeated.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from dpcorr import chaos as jchaos
from dpcorr.stream import sketch as jsketch
from dpcorr.stream.service import StreamService as JService
from dpcorr.stream.wal import IngestWAL as JIngestWAL
from dpcorr.stream.wal import ReleaseJournal as JReleaseJournal
from dpcorr.stream.windows import WindowManager as JWindowManager
from dpcorr.stream.windows import WindowSpec as JWindowSpec
from dpcorr.utils.rng import master_key as jmaster_key
from dpcorr_torch import chaos
from dpcorr_torch.obs.audit import read_events, replay_levels
from dpcorr_torch.stream import sketch
from dpcorr_torch.stream.http import make_stream_http_server
from dpcorr_torch.stream.service import (
    StreamOverloadedError,
    StreamService,
    window_charges,
)
from dpcorr_torch.stream.sketch import ReleaseParams, SketchState
from dpcorr_torch.stream.wal import (
    IngestWAL,
    ReleaseJournal,
    StreamCorruptError,
)
from dpcorr_torch.stream.windows import (
    LateRecordError,
    WindowManager,
    WindowSpec,
)
from dpcorr_torch.utils.rng import master_key

FAMILIES = ("ni_sign", "ni_subg", "int_sign", "int_subg")


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    chaos.clear()
    jchaos.clear()
    yield
    chaos.clear()
    jchaos.clear()


def _rows(n, seed=0):
    r = np.random.default_rng(seed)
    xy = np.clip(r.normal(size=(n, 2)), -3.0, 3.0)
    xy[:, 1] = 0.6 * xy[:, 0] + 0.8 * xy[:, 1]
    return xy.astype(np.float32)


def release(xy, params, wkey, **kw):
    return sketch.release_window(xy, params, wkey, device="cpu", **kw)


# ---------------------------------------------------------- windows ----
#: scripted sequences of tests/test_stream.py: (spec kwargs, operations)
#: with operations ("admit", ts, rows) | ("close", id)
WINDOW_SCRIPTS = {
    "heartbeat": ({"size_s": 10.0}, [("admit", 42.0, [])]),
    "late": ({"size_s": 10.0}, [("admit", 20.0, [(1.0, 2.0)]),
                                ("admit", 5.0, [(1.0, 2.0)]),
                                ("admit", 5.0, [])]),
    "bounded_lateness": ({"size_s": 10.0, "late_s": 5.0},
                         [("admit", 20.0, [(0.0, 0.0)]),
                          ("admit", 16.0, [(0.0, 0.0)]),
                          ("admit", 14.0, [(0.0, 0.0)])]),
    "closable": ({"size_s": 10.0}, [("admit", 5.0, [(0.0, 0.0)]),
                                    ("admit", 15.0, [(0.0, 0.0)]),
                                    ("admit", 25.0, []),
                                    ("close", "0-10000")]),
    "reclosed_sibling": ({"size_s": 10.0, "slide_s": 5.0},
                         [("close", "5000-15000"),
                          ("admit", 12.0, [(1.0, 1.0)])]),
    "sliding": ({"size_s": 10.0, "slide_s": 2.5, "late_s": 3.0},
                [("admit", 0.5, [(0.1, 0.2)]), ("admit", 7.25, [(0.3, 0.4)]),
                 ("admit", 5.0, [(0.5, 0.6)]), ("admit", 3.0, [(0.7, 0.8)]),
                 ("close", "0-10000"), ("admit", 21.0, [])]),
}


def _run_script(spec_cls, mgr_cls, late_cls, spec_kw, ops):
    m = mgr_cls(spec_cls(**spec_kw))
    trace = []
    for op in ops:
        if op[0] == "close":
            m.close(op[1])
            trace.append(("close", op[1]))
            continue
        try:
            trace.append(("hit", m.admit(op[1], op[2])))
        except late_cls as e:
            trace.append(("late", e.ts, e.watermark))
        trace.append(("closable", [w.id for w in m.closable()],
                      m.watermark))
    trace.append(("state", sorted(m.windows), sorted(m.closed),
                  {w: len(m.windows[w]) for w in m.windows},
                  m.late_refused, m.reclosed_skips))
    return trace


@pytest.mark.parametrize("name", sorted(WINDOW_SCRIPTS))
def test_window_manager_equals_jax(name):
    from dpcorr.stream.windows import LateRecordError as JLate

    spec_kw, ops = WINDOW_SCRIPTS[name]
    assert _run_script(WindowSpec, WindowManager, LateRecordError, spec_kw,
                       ops) \
        == _run_script(JWindowSpec, JWindowManager, JLate, spec_kw, ops)


def test_window_spans_ids_and_validation_equal_jax():
    for kw in ({"size_s": 10.0}, {"size_s": 10.0, "slide_s": 5.0},
               {"size_s": 7.5, "slide_s": 2.5}):
        ours, theirs = WindowSpec(**kw), JWindowSpec(**kw)
        assert ours.hop_s == theirs.hop_s
        for ts in (0.0, 3.0, 12.0, 20.0, 25.0, 1234.567):
            assert ours.spans_for(ts) == theirs.spans_for(ts)
            for span in ours.spans_for(ts):
                assert WindowSpec.window_id(span) \
                    == JWindowSpec.window_id(span)
    assert WindowSpec.window_id((7.5, 17.5)) == "7500-17500"
    for bad in ({"size_s": 0.0}, {"size_s": 10.0, "slide_s": 11.0},
                {"size_s": 10.0, "late_s": -1.0}):
        with pytest.raises(ValueError):
            WindowSpec(**bad)
    with pytest.raises(ValueError):
        WindowSpec(size_s=10.0).spans_for(-1.0)


def test_window_rows_are_the_f32_cast_of_the_doubles():
    m = WindowManager(WindowSpec(size_s=10.0))
    rows = [(0.1, 1.0 / 3.0), (2.0 ** 0.5, -7.25)]
    m.admit(1.0, rows[:1])
    m.admit(2.0, rows[1:])
    w = m.windows["0-10000"]
    assert len(w) == 2 and w.rows.dtype == np.float32
    assert np.array_equal(w.rows, np.asarray(rows, dtype=np.float32))


# --------------------------------------------------------- sketches ----
@pytest.mark.parametrize("seed,window_id", [(0, "0-10000"), (77, "w"),
                                            (2025, "2000-4000"),
                                            (2**33 + 5, "7500-17500")])
def test_window_key_bit_equal_to_jax(seed, window_id):
    import jax

    got = sketch.window_key(master_key(seed), window_id)
    want = jax.random.key_data(jsketch.window_key(jmaster_key(seed),
                                                  window_id))
    assert got.tolist() == np.asarray(want).tolist()
    with pytest.raises(ValueError):
        sketch.window_key(master_key(seed), "")


def _close(label, got, want, subg):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 1e-5 + (2.5e-7 * np.abs(want) if subg else 0.0)
    assert (np.abs(got - want) <= tol).all(), (label, got, want)


def _close_stats(label, got, want):
    """A chunk's f32 sums: their last bits follow the summation order, and
    Σ Uc cancels, so the chunk's largest stat (Σ Uc², Σ T², Σ clip²) sets
    the scale of the 2.5e-7 relative term."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 1e-5 + 2.5e-7 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all(), (label, got, want)


@pytest.mark.parametrize("family", FAMILIES)
def test_release_and_chunk_stats_match_jax(family):
    """stream_load.py's --assoc-n / --assoc-chunk shape: n = 2000,
    chunk 512; per-chunk stats of both passes and the release within
    the card-against-CPU tolerance."""
    xy = _rows(2000, seed=11)
    subg = family.endswith("subg")
    ours = ReleaseParams(family, 0.9, 0.7, target_chunk=512)
    theirs = jsketch.ReleaseParams(family, 0.9, 0.7, target_chunk=512)
    wkey = sketch.window_key(master_key(5), "0-2000")
    jkey = jsketch.window_key(jmaster_key(5), "0-2000")
    grid = sketch.grid_for(ours, 2000)
    assert grid == sketch.ChunkGrid(**vars(jsketch.grid_for(theirs, 2000)))
    assert grid.n_chunks >= 3
    moments = jmoments = None
    if ours.needs_moments:
        a = sketch.sketch_window(xy, ours, wkey, "pass_a", device="cpu")
        ja = jsketch.sketch_window(xy, theirs, jkey, "pass_a")
        for c in range(grid.n_chunks):
            _close_stats(f"pass_a {c}", a.chunks[c], ja.chunks[c])
        moments = sketch.moments_for_window(a, ours, grid, wkey, "cpu")
        jmoments = jsketch.moments_for_window(ja, theirs,
                                              jsketch.grid_for(theirs, 2000),
                                              jkey)
        _close("moments", [moments[k] for k in sorted(moments)],
               [jmoments[k] for k in sorted(jmoments)], True)
    est = sketch.sketch_window(xy, ours, wkey, moments=moments, device="cpu")
    jest = jsketch.sketch_window(xy, theirs, jkey, moments=jmoments)
    assert est.meta.keys() == jest.meta.keys()
    for c in range(grid.n_chunks):
        _close_stats(f"estimate {c}", est.chunks[c], jest.chunks[c])
    got, want = release(xy, ours, wkey), jsketch.release_window(xy, theirs,
                                                                jkey)
    assert {k: v for k, v in got.items() if k not in ("rho", "lo", "hi")} \
        == {k: v for k, v in want.items() if k not in ("rho", "lo", "hi")}
    _close("release", [got[k] for k in ("rho", "lo", "hi")],
           [want[k] for k in ("rho", "lo", "hi")], subg)


def test_ni_sign_critical_value_against_jax():
    """The NI-sign finisher's z at the default α is JAX's f32 ndtri bit for
    bit; torch's f32 ndtri, which other α use, is within two f32 ulps of
    it (one at α = 0.05)."""
    from jax.scipy.special import ndtri

    from dpcorr_torch.models.estimators.ni_sign import crit_value

    assert sketch._JAX_Z_0975 == float(ndtri(np.float32(0.975)))
    for alpha in (0.05, 0.1, 0.01, 0.2):
        want = np.float32(ndtri(np.float32(1.0 - alpha / 2.0)))
        got = np.float32(crit_value(alpha, "cpu"))
        assert abs(float(got) - float(want)) <= 2 * np.spacing(want)
    assert float(crit_value(0.05, "cpu")) != sketch._JAX_Z_0975


@pytest.mark.parametrize("family,normalise", [(f, True) for f in FAMILIES]
                         + [("ni_sign", False)])
def test_every_partition_is_byte_equal_to_the_monolith(family, normalise):
    """tests/test_stream.py's partitions (n = 600, chunk 128), a
    placement over 3 devices and a tree of many shards."""
    n = 600
    xy = _rows(n, seed=3)
    params = ReleaseParams(family, 0.9, 0.7, normalise=normalise,
                           target_chunk=128)
    grid = sketch.grid_for(params, n)
    wkey = sketch.window_key(master_key(77), "0-10000")
    ref = json.dumps(release(xy, params, wkey), sort_keys=True)
    ids = list(range(grid.n_chunks))

    class Three:
        device_count = 3

    for shards in ([ids[0::2], ids[1::2]], [ids[:1], ids[1:]],
                   [[c] for c in reversed(ids)], [ids[1:], ids[:1]]):
        assert json.dumps(release(xy, params, wkey, shards=shards),
                          sort_keys=True) == ref, shards
    assert json.dumps(release(xy, params, wkey, placement=Three()),
                      sort_keys=True) == ref
    with pytest.raises(ValueError, match="not both"):
        release(xy, params, wkey, shards=[ids], placement=Three())


class TestSketchState:
    def _sketches(self):
        xy = _rows(200, seed=9)
        params = ReleaseParams("int_subg", 1.0, 0.5, target_chunk=64)
        wkey = sketch.window_key(master_key(1), "w")
        grid = sketch.grid_for(params, 200)
        ids = list(range(grid.n_chunks))
        a = sketch.sketch_window(xy, params, wkey, chunk_ids=ids[0::2],
                                 device="cpu")
        b = sketch.sketch_window(xy, params, wkey, chunk_ids=ids[1::2],
                                 device="cpu")
        return a, b, params, wkey

    def _final(self, s, params, wkey):
        return json.dumps(sketch.release_from_sketch(s, params, wkey,
                                                     device="cpu"),
                          sort_keys=True)

    def test_merge_order_invariant_and_tree_merge(self):
        a, b, params, wkey = self._sketches()
        assert self._final(a.merge(b), params, wkey) \
            == self._final(b.merge(a), params, wkey) \
            == self._final(sketch.tree_merge([b, a]), params, wkey)
        with pytest.raises(ValueError):
            sketch.tree_merge([])

    def test_merge_rejects_meta_mismatch(self):
        a, _, _, wkey = self._sketches()
        other = sketch.sketch_window(
            _rows(200, seed=9),
            ReleaseParams("int_subg", 2.0, 0.5, target_chunk=64), wkey,
            device="cpu")
        with pytest.raises(ValueError, match="different windows"):
            a.merge(other)

    def test_merge_rejects_conflicting_chunk(self):
        a, b, *_ = self._sketches()
        evil = SketchState(b.meta, dict(b.chunks))
        evil.chunks[next(iter(evil.chunks))] = ((123.0,), (456.0,))
        with pytest.raises(ValueError, match="conflicting stats"):
            a.merge(b).merge(evil)
        assert a.merge(b).chunks == a.merge(b).merge(b).chunks

    def test_dict_roundtrip_preserves_bytes(self):
        a, b, params, wkey = self._sketches()
        merged = a.merge(b)
        back = SketchState.from_dict(json.loads(json.dumps(
            merged.to_dict())))
        assert back.to_dict() == merged.to_dict()
        assert self._final(back, params, wkey) \
            == self._final(merged, params, wkey)

    def test_incomplete_fold_and_bad_passes_refuse(self):
        a, _, params, wkey = self._sketches()
        with pytest.raises(ValueError, match="incomplete"):
            sketch.release_from_sketch(a, params, wkey, device="cpu")
        xy = _rows(200)
        with pytest.raises(ValueError, match="no standardization"):
            sketch.sketch_window(xy, params, wkey, "pass_a", device="cpu")
        with pytest.raises(ValueError, match="needs"):
            sketch.sketch_window(xy, ReleaseParams("ni_sign", 1.0, 1.0),
                                 wkey, device="cpu")
        with pytest.raises(ValueError, match="outside grid"):
            sketch.sketch_window(xy, params, wkey, chunk_ids=[99],
                                 device="cpu")

    def test_sketch_dict_is_jax_readable(self):
        """A port sketch's wire form merges into a JAX sketch of the other
        chunks (same meta) and folds in the JAX package."""
        a, _, params, wkey = self._sketches()
        xy = _rows(200, seed=9)
        jp = jsketch.ReleaseParams("int_subg", 1.0, 0.5, target_chunk=64)
        jkey = jsketch.window_key(jmaster_key(1), "w")
        ids = list(range(sketch.grid_for(params, 200).n_chunks))
        jb = jsketch.sketch_window(xy, jp, jkey, chunk_ids=ids[1::2])
        merged = jsketch.SketchState.from_dict(a.to_dict()).merge(jb)
        rel = jsketch.release_from_sketch(merged, jp, jkey)
        _close("mixed", [rel[k] for k in ("rho", "lo", "hi")],
               [json.loads(self._final(a.merge(self._sketches()[1]),
                                       params, wkey))[k]
                for k in ("rho", "lo", "hi")], True)


def test_release_requires_a_device(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sketch.release_window(_rows(100), ReleaseParams("ni_subg", 1.0, 1.0),
                              sketch.window_key(master_key(0), "w"))


# ------------------------------------------------------- durability ----
def _records():
    return [("b1", 1.0, [[1.0, 2.0]]), ("b2", 2.5, []),
            ("b3", 3.0, [[0.1, -0.2], [1.0 / 3.0, 7.0]])]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_and_journal_bytes_equal_jax_and_replay_both_ways(tmp_path,
                                                              writer):
    paths = {}
    for name, wal_cls, jr_cls in (("jax", JIngestWAL, JReleaseJournal),
                                  ("port", IngestWAL, ReleaseJournal)):
        d = tmp_path / name
        d.mkdir()
        w = wal_cls(str(d / "wal.jsonl"), fsync=False)
        for bid, ts, rows in _records():
            w.append(bid, ts, rows)
        w.close()
        j = jr_cls(str(d / "rel.jsonl"), fsync=False)
        j.append("w1", {"rows": 3, "releases": {"x": {"rho": 0.25}}})
        j.append("w1", {"rows": 999})
        j.append("w2", {"rows": 5})
        j.close()
        paths[name] = d
    for f in ("wal.jsonl", "rel.jsonl"):
        assert (paths["jax"] / f).read_bytes() \
            == (paths["port"] / f).read_bytes()
    src = paths[writer]
    wal_cls = IngestWAL if writer == "jax" else JIngestWAL
    jr_cls = ReleaseJournal if writer == "jax" else JReleaseJournal
    w = wal_cls(str(src / "wal.jsonl"), fsync=False)
    assert [r["batch_id"] for r in w.replay()] == ["b1", "b2", "b3"]
    assert w.append("b4", 4.0, []) == 4
    w.close()
    j = jr_cls(str(src / "rel.jsonl"), fsync=False)
    assert [e["window_id"] for e in j.entries()] == ["w1", "w2"]
    assert j.get("w1")["rows"] == 3


def test_wal_torn_tail_corruption_and_compact(tmp_path):
    p = str(tmp_path / "wal.jsonl")
    w = IngestWAL(p, fsync=False)
    for i in range(4):
        w.append(f"b{i}", float(i), [])
    w.close()
    with open(p, "a") as fh:
        fh.write('{"seq": 5, "batch_id": "to')  # kill mid-append
    assert [r["batch_id"] for r in IngestWAL(p, fsync=False).replay()] \
        == ["b0", "b1", "b2", "b3"]
    w = IngestWAL(p, fsync=False)
    w.compact(lambda r: r["batch_id"] in ("b2", "b3"))
    assert [r["batch_id"] for r in IngestWAL(p, fsync=False).replay()] \
        == ["b2", "b3"]
    lines = open(p).read().splitlines()
    lines[0] = "NOT JSON"
    with open(p, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with pytest.raises(StreamCorruptError):
        list(IngestWAL(p, fsync=False).replay())
    assert not os.path.exists(p)
    assert os.path.exists(p + ".corrupt")


def test_journal_is_idempotent(tmp_path):
    p = str(tmp_path / "rel.jsonl")
    j = ReleaseJournal(p, fsync=False)
    e1 = j.append("w1", {"rows": 3})
    assert e1["release_seq"] == 1 and j.append("w1", {"rows": 9}) == e1
    assert j.append("w2", {"rows": 5})["release_seq"] == 2
    j.close()
    j2 = ReleaseJournal(p, fsync=False)
    assert [e["window_id"] for e in j2.entries()] == ["w1", "w2"]
    assert "w1" in j2 and j2.get("w1")["rows"] == 3


# ---------------------------------------------------------- service ----
BATCHES = [
    ("b1", 1.0, [[0.5, 0.4], [-0.2, 0.3], [1.0, -1.0], [0.1, 0.2]]),
    ("b2", 4.0, [[0.3, 0.3], [-0.4, -0.5], [0.8, 0.9], [-1.0, 0.7]]),
    ("b3", 12.0, [[0.2, -0.2], [0.6, 0.5], [-0.7, -0.6], [0.9, 0.1]]),
    ("hb", 50.0, []),  # far-future heartbeat closes everything
]


def _kw(**kw):
    out = dict(spec=WindowSpec(size_s=10.0), families=("ni_sign",),
               eps1=0.8, eps2=0.8, normalise=False, budget=10.0, seed=7,
               fsync=False)
    out.update(kw)
    return out


def _service(workdir, **kw):
    return StreamService(str(workdir), device="cpu", **_kw(**kw))


def _jservice(workdir, **kw):
    kw = _kw(**kw)
    kw["spec"] = JWindowSpec(size_s=kw["spec"].size_s,
                             slide_s=kw["spec"].slide_s,
                             late_s=kw["spec"].late_s)
    return JService(str(workdir), **kw)


def _feed(sv, batches):
    acks = []
    for bid, ts, rows in batches:
        try:
            acks.append(sv.ingest(bid, ts, rows))
        except (LateRecordError, StreamOverloadedError):
            acks.append(None)
    return acks


def _spent(sv):
    return {p: v["spent"] for p, v in sv.ledger.snapshot()["parties"].items()}


class TestStreamService:
    def test_release_eps_and_feed(self, tmp_path):
        sv = _service(tmp_path)
        acks = _feed(sv, BATCHES)
        assert acks[-1]["released"]
        feed = sv.releases()
        assert [e["window_id"] for e in feed] == ["0-10000", "10000-20000"]
        assert sv.per_window_charges == {"party/x": 0.8, "party/y": 0.8}
        for p in ("party/x", "party/y"):
            assert _spent(sv)[p] == pytest.approx(1.6)
        e = feed[0]
        assert e["rows"] == 8 and e["eps_window"] == pytest.approx(1.6)
        assert e["charge_id"] == "stream:stream:0-10000"
        assert set(e["releases"]["ni_sign"]) >= {"rho", "lo", "hi"}
        assert [x["window_id"] for x in sv.releases(since=1)] \
            == ["10000-20000"]
        levels = replay_levels(read_events(str(tmp_path / "audit.jsonl")))
        assert levels["party"] == _spent(sv)
        sv.close()

    def test_feed_matches_the_jax_service(self, tmp_path):
        """Same batches, all four families: the same windows, rows,
        charges and release metadata; estimates within tolerance."""
        kw = dict(families=FAMILIES, normalise=True)
        ours, theirs = _service(tmp_path / "p", **kw), \
            _jservice(tmp_path / "j", **kw)
        _feed(ours, BATCHES)
        _feed(theirs, BATCHES)
        for a, b in zip(ours.releases(), theirs.releases(), strict=True):
            for fam in FAMILIES:
                ra, rb = a["releases"].pop(fam), b["releases"].pop(fam)
                _close(fam, [ra.pop(k) for k in ("rho", "lo", "hi")],
                       [rb.pop(k) for k in ("rho", "lo", "hi")],
                       fam.endswith("subg"))
                assert ra == rb
            assert a == b
        assert _spent(ours) == _spent(theirs)
        assert set(ours.stats()) == set(theirs.stats())
        assert (tmp_path / "p" / "wal.jsonl").read_bytes() \
            == (tmp_path / "j" / "wal.jsonl").read_bytes()
        ours.close()
        theirs.close()

    def test_dedup_is_free(self, tmp_path):
        sv = _service(tmp_path)
        sv.ingest("b1", 1.0, [[0.1, 0.2]])
        ack = sv.ingest("b1", 1.0, [[0.1, 0.2]])
        assert ack["deduped"] and ack["seq"] is None
        assert sv.stats()["seen_batches"] == 1
        sv.close()

    def test_refuse_before_release_spends_nothing(self, tmp_path):
        sv = _service(tmp_path, budget=0.5)
        _feed(sv, BATCHES)
        st = sv.stats()
        assert st["released"] == 0
        assert st["refused"] == ["0-10000", "10000-20000"]
        assert all(v == 0.0 for v in _spent(sv).values())
        sv.close()

    def test_overload_backpressure(self, tmp_path):
        sv = _service(tmp_path, max_pending_rows=6)
        sv.ingest("b1", 1.0, [[0.0, 0.0]] * 5)
        with pytest.raises(StreamOverloadedError) as ei:
            sv.ingest("b2", 2.0, [[0.0, 0.0]] * 5)
        assert ei.value.retry_after_s > 0.0 and "b2" not in sv._seen
        sv.close()

    def test_late_refusal_and_stats_shape(self, tmp_path):
        sv = _service(tmp_path)
        st = sv.stats()
        assert st["eps_per_window"] == {"party/x": 0.8, "party/y": 0.8}
        assert st["watermark"] is None and st["window"]["size_s"] == 10.0
        sv.ingest("b1", 100.0, [[0.0, 0.0]])
        with pytest.raises(LateRecordError):
            sv.ingest("b2", 5.0, [[0.0, 0.0]])
        assert sv.stats()["late_refused"] == 1
        text = sv.render_metrics()
        for series in ("dpcorr_stream_batches_total",
                       "dpcorr_stream_rows_total",
                       "dpcorr_stream_windows_total",
                       "dpcorr_stream_open_windows",
                       "dpcorr_stream_pending_rows",
                       "dpcorr_stream_watermark_ts",
                       "dpcorr_stream_watermark_lag_seconds",
                       "dpcorr_stream_release_seconds"):
            assert series in text
        sv.close()

    def test_user_and_global_legs(self, tmp_path):
        """A bound user renews on the released window's event time (each
        window a fresh user window); a user budget below a window's leg
        refuses every window at the user level; a global budget of two
        windows refuses the third at the global level; refusals spend
        nothing at any level."""
        from dpcorr_torch.obs.budget_replay import read_user_balances

        more = BATCHES[:3] + [("b4", 23.0, [[0.1, 0.1]]),
                              ("b5", 34.0, [[0.2, 0.3]]), ("hb", 90.0, [])]
        sv = _service(tmp_path / "u", user="alice", user_budget=1.6)
        _feed(sv, more)
        st = sv.stats()
        assert st["released"] == 4
        assert st["budget_dir"]["counters"]["renewals"] == 3
        assert read_user_balances(str(tmp_path / "u" / "budget_dir")
                                  )["alice"]["l"] == pytest.approx(6.4)
        sv.close()
        sv = _service(tmp_path / "r", user="alice", user_budget=1.0)
        _feed(sv, more)
        assert sv.stats()["released"] == 0
        assert sv.ledger.refusals_by_level()["user"] == 4
        assert all(v == 0.0 for v in _spent(sv).values())
        sv.close()
        sv = _service(tmp_path / "g", global_budget=3.2)
        _feed(sv, more)
        st = sv.stats()
        assert st["released"] == 2 and len(st["refused"]) == 2
        assert sv.ledger.refusals_by_level()["global"] == 2
        assert _spent(sv)["global/total"] == pytest.approx(3.2)
        sv.close()


class TestCrashExactRecovery:
    def _reference(self, workdir):
        sv = _service(workdir)
        _feed(sv, BATCHES)
        feed = json.dumps(sv.releases(), sort_keys=True)
        spent = _spent(sv)
        sv.close()
        return feed, spent

    @pytest.mark.parametrize("point,hit", [
        ("stream.mid_window", 1), ("stream.mid_window", 3),
        ("stream.pre_release", 1), ("stream.pre_release", 2),
        ("stream.post_journal", 1), ("stream.post_journal", 2)])
    def test_crash_then_recover_bit_identical(self, tmp_path, point, hit):
        ref_feed, ref_spent = self._reference(tmp_path / "ref")
        work = tmp_path / "crash"
        chaos.install(chaos.ChaosPlan(point, hit=hit, mode="raise"))
        try:
            sv = _service(work)
            with pytest.raises(chaos.SimulatedCrash):
                for bid, ts, rows in BATCHES:
                    sv.ingest(bid, ts, rows)
        finally:
            chaos.clear()
        sv2 = _service(work)
        _feed(sv2, BATCHES)
        assert json.dumps(sv2.releases(), sort_keys=True) == ref_feed
        assert _spent(sv2) == pytest.approx(ref_spent)
        sv2.close()

    def test_post_journal_recovery_serves_from_journal(self, tmp_path):
        work = tmp_path / "w"
        chaos.install(chaos.ChaosPlan("stream.post_journal", hit=1,
                                      mode="raise"))
        try:
            sv = _service(work)
            with pytest.raises(chaos.SimulatedCrash):
                _feed(sv, BATCHES)
        finally:
            chaos.clear()
        before = json.dumps(ReleaseJournal(
            str(work / "releases.jsonl"), fsync=False).entries(),
            sort_keys=True)
        sv2 = _service(work)
        _feed(sv2, BATCHES)
        after = [e for e in sv2.releases() if e["window_id"] == "0-10000"]
        assert json.dumps(after, sort_keys=True) == before
        sv2.close()


@pytest.mark.parametrize("first", ["jax", "port"])
def test_workdir_resumed_by_the_other_package(tmp_path, first):
    """One package crashes after journaling the first window; the other
    resumes the workdir and the client resends everything: the journaled
    window is served unchanged, each window is charged once, and the
    audit trail replays to the ledger."""
    make = {"jax": _jservice, "port": _service}
    plan_cls = jchaos if first == "jax" else chaos
    kw = dict(families=("ni_sign", "int_subg"), normalise=True)
    plan_cls.install(plan_cls.ChaosPlan("stream.post_journal", hit=1,
                                        mode="raise"))
    try:
        sv = make[first](tmp_path, **kw)
        with pytest.raises(plan_cls.SimulatedCrash):
            _feed(sv, BATCHES)
    finally:
        plan_cls.clear()
    journaled = ReleaseJournal(str(tmp_path / "releases.jsonl"),
                               fsync=False).get("0-10000")
    second = make["port" if first == "jax" else "jax"](tmp_path, **kw)
    _feed(second, BATCHES)
    feed = second.releases()
    assert [e["window_id"] for e in feed] == ["0-10000", "10000-20000"]
    assert feed[0] == journaled
    per = second.per_window_charges
    assert _spent(second) == pytest.approx({p: 2 * v
                                            for p, v in per.items()})
    with open(tmp_path / "ledger.json") as fh:
        assert sorted(json.load(fh)["charge_ids"]) == [
            "stream:stream:0-10000", "stream:stream:10000-20000"]
    assert replay_levels(read_events(str(tmp_path / "audit.jsonl"))
                         )["party"] == pytest.approx(_spent(second))
    second.close()


def test_window_charges_equal_jax():
    from dpcorr.stream.service import window_charges as jcharges

    for fams, e1, e2, norm in ((["ni_sign", "int_subg"], 0.4, 0.4, True),
                               (["ni_sign"], 0.4, 0.3, False),
                               (["int_sign"], 1.0, 0.5, False),
                               (list(FAMILIES), 0.4, 0.4, True)):
        assert window_charges(fams, e1, e2, norm, "x", "y") \
            == jcharges(fams, e1, e2, norm, "x", "y")
    assert window_charges(["ni_sign", "int_subg"], 0.4, 0.4, True, "x",
                          "y")["x"] == pytest.approx(1.2)


def test_stream_points_fire_in_the_port():
    for p in ("stream.pre_release", "stream.mid_window",
              "stream.post_journal"):
        assert p in chaos.KNOWN_POINTS and p not in chaos.MATRIX_POINTS
        assert p not in chaos.UNREACHABLE_POINTS
        chaos.install(chaos.ChaosPlan(p, mode="raise"))
        with pytest.raises(chaos.SimulatedCrash):
            chaos.point(p)
        chaos.clear()


# -------------------------------------------------------------- http ----
@pytest.fixture
def http_stream(tmp_path):
    sv = _service(tmp_path, max_pending_rows=64)
    srv = make_stream_http_server(sv, host="127.0.0.1", port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", sv
    srv.shutdown()
    srv.server_close()
    t.join(timeout=5)
    sv.close()


def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


class TestStreamHTTP:
    def test_ingest_release_subscribe_and_dedup(self, http_stream):
        base, _ = http_stream
        code, _, ack = _post(base, "/ingest", {
            "batch_id": "b1", "ts": 1.0,
            "rows": [[0.1, 0.2], [0.3, -0.4], [0.5, 0.6]]})
        assert code == 200 and ack["ok"] and ack["seq"] == 1
        code, _, ack = _post(base, "/ingest", {"batch_id": "b1", "ts": 1.0,
                                               "rows": [[0.1, 0.2]]})
        assert code == 200 and ack["deduped"]
        code, _, ack = _post(base, "/ingest", {"batch_id": "hb",
                                               "ts": 50.0})
        assert code == 200 and ack["released"] == ["0-10000"]
        feed = json.loads(_get(base, "/releases?since=0")[2])["releases"]
        assert [e["window_id"] for e in feed] == ["0-10000"]
        assert json.loads(_get(base, "/releases?since=1")[2]) \
            == {"releases": []}
        assert _get(base, "/releases?since=x")[0] == 400

    def test_refusals_map_to_codes(self, http_stream):
        base, _ = http_stream
        _post(base, "/ingest", {"batch_id": "b1", "ts": 100.0,
                                "rows": [[0.0, 0.0]] * 60})
        code, _, err = _post(base, "/ingest", {"batch_id": "b2", "ts": 5.0,
                                               "rows": [[0.0, 0.0]]})
        assert code == 400 and err["refused"] == "late" \
            and err["watermark"] == 100.0
        code, headers, err = _post(base, "/ingest", {
            "batch_id": "b3", "ts": 101.0, "rows": [[0.0, 0.0]] * 10})
        assert code == 429 and err["refused"] == "overload"
        assert int(headers["Retry-After"]) >= 1
        code, _, err = _post(base, "/ingest", {"ts": 1.0})
        assert code == 400 and "invalid ingest body" in err["error"]
        code, _, err = _post(base, "/ingest", {"batch_id": "b4", "ts": 102.0,
                                               "rows": [[1.0, 2.0, 3.0]]})
        assert code == 400

    def test_stats_metrics_healthz_trigger_and_404(self, http_stream):
        base, _ = http_stream
        code, _, body = _get(base, "/stats")
        assert code == 200 and json.loads(body)["stream_id"] == "stream"
        code, headers, body = _get(base, "/metrics")
        assert code == 200 and b"dpcorr_stream_rows_total" in body
        assert headers["Content-Type"].startswith("text/plain")
        assert _get(base, "/healthz")[0] == 200
        assert _get(base, "/nope")[0] == 404
        assert _post(base, "/nope", {})[0] == 404
        code, _, err = _post(base, "/obs/trigger", {"reason": "no_reason"})
        assert code == 400 and "unknown trigger reason" in err["error"]
        code, _, ok = _post(base, "/obs/trigger", {"reason": "cli"})
        assert code == 200 and ok["armed"] in (True, False)


def test_obs_endpoint_routes():
    from dpcorr_torch.obs.endpoint import start_obs_server
    from dpcorr_torch.obs.metrics import Registry

    reg = Registry()
    reg.counter("dpcorr_demo_total", "demo").inc()
    srv, port = start_obs_server(reg, stats_fn=lambda: {"kind": "demo"})
    base = f"http://127.0.0.1:{port}"
    try:
        assert json.loads(_get(base, "/stats")[2]) == {"kind": "demo"}
        assert b"dpcorr_demo_total" in _get(base, "/metrics")[2]
        assert _get(base, "/healthz")[0] == 200
        assert _get(base, "/x")[0] == 404
        assert _post(base, "/obs/trigger", {"reason": "bogus"})[0] == 400
        assert _post(base, "/obs/trigger",
                     {"reason": "cli", "detail": 3})[0] == 400
    finally:
        srv.shutdown()
        srv.server_close()
