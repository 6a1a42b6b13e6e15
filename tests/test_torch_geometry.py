"""The port's geometry autotuner and the grid's geometry and precompile
knobs against ``dpcorr.utils.geometry`` and ``dpcorr.grid``, on the CPU.

Exact contracts: the cache key strings, ``entries`` and ``load_strict``
on the same file, the winner of one scripted clock and ladder, pin
precedence, a cache file written by either package read by the other,
the validation messages. The grid with ``geometry="auto"`` takes the
tuned chunk and gives the same bits as the pinned grid; ``precompile``
off and on are bit-equal and prepare nothing (``precompiled`` false).
"""

import dataclasses
import json

import numpy as np
import pytest

import dpcorr.grid as jgrid
from dpcorr.utils import geometry as jgeo
from dpcorr_torch import grid, sim
from dpcorr_torch.obs import trace
from dpcorr_torch.utils import geometry, rng

LADDER = ((2, 4, 8), (100, 200))
#: each probe's measured interval, in probe order: chunks (2, 4, 8) at
#: block 100, then blocks (100, 200) at the winning chunk
DUR = [0.30, 0.10, 0.20, 0.10, 0.18]
TINY = dict(n_grid=(200, 300), rho_grid=(0.0, 0.5),
            eps_pairs=((1.0, 1.0), (1.5, 0.5)), b=8, seed=5)


def _scripted_clock(durations):
    """Each probe reads the clock twice; consecutive entries of
    ``durations`` become consecutive probes' intervals."""
    seq = iter(durations)
    state = {"t": 0.0, "d": None}

    def clock():
        if state["d"] is None:
            state["d"] = next(seq)
            return state["t"]
        state["t"] += state["d"]
        state["d"] = None
        return state["t"]

    return clock


def _null_runner(chunk, block):
    return lambda: None


def _boom_runner(chunk, block):
    raise AssertionError("probe must not run")


@pytest.fixture()
def clean(monkeypatch, tmp_path):
    """Both packages' memos empty, no pins, each cache at its own path."""
    for mod in (geometry, jgeo):
        monkeypatch.setattr(mod, "_MEMO", {})
    monkeypatch.delenv("DPCORR_BENCH_CHUNK", raising=False)
    monkeypatch.delenv("DPCORR_BENCH_BLOCK_REPS", raising=False)
    monkeypatch.setenv("DPCORR_GEOMETRY_CACHE", str(tmp_path / "geo.json"))
    return tmp_path / "geo.json"


@pytest.mark.parametrize("args", [
    ("cpu", "grid-sign", 1000, "f32"),
    ("cuda-h100", "fused-ni", 10_000, "f32-band"),
    ("cpu", "f", 100, "f32", 1),
    ("cpu", "f", 100, "f32", 4, {"rep": 4}),
    ("cuda-h100", "f", 100, "f32", 2, {"rep": 2, "x": 1}),
])
def test_cache_key_strings_match_jax(args):
    assert geometry._cache_key(*args) == jgeo._cache_key(*args)


@pytest.mark.parametrize("eps_pairs,n", [
    (None, 1000), ([(1.0, 1.0)], 1000), ([(0.5, 0.5), (1.5, 0.5)], 4000),
    ([(2.0, 4.0)], None), ([(1.0, 8.0)], 9000),
])
def test_dtype_tag_matches_jax(eps_pairs, n):
    assert geometry.dtype_tag("f32", eps_pairs, n) == \
        jgeo.dtype_tag("f32", eps_pairs, n)


def test_entries_and_load_strict_on_the_same_file(tmp_path):
    state = {"cpu|bench-icdf|n=10000|f32": {
        "chunk_size": 4, "block_reps": 4096, "reps_per_sec": 5121.5,
        "captured_utc": "2026-08-01T00:00:00Z"},
        "cuda-h100|fused-ni|n=10000|f32|dev=2:rep=2": {
            "chunk_size": 4096, "block_reps": 65536, "reps_per_sec": 1.0},
        "cpu|f|n=1|f32|junk": {"chunk_size": 2},
        "weird-key": {"chunk_size": 1}, "cpu|g|n=5|f32": 7,
        "cpu|h|n=5|f32": {"chunk_size": 2, "captured_utc": "yesterday"}}
    p = tmp_path / "geometry.json"
    p.write_text(json.dumps(state))
    assert geometry.load_strict(str(p)) == jgeo.load_strict(str(p))
    now = 1787616000.0
    assert geometry.entries(state, now=now) == jgeo.entries(state, now=now)
    p.write_text("{broken")
    assert geometry._load(str(p)) == {}
    for mod in (geometry, jgeo):
        with pytest.raises(ValueError):
            mod.load_strict(str(p))
    p.write_text("[1, 2]")
    with pytest.raises(ValueError, match="not a JSON object"):
        geometry.load_strict(str(p))


@pytest.mark.parametrize("durations", [
    DUR, [0.1, 0.1, 0.1, 0.2, 0.4], [0.5, 0.4, 0.3, 0.2, 0.1],
])
def test_autotune_same_winner_as_jax(clean, durations):
    """One scripted clock and ladder: both packages probe in the same
    order and pick the same (chunk, block), ties toward the earlier
    ladder entry, with the same probe rate."""
    kw = dict(device_kind="cpu", ladder=LADDER, use_cache=False,
              force=True)
    got = geometry.autotune("det", 10, _null_runner,
                            clock=_scripted_clock(durations), **kw)
    want = jgeo.autotune("det", 10, _null_runner,
                         clock=_scripted_clock(durations), **kw)
    assert (got.chunk_size, got.block_reps, got.source) == \
        (want.chunk_size, want.block_reps, want.source)
    assert got.reps_per_sec == want.reps_per_sec
    assert got.as_detail() == want.as_detail()


def test_autotune_memo_then_cache(clean):
    geo = geometry.autotune("memo", 10, _null_runner, device_kind="cpu",
                            ladder=LADDER, clock=_scripted_clock(DUR))
    assert geo.source == "autotune"
    assert geometry.autotune("memo", 10, _boom_runner,
                             device_kind="cpu") is geo
    geometry._MEMO.clear()
    again = geometry.autotune("memo", 10, _boom_runner, device_kind="cpu")
    assert again.source == "cache"
    assert (again.chunk_size, again.block_reps) == (4, 200)
    assert geometry.lookup("memo", 10) == again
    assert geometry.lookup("cold", 10) is None


def test_pins_outrank_everything(clean, monkeypatch):
    monkeypatch.setenv("DPCORR_BENCH_CHUNK", "16")
    monkeypatch.setenv("DPCORR_BENCH_BLOCK_REPS", "512")
    for mod in (geometry, jgeo):
        geo = mod.autotune("pin", 10, _boom_runner, device_kind="cpu",
                           ladder=LADDER, use_cache=False)
        assert (geo.chunk_size, geo.block_reps, geo.source) == \
            (16, 512, "pinned")
        assert mod.lookup("pin", 10).source == "pinned"
    # env_pin=False ignores the pin in both
    geo = geometry.autotune("nopin", 10, _null_runner, device_kind="cpu",
                            ladder=LADDER, clock=_scripted_clock(DUR),
                            use_cache=False, force=True, env_pin=False)
    assert (geo.chunk_size, geo.block_reps, geo.source) == \
        (4, 200, "autotune")
    assert geometry.lookup("nopin", 10, env_pin=False) == geo
    # a half pin takes the other axis from the device's ladder; a pinned
    # width of 1 is floored
    monkeypatch.delenv("DPCORR_BENCH_BLOCK_REPS")
    monkeypatch.setenv("DPCORR_BENCH_CHUNK", "1")
    for kind in ("cpu", "cuda-h100"):
        got = geometry.lookup("half", 10, device_kind=kind)
        want = jgeo.resolve_pinned(jgeo._pinned(), kind)
        assert got.chunk_size == geometry.CHUNK_FLOOR == 2
        assert got.block_reps == geometry.LADDERS[kind][1][-1]
        if kind == "cpu":
            assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_probe_error_raises_where_jax_falls_back(clean):
    """A probe that fails raises (a K1 build or launch error on the card
    must not hide behind a default shape); the JAX tuner warns and
    returns its ladder default."""
    def broken(chunk, block):
        def run():
            raise RuntimeError("device fell over")
        return run

    with pytest.raises(RuntimeError, match="device fell over"):
        geometry.autotune("broken", 10, broken, device_kind="cpu",
                          ladder=LADDER, use_cache=False, force=True)
    assert jgeo.autotune("broken", 10, broken, device_kind="cpu",
                         ladder=LADDER, use_cache=False,
                         force=True).source == "default"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_files_read_both_ways(clean, writer):
    """A cache written by either package's tuner is read by the other's
    lookup and ``entries``, key for key."""
    w, r = (geometry, jgeo) if writer == "port" else (jgeo, geometry)
    w.autotune("both", 1000, _null_runner, device_kind="cpu",
               eps_pairs=[(1.0, 1.0)], ladder=LADDER,
               clock=_scripted_clock(DUR))
    w.autotune("both", 4000, _null_runner, device_kind="cpu",
               ladder=LADDER, clock=_scripted_clock([0.2, 0.3, 0.1, 0.4,
                                                     0.9]),
               device_count=4, mesh_shape={"rep": 4})
    state = json.loads(clean.read_text())
    assert sorted(state) == ["cpu|both|n=1000|f32",
                             "cpu|both|n=4000|f32|dev=4:rep=4"]
    r._MEMO.clear()
    one = r.lookup("both", 1000, device_kind="cpu", eps_pairs=[(1.0, 1.0)])
    four = r.lookup("both", 4000, device_kind="cpu", device_count=4,
                    mesh_shape={"rep": 4})
    assert (one.chunk_size, one.block_reps, one.source) == (4, 200, "cache")
    assert (four.chunk_size, four.block_reps) == (8, 100)
    now = 1.9e9
    assert geometry.entries(state, now=now) == jgeo.entries(state, now=now)


def test_default_cache_paths_never_mix(monkeypatch):
    monkeypatch.delenv("DPCORR_GEOMETRY_CACHE", raising=False)
    assert geometry.cache_path() != jgeo.cache_path()
    assert geometry.cache_path().endswith("dpcorr_torch/geometry.json")
    for off in ("0", "off", "none", ""):
        monkeypatch.setenv("DPCORR_GEOMETRY_CACHE", off)
        assert geometry.cache_path() is None


def test_pipeline_runner_probes_one_synchronous_block(clean):
    """A runner is one ``RepBlockPipeline.run(1, ...)``: one fetch, the
    next block address each call; the tuner makes two calls a probe."""
    rep_fn = sim.ni_rep_fn(200, 0.5, 1.0, 1.0)
    mk = geometry.pipeline_runner(rep_fn, 3, key=rng.master_key(
        device="cpu"), device="cpu")
    geo = geometry.autotune("runner", 200, mk, device_kind="cpu",
                            ladder=((2, 4), (8, 16)))
    assert geo.source == "autotune" and geo.reps_per_sec > 0
    assert mk.probes == 2 * (2 + 2)
    run = mk(4, 8)
    sums, reps = run()
    assert reps == 8 and len(sums) == 3


def test_grid_geometry_auto_takes_the_tuned_chunk(clean):
    """``geometry="auto"`` reads the tuned chunk of the grid's family at
    each point's n, keeps ``chunk_size`` where nothing was tuned, and
    gives the pinned grid's bits on the CPU (under its own stamp: the
    width is stamped); the JAX grid resolves the same chunk from the
    same cache."""
    gcfg = grid.GridConfig(**TINY, device="cpu", geometry="auto",
                           chunk_size=16)
    assert gcfg.grid_family() == "grid-sign"
    assert grid.GridConfig(use_subg=True).grid_family() == "grid-subg"
    geometry.autotune("grid-sign", 200, _null_runner, device_kind="cpu",
                      eps_pairs=[(1.0, 1.0)], ladder=LADDER,
                      clock=_scripted_clock(DUR))
    rows = grid._rows(gcfg.design_points())
    chunks = {(r.n, r.eps1): gcfg.sim_config(r).chunk_size for r in rows}
    assert chunks == {(200, 1.0): 4, (200, 1.5): 4, (300, 1.0): 16,
                      (300, 1.5): 16}
    jgeo._MEMO.clear()
    jcfg = jgrid.GridConfig(**TINY, geometry="auto", chunk_size=16)
    design = jcfg.design_points()
    assert [jcfg.sim_config(r).chunk_size for _, r in design.iterrows()] \
        == [gcfg.sim_config(r).chunk_size for r in rows]
    for backend in ("local", "bucketed"):
        auto = grid.run_grid(dataclasses.replace(gcfg, backend=backend))
        pinned = grid.run_grid(grid.GridConfig(**TINY, device="cpu",
                                               backend=backend))
        for f in sim.DETAIL_FIELDS:
            assert np.array_equal(auto.detail_all[f], pinned.detail_all[f])
    row = next(r for r in rows if r.n == 200)
    assert grid._stamp(gcfg.sim_config(row)) != grid._stamp(
        grid.GridConfig(**TINY, chunk_size=16).sim_config(row))


def test_precompile_off_and_on_bit_equal(tmp_path, monkeypatch):
    """Every ``precompile`` value dispatches the same lazy unit (eager
    torch has nothing to build ahead): bit-equal tables, nothing
    prepared through the executor, and ``precompiled`` false in the
    timings and on every ``grid.dispatch`` span, bucketed and ε-merged."""
    from dpcorr_torch import plan

    def no_prepare(*a, **k):
        raise AssertionError("the grid prepared a unit")

    monkeypatch.setattr(plan.Executor, "prepare", no_prepare)
    spans = tmp_path / "spans.jsonl"
    trace.configure(str(spans))
    try:
        runs = {pc: grid.run_grid(grid.GridConfig(
            **TINY, device="cpu", backend="bucketed", precompile=pc))
            for pc in ("off", "on", "auto")}
    finally:
        trace.configure(None)
    flags = [s["attrs"]["precompiled"] for s in trace.read_spans(str(spans))
             if s["name"] == "grid.dispatch"]
    assert flags == [False] * 12
    for pc in ("on", "auto"):
        for f in sim.DETAIL_FIELDS:
            assert np.array_equal(runs[pc].detail_all[f],
                                  runs["off"].detail_all[f])
        assert not runs[pc].timings["precompiled"].any()
    subg = dict(n_grid=(400,), rho_grid=(0.2,), b=8, seed=3,
                eps_pairs=((1.0, 1.0), (1.5, 0.5)), dgp="bounded_factor",
                use_subg=True, device="cpu", backend="bucketed",
                bucket_merge="eps")
    m_off = grid.run_grid(grid.GridConfig(**subg, precompile="off"))
    m_on = grid.run_grid(grid.GridConfig(**subg, precompile="on"))
    assert not m_on.timings["precompiled"].any()
    for f in sim.DETAIL_FIELDS:
        assert np.array_equal(m_on.detail_all[f], m_off.detail_all[f])
    # the local backend has no buckets: its timings have no column
    loc = grid.run_grid(grid.GridConfig(**TINY, device="cpu",
                                        precompile="on"))
    assert "precompiled" not in loc.timings


@pytest.mark.parametrize("field,value,match", [
    ("precompile", "bogus", "precompile must be 'off', 'auto' or 'on'"),
    ("geometry", "tuned", "geometry must be 'pinned' or 'auto'"),
])
def test_knobs_validated_as_jax(field, value, match):
    with pytest.raises(ValueError, match=match):
        grid.run_grid(grid.GridConfig(**TINY, device="cpu",
                                      **{field: value}))
    jvalidate = getattr(jgrid, f"validate_{field}")
    with pytest.raises(ValueError) as jerr:
        jvalidate(value)
    with pytest.raises(ValueError) as perr:
        getattr(grid, f"validate_{field}")(value)
    assert str(perr.value) == str(jerr.value)
