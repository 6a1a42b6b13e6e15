"""The port's span tracer (dpcorr_torch.obs.trace) against the JAX
package's (dpcorr.obs.trace), and the spans the port's grid and HRS
ε-sweep write against the ones the JAX package writes.

The same operations go through both tracers; their span logs must have
the same names, parents, attribute keys and values (ids and times are
random and wall-clock). The grid is 3 points on each backend, the sweep
3 ε on a synthetic HRS panel.
"""

import json

import numpy as np
import pytest

from dpcorr import grid as jgrid
from dpcorr import hrs as jhrs
from dpcorr.obs import trace as jtrace
from dpcorr_torch import grid, hrs, perf_hrs
from dpcorr_torch.obs import trace


def _tree(spans):
    """Spans as (name, parent's name, attrs) in file order, with the
    parent found by its id in the same log."""
    by_id = {sp["span_id"]: sp for sp in spans}
    assert len({sp["trace_id"] for sp in spans}) == 1
    return [(sp["name"],
             by_id[sp["parent_id"]]["name"] if sp["parent_id"] else None,
             sp["attrs"]) for sp in spans]


def _exercise(mod, path):
    """The same calls through either tracer module."""
    tr = mod.configure(str(path))
    try:
        with tr.span("outer", k=1) as outer:
            with tr.span("inner", eps=0.5) as inner:
                inner.set(device_s=0.25)
            side = tr.start_span("side", parent=outer.context, n=3)
            side.end()
            side.end()  # a second end writes nothing
            remote = mod.from_wire_headers(mod.wire_headers(outer))
            tr.start_span("remote", parent=remote).end()
        with pytest.raises(KeyError):
            with tr.span("failing"):
                raise KeyError("x")
    finally:
        mod.configure(None)
    return mod.read_spans(str(path))


def test_tracer_writes_what_the_jax_tracer_writes(tmp_path):
    ours = _exercise(trace, tmp_path / "p.jsonl")
    theirs = _exercise(jtrace, tmp_path / "j.jsonl")
    assert [(sp["name"], sp["attrs"]) for sp in ours] == \
        [(sp["name"], sp["attrs"]) for sp in theirs]
    assert _tree(ours[:4]) == _tree(theirs[:4])
    assert [set(sp) for sp in ours] == [set(sp) for sp in theirs]
    assert ours[-1]["attrs"] == {"error": "KeyError"}
    assert ours[-1]["parent_id"] is None


def test_disabled_tracer_is_a_null_span_and_exports_match(tmp_path):
    tr = trace.Tracer(None)
    sp = tr.start_span("x", a=1)
    assert not tr.enabled and sp.trace_id is None
    assert trace.wire_headers(sp) == {} and trace.from_wire_headers({}) is None
    with tr.span("y") as sp2:
        sp2.set(b=2)
    seen = []
    tr.add_observer(seen.append)
    assert tr.enabled
    tr.start_span("z", c=3).end()
    tr.remove_observer(seen.append)
    assert not tr.enabled and [s["name"] for s in seen] == ["z"]
    spans = _exercise(trace, tmp_path / "s.jsonl")
    out = trace.write_chrome_trace(spans, str(tmp_path / "c.json"))
    ours = json.loads(open(out).read())
    theirs = jtrace.to_chrome_trace(spans)
    assert ours == theirs
    assert trace.to_chrome_trace(str(tmp_path / "s.jsonl")) == theirs
    (tmp_path / "bad.jsonl").write_text(
        '{"name": "a", "dur_s": 1}\nnot json\n')
    with pytest.raises(ValueError, match="bad.jsonl:2"):
        trace.read_spans(str(tmp_path / "bad.jsonl"))


def test_tracer_reads_the_environment_once_enabled(tmp_path, monkeypatch):
    path = tmp_path / "env.jsonl"
    monkeypatch.setenv("DPCORR_TRACE", str(path))
    trace.configure(None)
    try:
        tr = trace.tracer()
        assert tr.enabled and trace.tracer() is tr
        tr.start_span("e").end()
    finally:
        trace.configure(None)
    assert [sp["name"] for sp in trace.read_spans(str(path))] == ["e"]


GRID = dict(n_grid=(200,), rho_grid=(0.0, 0.5, 0.8), eps_pairs=((1.0, 1.0),),
            b=4)


@pytest.mark.parametrize("backend", ["bucketed", "local"])
def test_grid_span_tree_matches_jax(backend, tmp_path):
    """grid.run at the root; per bucket grid.dispatch and grid.fetch, or
    per point grid.point, with the JAX package's attributes (its
    precompile pool off: the port compiles nothing ahead)."""
    jtrace.configure(str(tmp_path / "j.jsonl"))
    try:
        jgrid.run_grid(jgrid.GridConfig(backend=backend, precompile="off",
                                        **GRID))
    finally:
        jtrace.configure(None)
    trace.configure(str(tmp_path / "p.jsonl"))
    try:
        grid.run_grid(grid.GridConfig(backend=backend, device="cpu", **GRID))
    finally:
        trace.configure(None)
    ours = _tree(trace.read_spans(str(tmp_path / "p.jsonl")))
    theirs = _tree(jtrace.read_spans(str(tmp_path / "j.jsonl")))
    assert ours == theirs
    assert ours[-1][:2] == ("grid.run", None)
    assert len(ours) == (3 if backend == "bucketed" else 4)


def test_grid_results_do_not_depend_on_tracing(tmp_path):
    cfg = grid.GridConfig(backend="bucketed", device="cpu", **GRID)
    plain = grid.run_grid(cfg)
    trace.configure(str(tmp_path / "p.jsonl"))
    try:
        traced = grid.run_grid(cfg)
    finally:
        trace.configure(None)
    for f, v in plain.detail_all.items():
        np.testing.assert_array_equal(traced.detail_all[f], v)


def test_sweep_span_tree_matches_jax(tmp_path):
    """hrs.eps_sweep at the root, an hrs.dispatch and an hrs.fetch child
    per ε, parented explicitly."""
    cols = perf_hrs.synthetic_panel(2, 16 * 300)
    kw = dict(cols=cols, eps_grid=[0.5, 1.5, 2.45], reps=4)
    jtrace.configure(str(tmp_path / "j.jsonl"))
    try:
        jhrs.eps_sweep(jhrs.HrsConfig(), **kw)
    finally:
        jtrace.configure(None)
    trace.configure(str(tmp_path / "p.jsonl"))
    try:
        hrs.eps_sweep(hrs.HrsConfig(), device="cpu", **kw)
    finally:
        trace.configure(None)
    ours = _tree(trace.read_spans(str(tmp_path / "p.jsonl")))
    theirs = _tree(jtrace.read_spans(str(tmp_path / "j.jsonl")))
    assert ours == theirs
    assert [s[0] for s in ours] == ["hrs.dispatch"] * 3 + ["hrs.fetch"] * 3 \
        + ["hrs.eps_sweep"]
