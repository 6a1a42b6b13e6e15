"""The port's measuring layer against the JAX package's, on the CPU: the
block profiler (``obs.prof``), the roofline (``utils.roofline``), the
device monitor (``obs.devicemon``), the torch.profiler trace
(``utils.profiling``), and the JAX-free readers ``obs trajectory``,
``obs hlo show | diff`` and ``obs geometry``.

Exact contracts: the profiler's cadence and sync counts for the same
blocks and bound; a profiled run's sums bit-equal to the unprofiled
run's with one fetch either way; profile artifacts read both ways; the
roofline's work model and summary equal JAX's (and K1's moved bound
0.3453 ms); the readers print the same text as JAX's CLI on the same
files. The device monitor publishes no series where there is no card.
"""

import dataclasses
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcorr.__main__ import main as jax_main
from dpcorr.obs import devicemon as jdevicemon
from dpcorr.obs import hlo as jhlo
from dpcorr.obs import prof as jprof
from dpcorr.obs import trajectory as jtraj
from dpcorr.obs.metrics import Registry as JRegistry
from dpcorr.utils import roofline as jroofline
from dpcorr_torch import sim
from dpcorr_torch.__main__ import main as port_main
from dpcorr_torch.obs import devicemon, hlo, prof, trace, trajectory, transfer
from dpcorr_torch.obs.metrics import Registry, parse_exposition
from dpcorr_torch.utils import profiling, rng, roofline

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent


def _pipeline(counters, profiler=None, block=8):
    return sim.RepBlockPipeline(
        sim.ni_rep_fn(200, 0.5, 1.0, 1.0), 3,
        key=rng.master_key(7, "cpu"), block_reps=block, chunk_size=4,
        device="cpu", counters=counters, profiler=profiler)


# ------------------------------------------------------------ profiler


@pytest.mark.parametrize("n_blocks,max_syncs,cadence", [
    (6, 64, 2), (100, 4, None), (10_000, 64, None), (7, 3, None),
    (1, 64, None), (64, 64, None), (130, 64, None),
])
def test_cadence_and_sync_count_as_jax(n_blocks, max_syncs, cadence):
    """The same blocks and bound give the same cadence, syncs and
    segment sizes in both packages."""
    ours = prof.BlockProfiler(cadence=cadence, max_syncs=max_syncs,
                              registry=Registry())
    theirs = jprof.BlockProfiler(cadence=cadence, max_syncs=max_syncs,
                                 registry=JRegistry())
    st = ours.run_start(block_reps=8, n_blocks=n_blocks)
    jst = theirs.run_start(block_reps=8, n_blocks=n_blocks)
    assert st["cadence"] == jst["cadence"]
    acc = [torch.zeros(3)]
    for i in range(n_blocks):
        ours.block_boundary(st, i, acc)
        theirs.block_boundary(jst, i, jnp.zeros(3))
    assert st["sync_count"] == jst["sync_count"] <= max(max_syncs,
                                                        n_blocks)
    assert [s["blocks"] for s in st["samples"]] == \
        [s["blocks"] for s in jst["samples"]]
    assert int(ours.syncs_total.value()) == st["sync_count"]


def test_unprofiled_run_one_fetch_zero_prof_syncs():
    reg = Registry()
    counters = transfer.TransferCounters(registry=reg)
    profiler = prof.BlockProfiler(registry=reg)  # exists, not attached
    pipe = _pipeline(counters)
    before = counters.snapshot()
    pipe.run(6)
    assert transfer.diff(counters.snapshot(), before)["fetches"] == 1
    assert pipe.fetches == 1
    assert int(profiler.syncs_total.value()) == 0


def test_profiled_run_bit_equal_bounded_syncs_not_fetches(tmp_path):
    reg = Registry()
    counters = transfer.TransferCounters(registry=reg)
    art = tmp_path / "profile.json"
    profiler = prof.BlockProfiler(cadence=2, registry=reg,
                                  artifact_path=str(art))
    plain = _pipeline(transfer.TransferCounters(registry=Registry()))
    pipe = _pipeline(counters, profiler=profiler)
    before = counters.snapshot()
    got = pipe.run(6, start_block=3)
    assert got == plain.run(6, start_block=3)  # bit-equal sums
    diff = transfer.diff(counters.snapshot(), before)
    assert diff["fetches"] == 1 and pipe.fetches == 1
    assert int(profiler.syncs_total.value()) == 3  # blocks 1, 3, 5
    assert parse_exposition(reg.render())["dpcorr_prof_syncs_total"] == 3
    for reader in (prof.read_profile, jprof.read_profile):
        (run,) = reader(str(art))["runs"]
        assert (run["sync_count"], run["n_blocks"], run["start_block"],
                run["cadence"]) == (3, 6, 3, 2)
        assert [s["block"] for s in run["samples"]] == [1, 3, 5]
        assert run["transfer"]["fetches"] == 1
        assert run["transfer"]["donated_blocks"] == 6
        assert run["reps_per_sec"] > 0 and run["family"] == "custom"


def test_jax_profile_artifact_read_by_the_port(tmp_path):
    theirs = jprof.BlockProfiler(registry=JRegistry())
    st = theirs.run_start(family="f", block_reps=4, n_blocks=2)
    theirs.block_boundary(st, 0, jnp.zeros(()))
    theirs.run_end(st)
    theirs.note_phase("grid.scan", 0.25, buckets=3)
    path = tmp_path / "jax_profile.json"
    theirs.write_artifact(str(path))
    data = prof.read_profile(str(path))
    assert data["runs"][0]["family"] == "f"
    assert data["phases"] == [{"name": "grid.scan", "seconds": 0.25,
                               "buckets": 3}]
    path.write_text(json.dumps({"kind": "other"}))
    with pytest.raises(ValueError, match="not a dpcorr_profile"):
        prof.read_profile(str(path))


def test_phases_and_module_helpers():
    reg = Registry()
    profiler = prof.BlockProfiler(registry=reg)
    with profiler.phase("grid.dispatch", buckets=3):
        pass
    assert profiler.phase_seconds.value(phase="grid.dispatch") >= 0.0
    assert profiler.as_artifact()["phases"][0]["name"] == "grid.dispatch"
    prof.activate(None)
    with prof.phase("anything"):
        pass
    prof.note_phase("anything", 1.0)
    prof.activate(profiler)
    try:
        prof.note_phase("armed", 0.5)
        assert profiler.phase_seconds.value(phase="armed") == 0.5
    finally:
        prof.activate(None)


def test_grid_notes_its_three_phases():
    """The bucketed grid notes grid.scan, grid.dispatch and grid.fetch
    into the active profiler, as the JAX grid does."""
    from dpcorr_torch import grid

    profiler = prof.BlockProfiler(registry=Registry())
    prof.activate(profiler)
    try:
        grid.run_grid(grid.GridConfig(
            n_grid=(200,), rho_grid=(0.0, 0.5), eps_pairs=((1.0, 1.0),),
            b=4, device="cpu", backend="bucketed"))
    finally:
        prof.activate(None)
    phases = profiler.as_artifact()["phases"]
    assert [p["name"] for p in phases] == ["grid.scan", "grid.dispatch",
                                           "grid.fetch"]
    assert phases[0]["buckets"] == phases[1]["buckets"] == 1
    assert phases[2]["points_run"] == 2


# ------------------------------------------------------------ roofline


@pytest.mark.parametrize("n,eps", [(10_000, (1.0, 1.0)), (1000, (0.5, 0.5)),
                                   (4000, (1.5, 0.5)), (7, (8.0, 8.0))])
def test_analytic_model_and_summary_equal_jax(n, eps):
    model = roofline.analytic_rep_model(n, *eps)
    assert model == jroofline.analytic_rep_model(n, *eps)
    for rps in (1.0, 5122.0, 2.1e6):
        got = roofline.summarize(rps, model["flops_per_rep"],
                                 model["bytes_per_rep_floor"],
                                 roofline.CPU_CORE)
        want = jroofline.summarize(rps, model["flops_per_rep"],
                                   model["bytes_per_rep_floor"],
                                   jroofline.CPU_CORE)
        assert got == want


def test_peaks_by_device_kind():
    assert dataclasses.asdict(roofline.peaks_for("cpu")) == \
        dataclasses.asdict(jroofline.peaks_for("cpu"))
    h100 = roofline.peaks_for("cuda-h100")
    assert (h100.vpu_f32_flops, h100.hbm_bytes) == (6.7e13, 3.35e12)
    for kind in ("tpu", "cuda-a100", "gpu"):
        with pytest.raises(ValueError, match="no peak figures"):
            roofline.peaks_for(kind)
    s = roofline.summarize(1e6, 1.97e6, 1.6e4, h100)
    assert s["bound"] == "vpu" and s["peaks"]["name"] == "cuda-h100"


def test_k1_bound_moved_unchanged():
    """K1 at the main path's launch (2¹⁴ reps, n = 10⁴, ε = (1, 1),
    in-kernel Philox, NI): 0.3453 ms by the int32 pipe, 0.2633 ms of
    issue slots; NI + INT 0.5217 ms (PERF.md §6)."""
    b = 1 << 14
    t = roofline.least_time_ms(roofline.fused_pipe_ops(10_000, (1.0, 1.0),
                                                       False), b, b * 24)
    assert round(t["int32"], 4) == 0.3453
    assert round(t["issue"], 4) == 0.2633
    assert max(t, key=t.get) == "int32"
    t_int = roofline.least_time_ms(roofline.fused_pipe_ops(
        10_000, (1.0, 1.0), True), b, b * 24)
    assert round(t_int["int32"], 4) == 0.5217
    ext = roofline.fused_pipe_ops(10_000, (1.0, 1.0), False, philox=False)
    assert ext["int32"] < roofline.fused_pipe_ops(10_000, (1.0, 1.0),
                                                  False)["int32"]


@pytest.mark.parametrize("name,kind", [
    ("NVIDIA H100 80GB HBM3", "cuda-h100"), ("NVIDIA H100 PCIe", "cuda-h100"),
    ("NVIDIA A100-SXM4-40GB", "cuda-a100"),
    ("NVIDIA GeForce RTX", "cuda-nvidia-geforce-rtx"),
])
def test_device_kind_names_the_card(monkeypatch, name, kind):
    from dpcorr_torch.utils.device import device_kind

    assert device_kind("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: name)
    assert device_kind("cuda") == kind
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_kind()


def test_throughput_utilization_reads_the_roofline():
    tp = profiling.Throughput(n_devices=2)
    with tp.measure():
        pass
    tp.seconds = 2.0
    tp.add(4000)
    assert tp.reps_per_sec == 2000.0 and tp.reps_per_sec_chip == 1000.0
    got = tp.utilization(100.0, 10.0, device_kind="cpu")
    assert got == roofline.summarize(1000.0, 100.0, 10.0,
                                     roofline.CPU_CORE)
    assert math.isnan(profiling.Throughput().reps_per_sec)


# ---------------------------------------------------------- devicemon


def test_devicemon_no_card_no_series():
    reg = Registry()
    mon = devicemon.DeviceMonitor(registry=reg,
                                  transfer_counters=transfer.TransferCounters(
                                      registry=Registry()))
    assert devicemon.probe() == {}
    assert mon.sample() == {}
    assert mon.watermarks() == {}
    assert devicemon.watermarks_detail() == {}
    assert not [k for k in parse_exposition(reg.render())
                if k.startswith("dpcorr_device_")]


def test_devicemon_maps_allocator_stats_to_jax_keys(monkeypatch):
    """A faked card: the allocator's current and peak bytes and the total
    memory land on the JAX package's keys and gauge names, labelled
    ``cuda:<i>``; no live-buffer series."""
    stats = [{"allocated_bytes.all.current": 100,
              "allocated_bytes.all.peak": 300}, {}]

    class Props:
        total_memory = 80 * 2 ** 30

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats[i])
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props)
    reg = Registry()
    counters = transfer.TransferCounters(registry=Registry())
    counters.fetches.inc(2)
    mon = devicemon.DeviceMonitor(registry=reg, transfer_counters=counters)
    snap = mon.sample()
    limit = Props.total_memory
    assert snap == {"cuda:0": {"bytes_in_use": 100,
                               "peak_bytes_in_use": 300,
                               "bytes_limit": limit},
                    "cuda:1": {"bytes_limit": limit}}
    stats[0]["allocated_bytes.all.current"] = 50
    mon.sample()
    assert mon.watermarks()["cuda:0"] == {"bytes_in_use": 100,
                                          "peak_bytes_in_use": 300,
                                          "bytes_limit": limit}
    series = parse_exposition(reg.render())
    assert series['dpcorr_device_mem_bytes_in_use{device="cuda:0"}'] == 50
    assert series['dpcorr_device_mem_limit_bytes{device="cuda:1"}'] == limit
    assert series['dpcorr_device_transfer{device="cuda:0",'
                  'counter="fetches"}'] == 2
    # the gauge names are the JAX package's, less the live-buffer pair
    jreg = JRegistry()
    jdevicemon.DeviceMonitor(registry=jreg)
    ours = {m.name for m in reg.metrics()}
    theirs = {m.name for m in jreg.metrics()}
    assert ours == theirs - {"dpcorr_device_live_buffers",
                             "dpcorr_device_live_buffer_bytes"}


# -------------------------------------------------------------- trace


def test_trace_writes_a_chrome_trace_and_a_span(tmp_path):
    spans = tmp_path / "spans.jsonl"
    trace.configure(str(spans))
    try:
        with profiling.trace(str(tmp_path / "tr")) as p:
            (torch.ones(64) * 2.0).sum()
        names = {e.key for e in p.key_averages()}
    finally:
        trace.configure(None)
    assert "aten::mul" in names
    doc = json.loads((tmp_path / "tr" / profiling.TRACE_FILE).read_text())
    assert any(e.get("name") == "aten::mul" for e in doc["traceEvents"])
    (sp,) = trace.read_spans(str(spans))
    assert sp["name"] == "profiler.trace"
    assert sp["attrs"]["log_dir"] == str(tmp_path / "tr")


# -------------------------------------------- trajectory, hlo, geometry


def _cli(main, argv, capsys):
    """Run a CLI in process; (exit code, stdout, stderr)."""
    try:
        main(argv)
        rc = 0
    except SystemExit as e:
        rc = e.code or 0
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_trajectory_same_report_as_jax(capsys):
    roots = trajectory.default_roots(str(REPO))
    ours, theirs = (trajectory.build_report(roots),
                    jtraj.build_report(roots))
    assert ours.points and ours.statuses
    for render in ("render_console", "render_json", "render_markdown"):
        assert getattr(trajectory, render)(ours) == \
            getattr(jtraj, render)(theirs)
    for fmt in ("console", "json", "markdown"):
        argv = ["obs", "trajectory", "--repo", str(REPO), "--format", fmt,
                "--check"]
        assert _cli(port_main, argv, capsys) == _cli(jax_main, argv, capsys)


def test_trajectory_names_a_regression_and_never_mixes_kinds(tmp_path):
    def art(name, value, kind):
        (tmp_path / name).write_text(json.dumps({
            "metric": "m", "value": value, "unit": "reps/s",
            "detail": {"device_kind": kind}}))

    art("BENCH_r01.json", 100.0, "cuda-h100")
    art("BENCH_r02.json", 110.0, "cuda-h100")
    art("BENCH_r03.json", 44.0, "cuda-h100")
    art("BENCH_r04.json", 10.0, "cpu")
    (tmp_path / "BENCH_r05.json").write_text("{broken")
    rep = trajectory.build_report([str(tmp_path)])
    (reg,) = rep.regressions
    assert reg.series == ("cuda-h100", "m")
    assert reg.path.endswith("BENCH_r03.json") and reg.ratio == 0.4
    assert sorted(rep.series) == [("cpu", "m"), ("cuda-h100", "m")]
    assert rep.as_dict() == jtraj.build_report([str(tmp_path)]).as_dict()
    assert trajectory.gate_attribution(
        [str(tmp_path)], metric="m", device_kind="cpu",
        measured_value=1.0)["path"] == "<this run>"


@pytest.fixture()
def jax_dumps(tmp_path):
    """Two signature dumps written by the JAX package: one changed
    program, one removed and one added signature."""
    import jax

    def compiled(fn):
        return jax.jit(fn).lower(
            jax.ShapeDtypeStruct((64,), jnp.float32)).compile()

    a, b = jhlo.HloStore(), jhlo.HloStore()
    a.record({"kernel": "k", "n": 64}, compiled(lambda x: jnp.sin(x) + 1.0),
             seconds=0.1, cause="new-signature")
    a.record({"kernel": "gone"}, compiled(lambda x: x * 2.0))
    b.record({"kernel": "k", "n": 64},
             compiled(lambda x: jnp.sin(jnp.cos(x)) * 2.0 + 1.0),
             seconds=0.1, cause="cache-evict")
    b.record({"kernel": "new", "n": 8}, compiled(lambda x: x + 3.0))
    return a.dump(str(tmp_path / "a.json")), b.dump(str(tmp_path / "b.json"))


def test_hlo_show_and_diff_same_text_as_jax(jax_dumps, capsys, tmp_path):
    old, new = jax_dumps
    assert hlo.load_dump(old) == jhlo.load_dump(old)
    diff = hlo.diff_dumps(hlo.load_dump(old), hlo.load_dump(new))
    assert diff == jhlo.diff_dumps(jhlo.load_dump(old), jhlo.load_dump(new))
    assert [c["label"] for c in diff["changed"]] == ["kernel=k,n=64"]
    assert hlo.render_diff(diff) == jhlo.render_diff(diff)
    assert hlo.render_diff(hlo.diff_dumps({}, {})) == \
        "dumps are identical.\n"
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"kind": "other"}))
    for argv in (["obs", "hlo", "show", old],
                 ["obs", "hlo", "show", new, "--json"],
                 ["obs", "hlo", "diff", old, new],
                 ["obs", "hlo", "diff", old, new, "--json"],
                 ["obs", "hlo", "show", str(bad)],
                 ["obs", "hlo", "diff", old, str(tmp_path / "none.json")]):
        ours = _cli(port_main, argv, capsys)
        assert ours == _cli(jax_main, argv, capsys)
        assert ours[0] == (1 if "bad" in argv[-1] or "none" in argv[-1]
                           else 0)


def test_obs_geometry_same_output_as_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("DPCORR_BENCH_CHUNK", raising=False)
    monkeypatch.delenv("DPCORR_BENCH_BLOCK_REPS", raising=False)
    bad = tmp_path / "bad.json"
    bad.write_text("{broken")
    rc, _, err = _cli(port_main, ["obs", "geometry", "--path", str(bad)],
                      capsys)
    assert rc == 1 and "corrupt" in err
    good = tmp_path / "good.json"
    good.write_text(json.dumps({
        "cuda-h100|fused-ni|n=10000|f32": {
            "chunk_size": 16384, "block_reps": 65536,
            "reps_per_sec": 2.0e6, "captured_utc": "2026-08-01T00:00:00Z"},
        "cpu|grid-sign|n=1000|f32": {"chunk_size": 4, "block_reps": 4096,
                                     "reps_per_sec": None}}))
    monkeypatch.setenv("DPCORR_BENCH_CHUNK", "64")
    argv = ["obs", "geometry", "--path", str(tmp_path / "none")]
    assert _cli(port_main, argv, capsys) == _cli(jax_main, argv, capsys)
    argv = ["obs", "geometry", "--path", str(good), "--json"]
    docs = [json.loads(_cli(main, argv, capsys)[1])
            for main in (port_main, jax_main)]
    for doc in docs:  # staleness is read from the clock at each call
        for e in doc["entries"]:
            e.pop("age_s")
    assert docs[0] == docs[1]
    rc, out, _ = _cli(port_main, ["obs", "geometry", "--path", str(good)],
                      capsys)
    assert rc == 0 and "[cuda-h100] fused-ni n=10000 f32: chunk=16384" \
        in out and "env pin" in out
    doc = json.loads(_cli(port_main, ["obs", "geometry", "--path",
                                      str(good), "--json"], capsys)[1])
    assert [e["device_kind"] for e in doc["entries"]] == ["cpu",
                                                          "cuda-h100"]
    assert np.isclose(doc["entries"][1]["reps_per_sec"], 2.0e6)
