"""The port's ranges where the work is done, and the benchmark's readers
of them.

On the CPU profiler: each range the benchmark's cells read
(``keytree``, ``host_read``, ``pipeline_init``, ``hrs_wave``,
``hrs_standardize``, the streamed pass's ``stream_dgp``, ``subg_stats``
and ``subg_interval``) appears on the cells' paths (the pipeline's fused
and unfused bodies at toy sizes, the bootstrap on a small synthetic
panel, the stress study's streamed pair) and encloses no stage range,
and no streamed stage encloses or sits in another stage; a nested
key-tree call opens one range; with the profiler off no range is made
and no thread-local state is read; every output is bit-equal with the
profiler on and off; a
``Tracer`` span is a profiler range too, and ``obs/trace.py`` imports
without torch. The readers under ``portbench/layer_metrics/`` give their
values on a hand-built timeline, and None without the ranges.
"""

import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dpcorr_torch import hrs, perf_hrs, sim
from dpcorr_torch.models.estimators import streaming
from dpcorr_torch.obs import trace as obs_trace
from dpcorr_torch.ops import fused_ni
from dpcorr_torch.utils import profiling, rng

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:  # the benchmark imports from the root
    sys.path.insert(0, str(REPO))

from portbench import core, tracing  # noqa: E402

N, RHO, EPS = 600, 0.5, (1.0, 1.0)
NEW = ("keytree", "host_read", "pipeline_init", "hrs_wave",
       "hrs_standardize")
STREAM = set(streaming.STREAM_STAGES)
OLD = set(sim.FUSED_STAGES + sim.GRID_STAGES + hrs.HRS_STAGES) | STREAM


@pytest.fixture(scope="module")
def panel():
    return perf_hrs.synthetic_panel(7, 16_000)


@pytest.fixture
def plain_k1(monkeypatch):
    """K1 as its plain version on the CPU, its in-kernel draws laid out
    as external uniforms (the fused body is otherwise card-only)."""
    real = sim.fused_ni_sums

    def plain(seeds, rho, n, eps1, eps2, *args, **kw):
        u = fused_ni.philox_uniforms(seeds, n, eps1, eps2)
        return real(seeds, rho, n, eps1, eps2, *args, uniforms=u, **kw)

    monkeypatch.setattr(sim, "fused_ni_sums", plain)


def _study(path, panel):
    """One study of a cell's path at a toy size: the pipeline built and
    run once (as ``portbench/drivers/mc_pipeline.py`` does), one
    bootstrap, or one streamed stress study (as
    ``portbench/drivers/sim_one.py`` runs it); returns its outputs."""
    if path == "stream":
        cfg = sim.SimConfig(n=1000, rho=RHO, eps1=EPS[0], eps2=EPS[1], b=3,
                            dgp="bounded_factor", use_subg=True,
                            stream_n_chunk=256, chunk_size=2)
        res = sim.run_sim_one(cfg, key=rng.master_key(5, "cpu"),
                              device="cpu")
        return [res.detail[f] for f in sim.DETAIL_FIELDS]
    if path == "bootstrap":
        res = hrs.bootstrap(hrs.HrsConfig(seed=3), cols=panel, reps=8,
                            chunk=4, device="cpu")
        return [res.runs[f] for f in hrs.BOOT_FIELDS]
    make = {"fused": sim.fused_ni_rep_fn, "unfused": sim.ni_rep_fn}[path]
    pipe = sim.RepBlockPipeline(make(N, RHO, *EPS), 3,
                                key=rng.master_key(5, "cpu"), block_reps=8,
                                chunk_size=4, device="cpu")
    sums, _ = pipe.run(1)
    return [np.asarray(sums), pipe._shards[0].out.numpy().copy()]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = [(ev.name, ev.time_range.start, ev.time_range.end, ev.thread)
              for ev in prof.events() if ev.device_type == DeviceType.CPU
              and ev.name in set(NEW) | OLD]
    return out, ranges


def _encloses(outer, inner) -> bool:
    return (outer[3] == inner[3] and outer[1] <= inner[1]
            and inner[2] <= outer[2] and outer != inner)


WANT = {"fused": {"keytree", "host_read", "pipeline_init", "kernel_seeds",
                  "rep_keys"},
        "unfused": {"keytree", "host_read", "pipeline_init", "rep_keys"},
        "bootstrap": {"keytree", "host_read", "hrs_wave", "hrs_standardize",
                      "hrs_resample", "hrs_ni", "hrs_int"},
        "stream": {"keytree", "host_read"} | STREAM}


@pytest.mark.parametrize("path", sorted(WANT))
def test_new_ranges_on_the_cells_paths(path, panel, plain_k1):
    _, ranges = _profiled(lambda: _study(path, panel))
    assert WANT[path] <= {r[0] for r in ranges}
    for outer in ranges:
        for inner in ranges:
            if not _encloses(outer, inner):
                continue
            # no new range encloses a stage range, nor a keytree another
            assert not (outer[0] in NEW and inner[0] in OLD), (outer, inner)
            assert not (outer[0] == inner[0] == "keytree"), (outer, inner)
            # a streamed stage neither holds nor sits in another stage
            assert not (outer[0] in OLD and inner[0] in OLD
                        and STREAM & {outer[0], inner[0]}), (outer, inner)


def test_standardize_holds_its_draws_and_reads(panel):
    _, ranges = _profiled(lambda: _study("bootstrap", panel))
    std = [r for r in ranges if r[0] == "hrs_standardize"]
    assert len(std) == 1  # the bootstrap's one range over it
    inside = {r[0] for r in ranges if _encloses(std[0], r)}
    assert {"keytree", "host_read"} <= inside


CALLS = {
    "master_key": lambda k: rng.master_key(9),
    "fold_in": lambda k: rng.fold_in(k, 3),
    "fold_in_words": lambda k: rng.fold_in_words((1, 2), 3),
    "threefry2x32": lambda k: rng.threefry2x32(k, torch.zeros(2, dtype=
                                                 torch.int64), 1),
    "design_key": lambda k: rng.design_key(k, 4),
    "rep_keys": lambda k: rng.rep_keys(k, 5),
    "rep_keys_slice": lambda k: rng.rep_keys_slice(k, 2, 5),
    "stream": lambda k: rng.stream(k, "x"),
    "party_root": lambda k: rng.party_root(k, "x", "hardened"),
    "column_root": lambda k: rng.column_root(k, "c"),
    "chunk_key": lambda k: rng.chunk_key(k, 1),
    "split": lambda k: rng.split(k, 3),
    "random_bits": lambda k: rng.random_bits(k, (6,)),
    "uniform": lambda k: rng.uniform(k, (6,)),
    "normal": lambda k: rng.normal(k, (6,)),
    "exponential": lambda k: rng.exponential(k, (6,)),
    "bernoulli": lambda k: rng.bernoulli(k, 0.3, (6,)),
    "randint": lambda k: rng.randint(k, (6,), 0, 10),
    "choice": lambda k: rng.choice(k, 10, (6,)),
    "permutation": lambda k: rng.permutation(k, 7),
    "kernel_seeds": lambda k: rng.kernel_seeds(rng.rep_keys(k, 3)),
}


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
@pytest.mark.parametrize("name", sorted(CALLS))
def test_a_key_tree_call_opens_one_range(name, impl, monkeypatch):
    """Each public derivation or draw is one ``keytree`` range, however
    many key-tree calls it makes inside (rbg keys draw key by key)."""
    monkeypatch.setenv("DPCORR_PRNG", impl)
    key = rng.master_key(11)
    if name == "kernel_seeds":  # its own rep_keys is a range of its own
        keys = rng.rep_keys(key, 3)
        fn = lambda: rng.kernel_seeds(keys)  # noqa: E731
    elif name == "threefry2x32" and impl == "rbg":
        fn = lambda: rng.threefry2x32(key[:2], 0, 1)  # noqa: E731
    else:
        fn = lambda: CALLS[name](key)  # noqa: E731
    plain = fn()
    got, ranges = _profiled(fn)
    assert [r[0] for r in ranges] == ["keytree"]
    assert _bits(got) == _bits(plain)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().tobytes()
    if isinstance(x, tuple):
        return tuple(_bits(v) for v in x)
    return x


def test_no_range_and_no_thread_state_while_the_profiler_is_off(
        monkeypatch, panel, plain_k1):
    def made(*args, **kw):
        raise AssertionError("a range was made with the profiler off")

    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError("thread-local state read")

        def __setattr__(self, name, value):
            raise AssertionError("thread-local state written")

    monkeypatch.setattr(profiling, "record_function", made)
    monkeypatch.setattr(profiling, "_host_timed", made)
    monkeypatch.setattr(profiling, "_open", Untouchable())
    monkeypatch.setattr(torch.autograd.profiler, "record_function", made)
    key = rng.master_key(2)
    for fn in CALLS.values():
        fn(key)
    for path in WANT:
        _study(path, panel)
    with obs_trace.Tracer(None).span("grid.run"):
        pass


@pytest.mark.parametrize("path", ["fused", "unfused", "bootstrap", "stream",
                                  "draws"])
def test_outputs_bit_equal_with_the_profiler_on_and_off(path, panel,
                                                        plain_k1):
    def run():
        if path == "draws":
            k = rng.stream(rng.master_key(4), "d")
            return [rng.random_bits(k, (64,)).numpy(),
                    rng.normal(k, (64,)).numpy(),
                    rng.permutation(k, 50).numpy()]
        return _study(path, panel)

    off = run()
    on, _ = _profiled(run)
    with profiling.stage_host_seconds():
        timed = run()
    for a, b, c in zip(off, on, timed, strict=True):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        assert np.asarray(a).tobytes() == np.asarray(c).tobytes()


@pytest.mark.parametrize("log", [False, True])
def test_a_tracer_span_is_a_profiler_range(log, tmp_path):
    tr = obs_trace.Tracer(str(tmp_path / "spans.jsonl") if log else None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("grid.run"):
            sp = tr.start_span("hrs.fetch")
            torch.ones(3).sum()
            sp.end()
            sp.end()  # a second end does nothing
    names = [ev.name for ev in prof.events()]
    assert names.count("grid.run") == 1 and names.count("hrs.fetch") == 1
    ev = {e.name: e.time_range for e in prof.events()}
    assert ev["grid.run"].start <= ev["hrs.fetch"].start
    assert ev["hrs.fetch"].end <= ev["grid.run"].end
    assert obs_trace.current_span() is None
    if log:
        tr.close()
        assert [s["name"] for s in obs_trace.read_spans(
            str(tmp_path / "spans.jsonl"))] == ["hrs.fetch", "grid.run"]


def test_obs_trace_imports_and_spans_without_torch(tmp_path):
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "from dpcorr_torch.obs import trace\n"
            f"t = trace.Tracer({str(tmp_path / 's.jsonl')!r})\n"
            "with t.span('a'):\n"
            "    t.start_span('b').end()\n"
            "with trace.Tracer(None).span('c'):\n"
            "    pass\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def _timeline(with_ranges: bool = True):
    """A 100-µs window: a kernel launched inside a keytree range, a gap
    half inside that range, a set-up range holding a keytree range, a
    read holding one sync, two stray syncs (a driver call nested in the
    first counts once) and the window's closing sync."""
    events = [
        _ev(tracing.WINDOW, "user_annotation", 0, 100),
        _ev("keytree", "user_annotation", 0, 30),
        _ev("cudaLaunchKernel", "cuda_runtime", 5, 1, correlation=1),
        _ev("threefry", "kernel", 10, 10, correlation=1),
        _ev("pipeline_init", "user_annotation", 25, 20),
        _ev("keytree", "user_annotation", 35, 5),
        _ev("cudaLaunchKernel", "cuda_runtime", 36, 1, correlation=3),
        _ev("fold_in", "kernel", 40, 5, correlation=3),
        _ev("cudaStreamSynchronize", "cuda_runtime", 50, 2),
        _ev("cuStreamSynchronize", "cuda_driver", 50.5, 1),
        _ev("host_read", "user_annotation", 60, 20),
        _ev("cudaStreamSynchronize", "cuda_runtime", 70, 5),
        _ev("cudaMemcpy", "cuda_runtime", 85, 1, correlation=2),
        _ev("Memcpy DtoH", "gpu_memcpy", 86, 4, correlation=2),
        _ev("cudaDeviceSynchronize", "cuda_runtime", 95, 5),
    ]
    if not with_ranges:
        events = [e for e in events if e["name"] not in NEW]
    return tracing.Trace(events)


# busy [10, 20), [40, 45), [86, 90); idle [0, 10), [20, 40), [45, 86),
# [90, 100); 2 studies of 500 replications
READINGS = {
    "keytree_device_ms_per_krep": 15e-3,   # 15 µs of kernels, 1 krep
    "keytree_device_ms_per_krep.unfused": 15e-3,
    "keytree_idle_pct": 25.0,              # [0, 10), [20, 30), [35, 40)
    "prep_idle_pct": 5.0,                  # [30, 35); [40, 45) is busy
    "stray_syncs_per_study": 1.0,          # at 50 and 85, over 2 studies
    "stray_syncs_per_study.unfused": 1.0,
    "keytree_device_ms_per_krep.stream": 15e-3,
    "stray_syncs_per_study.stream": 1.0,
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_on_a_known_timeline(name):
    run = core.Run("cell", {}, {}, 0, "cpu", studies=2, reps=1000)
    reader = core.layer_metric(name)
    assert reader.read(_timeline(), run) == pytest.approx(READINGS[name])
    assert reader.read(_timeline(with_ranges=False), run) is None


def test_the_benchmark_lists_the_readers():
    entries = {m["name"]: m for m in core.benchmark()["per_layer"]}
    for name in READINGS:
        assert entries[name]["source"] == "device_trace"
        assert core.layer_metric_path(name).is_file()


def _stream_timeline(with_ranges: bool = True):
    """A 100-µs window of a streamed study: a chunk's generation (its
    draws in a keytree range) launching 20 µs of kernels, its statistics
    10 µs, the intervals 5 µs, and 10 µs launched outside them."""
    events = [
        _ev(tracing.WINDOW, "user_annotation", 0, 100),
        _ev("stream_dgp", "user_annotation", 2, 10),
        _ev("keytree", "user_annotation", 3, 5),
        _ev("cudaLaunchKernel", "cuda_runtime", 4, 1, correlation=1),
        _ev("subg_stats", "user_annotation", 14, 6),
        _ev("cudaLaunchKernel", "cuda_runtime", 15, 1, correlation=2),
        _ev("subg_interval", "user_annotation", 22, 4),
        _ev("cudaLaunchKernel", "cuda_runtime", 23, 1, correlation=3),
        _ev("cudaLaunchKernel", "cuda_runtime", 50, 1, correlation=4),
        _ev("threefry_bits", "kernel", 10, 20, correlation=1),
        _ev("reduce", "kernel", 30, 10, correlation=2),
        _ev("mixquant", "kernel", 40, 5, correlation=3),
        _ev("copy", "kernel", 60, 10, correlation=4),
    ]
    if not with_ranges:
        events = [e for e in events if e["name"] not in STREAM]
    return tracing.Trace(events)


#: the stream's readers on that timeline, 1,000 replications at n =
#: 1,000 in chunks of 256: 4 words a row of 4 chunks, 41 ALU operations a
#: word at 64 a clock on 132 SMs at 1.98 GHz, over the 30 µs launched in
#: stream_dgp and subg_stats
STREAM_READINGS = {
    "stream_dgp_ms_per_krep": 20e-3,
    "subg_stats_ms_per_krep": 10e-3,
    "stream_pass_roofline": 100.0 * (4 * 4 * 256 * 1000 * 41
                                     / (64 * 132 * 1.98e9)) / 30e-6,
}


@pytest.mark.parametrize("name", sorted(STREAM_READINGS))
def test_stream_reader_on_a_known_timeline(name):
    run = core.Run("cell", {}, {"n": 1000, "stream_n_chunk": 256}, 0, "cpu",
                   studies=1, reps=1000)
    reader = core.layer_metric(name)
    got = reader.read(_stream_timeline(), run)
    assert got == pytest.approx(STREAM_READINGS[name])
    assert reader.read(_stream_timeline(with_ranges=False), run) is None


def test_the_benchmark_lists_the_stream_readers():
    entries = {m["name"]: m for m in core.benchmark()["per_layer"]}
    rate = {m["name"]: m for m in core.benchmark()["end_to_end"]}
    assert "subg.stream_n1e6" in rate["reps_per_s"]["workloads"]
    for name in list(STREAM_READINGS) + [
            "device_idle_pct.stream", "launches_per_krep.stream",
            "keytree_device_ms_per_krep.stream",
            "stray_syncs_per_study.stream"]:
        m = entries[name]
        assert m["source"] == "device_trace" and m["workloads"] == [
            "subg.stream_n1e6"], name
        assert m["moves"] == "reps_per_s"
        assert core.layer_metric_path(name).is_file()


def _prof(events):
    return types.SimpleNamespace(events=lambda: events)


def _fe(name, dev, a, b, ann=False):
    return types.SimpleNamespace(
        name=name, device_type=dev, is_user_annotation=ann,
        time_range=types.SimpleNamespace(start=a, end=b))


def test_device_idle_share_from_one_profile():
    """Idle over the one profiled run's window, the profiler's device
    annotations of the host's ranges left out by kind whatever their
    names."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [_fe(profiling.RUN_RANGE, cpu, 10, 110),
              _fe("keytree", cuda, 10, 110, ann=True),
              _fe("any_new_range", cuda, 0, 200, ann=True),
              _fe("k1", cuda, 0, 30),     # 20 µs inside the window
              _fe("k2", cuda, 20, 40),    # overlaps k1: 10 µs more
              _fe("Memcpy DtoH", cuda, 100, 120)]  # 10 µs inside
    prof = _prof(events)
    assert [a[0] for a in profiling.device_activities(prof)] == [
        "k1", "k2", "Memcpy DtoH"]
    assert profiling.device_idle_share(prof) == pytest.approx(0.6)
    assert profiling.device_idle_share(_prof(events[:3])) is None
