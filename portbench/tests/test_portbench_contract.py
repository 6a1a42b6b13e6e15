"""The benchmark's files keep to its contract, and the harness's pieces
do what they say, on the CPU."""

import ast
import json
import re
import shutil
import subprocess
import sys
import pytest

from portbench import core, roofline, tracing
from portbench.tests.small import small

ROOT = core.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = core.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _names(bench):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            yield e["name"]
    for w in bench["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in bench["configs"]:
        yield from c["reduced"]


def test_names_and_units_use_allowed_characters():
    for name in _names(BENCH):
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for path in (core.HERE / "cells").glob("*.json"):
        cell = json.loads(path.read_text())
        assert NAME.match(path.stem) and NAME.match(cell["config"])
        for name in cell["limits"]:
            assert NAME.match(name), name
    for path in (core.HERE / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        assert NAME.match(cfg["name"]) and cfg["name"] == path.stem
        for key in cfg["reduced"]:
            assert NAME.match(key) and key in cfg, key


def test_every_named_file_is_there():
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    names = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert (core.HERE / "reference" / f"{c['name']}.py").is_file()
    for w in BENCH["workloads"]:
        cell, config = core.cell_files(w["name"])
        assert cell["config"] == w["config"] and w["config"] in names
        assert (core.HERE / "drivers" / f"{cell['driver']}.py").is_file()
        assert w["chips"] == 1
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert core.layer_metric_path(m["name"]).is_file(), m["name"]
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)


def test_last_line_holds_the_contract_keys():
    config, cell = small("ni_n10k.unfused")
    out = core.execute("ni_n10k.unfused", 2**31 + 5, 0.2, device="cpu",
                       config=config, cell=cell)
    out.pop("_run")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert out["correct"] is True and out["attempted"] >= 1
    assert set(out["metrics"]) == {"setup_s", "reps_per_s.unfused"}
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(out)


def test_import_guard_catches_jax_and_dpcorr_but_not_the_port(monkeypatch):
    import types

    for name in ("jax", "jaxlib.xla", "flax", "dpcorr", "dpcorr.sim"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "dpcorr_torch_extra",
                        types.ModuleType("dpcorr_torch_extra"))
    found = core.forbidden_modules()
    assert {"jax", "jaxlib.xla", "flax", "dpcorr", "dpcorr.sim"} <= set(found)
    assert not any(m.split(".")[0].startswith("dpcorr_torch") for m in found)


def test_reference_imports_nothing_of_the_program():
    for path in (core.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("dpcorr_torch", "dpcorr", "jax"), \
                    f"{path.name} imports {mod}"


@pytest.mark.parametrize("chunk", [2**14, 2**18])
def test_frozen_roofline_matches_the_program_today(chunk):
    from dpcorr_torch.utils import roofline as live

    cfg = core.cell_files("ni_n10k.fused")[1]
    eps = cfg["eps"]
    assert roofline.fused_pipe_ops(cfg["n"], eps, False) == \
        live.fused_pipe_ops(cfg["n"], eps, False)
    want = live.least_time_ms(live.fused_pipe_ops(cfg["n"], eps, False),
                              chunk, chunk * 24)
    least, pipe = roofline.k1_bound(cfg["n"], eps, chunk)
    assert pipe == "int32" and least == max(want.values())


class _Fake:
    """A driver whose studies take the clock's steps."""

    def __init__(self, steps):
        self.steps, self.t = list(steps), 0.0

    def clock(self):
        return self.t

    def study(self, state, index):
        self.t += self.steps[index]
        return {"reps": 100}


@pytest.mark.parametrize("name", ["reps_per_s", "reps_per_s.unfused"])
def test_a_stall_inside_the_window_moves_the_metric(name):
    def metric(steps):
        fake = _Fake(steps)
        run = core.Run("x", {}, {}, 0, "cpu")
        core.run_window(fake, None, run, 1.0, clock=fake.clock)
        return run, core.end_to_end(run, 1.0, ["setup_s", name])

    run, steady = metric([0.25] * 8)
    assert run.studies == 4 and run.window_s == pytest.approx(1.0)
    run, stalled = metric([0.25, 0.75, 0.25, 0.25, 0.25])
    assert run.studies == 2  # the study that crosses the end counts
    assert stalled[name]["value"] < steady[name]["value"]
    assert stalled["setup_s"]["value"] == 1.0


@pytest.mark.parametrize("workload", ["ni_n10k.unfused", "hrs.bootstrap"])
def test_driver_and_reference_agree_on_the_cpu(workload):
    config, cell = small(workload)
    out = core.execute(workload, 3_000_000_017, 0.2, device="cpu",
                       config=config, cell=cell)
    assert out["correct"], out["check"]
    assert out["check"]["share_over_tau"]["value"] == 0.0


def test_a_cell_added_as_files_is_found_without_editing_code(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(core.HERE, copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "dpcorr_torch").symlink_to(ROOT / "dpcorr_torch")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(
        {"name": "ni_n10k.tiny", "config": "ni_n10k", "traffic": "tiny",
         "chips": 1, "why": "a cell added as data"})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = json.loads((core.HERE / "cells" /
                       "ni_n10k.unfused.json").read_text())
    cell.update(block_reps=32, chunk_size=16, sample_per_study=4)
    (copy / "portbench" / "cells" / "ni_n10k.tiny.json").write_text(
        json.dumps(cell))
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from portbench import core;"
            "r = core.execute('ni_n10k.tiny', 11, 0.1, device='cpu');"
            "print(r['correct'], r['_run']['reps'] % 32)")
    out = subprocess.run([sys.executable, "-c", code, str(copy)],
                         capture_output=True, text=True, timeout=600,
                         cwd=copy)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "0"]


def _ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def test_trace_reduction_on_a_known_timeline():
    events = [
        _ev(tracing.WINDOW, "user_annotation", 0, 100),
        _ev("rep_keys", "user_annotation", 5, 10),
        _ev("cudaLaunchKernel", "cuda_runtime", 6, 1, correlation=1),
        _ev("fused_ni", "user_annotation", 20, 10),
        _ev("cudaLaunchKernel", "cuda_runtime", 21, 1, correlation=2),
        _ev("aten::item", "cpu_op", 45, 45),
        _ev("k_keys", "kernel", 10, 20, correlation=1),
        _ev("fused_ni_kernel<>", "kernel", 25, 25, correlation=2),
        _ev("copy", "gpu_memcpy", 95, 10, correlation=3),
    ]
    t = tracing.Trace(events)
    assert t.window_us == 100
    assert t.busy_us == pytest.approx(40 + 5)  # [10, 50) and [95, 100)
    assert t.gaps() == [(0, 10), (50, 95)]
    assert t.device_us_launched_in(["rep_keys"]) == 20
    idle = t.idle_by_host()
    assert idle["host:outside any range"] == 10
    assert idle["-:aten::item"] == 45  # the host waited in a read
    assert len(t.kernels()) == 2
    top = tracing.top(t.device_us_by_name(), 2)
    assert top[0][0] == "fused_ni_kernel<>"
    assert top[0][1] == pytest.approx(25e-6)
