"""The benchmark's engine: find a cell's files by name, set it up, run its
window of whole studies, check what the window produced, read the trace.

A cell is ``cells/<workload>.json``: its configuration (a name under
``configs/``), its driver (a module under ``drivers/``), the traffic's
parameters and the limits of its correctness numbers. A driver module
provides::

    setup(run) -> state            # inputs, program objects, no timing
    study(state, index) -> dict    # one whole study, ending in a host read:
                                   # {"reps": replications it ran}
    collect(state) -> answers      # after the window: the program's outputs
    numbers(answers, run, control=False) -> {name: value}

``numbers`` compares the program's outputs with the configuration's plain
reference (``reference/<config>.py``); with ``control`` the reference in
the precision below the configuration's takes the program's place. Each
per-layer metric is ``layer_metrics/<name>.py`` with ``read(trace, run)``
returning a number, or None when the trace holds nothing for it.

A metric split by cells, ``<metric>.<part>`` (so that cells of different
noise get bounds of their own), is computed as ``<metric>`` is: an
end-to-end metric by its first part's rule, a per-layer one by the
reader of ``<metric>`` where it has no file of its own.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that no run may load (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "dpcorr")


@dataclasses.dataclass
class Run:
    """What a run knows about itself: its cell, configuration, seed and
    device, and what its window did."""

    workload: str
    cell: dict
    config: dict
    seed: int
    device: str
    studies: int = 0
    reps: int = 0
    window_s: float = 0.0

    @property
    def reference(self):
        return importlib.import_module(
            f"portbench.reference.{self.cell['config']}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(workload: str) -> tuple[dict, dict]:
    """(cell, configuration) of a workload, found by name."""
    cell = load_json(HERE / "cells" / f"{workload}.json")
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    return cell, config


def driver(cell: dict):
    return importlib.import_module(f"portbench.drivers.{cell['driver']}")


def layer_metric_path(name: str) -> Path:
    """``layer_metrics/<name>.py``, or that of the metric it was split
    from."""
    path = HERE / "layer_metrics" / f"{name}.py"
    while not path.is_file() and "." in name:
        name = name.rsplit(".", 1)[0]
        path = HERE / "layer_metrics" / f"{name}.py"
    return path


def layer_metric(name: str):
    """The reader of a per-layer metric (names may hold dots, so the file
    is loaded by its path)."""
    path = layer_metric_path(name)
    spec = importlib.util.spec_from_file_location(
        f"portbench_layer_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one no run may load."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of
    its start (so interpreter start-up and imports count)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def run_window(drv, state, run: Run, seconds: float, clock=time.perf_counter):
    """Whole studies from index 0 until ``seconds`` have passed; the study
    running then is finished and counts. Fills the run's counts and the
    window's length, from its start to the end of its last study."""
    t0 = clock()
    while True:
        got = drv.study(state, run.studies)
        run.studies += 1
        run.reps += int(got["reps"])
        t = clock()
        if t - t0 >= seconds:
            break
    run.window_s = t - t0
    return run


def end_to_end(run: Run, setup_s: float, names) -> dict:
    """The cell's end-to-end metrics ``names``, from its window: the set-up
    time and the replication rate (``reps_per_s`` or a split of it)."""
    out = {}
    for name in names:
        if name == "setup_s":
            out[name] = {"value": setup_s, "unit": "s"}
        elif name.split(".")[0] == "reps_per_s":
            out[name] = {"value": run.reps / run.window_s, "unit": "reps/s"}
    return out


def cell_metrics(workload: str, group: str) -> list[tuple[str, str]]:
    """(name, unit) of the ``end_to_end`` or ``per_layer`` metrics that
    ``BENCHMARK.json`` gives this cell."""
    return [(m["name"], m["unit"]) for m in benchmark()[group]
            if workload in m.get("workloads", [workload])]


def per_layer(trace, run: Run, names) -> dict:
    out = {}
    for name, unit in names:
        value = layer_metric(name).read(trace, run)
        if value is not None:
            out[name] = {"value": value, "unit": unit}
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number against its limit (a number passes at or under it; a
    NaN never passes); every limit needs its number."""
    check, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        check[name] = {"value": value, "limit": limit}
        ok = ok and value == value and value <= limit
    return ok, check


def execute(workload: str, seed: int, seconds: float, trace: bool = False,
            device: str = "cuda", chips: int = 1, config: dict | None = None,
            cell: dict | None = None, control: bool = False) -> dict:
    """One run of a cell after the look for the card: set-up, the window
    (traced or not), the check against the reference. Returns the result
    object, with ``check`` last; ``config`` and ``cell`` replace the
    files' (the tests shrink a cell with them). With ``control`` the
    control's check (the reference in the precision below the
    configuration's, in the program's place) is kept in ``_control``."""
    import gc

    import torch

    from portbench import tracing

    cell_f, config_f = cell_files(workload)
    run = Run(workload, cell or cell_f, config or config_f, int(seed),
              device)
    on_card = device != "cpu"
    drv = driver(run.cell)
    state = drv.setup(run)
    if on_card:
        torch.cuda.synchronize()
    setup_s = process_age_s()
    holder = None
    if trace:
        with tracing.profiled() as holder:
            run_window(drv, state, run,
                       min(seconds, float(run.cell["trace_seconds"])))
    else:
        run_window(drv, state, run, seconds)
    peak = 0
    if on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(0)
    answers = drv.collect(state)
    del state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    limits = run.cell["limits"]
    ok, check = judge(drv.numbers(answers, run), limits)
    result = {"correct": ok, "attempted": run.studies, "failed": 0}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(chips), "memory_peak_bytes": int(peak)}
    if trace:
        t = holder.trace
        result["metrics"] = per_layer(t, run,
                                      cell_metrics(workload, "per_layer"))
        dev["busy_s"] = t.busy_us * 1e-6
        dev["window_s"] = t.window_us * 1e-6
        result["breakdown"] = {
            "device_ops": tracing.top(t.device_us_by_name()),
            "idle_gaps": tracing.top(t.idle_by_host())}
    else:
        result["metrics"] = end_to_end(
            run, setup_s, [n for n, _ in cell_metrics(workload, "end_to_end")])
    result["device"] = dev
    result["check"] = check
    result["_run"] = {"studies": run.studies, "reps": run.reps,
                      "window_s": run.window_s, "setup_s": setup_s}
    if control:
        c_ok, c_check = judge(drv.numbers(answers, run, control=True),
                              limits)
        result["_control"] = {"correct": c_ok, "check": c_check}
    return result
