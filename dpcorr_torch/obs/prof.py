"""Low-overhead block-boundary profiler for the replication pipeline.

Counterpart of ``dpcorr/obs/prof.py``, with its series, artifact format
and cadence rule. ``sim.RepBlockPipeline`` reads the host once per
``run()``; a profiler therefore cannot sync every block. It syncs at a
bounded *cadence*: with ``max_syncs=64`` and a 10,000-block run it waits
for the accumulators' device every ~156 blocks, giving per-segment
device timings.

The unprofiled path pays nothing: ``RepBlockPipeline`` touches the
profiler only under ``if profiler is not None``, and a run with no
profiler makes the same single fetch it always did.

A profiler sync waits for the device the accumulators live on
(``torch.cuda.synchronize``; CPU tensors are ready when computed). It is
counted in ``dpcorr_prof_syncs_total``, never in the transfer
``fetches`` counter, so ``fetches`` keeps meaning "results the caller
asked for".

Importing this module imports no torch, so the metric names and the
artifact reader work from the torch-free CLI.
"""

from __future__ import annotations

import contextlib
import datetime as _dt
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from dpcorr_torch.obs import metrics as metrics_mod

ENV_VAR = "DPCORR_PROF"
DEFAULT_MAX_SYNCS = 64

# Per-segment device timings: a segment is cadence-many blocks, so
# spans run from sub-ms (tiny tests) to seconds (big cells).
PROF_BUCKETS = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _utcnow() -> str:
    return _dt.datetime.now(_dt.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


def _sync(acc) -> None:
    """Wait for the device(s) the accumulator tensors live on."""
    import torch

    for dev in sorted({t.device for t in acc if t.device.type == "cuda"},
                      key=str):
        torch.cuda.synchronize(dev)


class BlockProfiler:
    """Bounded-sync profiler folded with transfer counters and spans.

    One instance may observe many runs; per-run state lives in the dict
    ``run_start`` returns, so concurrent pipelines can share a profiler.
    """

    def __init__(
        self,
        *,
        cadence: Optional[int] = None,
        max_syncs: int = DEFAULT_MAX_SYNCS,
        registry=None,
        artifact_path: Optional[str] = None,
        tracer=None,
    ) -> None:
        self.cadence = cadence
        self.max_syncs = max(1, int(max_syncs))
        self.artifact_path = artifact_path
        self._tracer = tracer
        self._lock = threading.Lock()
        self._runs: List[Dict[str, Any]] = []
        self._phases: List[Dict[str, Any]] = []
        reg = registry or metrics_mod.default_registry()
        self.runs_total = reg.counter(
            "dpcorr_prof_runs_total", "Profiled pipeline runs."
        )
        self.syncs_total = reg.counter(
            "dpcorr_prof_syncs_total",
            "Host syncs the profiler itself performed (cadence-bounded; "
            "never counted as transfer fetches).",
        )
        self.block_seconds = reg.histogram(
            "dpcorr_prof_block_seconds",
            "Per-block device seconds inferred from cadence segments.",
            buckets=PROF_BUCKETS,
        )
        self.last_rps = reg.gauge(
            "dpcorr_prof_last_reps_per_sec",
            "Throughput of the most recent profiled run.",
        )
        self.phase_seconds = reg.counter(
            "dpcorr_prof_phase_seconds_total",
            "Wall seconds spent per instrumented phase.",
            labelnames=("phase",),
        )

    # -- run lifecycle (called by RepBlockPipeline under `is not None`) --

    def run_start(
        self,
        *,
        family: str = "custom",
        block_reps: int = 0,
        n_blocks: int = 0,
        start_block: int = 0,
        counters=None,
    ) -> Dict[str, Any]:
        cadence = self.cadence
        if cadence is None:
            cadence = max(1, int(n_blocks) // self.max_syncs)
        now = time.perf_counter()
        return {
            "family": family,
            "block_reps": int(block_reps),
            "n_blocks": int(n_blocks),
            "start_block": int(start_block),
            "cadence": int(cadence),
            "t0": now,
            "t_last": now,
            "i_last": -1,
            "sync_count": 0,
            "samples": [],
            "counters": counters,
            "transfer_before": counters.snapshot() if counters is not None else None,
        }

    def block_boundary(self, state: Dict[str, Any], i: int, acc) -> None:
        """Maybe sync at block ``i`` (``acc``: the accumulator tensors);
        record a segment sample if we did."""
        if (i + 1) % state["cadence"] != 0:
            return
        _sync(acc)
        now = time.perf_counter()
        blocks = i - state["i_last"]
        seconds = now - state["t_last"]
        state["t_last"] = now
        state["i_last"] = i
        state["sync_count"] += 1
        self.syncs_total.inc()
        state["samples"].append(
            {
                "block": int(i),
                "blocks": int(blocks),
                "seconds": seconds,
                "reps_per_sec": (
                    blocks * state["block_reps"] / seconds if seconds > 0 else 0.0
                ),
            }
        )
        if blocks > 0 and seconds > 0:
            self.block_seconds.observe(seconds / blocks)

    def run_end(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Close out a run: fold transfer deltas, emit span + artifact."""
        seconds = time.perf_counter() - state["t0"]
        reps = state["n_blocks"] * state["block_reps"]
        rps = reps / seconds if seconds > 0 else 0.0
        rec: Dict[str, Any] = {
            "family": state["family"],
            "start_block": state["start_block"],
            "n_blocks": state["n_blocks"],
            "block_reps": state["block_reps"],
            "cadence": state["cadence"],
            "seconds": seconds,
            "reps_per_sec": rps,
            "sync_count": state["sync_count"],
            "samples": state["samples"],
        }
        counters = state.get("counters")
        before = state.get("transfer_before")
        if counters is not None and before is not None:
            from dpcorr_torch.obs import transfer as transfer_mod

            rec["transfer"] = transfer_mod.diff(counters.snapshot(), before)
        self.runs_total.inc()
        self.last_rps.set(rps)
        tr = self._tracer if self._tracer is not None else _trace_mod().tracer()
        sp = tr.start_span(
            "prof.run",
            family=state["family"],
            n_blocks=state["n_blocks"],
            block_reps=state["block_reps"],
            sync_count=state["sync_count"],
            reps_per_sec=round(rps, 3),
        )
        sp.end()
        with self._lock:
            self._runs.append(rec)
        if self.artifact_path:
            self.write_artifact(self.artifact_path)
        return rec

    # -- phase timing (grid.py scan/dispatch/fetch) --

    def note_phase(self, name: str, seconds: float, **attrs) -> None:
        """Record an already-timed phase (the grid times its phases
        inline so the unprofiled path needs no context-manager frames)."""
        self.phase_seconds.inc(seconds, phase=name)
        rec = {"name": name, "seconds": float(seconds)}
        rec.update(attrs)
        with self._lock:
            self._phases.append(rec)

    @contextlib.contextmanager
    def phase(self, name: str, **attrs):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.note_phase(name, time.perf_counter() - t0, **attrs)

    # -- artifact --

    def as_artifact(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "kind": "dpcorr_profile",
                "runs": [dict(r) for r in self._runs],
                "phases": [dict(p) for p in self._phases],
                "captured_utc": _utcnow(),
            }

    def write_artifact(self, path: str) -> str:
        payload = self.as_artifact()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return path


def _trace_mod():
    from dpcorr_torch.obs import trace as trace_mod

    return trace_mod


# ---------------------------------------------------------------------------
# Process-wide activation (opt-in; nothing reads the env on the hot path)

_active: Optional[BlockProfiler] = None
_env_checked = False
_lock = threading.Lock()


def activate(profiler: Optional[BlockProfiler]) -> None:
    """Install (or clear, with None) the process profiler."""
    global _active, _env_checked
    with _lock:
        _active = profiler
        _env_checked = True


def active() -> Optional[BlockProfiler]:
    """The process profiler, initialized once from ``DPCORR_PROF``.

    Unset/0/off/false → None (the default, zero-cost path).  "1"/"true"/
    "on" → an artifact-less profiler.  Any other value is treated as the
    profile artifact path.
    """
    global _active, _env_checked
    with _lock:
        if not _env_checked:
            _env_checked = True
            raw = os.environ.get(ENV_VAR, "").strip()
            if raw and raw.lower() not in ("0", "off", "false", "none"):
                if raw.lower() in ("1", "true", "on"):
                    _active = BlockProfiler()
                else:
                    _active = BlockProfiler(artifact_path=raw)
        return _active


def phase(name: str, **attrs):
    """Module-level phase timer: nullcontext when no profiler is active."""
    prof = active()
    if prof is None:
        return contextlib.nullcontext()
    return prof.phase(name, **attrs)


def note_phase(name: str, seconds: float, **attrs) -> None:
    """Module-level pre-timed phase record: no-op when inactive."""
    prof = active()
    if prof is not None:
        prof.note_phase(name, seconds, **attrs)


def read_profile(path: str) -> Dict[str, Any]:
    """Load a profile artifact; raises ValueError on bad shape."""
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if not isinstance(data, dict) or data.get("kind") != "dpcorr_profile":
        raise ValueError(f"{path}: not a dpcorr_profile artifact")
    return data
