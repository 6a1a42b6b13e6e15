"""The traced window: ``torch.profiler`` over whole studies, reduced to
what the per-layer readers and the breakdown need.

The window is one ``portbench.window`` range on the host; device
activities (kernels, copies, fills) are clipped to it. Everything comes
from the one trace of the one run: busy time is the union of the device
intervals, idle time the rest of the window, and each idle gap is
labelled by the host ranges open when it began (outermost stage, then
innermost operation).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def profiled():
    """Profile the block on the host and the card; yields a holder whose
    ``trace`` is the reduced :class:`Trace` once the block has ended. The
    raw trace goes to a file under the temporary directory and is deleted
    after it is read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = type("Holder", (), {"trace": None})()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield holder
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    holder.trace = Trace(events)


class Trace:
    """Device intervals, host ranges and launch correlations of one
    traced window (times in microseconds of the trace's clock)."""

    def __init__(self, events: list):
        spans = [e for e in events if e.get("ph") == "X"]
        win = [e for e in spans if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no portbench.window range")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        self.device = []  # (start, end, name, cat, correlation)
        self.host = []    # (start, end, name, cat)
        self.launch_ts = {}  # correlation -> host time of its launch call
        for e in spans:
            cat = e.get("cat")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                a, b = max(ts, self.t0), min(ts + dur, self.t1)
                if b > a:
                    self.device.append((a, b, e.get("name", ""), cat,
                                        (e.get("args") or {}).get(
                                            "correlation")))
            elif cat in HOST_CATS and e.get("name") != WINDOW:
                self.host.append((ts, ts + dur, e.get("name", ""), cat))
                if cat in ("cuda_runtime", "cuda_driver"):
                    corr = (e.get("args") or {}).get("correlation")
                    if corr is not None:
                        self.launch_ts[corr] = ts
        self.device.sort()
        self.host.sort(key=lambda h: (h[0], -h[1]))
        self.busy = self._union()

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy)

    def kernels(self) -> list:
        return [d for d in self.device if d[3] == "kernel"]

    def _union(self) -> list:
        out = []
        for a, b, *_ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def gaps(self) -> list:
        """(start, end) of each stretch of the window with no device
        activity."""
        out, t = [], self.t0
        for a, b in self.busy:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def device_us_by_name(self) -> dict:
        tot = defaultdict(float)
        for a, b, name, *_ in self.device:
            tot[name] += b - a
        return dict(tot)

    def range_intervals(self, names) -> list:
        """Sorted (start, end) host intervals of the named ranges."""
        return sorted((a, b) for a, b, name, cat in self.host
                      if cat == "user_annotation" and name in names)

    def device_us_launched_in(self, names) -> float:
        """Device microseconds of activities launched while one of the
        named host ranges was open."""
        merged = []
        for a, b in self.range_intervals(set(names)):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        starts = [a for a, _ in merged]
        tot = 0.0
        for a, b, _, _, corr in self.device:
            t = self.launch_ts.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= merged[i][1]:
                tot += b - a
        return tot

    def idle_by_host(self) -> dict:
        """Idle microseconds by what the host was doing when each gap
        began: ``<outermost range>:<innermost operation>``."""
        tot = defaultdict(float)
        host, j, stack = self.host, 0, []
        for a, b in self.gaps():
            while j < len(host) and host[j][0] <= a:
                stack.append(host[j])
                j += 1
            stack = [h for h in stack if h[1] > a]
            if not stack:
                label = "host:outside any range"
            else:
                ranges = [h for h in stack if h[3] == "user_annotation"]
                outer = ranges[0][2] if ranges else "-"
                label = f"{outer}:{stack[-1][2]}"
            tot[label] += b - a
        return dict(tot)


def top(d: dict, k: int = 10) -> list:
    """The ``k`` largest entries as [[name, seconds], ...] (microseconds
    in, seconds out)."""
    items = sorted(d.items(), key=lambda kv: -kv[1])[:k]
    return [[name, us * 1e-6] for name, us in items]
