"""Tracing and throughput.

Counterpart of ``dpcorr/utils/profiling.py``, plus the port's ranges:

- :func:`stage`: a ``torch.profiler`` range around one stage of the
  work while the profiler records (so it lands in the same trace as the
  kernels, on their clock), the stage's host seconds inside
  :func:`stage_host_seconds`, else nothing; :func:`outermost_stage` and
  the decorator :func:`outermost` open their range only when none of the
  same name is open on the thread (the key-tree's ``keytree``, HRS's
  ``hrs_standardize``), and :data:`HOST_READ`
  names the range around a device-to-host read whose value the host
  uses. Every layer imports them from here (this module imports torch
  and nothing of the package at import time);
- :func:`device_idle_share`: the card's idle share of one range of a
  profile, from that profile alone;
- :func:`trace`: a context manager around ``torch.profiler`` recording
  the host's and, where there is a card, the card's activities, written
  on exit as a Chrome trace (``trace.json``) under ``log_dir`` for
  Perfetto or ``chrome://tracing``; the capture window is mirrored as a
  ``profiler.trace`` span in the obs span log;
- :class:`Throughput`: a wall-clock replications/s counter whose
  :meth:`~Throughput.utilization` reads the roofline
  (``utils.roofline``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
import time

import torch
from torch.profiler import record_function

#: the Chrome trace's file name under ``trace``'s ``log_dir``
TRACE_FILE = "trace.json"
#: the range around a device-to-host read whose value the host then uses
HOST_READ = "host_read"
#: the range :func:`device_idle_share` takes a profiled run's window from
RUN_RANGE = "profiling.run"

_stage_seconds: dict | None = None  # inside stage_host_seconds() only
_open = threading.local()  # ranges open on the thread (outermost())


@contextlib.contextmanager
def stage_host_seconds():
    """Inside this block, the host seconds spent in each :func:`stage`
    are summed by name into the dict it yields (the stages are
    asynchronous, so this is their enqueue time)."""
    global _stage_seconds
    outer, _stage_seconds = _stage_seconds, {}
    try:
        yield _stage_seconds
    finally:
        _stage_seconds = outer


@contextlib.contextmanager
def _host_timed(name: str, into: dict):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        into[name] = into.get(name, 0.0) + time.perf_counter() - t0


def stage(name: str):
    """A ``torch.profiler`` range named ``name`` around one stage of the
    work while the profiler records, or the stage's host time inside
    :func:`stage_host_seconds`; else nothing (a range costs microseconds
    of host time, and the fused path is host-bound)."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    if _stage_seconds is not None:
        return _host_timed(name, _stage_seconds)
    return contextlib.nullcontext()


def _recording() -> bool:
    return torch.autograd._profiler_enabled() or _stage_seconds is not None


@contextlib.contextmanager
def _opened(name: str):
    setattr(_open, name, True)
    try:
        with stage(name):
            yield
    finally:
        setattr(_open, name, False)


def outermost_stage(name: str):
    """:func:`stage` ``name``, unless one opened by this function or by
    :func:`outermost` under the same name is already open on the thread:
    nested calls (a draw that derives keys, a batch drawn key by key, a
    study that standardises) open one range, not one each. While neither
    the profiler nor :func:`stage_host_seconds` records, it touches no
    thread-local state."""
    if not _recording() or getattr(_open, name, False):
        return contextlib.nullcontext()
    return _opened(name)


def outermost(name: str):
    """Decorator: the function runs inside :func:`outermost_stage`
    ``name``; while nothing records, a call costs one check more."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _recording() or getattr(_open, name, False):
                return fn(*args, **kwargs)
            with _opened(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def device_activities(prof) -> list:
    """``(name, start µs, end µs)`` of the card's kernels, copies and
    fills in a ``torch.profiler`` profile. The device-side annotations
    the profiler makes of the host's ranges are left out by their kind,
    whatever their names."""
    from torch.autograd import DeviceType

    return [(ev.name, ev.time_range.start, ev.time_range.end)
            for ev in prof.events()
            if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)]


def device_idle_share(prof, name: str = RUN_RANGE) -> float | None:
    """The card's idle share of the host range ``name`` in one profile
    (the first such range): 1 − the union of its kernel, copy and fill
    intervals inside the range over the range's length, all from the one
    profiled run. None where the profile holds no such range or no
    device activity."""
    from torch.autograd import DeviceType

    win = next((ev.time_range for ev in prof.events()
                if ev.device_type == DeviceType.CPU and ev.name == name),
               None)
    acts = device_activities(prof)
    if win is None or not acts or win.end <= win.start:
        return None
    busy, end = 0.0, win.start
    for _, a, b in sorted(acts, key=lambda x: x[1]):
        a, b = max(a, end), min(b, win.end)
        if b > a:
            busy += b - a
            end = b
    return 1.0 - busy / (win.end - win.start)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace("dir") as prof: run_kernels()``.

    Yields the ``torch.profiler.profile`` (its ``key_averages()`` sums
    the recorded activities by name); on exit the Chrome trace is written
    to ``log_dir/trace.json``. CUDA activities are recorded when a card
    is present."""
    from torch.profiler import ProfilerActivity, profile

    from dpcorr_torch.obs import trace as obs_trace

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    sp = obs_trace.tracer().start_span("profiler.trace", log_dir=log_dir)
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        sp.end()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@dataclasses.dataclass
class Throughput:
    """reps/sec counter.

    >>> tp = Throughput()
    >>> with tp.measure():
    ...     out = pipe.run(n_blocks)   # must end in a host read
    >>> tp.add(n_reps)
    >>> tp.reps_per_sec_chip
    """

    n_devices: int = 1
    reps: int = 0
    seconds: float = 0.0

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.seconds += time.perf_counter() - t0

    def add(self, n_reps: int) -> None:
        self.reps += int(n_reps)

    @property
    def reps_per_sec(self) -> float:
        return self.reps / self.seconds if self.seconds > 0 else float("nan")

    @property
    def reps_per_sec_chip(self) -> float:
        return self.reps_per_sec / max(self.n_devices, 1)

    def utilization(self, flops_per_rep: float, bytes_per_rep: float,
                    device_kind: str | None = None) -> dict:
        """%-of-peak view of the measured throughput: a per-rep work
        model (``roofline.analytic_rep_model``) with reps/s/device
        against the peaks of ``device_kind`` (default: the card's,
        ``utils.device.device_kind``; raises where there is no card or no
        figures for it)."""
        from dpcorr_torch.utils.roofline import peaks_for, summarize

        if device_kind is None:
            from dpcorr_torch.utils.device import device_kind as kind_of

            device_kind = kind_of(None)
        return summarize(self.reps_per_sec_chip, flops_per_rep,
                         bytes_per_rep, peaks_for(device_kind))
