"""Tracing and throughput.

Counterpart of ``dpcorr/utils/profiling.py``:

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
import os
import time

#: the Chrome trace's file name under ``trace``'s ``log_dir``
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a trace: ``with trace("dir") as prof: run_kernels()``.

    Yields the ``torch.profiler.profile`` (its ``key_averages()`` sums
    the recorded activities by name); on exit the Chrome trace is written
    to ``log_dir/trace.json``. CUDA activities are recorded when a card
    is present."""
    import torch
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
