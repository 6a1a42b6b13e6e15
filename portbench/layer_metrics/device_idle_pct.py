"""The device's idle share of the traced window, in percent: one minus
the union of its kernel, copy and fill intervals over the window, both
from the one trace of the run."""


def read(trace, run):
    if trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us / trace.window_us)
