"""Device milliseconds of the key-tree per 1,000 replications: the
device time of everything launched inside the program's key-tree ranges
(``rep_keys``, ``kernel_seeds``, ``hrs_keys``) in the traced window."""

RANGES = ("rep_keys", "kernel_seeds", "hrs_keys")


def read(trace, run):
    if not run.reps or not trace.range_intervals(set(RANGES)):
        return None
    return trace.device_us_launched_in(RANGES) * 1e-3 / (run.reps / 1e3)
