"""Device milliseconds per 1,000 replications of the streamed data's
generation: the device time of everything launched while the program's
``stream_dgp`` range was open (each n-chunk's bounded-factor draws and
the arithmetic on them, key-tree included), in the traced window. None
when the program opens no such range."""

RANGE = "stream_dgp"


def read(trace, run):
    if not run.reps or not trace.range_intervals({RANGE}):
        return None
    return trace.device_us_launched_in([RANGE]) * 1e-3 / (run.reps / 1e3)
