"""Device milliseconds per 1,000 replications of the streamed
statistics: the device time of everything launched while the program's
``subg_stats`` range was open (each n-chunk's NI batch sums and INT
product sums, the INT sender's Laplace draw included), in the traced
window. None when the program opens no such range."""

RANGE = "subg_stats"


def read(trace, run):
    if not run.reps or not trace.range_intervals({RANGE}):
        return None
    return trace.device_us_launched_in([RANGE]) * 1e-3 / (run.reps / 1e3)
