"""Device milliseconds of the key-tree per 1,000 replications, from
inside: the device time of everything launched while the program's own
``keytree`` range was open (each outermost derivation or draw of
``utils/rng.py``, wherever it is called), in the traced window. None
when the program opens no such range."""

from portbench.ranges import KEYTREE


def read(trace, run):
    if not run.reps or not trace.range_intervals({KEYTREE}):
        return None
    return trace.device_us_launched_in([KEYTREE]) * 1e-3 / (run.reps / 1e3)
