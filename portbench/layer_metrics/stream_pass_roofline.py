"""The streamed pass's share of its roofline, in percent: the least time
the card needs for the key-tree words drawn inside the program's
``stream_dgp`` and ``subg_stats`` ranges (the frozen count in
``portbench/stream_roofline.py``: four words a chunk row, the integer
ALU's bound of a threefry word, for the window's replications at the
configuration's n and n_chunk) over the device time launched inside
those ranges. Against the published peaks of an H100 SXM at 700 W. None
when the program opens neither range."""

from portbench.stream_roofline import least_seconds, words_per_rep

RANGES = ("stream_dgp", "subg_stats")


def read(trace, run):
    if not run.reps or not trace.range_intervals(set(RANGES)):
        return None
    busy_us = trace.device_us_launched_in(RANGES)
    if busy_us <= 0:
        return None
    words = words_per_rep(run.config["n"], run.config["stream_n_chunk"])
    return 100.0 * least_seconds(words * run.reps) * 1e6 / busy_us
