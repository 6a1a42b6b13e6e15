"""K1's share of its roofline: the least time the card needs for one
launch of the cell's shape (the frozen work count in
``portbench/roofline.py``: NI, in-kernel Philox, the configuration's n and
eps, ``chunk_size`` replications) over K1's mean kernel time in the
trace, found by its kernel name. Against the published peaks of an H100
SXM at 700 W; the bounding pipe is int32."""

from portbench.roofline import k1_bound

KERNEL = "fused_ni_kernel"


def read(trace, run):
    times = [b - a for a, b, name, *_ in trace.kernels() if KERNEL in name]
    if not times:
        return None
    least_ms, _ = k1_bound(int(run.config["n"]),
                           [float(e) for e in run.config["eps"]],
                           int(run.cell["chunk_size"]))
    return 100.0 * least_ms * 1e3 / (sum(times) / len(times))
