"""What the program's own ranges mark in a traced window, for the
per-layer readers that read them (``layer_metrics/keytree_*``,
``prep_idle_pct``, ``stray_syncs_per_study``).

The program opens ``record_function`` ranges where the work is done:
``keytree`` around each outermost derivation or draw of the key-tree,
``host_read`` around each device-to-host read whose value the host uses,
``pipeline_init``, ``hrs_wave`` and ``hrs_standardize`` around a
study's set-up. A program without them gives None from every reader
here, never 0.
"""

from __future__ import annotations

KEYTREE = "keytree"
HOST_READ = "host_read"
#: a study's set-up: the pipeline's shards and buffers, the HRS wave's
#: complete cases, the DP standardisation
PREP = ("pipeline_init", "hrs_wave", "hrs_standardize")
#: host calls that block until the card has finished work: the runtime's
#: and the driver's synchronisations and the blocking copy
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cuStreamSynchronize",
                   "cuCtxSynchronize", "cudaMemcpy"})
#: what ``torch.cuda.synchronize()`` calls, as the window's last act
CLOSING_SYNC = "cudaDeviceSynchronize"


def merged(intervals) -> list:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap_us(xs, ys) -> float:
    """Length of the intersection of two sorted, disjoint interval
    lists."""
    tot, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            tot += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return tot


def minus(xs, ys) -> list:
    """``xs`` with every part that lies in ``ys`` taken out (both sorted
    and disjoint)."""
    out = []
    for a, b in xs:
        for c, d in ys:
            if d <= a or c >= b:
                continue
            if c > a:
                out.append((a, c))
            a = max(a, d)
            if a >= b:
                break
        if b > a:
            out.append((a, b))
    return out


def idle_pct_in(trace, names, leave_out=()) -> float | None:
    """Percent of the window in which the card is idle while the host is
    inside one of the ranges ``names`` (and in none of ``leave_out``),
    over each idle gap's whole length; None when no such range is in the
    trace."""
    inside = merged(trace.range_intervals(set(names)))
    if not inside or trace.window_us <= 0:
        return None
    if leave_out:
        inside = minus(inside, merged(trace.range_intervals(set(leave_out))))
    return 100.0 * overlap_us(trace.gaps(), inside) / trace.window_us


def stray_syncs(trace) -> int | None:
    """Host-blocking calls (:data:`SYNCS`) that start in the window
    outside every ``host_read`` range, less the window's closing
    synchronisation; a driver call made inside a runtime call counts
    once. None when the trace holds no ``host_read`` range."""
    reads = merged(trace.range_intervals({HOST_READ}))
    if not reads:
        return None
    calls = sorted((a, b, name) for a, b, name, cat in trace.host
                   if cat in ("cuda_runtime", "cuda_driver")
                   and name in SYNCS and trace.t0 <= a <= trace.t1)
    syncs, end = [], None
    for a, b, name in calls:
        if end is not None and a < end:
            continue  # inside the call counted before it
        syncs.append((a, name))
        end = b
    if syncs and syncs[-1][1] == CLOSING_SYNC:
        syncs.pop()
    return sum(1 for a, _ in syncs
               if not any(c <= a <= d for c, d in reads))
