"""Host-blocking runtime and driver calls per study that fall outside
every ``host_read`` range: synchronisations (stream, device, event,
context) and blocking ``cudaMemcpy`` in the traced window, less the
window's own closing ``torch.cuda.synchronize()``, over the window's
studies. Each stalls the host where the program reads nothing. None
when the program opens no ``host_read`` range."""

from portbench.ranges import stray_syncs


def read(trace, run):
    count = stray_syncs(trace)
    if count is None or not run.studies:
        return None
    return count / run.studies
