"""Device kernels per 1,000 replications, counted in the trace (so the
kernels a CUDA graph replays count too)."""


def read(trace, run):
    if not run.reps:
        return None
    return len(trace.kernels()) / (run.reps / 1e3)
