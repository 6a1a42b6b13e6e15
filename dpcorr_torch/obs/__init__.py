"""Telemetry for the port: the span tracer (:mod:`dpcorr_torch.obs.trace`),
counterpart of ``dpcorr/obs/trace.py``. The grid's ``grid.run``,
``grid.dispatch``, ``grid.fetch`` and ``grid.point`` spans and the HRS
ε-sweep's ``hrs.eps_sweep``, ``hrs.dispatch`` and ``hrs.fetch`` spans
are written through it."""
