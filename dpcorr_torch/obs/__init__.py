"""Telemetry for the port, counterparts of ``dpcorr/obs/``: the span
tracer (:mod:`~dpcorr_torch.obs.trace`; the grid's and the HRS ε-sweep's
spans), metrics, cost records, the audit trail, the flight recorder, the
budget replay and the scrape endpoint, and the fleet telemetry plane —
exposition merge, spool unions and the fleet ε replay
(:mod:`~dpcorr_torch.obs.fleet`) with multi-window burn-rate SLOs
(:mod:`~dpcorr_torch.obs.slo`)."""
