"""Telemetry for the port, counterparts of ``dpcorr/obs/``: the span
tracer (:mod:`~dpcorr_torch.obs.trace`; the grid's and the HRS ε-sweep's
spans), metrics, cost records, the audit trail, the flight recorder, the
budget replay and the scrape endpoint, and the fleet telemetry plane —
exposition merge, spool unions and the fleet ε replay
(:mod:`~dpcorr_torch.obs.fleet`) with multi-window burn-rate SLOs
(:mod:`~dpcorr_torch.obs.slo`).

The operator's tools over the running services, none of which computes
on a device or imports torch:

- :mod:`~dpcorr_torch.obs.console` — the live ops console behind
  ``obs top``: a terminal view over ``/metrics`` + ``/stats`` of a serve
  replica, a fleet, a federation's parties or a stream;
- :mod:`~dpcorr_torch.obs.provenance` — the federation ε-provenance DAG:
  per-party transcripts + audit trails + journals merged into artifacts
  → charges → rounds → cells, proving exactly-once charging and
  byte-identical reuse at the ``2·f·ε·(k−1)`` optimum; typed divergences
  name the offending party (``obs provenance`` exports JSON + DOT);
- :mod:`~dpcorr_torch.obs.sentinel` — the live invariant sentinel behind
  ``obs watch``: audit trails, stream WALs and journals, transcripts and
  budget directories tailed and re-proved within a poll of the write.
"""

from dpcorr_torch.obs.provenance import (  # noqa: F401
    DIVERGENCE_KINDS,
    Provenance,
    build_provenance,
    discover_federation,
)
