"""Serving observability: counters, latency percentiles, fill ratios.

Counterpart of ``dpcorr/serve/stats.py``, with its metric names and its
snapshot's key set. One :class:`ServeStats` instance is shared by the
coalescer, kernel cache and server; ``snapshot()`` is the single JSON
shape exposed by the ``/stats`` endpoint and the tests.

The counters live in a :class:`dpcorr_torch.obs.metrics.Registry` (one
per ServeStats, so concurrent in-process servers never
cross-contaminate): the same metric objects back both the ``/stats``
JSON snapshot and the Prometheus text exposition at ``GET /metrics``.
The attribute reads (``stats.kernel_compiles`` etc.) are properties
over them.

Latency is recorded twice, deliberately: a sliding reservoir feeding
the nearest-rank percentiles ``snapshot()["latency_s"]`` always
reported (recency-biased), and a fixed-bucket histogram exposing
Prometheus ``_bucket``/``_sum``/``_count`` series a scraper can
aggregate across servers (cumulative since boot).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Iterable, Sequence

from dpcorr_torch.obs.cost import ExemplarStore
from dpcorr_torch.obs.metrics import LATENCY_BUCKETS, Registry
from dpcorr_torch.utils.compile import RECOMPILE_CAUSES

#: Label vocabularies the JSON snapshot enumerates (the Prometheus side
#: discovers labels dynamically; the fixed JSON shape needs the list).
SHED_REASONS = ("expired", "queue_evict", "cancelled", "closed",
                "admission")
REFUSED_REASONS = ("budget", "overload", "breaker", "brownout",
                   "not_owner")
ABANDONED_STAGES = ("cancelled", "detached")


def percentiles(values: Iterable[float],
                qs: Sequence[float] = (0.5, 0.99)) -> dict[str, float]:
    """Nearest-rank percentiles, keyed ``"p50"``-style. Empty input →
    empty dict (callers render absent, not fake-zero, metrics)."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return {}
    out = {}
    for q in qs:
        rank = max(0, min(len(vals) - 1, int(round(q * len(vals))) - 1))
        out[f"p{int(q * 100)}"] = vals[rank]
    return out


class ServeStats:
    """Thread-safe serving counters, backed by an obs metrics registry.

    Counters are monotone totals (Prometheus-counter style) except
    ``queue_depth`` / ``flush_size_max`` / ``kernel_cache_size``
    (gauges) and the latency reservoir (last ``reservoir`` completions —
    bounded memory, recency-biased percentiles, same trade-off as
    production servers' sliding-window summaries).
    """

    def __init__(self, reservoir: int = 8192,
                 registry: Registry | None = None,
                 slo_s: float = 0.25, slo_window_s: float = 60.0,
                 instance: str | None = None):
        self.registry = registry if registry is not None else Registry()
        r = self.registry
        # instance identity: the name rides every snapshot and an
        # info-style gauge, so a collector can
        # cross-check its target map against what the process claims
        self.instance = instance
        self._instance_info = r.gauge(
            "dpcorr_serve_instance_info",
            "Constant 1; the label carries this process's fleet "
            "instance name", labelnames=("instance",))
        if instance is not None:
            self._instance_info.set(1, instance=str(instance))
        self._requests = r.counter(
            "dpcorr_serve_requests_total",
            "Requests admitted (charged and enqueued)")
        self._refused = r.counter(
            "dpcorr_serve_requests_refused_total",
            "Requests refused at admission", labelnames=("reason",))
        self._failed = r.counter(
            "dpcorr_serve_requests_failed_total",
            "Requests that failed during execution")
        self._flushes = r.counter(
            "dpcorr_serve_batches_flushed_total",
            "Coalescer flush launches")
        self._completed = r.counter(
            "dpcorr_serve_requests_completed_total",
            "Requests served, by execution mode", labelnames=("mode",))
        self._flush_max = r.gauge(
            "dpcorr_serve_flush_size_max",
            "Largest flush (live requests in one launch) seen so far")
        self._compiles = r.counter(
            "dpcorr_serve_kernel_compiles_total",
            "Batch-kernel cache misses (fresh compilations)")
        self._hits = r.counter(
            "dpcorr_serve_kernel_cache_hits_total",
            "Batch-kernel cache hits")
        self._dedup = r.counter(
            "dpcorr_serve_kernel_compile_dedup_total",
            "Concurrent cache misses that waited on another thread's "
            "inflight compile instead of compiling again (single-flight"
            " — serve.kernels)")
        self._cache_size = r.gauge(
            "dpcorr_serve_kernel_cache_size",
            "Live compiled kernels held by the LRU-bounded cache")
        self._depth = r.gauge(
            "dpcorr_serve_queue_depth", "Requests pending in the coalescer")
        self._idem = r.counter(
            "dpcorr_serve_idempotent_hits_total",
            "Requests answered from the idempotency cache instead of "
            "re-executing — 'completed' replays a cached response, "
            "'inflight' attaches to a duplicate already running",
            labelnames=("stage",))
        self._latency = r.histogram(
            "dpcorr_serve_latency_seconds",
            "Admission-to-completion request latency",
            buckets=LATENCY_BUCKETS)
        # -- overload resilience --------------------------------
        self._shed = r.counter(
            "dpcorr_serve_shed_total",
            "Requests shed by the overload layer before any kernel "
            "launched (admitted ones get their charge refunded): "
            "'expired' deadline passed in queue, "
            "'queue_evict' displaced by a higher-(priority, urgency) "
            "arrival, 'cancelled' client abandoned the future, "
            "'closed' drained as refusals at shutdown, 'admission' "
            "refused by the brownout priority floor",
            labelnames=("reason",))
        self._abandoned = r.counter(
            "dpcorr_serve_abandoned_total",
            "estimate() timeouts: 'cancelled' the pending request was "
            "withdrawn before launch, 'detached' it was already "
            "running and completes unobserved", labelnames=("stage",))
        self._breaker_state = r.gauge(
            "dpcorr_serve_breaker_state",
            "Per-bucket circuit breaker state "
            "(0=closed, 1=open, 2=half-open)",
            labelnames=("family", "bucket"))
        self._breaker_trans = r.counter(
            "dpcorr_serve_breaker_transitions_total",
            "Circuit breaker state transitions, by destination state",
            labelnames=("to",))
        self._brownout = r.gauge(
            "dpcorr_serve_brownout_active",
            "1 while the server is browned out (unbatched fallback + "
            "low-priority rejection under sustained pressure)")
        self._flush_ewma_g = r.gauge(
            "dpcorr_serve_flush_ewma_seconds",
            "Exponentially weighted moving average of flush duration "
            "— the load-shedding pressure signal")
        # -- cost attribution + SLO burn rate -------------------
        self._kernel_hist = r.histogram(
            "dpcorr_serve_kernel_seconds",
            "Per-launch kernel wall time (dispatch through fetch "
            "barrier) — the denominator the per-request kernel-time "
            "attributions must sum back to (obs.cost; serve_load "
            "--cost gates on exactly this)",
            buckets=LATENCY_BUCKETS)
        self._slo_burn = r.gauge(
            "dpcorr_serve_slo_burn_rate",
            "Fraction of requests in the rolling window whose latency "
            "exceeded the SLO threshold — the burn-rate signal "
            "`dpcorr obs top` renders")
        self._slo_window_n = r.gauge(
            "dpcorr_serve_slo_window_requests",
            "Requests currently inside the SLO rolling window")
        self.slo_s = float(slo_s)
        self.slo_window_s = float(slo_window_s)
        #: latency-histogram trace exemplars: slow bucket → trace ID
        self.exemplars = ExemplarStore(buckets=LATENCY_BUCKETS)
        self._lock = threading.Lock()
        self._latencies: deque[float] = deque(maxlen=reservoir)  # guarded by: _lock
        self._slo_events: deque[tuple] = deque()  # guarded by: _lock
        self._flush_ewma_val: float | None = None  # guarded by: _lock
        self._ewma_alpha = 0.2

    # -- legacy attribute reads (tests, report layer) --------------------
    @property
    def requests_total(self) -> int:
        return int(self._requests.value())

    @property
    def requests_refused_budget(self) -> int:
        return int(self._refused.value(reason="budget"))

    @property
    def requests_refused_overload(self) -> int:
        return int(self._refused.value(reason="overload"))

    @property
    def requests_failed(self) -> int:
        return int(self._failed.value())

    @property
    def batches_flushed(self) -> int:
        return int(self._flushes.value())

    @property
    def batched_requests(self) -> int:
        return int(self._completed.value(mode="batched"))

    @property
    def unbatched_requests(self) -> int:
        return int(self._completed.value(mode="unbatched"))

    @property
    def flush_size_max(self) -> int:
        return int(self._flush_max.value())

    @property
    def kernel_compiles(self) -> int:
        return int(self._compiles.value())

    @property
    def kernel_hits(self) -> int:
        return int(self._hits.value())

    @property
    def kernel_compile_dedup(self) -> int:
        return int(self._dedup.value())

    @property
    def kernel_cache_size(self) -> int:
        return int(self._cache_size.value())

    @property
    def queue_depth(self) -> int:
        return int(self._depth.value())

    @property
    def idempotent_hits_completed(self) -> int:
        return int(self._idem.value(stage="completed"))

    @property
    def idempotent_hits_inflight(self) -> int:
        return int(self._idem.value(stage="inflight"))

    # -- recording -------------------------------------------------------
    def admitted(self) -> None:
        self._requests.inc()

    def refused_budget(self) -> None:
        self._refused.inc(reason="budget")

    def refused_overload(self) -> None:
        self._refused.inc(reason="overload")

    def refused(self, reason: str) -> None:
        """Generic admission refusal by reason — the overload layer's
        reasons ('breaker', 'brownout', 'expired') land next to the
        legacy 'budget'/'overload' series."""
        self._refused.inc(reason=reason)

    def shed(self, reason: str) -> None:
        """An ADMITTED (charged) request dropped before launch, charge
        refunded — see the counter help for the reason vocabulary."""
        self._shed.inc(reason=reason)

    def abandoned(self, stage: str) -> None:
        """An ``estimate()`` timeout outcome: ``"cancelled"`` (pending
        request withdrawn, ε refunded by the coalescer) or
        ``"detached"`` (already running; completes unobserved)."""
        self._abandoned.inc(stage=stage)

    def breaker_state(self, family: str, bucket: str, code: int) -> None:
        self._breaker_state.set(code, family=family, bucket=bucket)

    def breaker_transition(self, to: str) -> None:
        self._breaker_trans.inc(to=to)

    def brownout(self, active: bool) -> None:
        self._brownout.set(1.0 if active else 0.0)

    def observe_flush(self, seconds: float) -> None:
        """Feed one flush duration into the EWMA pressure signal."""
        s = float(seconds)
        with self._lock:
            prev = self._flush_ewma_val
            self._flush_ewma_val = s if prev is None else (
                self._ewma_alpha * s + (1.0 - self._ewma_alpha) * prev)
            self._flush_ewma_g.set(self._flush_ewma_val)

    def flush_ewma(self) -> float:
        with self._lock:
            return self._flush_ewma_val or 0.0

    def failed(self, k: int = 1) -> None:
        self._failed.inc(k)

    def flushed(self, size: int, batched: bool) -> None:
        self._flushes.inc()
        self._completed.inc(size, mode="batched" if batched
                            else "unbatched")
        # max-tracking needs read-modify-write; the stats lock arbitrates
        with self._lock:
            if size > self._flush_max.value():
                self._flush_max.set(size)

    def kernel(self, hit: bool) -> None:
        if hit:
            self._hits.inc()
        else:
            self._compiles.inc()

    def kernel_dedup(self) -> None:
        """A miss that piggybacked on an inflight compile (single-flight
        follower): neither a hit nor a compile — its own counter, so
        the dedup the race fix buys is observable."""
        self._dedup.inc()

    def set_queue_depth(self, depth: int) -> None:
        self._depth.set(depth)

    def idempotent_hit(self, stage: str) -> None:
        """A duplicate submission short-circuited — ``stage`` is
        ``"completed"`` (cached response replayed) or ``"inflight"``
        (attached to the original's future)."""
        self._idem.inc(stage=stage)

    def set_kernel_cache_size(self, n: int) -> None:
        """Gauge: live compiled kernels held by the LRU-bounded cache
        (serve.kernels) — lets an operator see eviction pressure."""
        self._cache_size.set(n)

    def observe_kernel(self, seconds: float) -> None:
        """One launch's dispatch-to-fetch wall time (batched launches
        observe once; their riders' cost records carry equal shares —
        the two views sum to the same total by construction)."""
        self._kernel_hist.observe(float(seconds))

    def observe_latency(self, seconds: float,
                        trace_id: str | None = None) -> None:
        s = float(seconds)
        self._latency.observe(s)
        self.exemplars.record(s, trace_id)
        now = time.monotonic()
        with self._lock:
            self._latencies.append(s)
            self._slo_events.append((now, s > self.slo_s))
            self._slo_update_locked(now)

    def _slo_update_locked(self, now: float) -> None:
        """Trim the rolling window and refresh the burn-rate gauges."""
        cutoff = now - self.slo_window_s
        ev = self._slo_events
        while ev and ev[0][0] < cutoff:
            ev.popleft()
        n = len(ev)
        over = sum(1 for _, o in ev if o)
        self._slo_window_n.set(n)
        self._slo_burn.set(over / n if n else 0.0)

    def slo_snapshot(self) -> dict:
        """The ``/stats`` SLO view (also refreshes the gauges, so a
        scrape after traffic stops sees the window drain)."""
        now = time.monotonic()
        with self._lock:
            self._slo_update_locked(now)
            n = len(self._slo_events)
            over = sum(1 for _, o in self._slo_events if o)
        return {"slo_s": self.slo_s, "window_s": self.slo_window_s,
                "window_requests": n,
                "burn_rate": over / n if n else 0.0}

    # -- reading ---------------------------------------------------------
    def batch_fill_ratio(self) -> float:
        """Mean live requests per flushed launch — the number the load
        test gates on (> 1 means real coalescing happened)."""
        flushes = self.batches_flushed
        if not flushes:
            return 0.0
        return (self.batched_requests + self.unbatched_requests) / flushes

    def render_prometheus(self) -> str:
        """The ``GET /metrics`` body: every instrument this server
        publishes (incl. the ledger's, which registers into the same
        registry via the server wiring), followed by the latency
        exemplars as comment lines — exposition 0.0.4 has no exemplar
        syntax, and comments keep every scraper (incl. our own
        parse_exposition) compatible while still shipping the
        bucket→trace links in the same scrape."""
        body = self.registry.render()
        ex = self.exemplars.snapshot()
        if not ex:
            return body
        lines = [f'# EXEMPLAR dpcorr_serve_latency_seconds_bucket'
                 f'{{le="{le}"}} trace_id={x["trace_id"]} '
                 f'value={x["value"]}'
                 for le, x in sorted(ex.items())]
        return body + "\n".join(lines) + "\n"

    def _recompile_snapshot(self) -> dict:
        # the KernelCache's CompileObserver registers this counter on our
        # registry; before any cache exists it simply isn't there yet
        rc = self.registry.get("dpcorr_compile_recompile_total")
        if rc is None:
            return {}
        return {c: int(rc.value(cause=c)) for c in RECOMPILE_CAUSES}

    def snapshot(self, ledger_snapshot: dict | None = None,
                 cost_aggregate: dict | None = None,
                 budget_dir: dict | None = None) -> dict:
        done = self.batched_requests + self.unbatched_requests
        flushes = self.batches_flushed
        with self._lock:
            lat = percentiles(self._latencies)
        snap = {
            "requests_total": self.requests_total,
            "requests_refused_budget": self.requests_refused_budget,
            "requests_refused_overload": self.requests_refused_overload,
            "requests_failed": self.requests_failed,
            "batches_flushed": flushes,
            "batched_requests": self.batched_requests,
            "unbatched_requests": self.unbatched_requests,
            "batch_fill_ratio": done / flushes if flushes else 0.0,
            "flush_size_max": self.flush_size_max,
            "kernel_compiles": self.kernel_compiles,
            "kernel_hits": self.kernel_hits,
            "kernel_compile_dedup": self.kernel_compile_dedup,
            "kernel_cache_size": self.kernel_cache_size,
            "queue_depth": self.queue_depth,
            "latency_s": lat,
            "idempotent_hits_completed": self.idempotent_hits_completed,
            "idempotent_hits_inflight": self.idempotent_hits_inflight,
            # the bucketed view behind the /metrics histogram series
            "latency_histogram": self._latency.snapshot(),
            # overload resilience
            "refused": {r: int(self._refused.value(reason=r))
                        for r in REFUSED_REASONS},
            "shed": {r: int(self._shed.value(reason=r))
                     for r in SHED_REASONS},
            "abandoned": {s: int(self._abandoned.value(stage=s))
                          for s in ABANDONED_STAGES},
            "brownout_active": bool(self._brownout.value()),
            "flush_ewma_s": self.flush_ewma(),
            # cost attribution + SLO burn
            "kernel_histogram": self._kernel_hist.snapshot(),
            "slo": self.slo_snapshot(),
            "exemplars": self.exemplars.snapshot(),
            # fleet identity: None for a standalone server
            "instance": self.instance,
            # why kernel-cache entries were built
            "recompiles": self._recompile_snapshot(),
        }
        if cost_aggregate is not None:
            snap["costs"] = cost_aggregate
        if ledger_snapshot is not None:
            snap["ledger"] = ledger_snapshot
        if budget_dir is not None:
            # per-user budget directory block: shard count, residency,
            # eviction/rehydration counters, refusals by level —
            # CompositeLedger.directory_snapshot()'s shape
            snap["budget_dir"] = budget_dir
        return snap
