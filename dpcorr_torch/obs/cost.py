"""Per-request cost attribution (counterpart of ``dpcorr/obs/cost.py``,
with its record format): where a request's time and ε went.

Dapper-style tracing (obs.trace) answers *when* things happened;
Canopy-style attribution (Kaldor et al., 2017) answers *what one
request cost*. A :class:`CostRecord` rides the serving path next to the
request's root span and accumulates, per request:

- **queue wait** — admission to flush-claim (the coalescer holding it);
- **compile wait** — time the launch spent blocked on a fresh kernel
  compilation (zero on warm-cache requests; serve.kernels reports it);
- **kernel time** — the launch's dispatch-to-fetch interval, divided
  evenly across the riders of one batched launch, so the records of a
  batch sum to the launch's cost instead of multiply-counting it;
- **retries** — client-side attempts beyond the first (stamped by the
  retrying client, serve.client — the server only ever sees attempts);
- **shed / refusal events** — every overload outcome the request hit;
- **ε charged / refunded per party** — the ledger deltas, so a refused
  request provably nets zero (``eps_net``) and a served one nets its
  quoted price.

The record is returned in response metadata (``EstimateResponse.cost``
/ the HTTP body's ``cost`` field), aggregated in ``/stats``, kept in a
bounded :class:`CostRegistry` the flight recorder dumps, and linked to
the latency histogram through :class:`ExemplarStore` — per-bucket trace
exemplars, so an operator can go from a slow histogram bucket straight
to a concrete trace ID and its cost breakdown.

Import-light: the JAX package's ``obs`` CLI reconstructs cost records
from flight-recorder dumps without touching the serving stack.
"""

from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from typing import Mapping, Sequence

from dpcorr_torch.obs.metrics import LATENCY_BUCKETS

_local_ids = itertools.count()


def split_exact(total, n: int) -> list:
    """Divide a batched launch's ``total`` (seconds or bytes) across its
    ``n`` riders so the parts sum back to exactly the total (the
    federation's per-cell cost records). Integer totals split
    largest-remainder (the first ``total % n`` riders carry one extra
    unit); float totals give every rider the even share and put the
    rounding residual on the last one."""
    if n <= 0:
        raise ValueError(f"cannot split across {n} riders")
    if isinstance(total, int):
        base, extra = divmod(total, n)
        return [base + (1 if i < extra else 0) for i in range(n)]
    share = float(total) / n
    parts = [share] * n
    parts[-1] = float(total) - share * (n - 1)
    return parts


class CostRecord:
    """One request's accumulating cost. Mutated from the admission
    (client) thread and the flush thread, so every update takes the
    record's lock; ``to_dict`` snapshots under the same lock."""

    __slots__ = ("id", "trace_id", "queue_wait_s", "compile_wait_s",
                 "kernel_s", "retries", "events", "eps_charged",
                 "eps_refunded", "_lock")

    def __init__(self, trace_id: str | None = None):
        # untraced servers still attribute cost: fall back to a
        # process-local id so the registry stays keyable
        self.trace_id = trace_id
        self.id = trace_id if trace_id is not None \
            else f"local-{next(_local_ids)}"
        self.queue_wait_s = 0.0  # guarded by: _lock
        self.compile_wait_s = 0.0  # guarded by: _lock
        self.kernel_s = 0.0  # guarded by: _lock
        self.retries = 0  # guarded by: _lock
        self.events: list[str] = []  # guarded by: _lock
        self.eps_charged: dict[str, float] = {}  # guarded by: _lock
        self.eps_refunded: dict[str, float] = {}  # guarded by: _lock
        self._lock = threading.Lock()

    # -- accumulation ----------------------------------------------------
    def charge(self, charges: Mapping[str, float]) -> None:
        with self._lock:
            for p, e in charges.items():
                self.eps_charged[str(p)] = \
                    self.eps_charged.get(str(p), 0.0) + float(e)

    def refund(self, charges: Mapping[str, float],
               reason: str | None = None) -> None:
        with self._lock:
            for p, e in charges.items():
                self.eps_refunded[str(p)] = \
                    self.eps_refunded.get(str(p), 0.0) + float(e)
            if reason is not None:
                self.events.append(f"refund:{reason}")

    def event(self, name: str) -> None:
        """A shed / refusal / degradation the request hit, in order."""
        with self._lock:
            self.events.append(str(name))

    def set_queue_wait(self, seconds: float) -> None:
        with self._lock:
            self.queue_wait_s = float(seconds)

    def add_kernel(self, seconds: float) -> None:
        with self._lock:
            self.kernel_s += float(seconds)

    def add_compile_wait(self, seconds: float) -> None:
        with self._lock:
            self.compile_wait_s += float(seconds)

    def add_retries(self, n: int) -> None:
        with self._lock:
            self.retries += int(n)

    # -- reading ---------------------------------------------------------
    def eps_net(self) -> dict[str, float]:
        """Charged minus refunded per party (clamped at zero, the
        ledger's own refund arithmetic) — zero for every request that
        never launched a kernel."""
        with self._lock:
            parties = set(self.eps_charged) | set(self.eps_refunded)
            return {p: max(0.0, self.eps_charged.get(p, 0.0)
                           - self.eps_refunded.get(p, 0.0))
                    for p in sorted(parties)}

    def to_dict(self) -> dict:
        """The response-metadata / dump form (strict-JSON friendly)."""
        with self._lock:
            net = {p: max(0.0, self.eps_charged.get(p, 0.0)
                          - self.eps_refunded.get(p, 0.0))
                   for p in sorted(set(self.eps_charged)
                                   | set(self.eps_refunded))}
            return {
                "trace_id": self.trace_id,
                "queue_wait_s": round(self.queue_wait_s, 6),
                "compile_wait_s": round(self.compile_wait_s, 6),
                "kernel_s": round(self.kernel_s, 9),
                "retries": self.retries,
                "events": list(self.events),
                "eps_charged": dict(self.eps_charged),
                "eps_refunded": dict(self.eps_refunded),
                "eps_net": net,
            }


class CostRegistry:
    """Bounded LRU map of recent cost records, keyed by record id
    (the trace ID when tracing is on). The server keeps one so refused
    requests — which never produce a response object — still leave an
    inspectable cost trail, and the flight recorder folds the whole
    registry into every dump."""

    def __init__(self, capacity: int = 2048):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._records: OrderedDict[str, CostRecord] = \
            OrderedDict()  # guarded by: _lock

    def new(self, trace_id: str | None = None) -> CostRecord:
        rec = CostRecord(trace_id)
        with self._lock:
            self._records[rec.id] = rec
            self._records.move_to_end(rec.id)
            while len(self._records) > self.capacity:
                self._records.popitem(last=False)
        return rec

    def get(self, rec_id: str) -> CostRecord | None:
        with self._lock:
            return self._records.get(rec_id)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def records(self) -> list[CostRecord]:
        with self._lock:
            return list(self._records.values())

    def to_dict(self) -> dict[str, dict]:
        """id → cost dict, insertion (≈ admission) order preserved."""
        return {r.id: r.to_dict() for r in self.records()}

    def aggregate(self) -> dict:
        """The ``/stats`` roll-up: totals across the retained window."""
        records = self.records()
        agg = {"records": len(records), "queue_wait_s": 0.0,
               "compile_wait_s": 0.0, "kernel_s": 0.0, "retries": 0,
               "eps_charged": 0.0, "eps_refunded": 0.0}
        for r in records:
            d = r.to_dict()
            agg["queue_wait_s"] += d["queue_wait_s"]
            agg["compile_wait_s"] += d["compile_wait_s"]
            agg["kernel_s"] += d["kernel_s"]
            agg["retries"] += d["retries"]
            agg["eps_charged"] += sum(d["eps_charged"].values())
            agg["eps_refunded"] += sum(d["eps_refunded"].values())
        for k in ("queue_wait_s", "compile_wait_s", "kernel_s",
                  "eps_charged", "eps_refunded"):
            agg[k] = round(agg[k], 9)
        return agg


class ExemplarStore:
    """Latency-histogram trace exemplars: the most recent (value,
    trace_id) landing in each bucket, using the same cumulative-``le``
    bucket bounds as the histogram it annotates. ``/stats`` exposes the
    snapshot and ``/metrics`` renders them as comment lines (exposition
    0.0.4 has no exemplar syntax; comments keep every scraper happy),
    so a slow bucket is one lookup away from a concrete trace."""

    def __init__(self, buckets: Sequence[float] = LATENCY_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._lock = threading.Lock()
        self._by_bucket: dict[str, dict] = {}  # guarded by: _lock

    def _le(self, value: float) -> str:
        for b in self.buckets:
            if value <= b:
                return repr(b)
        return "+Inf"

    def record(self, value: float, trace_id: str | None) -> None:
        if trace_id is None:
            return  # untraced requests have nothing to link to
        le = self._le(float(value))
        with self._lock:
            self._by_bucket[le] = {"trace_id": trace_id,
                                   "value": round(float(value), 6)}

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {le: dict(x) for le, x in self._by_bucket.items()}
