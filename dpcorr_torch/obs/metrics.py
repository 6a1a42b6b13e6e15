"""Metrics registry with Prometheus text exposition (counterpart of
``dpcorr/obs/metrics.py``, with its metric names and exposition format).

The serving layer's ``ServeStats``, the kernel cache and the privacy
ledger previously each kept their own ad-hoc counters; this module is
the one spine they now share. Three instrument kinds, mirroring the
Prometheus data model the ``/metrics`` endpoint speaks:

- :class:`Counter` — monotone totals (admissions, flushes, compiles).
  Optionally labelled (``requests_refused_total{reason="budget"}``).
- :class:`Gauge`  — set-to-current values (queue depth, live kernels,
  per-party ε spend).
- :class:`Histogram` — bucketed observations with cumulative bucket
  counts plus ``_sum``/``_count`` (serving latency). Buckets are
  cumulative (each ``le`` bound counts everything at or below it),
  exactly the exposition scrapers expect.

A :class:`Registry` renders all of its instruments as Prometheus text
exposition (version 0.0.4 — the ``text/plain`` format every scraper
accepts). Each server constructs its own, so concurrent server
instances never cross-contaminate counts.

Thread-safety: every mutation and read takes the instrument's lock —
the coalescer flush thread, many client threads and a scraper all touch
these concurrently (pinned by tests/test_obs.py's concurrency smoke).
"""

from __future__ import annotations

import math
import threading
from typing import Iterable, Mapping, Sequence

#: Default latency buckets (seconds) — tuned to the serving SLO range:
#: sub-ms in-process calls up through multi-second cold compiles.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_NAME_OK = frozenset("abcdefghijklmnopqrstuvwxyz"
                     "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _check_name(name: str) -> str:
    if not name or name[0].isdigit() or not set(name) <= _NAME_OK:
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    """Prometheus sample formatting: integers render bare, +Inf/-Inf/NaN
    use the exposition spellings."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _labels_suffix(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in zip(names, values))
    return "{" + inner + "}"


class _Metric:
    """Shared label plumbing: each child is keyed by its label-value
    tuple; unlabelled instruments use the single ``()`` child."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = _check_name(name)
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple, float] = {}  # guarded by: _lock

    def _key(self, labels: Mapping[str, str] | None) -> tuple:
        labels = labels or {}
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}")
        return tuple(str(labels[k]) for k in self.labelnames)

    def samples(self) -> list[tuple[str, str, float]]:
        """(name, labels-suffix, value) triples for exposition."""
        with self._lock:
            return [(self.name, _labels_suffix(self.labelnames, k), v)
                    for k, v in sorted(self._children.items())]


class Counter(_Metric):
    """Monotone total. ``inc`` only goes up; negative deltas raise."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counter increment must be "
                             f">= 0, got {amount}")
        k = self._key(labels)
        with self._lock:
            self._children[k] = self._children.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        k = self._key(labels)
        with self._lock:
            return self._children.get(k, 0.0)


class Gauge(_Metric):
    """Set-to-current value; also supports inc/dec for level tracking."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._children[k] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._children[k] = self._children.get(k, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        k = self._key(labels)
        with self._lock:
            return self._children.get(k, 0.0)

    def remove(self, **labels) -> None:
        """Drop one labelled child (a party leaving the ledger)."""
        k = self._key(labels)
        with self._lock:
            self._children.pop(k, None)


class Histogram:
    """Bucketed observations, Prometheus-style: per-bucket *cumulative*
    counts keyed by upper bound ``le``, plus ``_sum`` and ``_count``.
    Unlabelled (the serving layer has exactly one latency stream per
    server; labelled histograms can be added when a consumer exists)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        self.name = _check_name(name)
        self.help = help
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs or any(b <= 0 for b in bs if not math.isinf(b)):
            raise ValueError(f"{name}: buckets must be positive, got {bs}")
        # the +Inf bucket is implicit: _count plays its role
        self.buckets = tuple(b for b in bs if not math.isinf(b))
        self._lock = threading.Lock()
        self._bucket_counts = [0] * len(self.buckets)  # guarded by: _lock
        self._sum = 0.0  # guarded by: _lock
        self._count = 0  # guarded by: _lock

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._bucket_counts[i] += 1

    def snapshot(self) -> dict:
        """{"buckets": {le: cumulative_count}, "sum": s, "count": n} —
        the JSON-friendly view ``/stats`` consumers can read without
        parsing exposition text."""
        with self._lock:
            return {
                "buckets": {repr(float(b)): c for b, c in
                            zip(self.buckets, self._bucket_counts)},
                "sum": self._sum,
                "count": self._count,
            }

    def samples(self) -> list[tuple[str, str, float]]:
        with self._lock:
            out = [(f"{self.name}_bucket", f'{{le="{_fmt_value(b)}"}}',
                    float(c))
                   for b, c in zip(self.buckets, self._bucket_counts)]
            out.append((f"{self.name}_bucket", '{le="+Inf"}',
                        float(self._count)))
            out.append((f"{self.name}_sum", "", self._sum))
            out.append((f"{self.name}_count", "", float(self._count)))
            return out


class Registry:
    """A named set of instruments with Prometheus text exposition.

    Re-registering a name returns the existing instrument when the kind
    matches (so modules can idempotently declare what they use) and
    raises on a kind clash — two subsystems silently sharing one name
    with different semantics is exactly the bug a registry exists to
    prevent.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}  # guarded by: _lock

    def _register(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(m).__name__}, requested {cls.__name__}")
                return m
            m = cls(name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames=labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames=labelnames)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def metrics(self) -> Iterable[object]:
        with self._lock:
            return list(self._metrics.values())

    def render(self) -> str:
        """Prometheus text exposition (version 0.0.4) of every
        registered instrument — the ``GET /metrics`` body."""
        lines = []
        for m in sorted(self.metrics(), key=lambda m: m.name):
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for name, labels, value in m.samples():
                lines.append(f"{name}{labels} {_fmt_value(value)}")
        return "\n".join(lines) + "\n"


#: Exposition content type (what /metrics should send).
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_default_registry: Registry | None = None
_default_lock = threading.Lock()


def default_registry() -> Registry:
    """The process-wide registry, which the transfer counters
    (``obs.transfer``) and a compile observer built without one
    (``utils.compile``) report into. Built on first use."""
    global _default_registry
    with _default_lock:
        if _default_registry is None:
            _default_registry = Registry()
        return _default_registry

def parse_exposition(text: str) -> dict[str, float]:
    """Parse exposition text back to ``{"name{labels}": value}`` — the
    scrape side of the single-source-of-truth check in
    the serving tests on the CPU and the card (not a general
    Prometheus parser; handles exactly what :meth:`Registry.render`
    emits)."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        series, _, raw = line.rpartition(" ")
        v = {"+Inf": math.inf, "-Inf": -math.inf,
             "NaN": math.nan}.get(raw)
        out[series] = float(raw) if v is None else v
    return out
