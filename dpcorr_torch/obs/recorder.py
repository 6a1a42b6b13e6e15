"""Flight recorder (counterpart of ``dpcorr/obs/recorder.py``, with its
dump format): bounded in-memory rings, dumped atomically on failure.

A breaker trip, brownout latch or chaos kill used to leave only coarse
counters behind; the question an operator actually asks — *what was the
server doing in the seconds before it went wrong* — needs the recent
spans, budget events, log lines and metric values in ONE artifact. The
recorder keeps exactly that, always on and bounded:

- four rings (``collections.deque(maxlen=...)`` under one lock): recent
  **spans** (fed by a tracer observer — obs.trace), **audit events**
  (fed by an AuditTrail observer — obs.audit), **log lines** (a
  ``logging.Handler`` attached to the ``dpcorr`` logger tree) and
  **metric samples** (explicit :meth:`sample` calls plus one final
  sample at dump time, over every watched registry);
- the server's :class:`~dpcorr.obs.cost.CostRegistry` is folded into
  every dump, so the artifact carries each recent request's CostRecord
  next to its spans;
- :meth:`dump` writes one strict-JSON document atomically — tmp file,
  flush, fsync, ``os.replace`` — the same crash-safe publish the ledger
  and the protocol journal use, so a dump racing a kill is either fully
  there or absent, never truncated.

Dump triggers (all call :func:`trigger` on the installed recorder):
chaos crash points (``chaos.on_crash`` — the hook fires *before*
``os._exit``), circuit-breaker trips and brownout enter/exit
(serve.overload callbacks), unhandled coalescer flush exceptions,
party-session failures, ``SIGUSR2`` (wired by ``dpcorr serve``) and the
JAX package's ``dpcorr obs dump`` CLI, which reads the port's dumps too;
:func:`reconstruct` rebuilds one request's span chain, cost record and
ε trail from the artifact alone.

Import-light on purpose: the coalescer, the chaos module and the CLI all
import this.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque

DUMP_VERSION = 1

#: every trigger reason the recorder stamps — append-only by
#: convention, like chaos.KNOWN_POINTS (dashboards key on these)
TRIGGER_REASONS = (
    "chaos",               # a chaos crash point fired (pre-kill hook)
    "breaker_open",        # a bucket's circuit breaker tripped
    "brownout_enter",
    "brownout_exit",
    "coalescer_unhandled",  # the flush loop caught an unexpected error
    "party_unhandled",     # a protocol session died on an exception
    "sigusr2",             # operator asked (kill -USR2)
    "cli",                 # dpcorr obs dump --live / tests
    "shutdown",            # orderly close with --flight-recorder armed
    "slo_page",            # a burn-rate page armed this instance (obs.slo)
    "federation_unhandled",       # a federation party died unexpectedly
    "federation_resume_refused",  # a pair link's resume handshake refused
    "federation_scan_violation",  # cross-pair scan / provenance divergence
    "stream_release_failed",      # a charged window's release raised
    "sentinel_violation",         # the live invariant sentinel caught
                                  # an ε/durability break (obs.sentinel)
)


class FlightRecorder:
    """Bounded always-on capture + atomic crash dump.

    ``path`` is where :meth:`dump` publishes (each dump atomically
    replaces it — the newest incident wins, and a half-written file is
    impossible by construction). ``capacity`` bounds every ring
    independently, so a span storm cannot evict the audit trail.
    """

    def __init__(self, path: str, capacity: int = 2048):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.path = path
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._spans: deque[dict] = deque(maxlen=capacity)  # guarded by: _lock
        self._audit: deque[dict] = deque(maxlen=capacity)  # guarded by: _lock
        self._logs: deque[dict] = deque(maxlen=capacity)  # guarded by: _lock
        self._samples: deque[dict] = deque(maxlen=max(capacity // 8, 8))  # guarded by: _lock
        self._dumps = 0  # guarded by: _lock
        self._reasons: list[str] = []  # guarded by: _lock
        self._registries: list = []  # guarded by: _lock
        self._costs = None  # guarded by: _lock (CostRegistry | None)
        self._log_handler: logging.Handler | None = None

    # -- capture hooks ---------------------------------------------------
    def record_span(self, span: dict) -> None:
        """Tracer observer (obs.trace.Tracer.add_observer)."""
        with self._lock:
            self._spans.append(span)

    def record_audit(self, event: dict) -> None:
        """Audit observer (obs.audit.AuditTrail.add_observer)."""
        with self._lock:
            self._audit.append(event)

    def record_log(self, entry: dict) -> None:
        with self._lock:
            self._logs.append(entry)

    def watch_registry(self, registry) -> None:
        """Include ``registry`` (obs.metrics.Registry) in every metric
        sample and in the final snapshot a dump takes."""
        with self._lock:
            if registry not in self._registries:
                self._registries.append(registry)

    def watch_costs(self, costs) -> None:
        """Fold ``costs`` (obs.cost.CostRegistry) into every dump."""
        with self._lock:
            self._costs = costs

    def sample(self, label: str = "") -> None:
        """Append one timestamped metric sample (flat series → value
        over every watched registry) to the sample ring."""
        snap = self._metrics_now()
        with self._lock:
            self._samples.append({"ts": time.time(), "label": label,
                                  "values": snap})

    def _metrics_now(self) -> dict[str, float]:
        with self._lock:
            registries = list(self._registries)
        out: dict[str, float] = {}
        for reg in registries:
            for m in reg.metrics():
                for name, labels, value in m.samples():
                    out[f"{name}{labels}"] = value
        return out

    def logging_handler(self) -> logging.Handler:
        """A ``logging.Handler`` that feeds the log ring — attach it to
        the ``dpcorr`` logger tree (``attach_logging``)."""
        if self._log_handler is None:
            self._log_handler = _RingHandler(self)
        return self._log_handler

    def attach_logging(self, logger_name: str = "dpcorr") -> None:
        logging.getLogger(logger_name).addHandler(self.logging_handler())

    def detach_logging(self, logger_name: str = "dpcorr") -> None:
        if self._log_handler is not None:
            logging.getLogger(logger_name).removeHandler(self._log_handler)

    # -- dumping ---------------------------------------------------------
    def snapshot(self, reason: str, **detail) -> dict:
        """The dump document (also what tests assert on without I/O)."""
        metrics = self._metrics_now()
        with self._lock:
            costs = self._costs
            doc = {
                "version": DUMP_VERSION,
                "reason": reason,
                "ts": time.time(),
                "detail": {k: v for k, v in detail.items()},
                "spans": list(self._spans),
                "audit": list(self._audit),
                "logs": list(self._logs),
                "metric_samples": list(self._samples),
                "metrics": metrics,
            }
        doc["costs"] = costs.to_dict() if costs is not None else {}
        return doc

    def dump(self, reason: str, **detail) -> str:
        """Publish the current rings atomically to ``self.path`` and
        return the path. Crash-safe by the ledger's own pattern: write
        to a pid-suffixed tmp file, flush, fsync, ``os.replace`` — a
        reader never observes a partial document."""
        doc = self.snapshot(reason, **detail)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, default=_json_fallback)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        with self._lock:
            self._dumps += 1
            self._reasons.append(reason)
        return self.path

    @property
    def dumps(self) -> int:
        with self._lock:
            return self._dumps

    @property
    def reasons(self) -> list[str]:
        """Every dump reason so far, oldest first (the file on disk
        only keeps the newest incident — gates check history here)."""
        with self._lock:
            return list(self._reasons)

    @property
    def last_reason(self) -> str | None:
        with self._lock:
            return self._reasons[-1] if self._reasons else None


class _RingHandler(logging.Handler):
    """Feeds formatted log records into the recorder's log ring."""

    def __init__(self, recorder: FlightRecorder):
        super().__init__()
        self._recorder = recorder

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._recorder.record_log({
                "ts": record.created,
                "level": record.levelname,
                "logger": record.name,
                "message": record.getMessage(),
            })
        except Exception:  # a dying log path must never take down the app
            pass


def _json_fallback(obj):
    """Dump rings may hold numpy scalars (span attrs); render them as
    plain floats/strings rather than failing the one artifact a crash
    leaves behind."""
    try:
        return float(obj)
    except (TypeError, ValueError):
        return repr(obj)


# ------------------------------------------------- process-wide install ----
_install_lock = threading.Lock()
_active: FlightRecorder | None = None


def install(recorder: FlightRecorder | None) -> None:
    """Make ``recorder`` the process recorder :func:`trigger` dumps to
    (``None`` disarms). The serving/protocol layers call ``trigger``
    through this indirection so they stay importable — and zero-cost —
    when no recorder is armed."""
    global _active
    with _install_lock:
        _active = recorder


def active() -> FlightRecorder | None:
    return _active


def trigger(reason: str, **detail) -> str | None:
    """Dump the installed recorder (no-op without one). Never raises:
    the trigger sites are failure paths — a broken dump must not mask
    the original incident."""
    rec = _active
    if rec is None:
        return None
    try:
        return rec.dump(reason, **detail)
    except Exception:
        logging.getLogger("dpcorr.obs").exception(
            "flight-recorder dump failed (reason=%s)", reason)
        return None


def http_trigger(handler) -> tuple[int, dict]:
    """The ``POST /obs/trigger`` route every front end carries (serve,
    the stream, the mini endpoint): ``(status, JSON payload)`` for the
    request ``handler`` (a ``BaseHTTPRequestHandler``) is serving. The
    reason is validated against :data:`TRIGGER_REASONS` so a typo'd page
    cannot mint an unknown reason, and ``detail`` must be an object (400
    otherwise); a valid trigger dumps the installed recorder here, next
    to its rings, and answers 200 ``{"dumped": path, "armed": bool}``."""
    try:
        length = int(handler.headers.get("Content-Length", "0"))
        body = json.loads(handler.rfile.read(length))
        reason = body.get("reason")
        detail = body.get("detail") or {}
        if reason not in TRIGGER_REASONS:
            raise ValueError(f"unknown trigger reason {reason!r}")
        if not isinstance(detail, dict):
            raise ValueError("detail must be an object")
    except (ValueError, AttributeError) as e:
        return 400, {"error": str(e)}
    path = trigger(reason, **{str(k): v for k, v in detail.items()})
    return 200, {"dumped": path, "armed": active() is not None}


# ------------------------------------------------------ reading dumps ----
def read_dump(path: str) -> dict:
    """Load a flight-recorder dump strictly: one JSON document with the
    required keys, version-checked — the CI artifact gate wants a
    truncated or hand-edited dump to fail loudly, not parse as empty."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: dump is not a JSON object")
    if doc.get("version") != DUMP_VERSION:
        raise ValueError(f"{path}: dump version {doc.get('version')!r}, "
                         f"expected {DUMP_VERSION}")
    for key in ("reason", "ts", "spans", "audit", "logs", "metrics",
                "costs"):
        if key not in doc:
            raise ValueError(f"{path}: dump missing key {key!r}")
    return doc


def reconstruct(dump: dict, trace_id: str) -> dict:
    """Rebuild one request's story from a dump: its span
    chain (parent-linked, admission order), its cost record, its audit
    events, and the ε net of those events (charges minus refunds,
    clamped — the ledger's arithmetic via obs.audit.replay). This is
    what ``dpcorr obs dump --trace-id`` prints and what the
    end-to-end gate asserts on."""
    from dpcorr_torch.obs.audit import replay

    spans = [sp for sp in dump.get("spans", ())
             if sp.get("trace_id") == trace_id]
    spans.sort(key=lambda sp: sp.get("ts", 0.0))
    audit = [ev for ev in dump.get("audit", ())
             if ev.get("trace_id") == trace_id]
    chain = _order_chain(spans)
    return {
        "trace_id": trace_id,
        "spans": chain,
        "cost": dump.get("costs", {}).get(trace_id),
        "audit": audit,
        "eps_net": replay(audit),
    }


def _order_chain(spans: list[dict]) -> list[dict]:
    """Root-first parent-before-child ordering of one trace's spans
    (stable on timestamp within a generation; orphans — parents evicted
    from the ring — surface after the rooted tree rather than being
    dropped)."""
    by_parent: dict = {}
    ids = {sp.get("span_id") for sp in spans}
    for sp in spans:
        parent = sp.get("parent_id")
        if parent not in ids:
            parent = None if parent is None else "__orphan__"
        by_parent.setdefault(parent, []).append(sp)
    out: list[dict] = []
    queue = list(by_parent.get(None, ()))
    while queue:
        sp = queue.pop(0)
        out.append(sp)
        queue.extend(by_parent.get(sp.get("span_id"), ()))
    out.extend(by_parent.get("__orphan__", ()))
    return out
