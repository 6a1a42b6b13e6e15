"""Overload resilience: circuit breaker + brownout state machines.

Counterpart of ``dpcorr/serve/overload.py``. Besides the coalescer's
hard ``max_queue`` refusal, the admission path composes two stateful
controllers:

- :class:`CircuitBreaker` — per-:class:`~dpcorr_torch.serve.request.BucketKey`
  failure isolation. Consecutive kernel/compile failures in one bucket
  trip its breaker OPEN; while open, admissions for that bucket fail
  fast with :class:`CircuitOpenError` (HTTP 503 + ``Retry-After``)
  *before* any ε is charged — a poisoned kernel signature must not burn
  budget or queue slots on requests it cannot answer. After
  ``reset_after_s`` the breaker goes HALF-OPEN and admits exactly one
  probe; the probe's outcome closes the breaker (service restored,
  bit-identical results — nothing about the kernel path changed) or
  re-opens it for another cooldown.
- :class:`BrownoutController` — sustained-pressure degradation. When
  queue occupancy or the flush-latency EWMA stays over threshold for
  ``enter_after_s``, the server browns out: the coalescer drops to the
  unbatched fallback path (smaller, predictable launches) and admission
  rejects work below ``min_priority``. Hysteresis (``exit_after_s`` of
  sustained calm) prevents flapping at the threshold.

Both are clock-injectable (tests script ``clock=``), and
publish transitions into :class:`~dpcorr_torch.serve.stats.ServeStats` so
``/metrics`` carries a breaker state gauge and a brownout gauge.

Deadline errors live here too: :class:`DeadlineExpiredError` is what a
request's future resolves to when its deadline passed while queued —
the flush thread drops it *before* launch and refunds the charge, so
an expired request provably consumes zero ε (coalescer module
docstring).
"""

from __future__ import annotations

import threading
import time

from dpcorr_torch.serve.request import BucketKey
from dpcorr_torch.serve.stats import ServeStats

#: Gauge encoding for the per-bucket breaker state series.
STATE_CODES = {"closed": 0, "open": 1, "half_open": 2}


class DeadlineExpiredError(Exception):
    """The request's deadline passed before its kernel launched. The
    charge was refunded — retrying (with a fresh deadline) is safe."""

    def __init__(self, msg: str, retry_after_s: float | None = None):
        self.retry_after_s = retry_after_s
        super().__init__(msg)


class CircuitOpenError(Exception):
    """Admission refused fast: this request's (family, bucket) breaker
    is open after consecutive kernel failures. Nothing was charged.
    ``retry_after_s`` is the remaining cooldown."""

    def __init__(self, msg: str, retry_after_s: float | None = None):
        self.retry_after_s = retry_after_s
        super().__init__(msg)


def _bucket_label(bkey: BucketKey) -> str:
    """Compact label for the per-bucket metrics series."""
    return (f"{bkey.n_pad}/{bkey.eps1:g}/{bkey.eps2:g}/"
            f"{bkey.alpha:g}/{int(bkey.normalise)}")


class _Entry:
    """One bucket's breaker state (owner holds the breaker lock)."""

    __slots__ = ("state", "consecutive", "opened_at", "probe_at")

    def __init__(self):
        self.state = "closed"
        self.consecutive = 0
        self.opened_at = 0.0
        self.probe_at: float | None = None


class CircuitBreaker:
    """Per-bucket trip / cooldown / half-open-probe state machine.

    ``allow`` runs at admission (before the ledger charge);
    ``record_success`` / ``record_failure`` run on the flush thread per
    launch outcome. All transitions are published to ``stats`` when one
    is wired (state gauge + transition counter).
    """

    def __init__(self, fail_threshold: int = 5,
                 reset_after_s: float = 30.0,
                 stats: ServeStats | None = None,
                 clock=time.monotonic, on_open=None):
        if fail_threshold < 1:
            raise ValueError(f"fail_threshold must be >= 1, "
                             f"got {fail_threshold}")
        if reset_after_s <= 0.0:
            raise ValueError(f"reset_after_s must be > 0, "
                             f"got {reset_after_s}")
        self.fail_threshold = int(fail_threshold)
        self.reset_after_s = float(reset_after_s)
        self.stats = stats
        self.clock = clock
        #: ``on_open(bkey, consecutive)`` fires when a bucket trips
        #: open — OUTSIDE the breaker lock, so the flight recorder can
        #: dump (file I/O) without stalling concurrent admissions.
        #: Settable after construction (server wiring).
        self.on_open = on_open
        self._lock = threading.Lock()
        self._entries: dict[BucketKey, _Entry] = {}  # guarded by: _lock

    def _transition_locked(self, bkey: BucketKey, e: _Entry,
                           state: str) -> None:
        e.state = state
        if self.stats is not None:
            self.stats.breaker_state(bkey.family, _bucket_label(bkey),
                                     STATE_CODES[state])
            self.stats.breaker_transition(state)

    def allow(self, bkey: BucketKey) -> None:
        """Gate one admission. Raises :class:`CircuitOpenError` while
        the bucket's breaker is open (or a half-open probe is already
        in flight); after the cooldown the caller becomes the probe."""
        with self._lock:
            e = self._entries.get(bkey)
            if e is None or e.state == "closed":
                return
            now = self.clock()
            if e.state == "open":
                remaining = e.opened_at + self.reset_after_s - now
                if remaining > 0.0:
                    raise CircuitOpenError(
                        f"breaker open for {bkey.family} bucket "
                        f"{_bucket_label(bkey)} "
                        f"({e.consecutive} consecutive failures)",
                        retry_after_s=remaining)
                self._transition_locked(bkey, e, "half_open")
                e.probe_at = now
                return
            # half-open: one probe at a time; a probe that never came
            # back (refused downstream, client vanished) goes stale
            # after one more cooldown so recovery cannot deadlock
            if e.probe_at is not None \
                    and now - e.probe_at < self.reset_after_s:
                raise CircuitOpenError(
                    f"breaker half-open for {bkey.family} bucket "
                    f"{_bucket_label(bkey)}: probe in flight",
                    retry_after_s=e.probe_at + self.reset_after_s - now)
            e.probe_at = now

    def record_success(self, bkey: BucketKey) -> None:
        with self._lock:
            e = self._entries.get(bkey)
            if e is None:
                return
            e.consecutive = 0
            e.probe_at = None
            if e.state != "closed":
                self._transition_locked(bkey, e, "closed")

    def record_failure(self, bkey: BucketKey) -> None:
        tripped = None
        with self._lock:
            e = self._entries.setdefault(bkey, _Entry())
            e.consecutive += 1
            e.probe_at = None
            now = self.clock()
            if e.state == "half_open":
                # the probe failed: straight back to another cooldown
                e.opened_at = now
                self._transition_locked(bkey, e, "open")
                tripped = e.consecutive
            elif e.state == "closed" \
                    and e.consecutive >= self.fail_threshold:
                e.opened_at = now
                self._transition_locked(bkey, e, "open")
                tripped = e.consecutive
            elif e.state == "open":
                # a queued straggler failing while open: the bucket is
                # still sick — restart the cooldown
                e.opened_at = now
        if tripped is not None and self.on_open is not None:
            self.on_open(bkey, tripped)

    def state(self, bkey: BucketKey) -> str:
        with self._lock:
            e = self._entries.get(bkey)
            return e.state if e is not None else "closed"

    def any_open(self) -> bool:
        """True while any bucket is open or half-open — what degrades
        ``/readyz`` to 503 so a balancer drains this replica."""
        with self._lock:
            return any(e.state != "closed"
                       for e in self._entries.values())

    def snapshot(self) -> dict:
        with self._lock:
            states = {f"{k.family}:{_bucket_label(k)}": e.state
                      for k, e in self._entries.items()
                      if e.state != "closed"}
            return {"open": sum(1 for s in states.values()
                                if s == "open"),
                    "half_open": sum(1 for s in states.values()
                                     if s == "half_open"),
                    "tripped_buckets": states}


class BrownoutController:
    """Hysteretic sustained-pressure detector.

    ``observe(queue_fraction, flush_ewma_s)`` is called from the
    coalescer's admission and flush paths; pressure must persist for
    ``enter_after_s`` before brownout activates, and calm for
    ``exit_after_s`` before it deactivates — transient bursts ride
    through on the queue alone.
    """

    def __init__(self, queue_frac: float = 0.75,
                 flush_slo_s: float | None = None,
                 enter_after_s: float = 0.5, exit_after_s: float = 2.0,
                 stats: ServeStats | None = None,
                 clock=time.monotonic, on_change=None):
        if not 0.0 <= queue_frac <= 1.0:
            raise ValueError(f"queue_frac must be in [0, 1], "
                             f"got {queue_frac}")
        self.queue_frac = float(queue_frac)
        self.flush_slo_s = flush_slo_s
        self.enter_after_s = float(enter_after_s)
        self.exit_after_s = float(exit_after_s)
        self.stats = stats
        self.clock = clock
        #: ``on_change(active)`` fires on every enter/exit transition —
        #: OUTSIDE the controller lock (flight-recorder dump hook).
        #: Settable after construction (server wiring).
        self.on_change = on_change
        self._lock = threading.Lock()
        self._active = False  # guarded by: _lock
        self._pressured_since: float | None = None  # guarded by: _lock
        self._calm_since: float | None = None  # guarded by: _lock

    def _set_locked(self, active: bool) -> None:
        if active == self._active:
            return
        self._active = active
        if self.stats is not None:
            self.stats.brownout(active)

    def observe(self, queue_fraction: float,
                flush_ewma_s: float) -> None:
        pressured = queue_fraction >= self.queue_frac or (
            self.flush_slo_s is not None
            and flush_ewma_s > self.flush_slo_s)
        changed = None
        with self._lock:
            now = self.clock()
            if pressured:
                self._calm_since = None
                if self._pressured_since is None:
                    self._pressured_since = now
                if not self._active and \
                        now - self._pressured_since >= self.enter_after_s:
                    self._set_locked(True)
                    changed = True
            else:
                self._pressured_since = None
                if self._calm_since is None:
                    self._calm_since = now
                if self._active and \
                        now - self._calm_since >= self.exit_after_s:
                    self._set_locked(False)
                    changed = False
        if changed is not None and self.on_change is not None:
            self.on_change(changed)

    def active(self) -> bool:
        with self._lock:
            return self._active
