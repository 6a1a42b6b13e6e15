"""Privacy-budget audit trail (counterpart of ``dpcorr/obs/audit.py``, with
its JSONL event format): every ledger mutation as a structured event.

The ledger (serve.ledger) persists only the *current* spend table — the
correct recovery artifact, but useless for the questions an auditor or
an on-call operator actually asks: *which request* spent party A to
exhaustion, *when* did refusals start, what was the ε timeline. This
module is the event log answering those:

- every **charge**, **refund** and **refusal** is appended as one JSON
  line carrying the per-party ε deltas, the wall timestamp, a
  monotonically increasing sequence number, and — when the serve layer
  is traced — the originating request's ``trace_id``, so one budget
  event joins the same span chain the request's latency lives on;
- :func:`replay` folds an audit log back into the per-party spend table
  (charges add, refunds subtract-and-clamp, refusals spend nothing —
  the ledger's own arithmetic), so the trail alone reproduces the
  ledger state, and :func:`timeline` is the per-party view.

The trail is an *observer*, not the accounting source of truth: the
ledger's fsync-rename snapshot remains what restarts load, and a trail
write happens after the charge is durably persisted (losing a tail
event under crash can under-report the audit view but can never corrupt
the budget). Events are line-buffered appends; thread-safe.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Iterable, Mapping

EVENT_KINDS = ("charge", "refund", "refusal")

class AuditTrail:
    """Append-only JSONL budget-event log. ``path=None`` keeps the
    events in memory (``events()``) — what tests and the in-process
    stats view use; a path makes it durable."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._lock = threading.Lock()
        self._seq = 0  # guarded by: _lock
        self._mem: list[dict] = []  # guarded by: _lock
        self._fh = None  # guarded by: _lock
        self._observers: list = []  # guarded by: _lock
        if path is not None:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            # resume the sequence past an existing trail so a restarted
            # server appends monotonically instead of reusing seq 0
            if os.path.exists(path):
                self._seq = sum(1 for ln in open(path) if ln.strip())
            self._fh = open(path, "a", buffering=1)

    def record(self, kind: str, charges: Mapping[str, float],
               trace_id: str | None = None, **detail) -> dict:
        """Append one event; returns it (tests assert on the shape)."""
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown audit event kind {kind!r}; "
                             f"expected one of {EVENT_KINDS}")
        with self._lock:
            ev = {"seq": self._seq, "ts": time.time(), "kind": kind,
                  "charges": {str(p): float(e) for p, e in charges.items()},
                  "trace_id": trace_id}
            if detail:
                ev.update(detail)
            self._seq += 1
            if self._fh is not None:
                self._fh.write(json.dumps(ev) + "\n")
            else:
                self._mem.append(ev)
            observers = list(self._observers)
        # outside the trail lock: the flight recorder takes its own
        # ring lock and must not nest under ours
        for fn in observers:
            fn(ev)
        return ev

    def add_observer(self, fn) -> None:
        """Register ``fn(event_dict)`` to receive every recorded event
        (the flight recorder's audit ring)."""
        with self._lock:
            if fn not in self._observers:
                self._observers.append(fn)

    def remove_observer(self, fn) -> None:
        with self._lock:
            if fn in self._observers:
                self._observers.remove(fn)

    def events(self) -> list[dict]:
        """The in-memory events (memory-backed trails only; for a
        durable trail read the file via :func:`read_events`)."""
        with self._lock:
            if self.path is not None:
                return read_events(self.path)
            return list(self._mem)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def read_events(path: str) -> list[dict]:
    """Load an audit JSONL file; ValueError names the first bad line."""
    events = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: bad audit line: {e}") from e
            if not isinstance(ev, dict) or ev.get("kind") not in EVENT_KINDS:
                raise ValueError(f"{path}:{i}: not an audit event")
            events.append(ev)
    return events


def _dedup_walk(events: Iterable[dict]):
    """Yield ``(kind, charges)`` applying the ledger's charge_id
    idempotency chronologically: the first charge carrying a given id
    spends it — even a ``dedup``-flagged one, which is how a re-charge
    event repairs a trail whose original charge line was lost to a
    crash between ledger persist and audit append — and every later
    charge with that id spends nothing. A refund forgets the id, so a
    *later* charge may legitimately reuse it. Events without a
    charge_id always apply (pre-idempotency trails and serve-path
    charges)."""
    applied: set = set()
    for ev in events:
        kind, cid = ev["kind"], ev.get("charge_id")
        if kind == "charge" and cid is not None:
            if cid in applied:
                yield ev, False
                continue
            applied.add(cid)
        elif kind == "refund" and cid is not None:
            applied.discard(cid)
        yield ev, True


def replay(events: Iterable[dict]) -> dict[str, float]:
    """Fold events into the per-party spend table using the ledger's
    own arithmetic (refunds clamp at zero; refusals spend nothing;
    charge_id-deduplicated charges spend once no matter how many times
    a resumed session re-ran them). The acceptance check:
    replay(trail) == ledger snapshot."""
    spent: dict[str, float] = {}
    for ev, applies in _dedup_walk(events):
        if not applies:
            continue
        if ev["kind"] == "charge":
            for p, e in ev["charges"].items():
                spent[p] = spent.get(p, 0.0) + float(e)
        elif ev["kind"] == "refund":
            for p, e in ev["charges"].items():
                spent[p] = max(0.0, spent.get(p, 0.0) - float(e))
    return spent


def replay_levels(events: Iterable[dict]) -> dict[str, dict]:
    """Replay split by budget level: ``{"party", "user", "global"}``
    spend tables (user keys are bare ids, ``user/`` prefix stripped).
    The ``user`` table must equal each user's budget-directory
    *lifetime* spend (renewals reset only the admission window and draw
    no audit event)."""
    from dpcorr_torch.obs.budget_replay import fold_levels

    return fold_levels(replay(events))


def timeline(events: Iterable[dict], party: str | None = None) -> list[dict]:
    """Per-event cumulative view: each row is one event with the
    running post-event spend of every party it touched — the ε-spend
    timeline."""
    spent: dict[str, float] = {}
    rows = []
    for ev, applies in _dedup_walk(events):
        touched = {}
        for p, e in ev["charges"].items():
            if applies and ev["kind"] == "charge":
                spent[p] = spent.get(p, 0.0) + float(e)
            elif applies and ev["kind"] == "refund":
                spent[p] = max(0.0, spent.get(p, 0.0) - float(e))
            touched[p] = spent.get(p, 0.0)
        if party is not None and party not in ev["charges"]:
            continue
        rows.append({"seq": ev["seq"], "ts": ev["ts"], "kind": ev["kind"],
                     "trace_id": ev.get("trace_id"),
                     "charges": ev["charges"], "spent_after": touched})
    return rows
