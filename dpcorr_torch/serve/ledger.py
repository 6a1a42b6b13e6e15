"""Per-party privacy-budget ledger under basic composition.

Counterpart of ``dpcorr/serve/ledger.py``, with the same JSON state file
(version 1): a ledger file written by either package is read by the
other.

The reference handles privacy accounting implicitly: a grid run spends
exactly the (ε₁, ε₂) its design row names, once, offline. An online
service has no such luxury — each admitted query *permanently* consumes
budget from the data owners it touches, and the correctness invariant
is that the sum of admitted spends never exceeds a party's configured
budget, across restarts. This module is that invariant:

- **Basic composition** (the paper's setting — pure ε-DP Laplace
  mechanisms): total spend per party is the plain sum of per-query ε.
  :func:`request_charges` maps a request to its per-party spend: ε₁
  against x's owner and ε₂ against y's, doubled for the sign families
  under ``normalise`` because the private centering pass spends the
  same ε again before the sign-batch release (vert-cor.R:211-215; the
  subG families clip with data-independent λ_n bounds instead, so they
  spend once).
- **Refusal before execution**: :meth:`PrivacyLedger.charge` is
  all-or-nothing across the request's parties and raises
  :class:`BudgetExceededError` without mutating anything if *any* party
  would exceed its budget. The server charges at admission, before the
  kernel runs.
- **Write-ahead persistence**: when constructed with a path, the spend
  table is fsync-rename persisted *before* ``charge`` returns, so a
  server killed at any point can never have answered a query whose
  spend is not on disk. A restart therefore under-counts never,
  over-counts at most the in-flight queries that were admitted but
  never answered — the safe direction for privacy.
- **Refund only for never-executed queries**:
  :meth:`PrivacyLedger.refund` reverses a charge when the server can
  prove no kernel ran (the enqueue itself refused the request), so
  backpressure sheds load without consuming ε.
- **Audit trail + metrics**: constructed with an
  :class:`dpcorr_torch.obs.audit.AuditTrail`, every charge/refund/refusal
  is appended as a structured event carrying the caller's trace ID —
  ``obs.audit.replay`` folds the trail into this ledger's spend table. Constructed with an obs registry, per-party spend and
  the charge/refund/refusal totals are published as Prometheus series
  next to the serving counters. Both are observers: the fsync-rename
  snapshot stays the accounting source of truth, and the trail line is
  written only after the charge is durably persisted.

Thread-safe: one lock around check+spend+persist (the coalescer admits
from many client threads).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Mapping

from dpcorr_torch import chaos
from dpcorr_torch.obs.audit import AuditTrail
from dpcorr_torch.obs.budget_replay import quarantine_corrupt, sweep_stale_tmp
from dpcorr_torch.obs.metrics import Registry
from dpcorr_torch.serve.request import EstimateRequest

__all__ = [
    "BudgetExceededError", "LedgerCorruptError", "PrivacyLedger",
    "quarantine_corrupt", "release_factor", "request_charges",
    "sweep_stale_tmp",
]

_STATE_VERSION = 1

# Idempotency memory: how many distinct charge_ids the ledger remembers
# (FIFO). Far above any live session's outstanding charges — the bound
# only exists so a long-lived server's snapshot cannot grow unboundedly.
_CHARGE_ID_CAP = 4096


class LedgerCorruptError(ValueError):
    """The persisted ledger snapshot could not be parsed. The bad file
    has been quarantined to a ``.corrupt`` sidecar; the message says
    exactly what to do next."""


# sweep_stale_tmp / quarantine_corrupt live in obs.budget_replay, as in
# the JAX package; re-exported here because they are ledger durability
# idioms first.


class BudgetExceededError(Exception):
    """Admission refused: the query would overdraw a principal's ε
    budget. ``level`` names which budget refused — ``party`` for data
    owners, ``user`` / ``global`` for the reserved directory
    namespaces (serve.budget_dir) — so refusal stats and cost events
    can attribute the refusing level without parsing principal names."""

    def __init__(self, party: str, spent: float, charge: float,
                 budget: float):
        self.party = party
        self.spent = spent
        self.charge = charge
        self.budget = budget
        self.level = ("user" if party.startswith("user/")
                      else "global" if party.startswith("global/")
                      else "party")
        super().__init__(
            f"party {party!r}: spent {spent:.6g} + charge {charge:.6g} "
            f"> budget {budget:.6g}")


def release_factor(family: str, normalise: bool) -> float:
    """Spend multiplier for one side's release under basic composition.

    Sign families with ``normalise`` privately center the variable
    first, spending that side's ε a second time before the sign-batch /
    flip release (vert-cor.R:211-215); the subG families clip with
    data-independent λ_n bounds instead, so they spend once. Shared by
    the serving admission path (:func:`request_charges`) and the
    two-party protocol's per-role charge (protocol.party) so the two
    deployment modes can never drift on what a release costs.
    """
    return 2.0 if (family in ("ni_sign", "int_sign") and normalise) else 1.0


def request_charges(req: EstimateRequest) -> dict[str, float]:
    """Per-party ε spend of one request under basic composition.

    Sign families with ``normalise`` privately center each variable
    first, spending that side's ε a second time (see module docstring);
    a request whose two sides name the same party accumulates both
    charges against it.
    """
    factor = release_factor(req.family, req.normalise)
    charges: dict[str, float] = {}
    for party, eps in ((req.party_x, req.eps1 * factor),
                       (req.party_y, req.eps2 * factor)):
        charges[party] = charges.get(party, 0.0) + float(eps)
    return charges


class PrivacyLedger:
    """Cumulative per-party ε under basic composition, with refusal.

    ``budget``: default per-party budget; ``per_party`` overrides it for
    named parties. ``path``: JSON persistence file — loaded on
    construction (restart continuity) and rewritten atomically on every
    successful charge.
    """

    def __init__(self, budget: float, path: str | None = None,
                 per_party: Mapping[str, float] | None = None,
                 audit: AuditTrail | None = None,
                 registry: Registry | None = None):
        if budget <= 0.0:
            raise ValueError(f"budget must be positive, got {budget}")
        self.budget = float(budget)
        self.per_party = dict(per_party or {})
        self.path = path
        self.audit = audit
        self._lock = threading.Lock()
        self._spent: dict[str, float] = {}  # guarded by: _lock
        # insertion-ordered set of applied charge_ids (dict keys) — what
        # makes a resumed session's re-charge a no-op
        self._charge_ids: dict[str, None] = {}  # guarded by: _lock
        self._events = self._spent_gauge = None
        if registry is not None:
            self._events = registry.counter(
                "dpcorr_ledger_events_total",
                "Ledger mutations by kind", labelnames=("kind",))
            self._spent_gauge = registry.gauge(
                "dpcorr_ledger_spent_eps",
                "Cumulative per-party eps spend under basic composition",
                labelnames=("party",))
        if path:
            self._sweep_stale_tmp(path)
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    state = json.load(f)
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                quarantine = quarantine_corrupt(path)
                raise LedgerCorruptError(
                    f"ledger snapshot {path!r} is corrupt ({e}); the bad "
                    f"file was moved to {quarantine!r}. To recover, "
                    "rebuild the spend table from the audit trail "
                    "(`dpcorr_torch.obs.audit.replay`) and "
                    "restart, or delete the sidecar to start from zero "
                    "spend (spends budget-safety: never do this in "
                    "production without the audit replay).") from e
            if state.get("version") != _STATE_VERSION:
                raise ValueError(
                    f"ledger state {path!r} has version "
                    f"{state.get('version')!r}, expected {_STATE_VERSION}")
            self._spent = {str(k): float(v)
                           for k, v in state["spent"].items()}
            # absent in pre-idempotency snapshots — same version, additive
            self._charge_ids = {str(c): None
                                for c in state.get("charge_ids", [])}
            self._publish_locked()

    # kept as a staticmethod alias — external callers use the module
    # function; the constructor predates it
    _sweep_stale_tmp = staticmethod(sweep_stale_tmp)

    def _publish_locked(self) -> None:
        """Mirror the spend table into the per-party gauge (caller holds
        the lock, or is the constructor before any concurrency)."""
        if self._spent_gauge is not None:
            for party, spent in self._spent.items():
                self._spent_gauge.set(spent, party=party)

    def budget_for(self, party: str) -> float:
        return float(self.per_party.get(party, self.budget))

    def spent(self, party: str) -> float:
        with self._lock:
            return self._spent.get(party, 0.0)

    def remaining(self, party: str) -> float:
        with self._lock:
            return self.budget_for(party) - self._spent.get(party, 0.0)

    def charge(self, charges: Mapping[str, float],
               trace_id: str | None = None,
               charge_id: str | None = None) -> None:
        """Atomically spend ``{party: ε}`` across all named parties.

        All-or-nothing: if any party would exceed its budget the whole
        charge is refused (no partial spend) and
        :class:`BudgetExceededError` raised for the first violator. On
        success the new state is durably persisted before returning.
        ``trace_id`` stamps the audit event so a budget decision joins
        the request's span chain.

        ``charge_id`` makes the charge idempotent: a charge whose id the
        persisted snapshot already contains is a no-op (recorded as a
        deduped audit event, spending nothing). This is how a resumed
        protocol session re-runs its charge-then-send sequence without
        double-spending — the ledger and the session journal are two
        separate durable stores that cannot commit atomically, so the
        charge itself must be safely repeatable. A later ``refund`` with
        the same id forgets it, so a genuinely new charge can reuse it.
        """
        for party, eps in charges.items():
            if eps < 0.0:
                raise ValueError(f"negative charge {eps} for {party!r}")
        with self._lock:
            if charge_id is not None and charge_id in self._charge_ids:
                if self._events is not None:
                    self._events.inc(kind="dedup")
                if self.audit is not None:
                    self.audit.record("charge", charges, trace_id=trace_id,
                                      charge_id=charge_id, dedup=True)
                return
            for party, eps in charges.items():
                spent = self._spent.get(party, 0.0)
                # strict >: a charge landing exactly on the budget is
                # admitted (the budget is a spend *cap*, not an open bound)
                if spent + eps > self.budget_for(party) + 1e-12:
                    if self._events is not None:
                        self._events.inc(kind="refusal")
                    if self.audit is not None:
                        self.audit.record(
                            "refusal", charges, trace_id=trace_id,
                            party=party, spent=spent,
                            budget=self.budget_for(party))
                    raise BudgetExceededError(party, spent, eps,
                                              self.budget_for(party))
            for party, eps in charges.items():
                self._spent[party] = self._spent.get(party, 0.0) + eps
            if charge_id is not None:
                self._charge_ids[charge_id] = None
                while len(self._charge_ids) > _CHARGE_ID_CAP:
                    self._charge_ids.pop(next(iter(self._charge_ids)))
            chaos.point("ledger.pre_persist")
            # spend must be durable before the ack leaves the lock
            self._persist_locked()
            chaos.point("ledger.post_persist")
            # observers fire only after the spend is durably on disk —
            # a crash here under-reports the audit view, never the budget
            if self._events is not None:
                self._events.inc(kind="charge")
            self._publish_locked()
            if self.audit is not None:
                detail = {} if charge_id is None else {"charge_id": charge_id}
                self.audit.record("charge", charges, trace_id=trace_id,
                                  **detail)

    def charge_request(self, req: EstimateRequest,
                       trace_id: str | None = None,
                       charge_id: str | None = None) -> dict[str, float]:
        """Charge one request's spend; returns what was charged.
        ``charge_id`` (the request's durable retry identity, when it
        has one) makes the charge idempotent across a crash-retry."""
        charges = request_charges(req)
        self.charge(charges, trace_id=trace_id, charge_id=charge_id)
        return charges

    def refund(self, charges: Mapping[str, float],
               trace_id: str | None = None,
               charge_id: str | None = None,
               reason: str | None = None) -> None:
        """Reverse a charge whose query provably never executed.

        Only valid when no kernel ran and nothing was released under
        the charged ε — the server uses it when the enqueue itself
        refuses an already-charged request (queue backpressure) and
        when an admitted request is shed before launch (deadline
        expiry, priority eviction, shutdown drain, client abandonment
        — serve.coalescer), so sustained overload cannot drain budgets
        to exhaustion with zero queries served. The reversal is
        persisted like a charge; spends clamp at zero so a stray refund
        can only err toward privacy (over-counting), never
        under-counting. ``reason`` stamps the audit event with which
        shed path fired, so an audit replay can account every refund.
        """
        for party, eps in charges.items():
            if eps < 0.0:
                raise ValueError(f"negative refund {eps} for {party!r}")
        with self._lock:
            for party, eps in charges.items():
                self._spent[party] = max(
                    0.0, self._spent.get(party, 0.0) - eps)
            # the id is forgotten so a genuinely new attempt may charge
            # under it again — refund means "that charge never happened"
            if charge_id is not None:
                self._charge_ids.pop(charge_id, None)
            # refund must be durable before the ack leaves the lock
            self._persist_locked()
            if self._events is not None:
                self._events.inc(kind="refund")
            self._publish_locked()
            if self.audit is not None:
                detail = {} if charge_id is None else {"charge_id": charge_id}
                if reason is not None:
                    detail["reason"] = reason
                self.audit.record("refund", charges, trace_id=trace_id,
                                  **detail)

    def snapshot(self) -> dict:
        """Point-in-time accounting view (the stats endpoint's shape)."""
        with self._lock:
            return {
                "budget_default": self.budget,
                "parties": {
                    p: {"spent": s, "budget": self.budget_for(p),
                        "remaining": self.budget_for(p) - s}
                    for p, s in sorted(self._spent.items())},
            }

    def _persist_locked(self) -> None:
        """Atomic write-ahead persist (caller holds the lock): tmp +
        fsync + rename, so a crash mid-write leaves the previous state
        intact and a completed charge is never lost."""
        if not self.path:
            return
        state = {"version": _STATE_VERSION, "spent": self._spent,
                 "charge_ids": list(self._charge_ids)}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
