"""ReleaseGate: the ledger stands between computation and the wire.

Counterpart of ``dpcorr/protocol/gate.py``.

Everything that carries a DP release out of a party goes through
:meth:`ReleaseGate.send_release`, and the ordering is the whole point:

1. ``ledger.charge`` first — all-or-nothing across the named parties,
   durably persisted before it returns (serve.ledger). If the budget is
   exhausted, :class:`~dpcorr_torch.serve.ledger.BudgetExceededError`
   propagates and **no message is sent**: the peer learns nothing
   beyond the abort the party chooses to signal.
2. only then the channel send. If delivery *fails*
   (:class:`~dpcorr_torch.protocol.transport.TransportError` after the retry
   budget), the charge is refunded — the release never reached anyone,
   so the ε was provably not consumed. Note the asymmetry with
   success-side accounting: an ack timeout where the peer actually got
   the frame still counts as failure and refunds, which errs toward
   *over*-refunding only when the peer is also crashing out of the
   protocol (it will not use a release from an aborted session); the
   ledger's own clamp keeps refunds from going negative.

It is the charge-before-send / refund-on-refusal discipline the serving
admission path follows.
"""

from __future__ import annotations

from typing import Mapping

from dpcorr_torch import chaos
from dpcorr_torch.protocol.transport import ReliableChannel, TransportError
from dpcorr_torch.serve.ledger import PrivacyLedger


class ReleaseGate:
    """Charges ``ledger`` before any gated send; refunds on transport
    failure. The party runtime holds its ledger only through this gate,
    so every path from estimator output to the wire passes here.

    ``ledger`` is a :class:`PrivacyLedger` (the per-user budget
    directory that can wrap it in the JAX package is not ported yet).

    ``on_charge`` (optional) is called with the charge mapping after
    every *successful* charge leg — gated send delivered, local charge
    landed, replay charge landed — and never on the refund path. It is
    a telemetry observer (the federation party's ε-burn gauges hang
    here); observer failures are swallowed so metrics can never break
    the budget discipline they watch."""

    def __init__(self, ledger: PrivacyLedger, on_charge=None):
        self.ledger = ledger
        self._on_charge = on_charge

    def _observe(self, charges: Mapping[str, float]) -> None:
        if self._on_charge is None:
            return
        try:
            self._on_charge(dict(charges))
        except Exception:
            pass

    def send_release(self, channel: ReliableChannel, body: dict,
                     charges: Mapping[str, float],
                     trace_id: str | None = None,
                     charge_id: str | None = None,
                     seq: int | None = None) -> dict:
        """Charge, then send; returns the channel receipt augmented
        with the total ε charged (for the transcript's ``eps`` column).

        Raises ``BudgetExceededError`` (nothing sent, nothing spent)
        or ``TransportError`` (charge refunded).

        ``charge_id`` makes the charge leg idempotent (a crash-resumed
        session re-runs this whole sequence; the ledger spends the id
        once) and ``seq`` pins a journal-replayed send to its original
        wire sequence. Both default off, preserving the pre-journal
        call shape — including for channel test doubles that only
        implement ``send(body)``."""
        self.ledger.charge(charges, trace_id=trace_id, charge_id=charge_id)
        chaos.point("gate.post_charge")
        try:
            if seq is None:
                receipt = channel.send(body)
            else:
                receipt = channel.send(body, seq=seq)
        except TransportError:
            self.ledger.refund(charges, trace_id=trace_id,
                               charge_id=charge_id)
            raise
        chaos.point("gate.post_send")
        receipt["eps"] = float(sum(charges.values()))
        self._observe(charges)
        return receipt

    def charge_local(self, charges: Mapping[str, float],
                     trace_id: str | None = None,
                     charge_id: str | None = None) -> float:
        """Charge for releases that never cross a wire: a federation
        party's *local* cells (both columns its own) still run the DP
        split estimator, so the ε is real spend even though there is no
        send to gate. The idempotent ``charge_id`` carries the
        exactly-once contract across crash/resume — a resumed matrix
        re-runs its local cells bit-identically but the ledger spends
        the id once. Returns the total ε charged."""
        self.ledger.charge(charges, trace_id=trace_id,
                           charge_id=charge_id)
        self._observe(charges)
        return float(sum(charges.values()))

    def charge_replayed(self, charges: Mapping[str, float],
                        trace_id: str | None = None,
                        charge_id: str | None = None) -> None:
        """The charge leg alone, for journal-replay slots whose
        delivery is already established (the peer finished and left —
        party.py peer-gone path): the ε must still land exactly once,
        which the idempotent ``charge_id`` guarantees, but there is no
        wire send to pair it with and no failure that could justify a
        refund."""
        self.ledger.charge(charges, trace_id=trace_id,
                           charge_id=charge_id)
        self._observe(charges)
