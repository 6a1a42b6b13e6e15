"""PartyX/PartyY role runtimes: the estimator protocols as messages.

Counterpart of ``dpcorr/protocol/party.py``, on the wire byte for byte:
a port party and a JAX party can hold one session. Each party computes
on its device (the card unless ``device="cpu"``): its column is placed
there once, its release is computed there, copied to the host and
encoded as f32 bytes; the finisher decodes the peer's release and places
it back on its device with no change of dtype.

One :class:`Party` instance is one side of one protocol session. It
holds exactly one raw column, a reliable channel to the peer, and a
:class:`~dpcorr_torch.protocol.gate.ReleaseGate` wrapping its privacy ledger
— the ledger is reachable *only* through the gate, so there is no code
path from this module to the wire that skips the charge.

Session shape:

1. ``hello`` / ``hello_ack`` — X sends the spec hash (and the public
   spec for operator sanity), Y refuses the session unless the hash
   matches its own spec byte-for-byte. No ε is spent before this pins
   that both sides agree on family, n, ε's, seed and key layout.
2. ``release`` — the releasing role (split_reference.split_roles: the
   x-side for NI, the larger-ε side for INT) computes its column's DP
   release and sends it through the gate (charge → send → refund on
   transport failure).
3. ``result`` — the finishing role validates the payload against the
   family's release schema, combines it with its *own* column's
   contribution (models.estimators.split_reference.finish — spending
   its own ε, also gated), and returns (ρ̂, CI) to the peer.
4. ``error`` — either side aborts (budget refusal, validation failure);
   carries a reason string, never arrays, and is deliberately ungated.

Noise keys come from ``utils.rng.party_root``: ``"replay"`` reproduces
the monolithic stream addresses (bit-identity acceptance), and
``"hardened"`` roots each party in its disjoint ``"protocol/x"`` /
``"protocol/y"`` subtree. Tracing: X opens the session's root span and
its context rides the ``hello`` headers (obs.wire_headers), so Y's
spans — in another process — join the same trace ID.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

from dpcorr_torch import chaos
from dpcorr_torch.models.estimators import split_reference as sr
from dpcorr_torch.obs import recorder as obs_recorder
from dpcorr_torch.obs.trace import from_wire_headers, tracer, wire_headers
from dpcorr_torch.protocol.gate import ReleaseGate
from dpcorr_torch.protocol.journal import SessionJournal
from dpcorr_torch.protocol.messages import (
    Message,
    Transcript,
    canonical_encode,
    decode_array,
    encode_array,
)
from dpcorr_torch.protocol.transport import (
    ReliableChannel,
    SessionResumeRefused,
    TransportError,
)
from dpcorr_torch.serve.ledger import (
    BudgetExceededError,
    PrivacyLedger,
    release_factor,
)
from dpcorr_torch.utils import rng
from dpcorr_torch.utils.device import resolve_device


class ProtocolError(Exception):
    """Protocol violation: bad spec hash, malformed payload, unexpected
    message type. Not a budget event."""


class ProtocolRefused(Exception):
    """The session aborted on a budget refusal — locally (our ledger
    refused a gated send; nothing was sent) or remotely (the peer sent
    ``error`` with kind ``budget``)."""


@dataclass(frozen=True)
class ProtocolSpec:
    """The public design point both parties must agree on before any ε
    is spent. Everything here is public parameters — the spec hash in
    ``hello`` commits to it without revealing anything private."""

    family: str
    n: int
    eps1: float
    eps2: float
    alpha: float = 0.05
    normalise: bool = True
    seed: int = 2025
    noise_mode: str = "replay"
    party_x: str = "party-x"
    party_y: str = "party-y"
    session: str = ""
    # Optional per-role column key labels (federation): when set, the
    # role roots its noise in utils.rng.column_root(master, label)
    # instead of the bare master key, so different columns of a k×k
    # matrix draw independent noise and a column's release is the same
    # bytes in every pair that reuses it. Empty (the default) keeps the
    # original two-party key layout — and the original spec hash.
    key_x: str = ""
    key_y: str = ""

    def __post_init__(self):
        if self.session == "":
            object.__setattr__(self, "session",
                               f"sess-{self.spec_hash()[:12]}")

    def to_public(self) -> dict:
        pub = {"family": self.family, "n": int(self.n),
               "eps1": float(self.eps1), "eps2": float(self.eps2),
               "alpha": float(self.alpha),
               "normalise": bool(self.normalise),
               "seed": int(self.seed), "noise_mode": self.noise_mode,
               "party_x": self.party_x, "party_y": self.party_y}
        if self.key_x or self.key_y:
            # only present when used: pre-federation specs keep their
            # exact hash (and transcript bytes) across this change
            pub["key_x"] = self.key_x
            pub["key_y"] = self.key_y
        return pub

    def spec_hash(self) -> str:
        return hashlib.sha256(canonical_encode(self.to_public())).hexdigest()

    def party_name(self, role: str) -> str:
        return self.party_x if role == "x" else self.party_y

    def own_eps(self, role: str) -> float:
        return self.eps1 if role == "x" else self.eps2

    def charges_for(self, role: str) -> dict[str, float]:
        """This role's ε spend for its side of the protocol —
        its own ε times the family's release factor (the private
        centering double-spend for sign families, serve.ledger). The
        two roles' charges sum to exactly ``request_charges`` of the
        equivalent serve request, so serving-mode and protocol-mode
        accounting can never drift."""
        f = release_factor(self.family, self.normalise)
        return {self.party_name(role): float(self.own_eps(role)) * f}


@dataclass
class ProtocolResult:
    """One party's view of a completed session."""

    role: str
    session: str
    rho_hat: float
    ci_low: float
    ci_high: float
    trace_id: str | None = None
    stats: dict = field(default_factory=dict)


def host_floats(*values) -> list[float]:
    """f32 tensors (on any device) or numbers → Python floats through
    f32, in one copy to the host. float32 → binary64 is exact and repr
    round-trips binary64, so casting back to float32 on the far side
    restores the identical bits."""
    t = torch.stack([torch.as_tensor(v, dtype=torch.float32).reshape(())
                     .to("cpu") for v in values])
    return [float(v) for v in t.numpy()]


def host_column(col) -> np.ndarray:
    """A raw column (numpy, list or a tensor on any device) as a host f32
    array, for the shape checks before it is placed on the party's
    device."""
    if isinstance(col, torch.Tensor):
        col = col.detach().cpu().numpy()
    return np.asarray(col, dtype=np.float32)


def host_array(t) -> np.ndarray:
    """A release tensor on any device → its f32 numpy array on the host,
    bits unchanged (the wire's array envelope encodes it)."""
    return t.detach().to("cpu", torch.float32).numpy()


def _result_floats(rho, lo, hi) -> dict:
    """(ρ̂, CI) as wire floats (:func:`host_floats`): the result message
    never perturbs the estimate."""
    rho, lo, hi = host_floats(rho, lo, hi)
    return {"rho_hat": rho, "ci_low": lo, "ci_high": hi}


class SessionEndpoint:
    """One endpoint of one journaled, gated protocol session — the
    plumbing shared by the two-party :class:`Party` and the federation
    pair links (protocol.federation), factored out of ``Party``
    verbatim. Everything session-shaped lives here: transcript
    recording, the journal slot ↔ wire seq discipline, gated and plain
    sends, journal replay on receive, the resume re-attach handshake
    and its peer-gone fallback, and the terminal linger.

    Subclasses provide the three identity facts (``session`` id,
    ``spec_hash`` the handshake pins, ``sender`` — the wire name this
    endpoint signs messages with: the role letter for two-party
    sessions, the party's own name on a federation link) and drive the
    message flow; this class guarantees that however they drive it, ε
    is charged before any release send, refunded only on provable
    non-delivery, and spent exactly once across restarts.
    """

    def __init__(self, *, session: str, spec_hash: str, sender: str,
                 channel: ReliableChannel, ledger: PrivacyLedger,
                 transcript: Transcript | None = None,
                 recv_timeout_s: float = 30.0,
                 journal: SessionJournal | None = None):
        self.session = session
        self.spec_hash = spec_hash
        self.sender = sender
        self.channel = channel
        self._gate = ReleaseGate(ledger)
        self.transcript = transcript or Transcript(None)
        self.recv_timeout_s = recv_timeout_s
        self.journal = journal
        self._span = None
        self._resumed = False
        self._peer_gone = False  # resume went unanswered: peer finished
        self._out_slot = 0   # next outbound journal slot
        self._in_slot = 0    # next inbound journal slot
        self._replay_in = 0  # inbound slots below this replay from journal

    # ------------------------------------------------------- plumbing ----
    def _headers(self) -> dict:
        return wire_headers(self._span.context
                            if self._span is not None else None)

    def _trace_id(self) -> str | None:
        return self._span.trace_id if self._span is not None else None

    def _record(self, direction: str, msg: Message, receipt: dict,
                eps: float = 0.0, charge_id: str | None = None,
                replayed: bool = False) -> None:
        self.transcript.record(
            direction, msg, seq=receipt.get("seq", -1),
            n_bytes=receipt.get("bytes", len(msg.encode())),
            retries=receipt.get("retries", 0),
            latency_s=receipt.get("latency_s", 0.0), eps=eps,
            charge_id=charge_id, replayed=replayed)

    def _journal_outbound(self, msg: Message, charges=None,
                          charge_id=None) -> dict:
        """Claim the next outbound slot and journal the wire dict under
        it — durably, before anything irreversible happens. On a resume
        the slot may already exist, in which case the *journaled* entry
        wins wholesale: replaying recomputed bytes would diverge from
        what the peer may have already acked."""
        slot = self._out_slot
        self._out_slot += 1
        entry = self.journal.outbound_entry(slot)
        if entry is None:
            entry = self.journal.prepare_outbound(
                slot, msg.to_wire(), charges=charges, charge_id=charge_id)
            chaos.point("journal.post_prepare")
        return entry

    def _send_plain(self, msg: Message) -> None:
        """Ungated send — only for messages that carry no DP release
        (hello/hello_ack/error)."""
        if self.journal is None:
            receipt = self.channel.send(msg.to_wire())
            self._record("send", msg, receipt)
            return
        entry = self._journal_outbound(msg)
        wire_msg = Message.from_wire(entry["wire"])
        if entry["acked"]:
            # delivered before the crash; keep the transcript complete
            self._record("send", wire_msg, {"seq": entry["seq"]},
                         replayed=True)
            return
        if self._peer_gone:
            # peer completed without us: this frame was necessarily
            # delivered (see _attach_journal) — record, don't resend
            self.journal.mark_acked(entry["slot"])
            self._record("send", wire_msg, {"seq": entry["seq"]},
                         replayed=True)
            return
        receipt = self.channel.send(entry["wire"], seq=entry["seq"])
        self.journal.mark_acked(entry["slot"])
        self._record("send", wire_msg, receipt)

    def _linger(self) -> None:
        """Drain the channel after receiving the session's final
        message — but only when loss is actually possible (fault
        injection active, retransmissions already happened, this is
        a crash-resumed session whose peer may still be retransmitting
        into the gap the restart left, or we just acknowledged a
        *peer's* re-attach and its journal replay is about to arrive):
        a clean queue/TCP link never drops an ack, and the idle window
        would otherwise tax every clean session's latency for
        nothing."""
        if self.channel.fault is not None or self.channel.total_retries \
                or self._resumed or self.channel.peer_resumed:
            self.channel.drain()

    def _send_best_effort(self, msg: Message) -> None:
        """Abort notification: the peer may already be gone (its own
        abort crossed ours, or chaos ate the session) — a delivery
        failure here must not mask the refusal we are about to raise.
        Deliberately unjournaled: aborts are terminal, there is no
        resume that would replay one."""
        try:
            receipt = self.channel.send(msg.to_wire())
            self._record("send", msg, receipt)
        except TransportError:
            pass

    def _send_gated(self, msg: Message, charges) -> None:
        """Charge ``charges``, then send; refund handled inside the
        gate. On refusal, signal the peer with an ungated ``error`` so
        it stops waiting, then raise :class:`ProtocolRefused`.

        Journaled sessions make the whole sequence crash-repeatable:
        the slot (wire + charges + a deterministic charge_id) is
        durable before the charge, the charge is idempotent under that
        id, the send is pinned to the journaled seq (the peer's dedupe
        absorbs a pre-crash delivery), and a slot already marked acked
        skips straight to the transcript — ε spent exactly once no
        matter where in this function the process last died."""
        if self.journal is None:
            try:
                receipt = self._gate.send_release(
                    self.channel, msg.to_wire(), charges,
                    trace_id=self._trace_id())
            except BudgetExceededError as e:
                abort = self._msg("error", {
                    "kind": "budget", "reason": str(e), "party": e.party})
                # the abort frame is uncharged; send_release refunded
                # dpcorr-lint: ignore[budget-deep-missing-refund] — abort frame is uncharged; send_release already refunded
                self._send_best_effort(abort)
                raise ProtocolRefused(str(e)) from e
            self._record("send", msg, receipt, eps=receipt["eps"])
            return
        cid = f"{self.session}:{self.sender}:out{self._out_slot}"
        entry = self._journal_outbound(msg, charges=charges, charge_id=cid)
        cid = entry["charge_id"]
        wire_msg = Message.from_wire(entry["wire"])
        entry_charges = entry["charges"] or charges
        if entry["acked"]:
            self._record("send", wire_msg, {"seq": entry["seq"]},
                         eps=float(sum(entry_charges.values())),
                         charge_id=cid, replayed=True)
            return
        if self._peer_gone:
            # The peer finished and left before our journal saw this
            # slot acked — but it cannot have completed without the
            # release, so delivery happened at the channel level and
            # only the local bookkeeping is behind. Land the
            # (idempotent) charge, skip the wire, and mark the slot so
            # a further restart replays it identically. Refunding here
            # would double-credit a consumed release.
            self._gate.charge_replayed(entry_charges,
                                       trace_id=self._trace_id(),
                                       charge_id=cid)
            self.journal.mark_acked(entry["slot"])
            self._record("send", wire_msg, {"seq": entry["seq"]},
                         eps=float(sum(entry_charges.values())),
                         charge_id=cid, replayed=True)
            return
        try:
            receipt = self._gate.send_release(
                self.channel, entry["wire"], entry_charges,
                trace_id=self._trace_id(), charge_id=cid,
                seq=entry["seq"])
        except BudgetExceededError as e:
            abort = self._msg("error", {
                "kind": "budget", "reason": str(e), "party": e.party})
            # the abort frame is uncharged; send_release refunded
            # dpcorr-lint: ignore[budget-deep-missing-refund] — abort frame is uncharged; send_release already refunded
            self._send_best_effort(abort)
            raise ProtocolRefused(str(e)) from e
        self.journal.mark_acked(entry["slot"])
        chaos.point("party.post_gated")
        self._record("send", wire_msg, receipt, eps=receipt["eps"],
                     charge_id=cid)

    def _recv(self, *expect: str) -> Message:
        if self.journal is not None and self._in_slot < self._replay_in:
            # journaled before the crash; the channel pre-marked its seq
            # delivered, so the live link will re-ack but never re-queue
            got = dict(self.journal.inbound_entry(self._in_slot))
            self._in_slot += 1
        else:
            got = self.channel.recv(timeout_s=self.recv_timeout_s)
            self._in_slot += 1
        msg = Message.from_wire(got["body"])
        self._record("recv", msg, {"seq": got["seq"]})
        if msg.session != self.session:
            raise ProtocolError(
                f"session mismatch: peer says {msg.session!r}, "
                f"ours is {self.session!r}")
        if msg.msg_type == "error":
            # terminal inbound: linger so the peer's abort send doesn't
            # fail on a chaos-dropped ack after we raise (transport.drain)
            self._linger()
            kind = msg.payload.get("kind", "protocol")
            reason = msg.payload.get("reason", "peer aborted")
            if kind == "budget":
                raise ProtocolRefused(f"peer refused: {reason}")
            raise ProtocolError(f"peer error: {reason}")
        if msg.msg_type not in expect:
            raise ProtocolError(
                f"expected {expect}, got {msg.msg_type!r}")
        return msg

    def _msg(self, msg_type: str, payload: dict) -> Message:
        return Message(msg_type=msg_type, sender=self.sender,
                       session=self.session, payload=payload,
                       headers=self._headers())

    def _register_session_info(self) -> None:
        """Tell the channel which (session, token) a peer's resume
        handshake must present — the surviving side answers resumes
        from whatever loop it is blocked in."""
        token = self.journal.resume_token if self.journal else None
        if token:
            self.channel.session_info = {"session": self.session,
                                         "token": token}

    def _attach_journal(self) -> None:
        """Bind the journal to this session and reload channel state.

        The resume re-attach handshake runs only when there is evidence
        the *peer* already knows this session (something of ours was
        acked, or something of theirs journaled): before that point the
        peer is still parked in its opening recv and a resume frame
        would go unanswered — the plain journal replay alone is
        sufficient and correct there."""
        j = self.journal
        self._resumed = j.begin(self.session, self.sender, self.spec_hash)
        self._replay_in = len(j.inbound)
        self.channel.on_deliver = j.record_inbound
        self.channel.restore(send_seq=len(j.outbound),
                             delivered=j.delivered_seqs())
        self._register_session_info()
        token = j.resume_token
        peer_knows_us = bool(j.inbound) \
            or any(e["acked"] for e in j.outbound)
        if self._resumed and token and peer_knows_us:
            budget = max(10.0 * self.channel.timeout_s, 5.0)
            try:
                self.channel.resume(self.session, token,
                                    max_wait_s=budget)
            except SessionResumeRefused:
                raise  # wrong session/token — never a peer-gone case
            except TransportError:
                # Unanswered: the peer finished and left. Single-crash
                # soundness: it cannot have completed without every
                # release we journaled — the channel acks a frame only
                # after journaling it, and the peer's final recv could
                # not have returned otherwise — so delivery of our
                # unacked slots already happened and replay can finish
                # from the journal alone (_send_gated/_send_plain skip
                # the wire when this flag is set). A dual-crash that
                # violates the premise fails loudly via recv timeout.
                self._peer_gone = True

    def _stats(self) -> dict:
        ch = self.channel
        out = {"sent_msgs": ch.sent_msgs,
               "total_retries": ch.total_retries}
        if ch.fault is not None:
            out["fault"] = ch.fault.stats()
        return out


class Party(SessionEndpoint):
    """One role ("x" or "y") of one protocol session.

    ``column`` is this party's raw column — it never leaves this object
    except through ``split_reference.party_release``/``finish`` (DP
    releases) and is never serialized. ``ledger`` is wrapped in the
    release gate immediately; the party itself keeps no direct
    reference.

    With ``journal`` (a :class:`SessionJournal`), the session is
    crash-safe: every outbound message is journaled before it is sent
    (outbound slot *k* ↔ wire seq *k+1*), every inbound message is
    journaled before it is acked, the gated charge carries a
    deterministic ``charge_id`` so the ledger spends it once across
    restarts, and a restarted party replays its journal — re-sending
    journaled wire bytes verbatim under their original seqs — until it
    rejoins the live session exactly where it died. Without a journal
    nothing changes, down to the wire bytes (the determinism test
    byte-compares transcripts).

    ``device`` is where the party computes: the card unless the caller
    names another; without a card and without ``device`` it raises.
    """

    def __init__(self, role: str, column, spec: ProtocolSpec,
                 channel: ReliableChannel, ledger: PrivacyLedger,
                 transcript: Transcript | None = None,
                 recv_timeout_s: float = 30.0,
                 journal: SessionJournal | None = None, device=None):
        if role not in ("x", "y"):
            raise ValueError(f"role must be 'x' or 'y', got {role!r}")
        self.device = resolve_device(device)
        col = host_column(column)
        if col.ndim != 1 or col.shape[0] != spec.n:
            raise ValueError(
                f"column must be shape ({spec.n},), got {col.shape}")
        super().__init__(session=spec.session,
                         spec_hash=spec.spec_hash(), sender=role,
                         channel=channel, ledger=ledger,
                         transcript=transcript,
                         recv_timeout_s=recv_timeout_s, journal=journal)
        self.role = role
        self._column = torch.from_numpy(col.copy()).to(self.device)
        self.spec = spec

    def _handshake(self) -> None:
        """X proposes (opening the trace root), Y verifies the spec
        hash and parents its root span on the proposal's context —
        from here both processes share one trace ID.

        Journaled sessions thread two extra facts through the same two
        messages: X mints a resume token into the hello (journal-gated,
        so unjournaled sessions keep byte-identical wire traffic), and
        a restarted X pins its root span to the journaled trace ID so
        the resumed half of the session joins the original trace. Y
        needs no special casing — its root span parents on the hello
        headers, which a resume replays verbatim from the journal."""
        if self.role == "x":
            if self.journal is not None and self.journal.trace_id:
                # dpcorr-lint: ignore[span-no-finally] — session root span; ends in close()
                self._span = tracer().start_span(
                    "protocol.session", trace_id=self.journal.trace_id,
                    role=self.role, family=self.spec.family,
                    session=self.spec.session, resumed=True)
            else:
                # dpcorr-lint: ignore[span-no-finally] — session root span; ends in close()
                self._span = tracer().start_span(
                    "protocol.session", role=self.role,
                    family=self.spec.family, session=self.spec.session)
                if self.journal is not None and self._span.trace_id:
                    self.journal.set_trace(self._span.trace_id)
            payload = {"spec": self.spec.to_public(),
                       "spec_hash": self.spec.spec_hash()}
            if self.journal is not None:
                payload["resume_token"] = self.journal.ensure_token()
                self._register_session_info()
            hello = self._msg("hello", payload)
            self._send_plain(hello)
            self._recv("hello_ack")
        else:
            first = self._recv("hello")
            # the session root span ends in run()'s finally
            # dpcorr-lint: ignore[span-no-finally] — session root span; ends in close()
            self._span = tracer().start_span(
                "protocol.session", parent=from_wire_headers(first.headers),
                role=self.role, family=self.spec.family,
                session=self.spec.session)
            if self.journal is not None:
                token = first.payload.get("resume_token")
                if token:
                    self.journal.adopt_token(token)
                    self._register_session_info()
                if self._span.trace_id:
                    self.journal.set_trace(self._span.trace_id)
            theirs = first.payload.get("spec_hash")
            if theirs != self.spec.spec_hash():
                refusal = self._msg("error", {
                    "kind": "protocol",
                    "reason": f"spec hash mismatch: {theirs!r}"})
                self._send_best_effort(refusal)
                raise ProtocolError(
                    f"peer spec hash {theirs!r} != ours "
                    f"{self.spec.spec_hash()!r}")
            ack = self._msg("hello_ack",
                            {"spec_hash": self.spec.spec_hash()})
            self._send_plain(ack)

    # ----------------------------------------------------- estimation ----
    def _root_key(self):
        key = rng.master_key(self.spec.seed, device=self.device)
        label = self.spec.key_x if self.role == "x" else self.spec.key_y
        if label:
            key = rng.column_root(key, label)
        return rng.party_root(key, self.role, self.spec.noise_mode)

    def _run_releaser(self) -> ProtocolResult:
        s = self.spec
        with tracer().span("protocol.release", parent=self._span,
                           role=self.role):
            rel = sr.party_release(s.family, self._root_key(), self.role,
                                   self._column, s.eps1, s.eps2,
                                   s.normalise, device=self.device)
            kinds = sr.RELEASE_KINDS[s.family]
            payload = {name: encode_array(host_array(arr),
                                          kind=kinds[name])
                       for name, arr in rel.items()}
        outbound = self._msg("release", payload)
        self._send_gated(outbound, self.spec.charges_for(self.role))
        final = self._recv("result")
        # result is the session's last message and we are its receiver:
        # linger so our ack loss doesn't strand the finisher mid-send
        self._linger()
        p = final.payload
        return ProtocolResult(
            role=self.role, session=s.session,
            rho_hat=p["rho_hat"], ci_low=p["ci_low"],
            ci_high=p["ci_high"], trace_id=self._trace_id(),
            stats=self._stats())

    def _validate_release(self, msg: Message) -> dict:
        """Enforce the family's release schema on the inbound payload
        *before* touching values: unexpected keys, missing envelopes,
        wrong kind/shape/dtype are protocol errors. This is the
        receiving half of the no-raw-columns barrier — a payload shaped
        like a raw column cannot reach the finisher."""
        s = self.spec
        schema = sr.release_schema(s.family, s.n, s.eps1, s.eps2)
        payload = msg.payload
        if set(payload) != set(schema):
            raise ProtocolError(
                f"release payload keys {sorted(payload)} != schema "
                f"{sorted(schema)}")
        out = {}
        for name, want in schema.items():
            env = payload[name]
            if not (isinstance(env, dict) and env.get("__array__") == 1):
                raise ProtocolError(f"release[{name!r}] is not an "
                                    "array envelope")
            if env.get("kind") != want["kind"]:
                raise ProtocolError(
                    f"release[{name!r}] kind {env.get('kind')!r} != "
                    f"{want['kind']!r}")
            arr = decode_array(env)
            if tuple(arr.shape) != tuple(want["shape"]) \
                    or str(arr.dtype) != want["dtype"]:
                raise ProtocolError(
                    f"release[{name!r}] is {arr.dtype}{arr.shape}, "
                    f"schema says {want['dtype']}{tuple(want['shape'])}")
            out[name] = arr
        return out

    def _run_finisher(self) -> ProtocolResult:
        s = self.spec
        inbound = self._recv("release")
        peer_release = self._validate_release(inbound)
        with tracer().span("protocol.finish", parent=self._span,
                           role=self.role):
            rho, lo, hi = sr.finish(s.family, self._root_key(),
                                    peer_release, self._column, s.eps1,
                                    s.eps2, s.alpha, s.normalise,
                                    device=self.device)
            floats = _result_floats(rho, lo, hi)
        outbound = self._msg("result", floats)
        self._send_gated(outbound, self.spec.charges_for(self.role))
        # our result being acked does NOT mean our ack of the peer's
        # release got through: the releaser absorbs the result (and acks
        # it) from inside its own blocked send, so it can still be
        # retransmitting the release after this send returns. Linger to
        # keep re-acking, or chaos strands the releaser mid-send.
        self._linger()
        return ProtocolResult(
            role=self.role, session=s.session,
            rho_hat=floats["rho_hat"], ci_low=floats["ci_low"],
            ci_high=floats["ci_high"], trace_id=self._trace_id(),
            stats=self._stats())

    def run(self) -> ProtocolResult:
        """Execute this role's side of the session to completion. A
        journaled session that already finished returns its journaled
        result without touching the wire or the ledger — the terminal
        idempotency level."""
        s = self.spec
        if self.journal is not None:
            if self.journal.status == "finished" and self.journal.result:
                return ProtocolResult(**self.journal.result)
            self._attach_journal()
        # hello/ack frames carry no release, so nothing to charge
        # dpcorr-lint: ignore[budget-deep-uncharged-enqueue] — hello/ack frames carry no release, so nothing to charge
        self._handshake()
        chaos.point("party.post_handshake")
        releaser, _ = sr.split_roles(s.family, s.eps1, s.eps2)
        try:
            if self.role == releaser:
                result = self._run_releaser()
            else:
                result = self._run_finisher()
        except (ProtocolError, ProtocolRefused):
            raise  # typed protocol outcomes are expected, not dumped
        except Exception as e:
            # an unhandled session failure triggers a flight-recorder
            # dump (when one is installed — obs.recorder.trigger is a
            # no-op otherwise) so the postmortem has the span chain and
            # recent logs without re-running the session
            obs_recorder.trigger(
                "party_unhandled", role=self.role,
                session=self.spec.session, error=type(e).__name__,
                detail=str(e))
            raise
        finally:
            if self._span is not None:
                self._span.end()
            self.transcript.close()
        if self.journal is not None:
            self.journal.set_result({
                "role": result.role, "session": result.session,
                "rho_hat": result.rho_hat, "ci_low": result.ci_low,
                "ci_high": result.ci_high, "trace_id": result.trace_id,
                "stats": result.stats})
            self.journal.finish()
        return result
