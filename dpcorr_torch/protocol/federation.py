"""Federation runtime: N parties computing the k×k matrix.

Counterpart of ``dpcorr/protocol/federation.py``, on the same wire. Every
party computes on one ``device`` (the card unless ``device="cpu"``); its
link threads share that device's default stream.

:mod:`~dpcorr_torch.protocol.matrix` decides *what* happens — cells, venues,
rounds, artifact charges — as pure plan arithmetic. This module makes
it happen: one :class:`FederationParty` per real party, holding all of
that party's columns, its single privacy ledger, and one **pair link**
per peer it shares a cell with. A pair link is one
:class:`~dpcorr_torch.protocol.transport.ReliableChannel` carrying *all* of
the pair's cells as a multiplexed session: per round, the lower party
sends one gated ``release`` envelope bundling every column artifact the
round's cells need, and the higher party answers one gated ``result``
after a single batched finish kernel
(:func:`~dpcorr_torch.models.estimators.split_reference.finish_batch`,
``"exact"`` engine) — B cells, two messages, two charges at most.

The budget optimum falls out of the plan: a column's release artifact
is computed once (:meth:`FederationParty.release_artifact` caches the
*encoded* envelope, so every link embeds the identical bytes — which is
also what the cross-pair correlation-leak gate in protocol.scan
verifies) and charged once, at the artifact's first-use venue; rounds
that only reuse artifacts send them with an **empty** charge map
through the same release gate. Total spend is
``FederationPlan.optimal_eps()`` — ``2·f·ε·(k−1)`` for a full matrix —
against the naive per-cell ``f·ε·k·(k−1)``.

Crash safety composes from the two-party session unchanged: every pair
link is one journaled session
(:class:`~dpcorr_torch.protocol.journal.SessionJournal`),
local-cell charges carry a deterministic plan-derived ``charge_id``,
and the whole schedule is a pure function of the public plan — so a
party killed anywhere mid-matrix re-derives the identical schedule on
restart, finished links replay from their journals' terminal results,
and the interrupted link resumes exactly-once through the session
re-attach handshake. Chaos points ``federation.pre_release`` /
``federation.pre_finish`` / ``federation.mid_matrix`` mark the
federation-specific crash windows; the shared gate/journal/ledger
windows fire inside the common code paths as before.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from dataclasses import dataclass, field

import torch

from dpcorr_torch import chaos
from dpcorr_torch.models.estimators import split_reference as sr
from dpcorr_torch.obs import recorder as obs_recorder
from dpcorr_torch.obs.cost import split_exact
from dpcorr_torch.obs.metrics import LATENCY_BUCKETS, Registry
from dpcorr_torch.obs.trace import from_wire_headers, tracer
from dpcorr_torch.protocol.gate import ReleaseGate
from dpcorr_torch.protocol.journal import SessionJournal
from dpcorr_torch.protocol.matrix import FederationPlan, _factor
from dpcorr_torch.protocol.messages import (
    Transcript,
    canonical_encode,
    decode_array,
    encode_array,
)
from dpcorr_torch.protocol.party import (
    ProtocolError,
    ProtocolRefused,
    SessionEndpoint,
    host_array,
    host_column,
    host_floats,
)
from dpcorr_torch.protocol.transport import (
    InProcTransport,
    ReconnectingTcpLink,
    ReliableChannel,
    SessionResumeRefused,
    TransportError,
    TransportTimeout,
    tcp_accept,
    tcp_connect,
    tcp_listen,
)
from dpcorr_torch.serve.ledger import BudgetExceededError, PrivacyLedger
from dpcorr_torch.utils import rng
from dpcorr_torch.utils.device import resolve_device

#: Same convenience default as runner.DEFAULT_BUDGET (callers that
#: don't bring persistent ledgers are single-shot runs).
DEFAULT_BUDGET = 1e6


def _first_cells(plan: FederationPlan) -> dict:
    """``(side, label) -> first cell`` using the artifact — the cell its
    one-time ε charge is attributed to (matrix.artifact_venues keeps
    the venue; cost attribution needs the cell itself)."""
    first: dict = {}
    for i, j in plan.cells():
        first.setdefault(("x", plan.label(i)), (i, j))
        first.setdefault(("y", plan.label(j)), (i, j))
    return first


@dataclass
class FederationResult:
    """One party's view of a completed matrix: every cell it computed
    or received (local cells plus all cells on its links — cells
    between two *other* parties are not its business to know)."""

    party: str
    fed: str
    cells: dict            # "i,j" -> {"rho_hat", "ci_low", "ci_high"}
    eps: dict              # {"party", "optimal", "naive_per_cell"}
    stats: dict = field(default_factory=dict)
    costs: list = field(default_factory=list)  # per-cell attributions


class _PairLink(SessionEndpoint):
    """One multiplexed pair session — the federation's unit of wire
    traffic, riding the exact journaled/gated endpoint machinery the
    two-party :class:`~dpcorr_torch.protocol.party.Party` uses. The lower
    party (plan order) initiates and releases; the higher party
    verifies the plan hash, finishes each round with one batched
    kernel, and returns the round's results."""

    def __init__(self, owner: "FederationParty", peer: str,
                 channel: ReliableChannel,
                 transcript: Transcript | None = None,
                 journal: SessionJournal | None = None,
                 recv_timeout_s: float = 30.0):
        plan = owner.plan
        lo = plan.party_index(owner.name) < plan.party_index(peer)
        p, q = (owner.name, peer) if lo else (peer, owner.name)
        super().__init__(session=plan.link_session(p, q),
                         spec_hash=plan.fed_hash(), sender=owner.name,
                         channel=channel, ledger=owner.ledger,
                         transcript=transcript,
                         recv_timeout_s=recv_timeout_s, journal=journal)
        self.owner = owner
        self.plan = plan
        self.peer = peer
        self.p, self.q = p, q
        self.initiator = lo
        # re-point the endpoint's gate at an observed one: every charge
        # this link lands (gated send, replay) moves the owner's
        # ε-burn gauge without touching the budget discipline
        self._gate = ReleaseGate(owner.ledger,
                                 on_charge=owner.note_charge)

    # ------------------------------------------------------ handshake ----
    def _handshake(self, first) -> None:
        """Same two frames as the two-party opening, pinning the
        *federation* hash: both ends prove they compiled the identical
        plan (schedule, rounds, charge assignment included) before any
        ε moves. The initiator also names the pair — a link dialed to
        the wrong peer fails here, not mid-round. ``first`` is the
        acceptor's already-received ``hello`` (the span parented on its
        headers was opened in :meth:`run` before this call); the
        initiator passes ``None``."""
        plan = self.plan
        if self.initiator:
            payload = {"fed": plan.to_public(),
                       "fed_hash": plan.fed_hash(),
                       "pair": [self.p, self.q]}
            if self.journal is not None:
                payload["resume_token"] = self.journal.ensure_token()
                self._register_session_info()
            self._send_plain(self._msg("hello", payload))
            self._recv("hello_ack")
            return
        if self.journal is not None:
            token = first.payload.get("resume_token")
            if token:
                self.journal.adopt_token(token)
                self._register_session_info()
        theirs = first.payload.get("fed_hash")
        if theirs != plan.fed_hash() \
                or first.payload.get("pair") != [self.p, self.q]:
            self._send_best_effort(self._msg("error", {
                "kind": "protocol",
                "reason": f"federation plan mismatch: {theirs!r}"}))
            raise ProtocolError(
                f"peer plan hash {theirs!r} != ours "
                f"{plan.fed_hash()!r}")
        self._send_plain(self._msg("hello_ack",
                                   {"fed_hash": plan.fed_hash()}))

    # --------------------------------------------------------- rounds ----
    def _drive_releaser(self) -> list:
        out = []
        link = f"{self.p}-{self.q}"
        for r, cells in enumerate(self.plan.link_rounds(self.p, self.q)):
            t0 = time.perf_counter()
            with tracer().span("federation.round", parent=self._span,
                               link=link, round=r, role="release",
                               cells=len(cells)):
                labels = self.plan.round_x_labels(self.p, self.q, r)
                artifacts = {lab: self.owner.release_artifact(lab)
                             for lab in labels}
                rc = self.plan.round_charges(self.p, self.q,
                                             r)["release"]
                chaos.point("federation.pre_release")
                payload = {"round": r,
                           "cells": [list(c) for c in cells],
                           "artifacts": artifacts,
                           "charged": list(rc["labels"])}
                self._send_gated(self._msg("release", payload),
                                 rc["charges"])
                final = self._recv("result")
                out.extend(self._check_result(final, r, cells))
            self.owner.note_cells(cells, "link")
            self.owner.note_round(link, "release",
                                  time.perf_counter() - t0)
        return out

    def _check_result(self, msg, r: int, cells) -> list:
        pay = msg.payload
        if pay.get("round") != r:
            raise ProtocolError(
                f"result round {pay.get('round')!r} != expected {r}")
        got = pay.get("cells", [])
        if [tuple(c[:2]) for c in got] != [tuple(c) for c in cells]:
            raise ProtocolError(
                f"result cells do not match round {r} of "
                f"link {self.p}-{self.q}")
        return [(int(i), int(j), float(rho), float(lo), float(hi))
                for i, j, rho, lo, hi in got]

    def _refuse(self, reason: str):
        self._send_best_effort(self._msg("error", {
            "kind": "protocol", "reason": reason}))
        raise ProtocolError(reason)

    def _validate_round(self, msg, r: int, cells) -> dict:
        """The finisher's half of the no-raw-columns barrier, per
        artifact: round/cell agreement with the plan, charged-labels
        agreement (a releaser that under- or over-declares its charges
        is refused before any finish), and the family release schema
        on every envelope — exactly Party._validate_release, once per
        label."""
        plan = self.plan
        pay = msg.payload
        if pay.get("round") != r:
            self._refuse(f"release round {pay.get('round')!r} != "
                         f"expected {r}")
        if [tuple(c) for c in pay.get("cells", [])] \
                != [tuple(c) for c in cells]:
            self._refuse(f"release cells do not match round {r} of the "
                         "plan")
        labels = plan.round_x_labels(self.p, self.q, r)
        arts = pay.get("artifacts")
        if not isinstance(arts, dict) or set(arts) != set(labels):
            self._refuse(
                f"release artifacts {sorted(arts or ())} != plan "
                f"labels {sorted(labels)}")
        want_charged = plan.round_charges(self.p, self.q, r)["release"]
        if tuple(pay.get("charged", ())) != tuple(want_charged["labels"]):
            self._refuse("release charged-labels differ from the plan's "
                         "artifact assignment")
        schema = sr.release_schema(plan.family, plan.n, plan.eps,
                                   plan.eps)
        decoded: dict = {}
        for lab in labels:
            group = arts[lab]
            if not isinstance(group, dict) or set(group) != set(schema):
                self._refuse(f"artifact {lab!r} keys != release schema")
            vals = {}
            for name, want in schema.items():
                env = group[name]
                if not (isinstance(env, dict)
                        and env.get("__array__") == 1):
                    self._refuse(f"artifact {lab!r}[{name!r}] is not an "
                                 "array envelope")
                if env.get("kind") != want["kind"]:
                    self._refuse(
                        f"artifact {lab!r}[{name!r}] kind "
                        f"{env.get('kind')!r} != {want['kind']!r}")
                arr = decode_array(env)
                if tuple(arr.shape) != tuple(want["shape"]) \
                        or str(arr.dtype) != want["dtype"]:
                    self._refuse(
                        f"artifact {lab!r}[{name!r}] is "
                        f"{arr.dtype}{arr.shape}, schema says "
                        f"{want['dtype']}{tuple(want['shape'])}")
                vals[name] = arr
            decoded[lab] = vals
        return decoded

    def _drive_finisher(self) -> list:
        plan = self.plan
        out = []
        link = f"{self.p}-{self.q}"
        for r, cells in enumerate(plan.link_rounds(self.p, self.q)):
            msg = self._recv("release")
            rt0 = time.perf_counter()
            with tracer().span("federation.round", parent=self._span,
                               link=link, round=r, role="finish",
                               cells=len(cells)) as rsp:
                decoded = self._validate_round(msg, r, cells)
                chaos.point("federation.pre_finish")
                keys = [self.owner.finisher_key(plan.label(j))
                        for _i, j in cells]
                rels = [decoded[plan.label(i)] for i, _j in cells]
                cols = [self.owner.column(plan.label(j))
                        for _i, j in cells]
                t0 = time.perf_counter()
                with tracer().span("federation.finish",
                                   cells=len(cells)):
                    rho, lo, hi = sr.finish_batch(
                        plan.family, keys, rels, cols, plan.eps,
                        plan.eps, plan.alpha, plan.normalise,
                        engine=self.owner.engine,
                        device=self.owner.device)
                    # one copy to the host for the round (f32 → float
                    # is exact, so the wire floats keep every bit)
                    vals = torch.stack([rho, lo, hi]).to("cpu").numpy()
                finish_s = time.perf_counter() - t0
                result_cells = [
                    [int(i), int(j), float(vals[0, b]), float(vals[1, b]),
                     float(vals[2, b])]
                    for b, (i, j) in enumerate(cells)]
                for i, j in cells:
                    # per-cell completion markers: instantaneous child
                    # spans so the unioned timeline shows exactly when
                    # each matrix cell finished, on which link
                    with tracer().span("federation.cell", parent=rsp,
                                       i=int(i), j=int(j), link=link):
                        pass
                rc = plan.round_charges(self.p, self.q, r)["result"]
                self._send_gated(
                    self._msg("result",
                              {"round": r, "cells": result_cells,
                               "charged": list(rc["labels"])}),
                    rc["charges"])
                self.owner.attribute_round(
                    pair=(self.p, self.q), cells=cells,
                    finish_s=finish_s, n_bytes=len(msg.encode()))
            self.owner.note_cells(cells, "link")
            self.owner.note_round(link, "finish",
                                  time.perf_counter() - rt0)
            out.extend(tuple(c) for c in result_cells)
        return out

    def run(self) -> list:
        """All rounds of this pair session; returns the link's cells as
        ``(i, j, rho, lo, hi)`` tuples. A journaled link that already
        finished returns its terminal result without touching the wire
        or the ledger — the same idempotency level as Party.run.

        Every link of every party joins ONE federation trace: the
        initiator pins the deterministic plan-derived trace id
        (``FederationPlan.trace_id``; a resumed journal's recorded
        trace wins, and is itself that same id for any run of this
        code), the acceptor parents on the hello's wire headers and
        falls back to the same pin when the initiator runs untraced."""
        if self.journal is not None:
            if self.journal.status == "finished" and self.journal.result:
                return [tuple(c) for c in self.journal.result["cells"]]
            try:
                self._attach_journal()
            except SessionResumeRefused as e:
                obs_recorder.trigger(
                    "federation_resume_refused", party=self.sender,
                    peer=self.peer, session=self.session,
                    fed=self.plan.fed, detail=str(e))
                raise
        plan = self.plan
        first = None
        if self.initiator:
            resumed = bool(self.journal is not None
                           and self.journal.trace_id)
            span = tracer().start_span(
                "federation.link",
                trace_id=(self.journal.trace_id if resumed
                          else plan.trace_id()),
                party=self.sender, session=self.session,
                family=plan.family, resumed=resumed)
        else:
            first = self._recv("hello")
            span = tracer().start_span(
                "federation.link",
                parent=from_wire_headers(first.headers),
                trace_id=plan.trace_id(), party=self.sender,
                session=self.session, family=plan.family)
        self._span = span
        if self.journal is not None and span.trace_id:
            self.journal.set_trace(span.trace_id)
        try:
            self._handshake(first)
            cells = (self._drive_releaser() if self.initiator
                     else self._drive_finisher())
            # terminal symmetry with the two-party roles: whichever side
            # received the session's last frame keeps re-acking while
            # loss is possible (transport.drain decides)
            self._linger()
        finally:
            span.end()
            self.transcript.close()
        if self.journal is not None:
            self.journal.set_result({"cells": [list(c) for c in cells]})
            self.journal.finish()
        self.owner.note_link_done(self.p, self.q)
        return cells


class FederationParty:
    """One real party of one federation: its columns, its ledger (one
    gate, shared by every link and the local cells), its pair links.

    ``columns`` maps this party's column labels to raw value arrays —
    they never leave this object except as DP releases through
    ``split_reference``. ``channels`` maps peer name →
    :class:`ReliableChannel`; ``journals``/``transcripts`` likewise,
    all optional. ``engine`` selects the batched finish engine
    (``"exact"`` is the bit-identity contract). ``device`` is where the
    party computes: the card unless the caller names another."""

    def __init__(self, name: str, plan: FederationPlan, columns,
                 ledger: PrivacyLedger | None,
                 channels: dict | None = None, *,
                 journals: dict | None = None,
                 transcripts: dict | None = None,
                 recv_timeout_s: float = 30.0, engine: str = "exact",
                 registry: Registry | None = None,
                 instance: str | None = None, device=None):
        plan.party_index(name)  # unknown party fails loudly here
        self.device = resolve_device(device)
        self.name = name
        self.plan = plan
        self.ledger = ledger or PrivacyLedger(DEFAULT_BUDGET)
        self.engine = engine
        self.recv_timeout_s = recv_timeout_s
        self.instance = instance
        self.registry = registry if registry is not None else Registry()
        self._init_metrics()
        self._gate = ReleaseGate(self.ledger,
                                 on_charge=self.note_charge)
        self._channels = dict(channels or {})
        self._journals = dict(journals or {})
        self._transcripts = dict(transcripts or {})
        self._columns = {}
        for lab in plan.party_labels(name):
            if lab not in columns:
                raise ValueError(f"party {name!r} is missing its "
                                 f"column {lab!r}")
            col = host_column(columns[lab])
            if col.ndim != 1 or col.shape[0] != plan.n:
                raise ValueError(f"column {lab!r} must be shape "
                                 f"({plan.n},), got {col.shape}")
            self._columns[lab] = torch.from_numpy(col.copy()).to(
                self.device)
        for p, q in plan.party_links(name):
            peer = q if p == name else p
            if peer not in self._channels:
                raise ValueError(f"party {name!r} has no channel for "
                                 f"its link to {peer!r}")
        self._lock = threading.Lock()
        self._artifacts: dict = {}   # guarded by: _lock
        self._costs: list = []       # guarded by: _lock
        self._done: set = set()      # guarded by: _lock
        self._first = _first_cells(plan)

    # -------------------------------------------------------- metrics ----
    def _init_metrics(self) -> None:
        """The party-process telemetry: one registry holds the series
        the JAX package's ``--obs-port`` scrape serves (that endpoint is
        not ported yet; :meth:`stats_snapshot` is its /stats). All series carry
        enough labels for the SLO engine's federation objectives
        (round latency, ε-burn vs plan share) to point at them."""
        r = self.registry
        plan = self.plan
        self._m_info = r.gauge(
            "dpcorr_federation_instance_info",
            "federation party identity: constant 1, labelled with the "
            "fleet instance name, party and federation id",
            labelnames=("instance", "party", "fed"))
        if self.instance:
            self._m_info.set(1, instance=str(self.instance),
                             party=self.name, fed=plan.fed)
        self._m_round_latency = r.histogram(
            "dpcorr_federation_round_latency_seconds",
            "wall time of one pair-link round (release->result on the "
            "releaser, recv->result-sent on the finisher)",
            buckets=LATENCY_BUCKETS)
        self._m_rounds = r.counter(
            "dpcorr_federation_rounds_total",
            "pair-link rounds completed", labelnames=("link", "role"))
        self._m_cells = r.counter(
            "dpcorr_federation_cells_completed_total",
            "matrix cells this party finished or received",
            labelnames=("venue",))
        self._m_cache = r.counter(
            "dpcorr_federation_release_cache_total",
            "column release artifact cache outcomes (a hit is the "
            "byte-identical reuse the eps optimum rests on)",
            labelnames=("label", "outcome"))
        self._m_links = r.counter(
            "dpcorr_federation_links_finished_total",
            "pair links run to completion", labelnames=("link",))
        self._m_spent = r.gauge(
            "dpcorr_federation_ledger_spent_eps",
            "eps this party's ledger has spent on its own account",
            labelnames=("ledger",))
        self._m_share = r.gauge(
            "dpcorr_federation_plan_share_eps",
            "this party's plan-derived share of the federation "
            "optimum (constant; burn above it is an SLO violation)",
            labelnames=("ledger",))
        self._m_share.set(plan.party_eps().get(self.name, 0.0),
                          ledger=self.name)
        self.note_charge(None)

    def note_charge(self, charges) -> None:
        """Gate observer: refresh the ε-burn gauge from the ledger
        after any charge leg lands (the gauge reads the ledger, not the
        increment, so refunds and idempotent resume re-charges can
        never drift it)."""
        try:
            self._m_spent.set(self.ledger.spent(self.name),
                              ledger=self.name)
        except Exception:
            pass

    def note_round(self, link: str, role: str, seconds: float) -> None:
        self._m_round_latency.observe(seconds)
        self._m_rounds.inc(link=link, role=role)

    def note_link_done(self, p: str, q: str) -> None:
        self._m_links.inc(link=f"{p}-{q}")

    def note_cells(self, cells, venue: str) -> None:
        with self._lock:
            fresh = [c for c in cells
                     if (int(c[0]), int(c[1])) not in self._done]
            self._done.update((int(c[0]), int(c[1])) for c in fresh)
        if fresh:
            self._m_cells.inc(len(fresh), venue=venue)

    def stats_snapshot(self) -> dict:
        """The /stats document for the party obs endpoint — shaped so
        the fleet console's federation frame and FleetCollector's
        per-instance stats map both read it directly."""
        plan = self.plan
        with self._lock:
            done = len(self._done)
            cached = sorted(self._artifacts)
        spent = self.ledger.spent(self.name)
        return {
            "kind": "federation_party",
            "instance": self.instance,
            "party": self.name,
            "fed": plan.fed,
            "trace_id": plan.trace_id(),
            "family": plan.family,
            "cells_done": done,
            "cells_total": len(plan.cells()),
            "links": [f"{p}-{q}" for p, q in plan.party_links(self.name)],
            "eps": {"spent": spent,
                    "share": plan.party_eps().get(self.name, 0.0),
                    "optimal": plan.optimal_eps(),
                    "naive_per_cell": plan.naive_eps()},
            "artifacts_cached": cached,
        }

    # ----------------------------------------------------------- keys ----
    def _root(self, label: str, side: str):
        key = rng.column_root(
            rng.master_key(self.plan.seed, device=self.device), label)
        return rng.party_root(key, side, self.plan.noise_mode)

    def finisher_key(self, label: str):
        return self._root(label, "y")

    def column(self, label: str):
        return self._columns[label]

    # ------------------------------------------------------ artifacts ----
    def release_artifact(self, label: str) -> dict:
        """The column's encoded release envelope — computed once,
        cached as *bytes-stable wire dicts*, so every link (and every
        round) that embeds this label embeds identical bytes. Re-noising
        per pair would be an ε leak and a correlation leak; the
        cross-pair scan (protocol.scan.scan_federation) enforces the
        byte-identity this cache provides."""
        with self._lock:
            env = self._artifacts.get(label)
            if env is not None:
                self._m_cache.inc(label=label, outcome="hit")
                with tracer().span("federation.release_cache",
                                   label=label, hit=True):
                    pass
                return env
            with tracer().span("federation.release_cache",
                               label=label, hit=False):
                plan = self.plan
                rel = sr.party_release(
                    plan.family, self._root(label, "x"), "x",
                    self._columns[label], plan.eps, plan.eps,
                    plan.normalise, device=self.device)
                kinds = sr.RELEASE_KINDS[plan.family]
                env = {name: encode_array(host_array(arr),
                                          kind=kinds[name])
                       for name, arr in rel.items()}
                self._artifacts[label] = env
            self._m_cache.inc(label=label, outcome="build")
            return env

    # ----------------------------------------------------------- cost ----
    def attribute_round(self, pair, cells, finish_s: float,
                        n_bytes: int) -> None:
        """Per-cell cost records for one finished round: the round's
        one kernel time and one release envelope split exactly across
        its cells (obs.split_exact — attributions sum back to the round
        totals), and each cell's ε split into what its round charged
        *new* (artifacts first used by this cell) vs what it reused
        for free — the ledger-facing view of the release-reuse
        optimization."""
        plan = self.plan
        unit = _factor(plan.family, plan.normalise) * plan.eps
        times = split_exact(float(finish_s), len(cells))
        sizes = split_exact(int(n_bytes), len(cells))
        recs = []
        for b, (i, j) in enumerate(cells):
            new = sum(
                unit for art in (("x", plan.label(i)),
                                 ("y", plan.label(j)))
                if self._first[art] == (i, j))
            recs.append({"cell": [i, j], "pair": list(pair),
                         "finish_s": times[b], "bytes": sizes[b],
                         "eps_new": new,
                         "eps_reused": 2.0 * unit - new})
        with self._lock:
            self._costs.extend(recs)

    # ---------------------------------------------------- local cells ----
    def _run_local(self) -> list:
        plan = self.plan
        cells = plan.local_cells(self.name)
        if not cells:
            return []
        lc = plan.local_charges(self.name)
        if lc["charges"]:
            # charge-before-release, same discipline as the wire: the
            # plan-derived charge_id makes a resumed matrix re-run this
            # block without double-spending
            try:
                self._gate.charge_local(lc["charges"],
                                        charge_id=lc["charge_id"])
            except BudgetExceededError as e:
                raise ProtocolRefused(str(e)) from e
        out = []
        for i, j in cells:
            li, lj = plan.label(i), plan.label(j)
            t0 = time.perf_counter()
            with tracer().span("federation.cell",
                               parent=getattr(self, "_matrix_span",
                                              None),
                               i=int(i), j=int(j), venue="local"):
                rho, lo, hi = host_floats(*sr.split_estimate(
                    plan.family, self._root(li, "x"),
                    self.finisher_key(lj), self._columns[li],
                    self._columns[lj], plan.eps, plan.eps,
                    alpha=plan.alpha, normalise=plan.normalise,
                    device=self.device))
            cell_s = time.perf_counter() - t0
            out.append((i, j, rho, lo, hi))
            self.note_cells([(i, j)], "local")
            unit_new = sum(
                1 for art in (("x", li), ("y", lj))
                if self._first[art] == (i, j))
            unit = _factor(plan.family, plan.normalise) * plan.eps
            with self._lock:
                self._costs.append({
                    "cell": [i, j], "pair": [self.name],
                    "finish_s": cell_s, "bytes": 0,
                    "eps_new": unit * unit_new,
                    "eps_reused": unit * (2 - unit_new)})
        return out

    # ------------------------------------------------------------ run ----
    def run(self) -> FederationResult:
        """Local cells, then every pair link concurrently; joins *all*
        link threads before re-raising any link failure, so a simulated
        in-process crash leaves no zombie link thread competing for the
        channels when the restarted party re-attaches."""
        plan = self.plan
        span = tracer().start_span("federation.matrix",
                                   trace_id=plan.trace_id(),
                                   party=self.name, fed=plan.fed,
                                   instance=self.instance or self.name)
        self._matrix_span = span
        results: dict = {}
        try:
            for c in self._run_local():
                results[(c[0], c[1])] = c
            links = []
            for p, q in plan.party_links(self.name):
                peer = q if p == self.name else p
                links.append(_PairLink(
                    self, peer, self._channels[peer],
                    transcript=self._transcripts.get(peer),
                    journal=self._journals.get(peer),
                    recv_timeout_s=self.recv_timeout_s))
            outs: dict[str, list] = {}
            errs: dict[str, BaseException] = {}

            def drive(lk: _PairLink) -> None:
                try:
                    outs[lk.peer] = lk.run()
                except BaseException as e:  # joined + re-raised below
                    errs[lk.peer] = e

            threads = [threading.Thread(target=drive, args=(lk,),
                                        name=f"party-{self.name}")
                       for lk in links]
            for t in threads:
                t.start()
            pending = list(threads)
            try:
                while pending:
                    pending.pop(0).join()
                    chaos.point("federation.mid_matrix")
            finally:
                for t in pending:
                    t.join()
            if errs:
                raise errs[sorted(errs)[0]]
            for lk in links:
                for c in outs[lk.peer]:
                    results[(c[0], c[1])] = c
            stats = {lk.peer: lk._stats() for lk in links}
        except (ProtocolError, ProtocolRefused):
            raise
        except Exception as e:
            obs_recorder.trigger(
                "federation_unhandled", party=self.name, fed=plan.fed,
                error=type(e).__name__, detail=str(e))
            raise
        finally:
            span.end()
        with self._lock:
            costs = list(self._costs)
        return FederationResult(
            party=self.name, fed=plan.fed,
            cells={f"{i},{j}": {"rho_hat": rho, "ci_low": lo,
                                "ci_high": hi}
                   for (i, j), (_i, _j, rho, lo, hi)
                   in sorted(results.items())},
            eps={"party": plan.party_eps().get(self.name, 0.0),
                 "optimal": plan.optimal_eps(),
                 "naive_per_cell": plan.naive_eps()},
            stats=stats, costs=costs)


# ============================================ whole federations ====

def _backoff_max(timeout_s: float) -> float:
    # same cadence scaling as runner._make_parties
    return min(2.0, max(2.0 * timeout_s, 0.1))


def _mk_fault(fault: dict | None, default_seed: int):
    from dpcorr_torch.protocol.runner import _mk_fault as mk

    return mk(fault, default_seed)


def _party_files(plan: FederationPlan, name: str, peer_of: dict,
                 transcript_dir: str | None, journal_dir: str | None):
    transcripts, journals = {}, {}
    for (p, q), peer in peer_of.items():
        sess = plan.link_session(p, q)
        if transcript_dir:
            transcripts[peer] = Transcript(os.path.join(
                transcript_dir, f"{sess}.{name}.jsonl"))
        if journal_dir:
            journals[peer] = SessionJournal(os.path.join(
                journal_dir, f"journal.{name}.{sess}.json"))
    return transcripts, journals


def make_federation_parties(plan: FederationPlan, data, *,
                            ledgers: dict | None = None,
                            endpoints: dict | None = None,
                            fault: dict | None = None,
                            transcript_dir: str | None = None,
                            journal_dir: str | None = None,
                            timeout_s: float = 10.0,
                            max_retries: int = 10,
                            recv_timeout_s: float = 30.0,
                            engine: str = "exact", device=None) -> dict:
    """Build every party of an in-process federation over queue-pair
    transports. ``data`` maps column label → values (labels are
    globally unique, so one flat dict covers all parties). Pass
    ``endpoints`` — ``{(p, q): InProcTransport}`` — to reuse the same
    wire across a crash-restart (the chaos tests' pattern: fresh
    parties and channels on the surviving queue pair + the same
    journals); omitted, a fresh transport is made per link."""
    endpoints = ({(p, q): InProcTransport() for p, q in plan.links()}
                 if endpoints is None else endpoints)
    parties = {}
    link_index = {lk: n for n, lk in enumerate(plan.links())}
    for name, labels in plan.parties:
        channels, peer_of = {}, {}
        for p, q in plan.party_links(name):
            pair = endpoints[(p, q)]
            peer = q if p == name else p
            side = pair.a if name == p else pair.b
            # distinct deterministic fault seed per (link, side) so one
            # --fault-seed knob reproduces every endpoint's chaos
            seed = 11 + 2 * link_index[(p, q)] + (0 if name == p else 1)
            channels[peer] = ReliableChannel(
                side, timeout_s=timeout_s, max_retries=max_retries,
                backoff_max_s=_backoff_max(timeout_s),
                fault=_mk_fault(fault, default_seed=seed))
            peer_of[(p, q)] = peer
        transcripts, journals = _party_files(
            plan, name, peer_of, transcript_dir, journal_dir)
        if fault:
            for t in transcripts.values():
                t.meta(fault=dict(fault), fed=plan.fed)
        parties[name] = FederationParty(
            name, plan, {lab: data[lab] for lab in labels},
            (ledgers or {}).get(name), channels, journals=journals,
            transcripts=transcripts, recv_timeout_s=recv_timeout_s,
            engine=engine, device=device)
    return parties


def _drive_parties(parties: dict) -> dict:
    """Run every party to completion on its own thread; re-raises the
    first failure (party order) after all joined."""
    results: dict[str, FederationResult] = {}
    errors: dict[str, BaseException] = {}

    def drive(name: str, party: FederationParty) -> None:
        try:
            results[name] = party.run()
        except BaseException as e:  # captured for the joining thread
            errors[name] = e

    threads = [threading.Thread(target=drive, args=(name, p),
                                name=f"party-{name}")
               for name, p in parties.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        for name in parties:
            if name in errors:
                raise errors[name]
    return results


def run_federation_inproc(plan: FederationPlan, data, **kw) -> dict:
    """The whole federation in one process (tests, benchmarks, the
    single-command CLI): every party on a thread, queue-pair wires.
    Returns ``{party: FederationResult}``."""
    return _drive_parties(make_federation_parties(plan, data, **kw))


def run_federation_tcp(plan: FederationPlan, data, *,
                       host: str = "127.0.0.1",
                       ledgers: dict | None = None,
                       fault: dict | None = None,
                       transcript_dir: str | None = None,
                       journal_dir: str | None = None,
                       timeout_s: float = 10.0, max_retries: int = 10,
                       recv_timeout_s: float = 30.0,
                       engine: str = "exact", device=None) -> dict:
    """Same drive over real loopback TCP sockets, one per link (the
    full length-prefixed framing path; ``port=0`` ephemeral ports)."""
    resolve_device(device)  # raise before any socket opens
    links: dict = {}
    servers = []
    for p, q in plan.links():
        srv, bound = tcp_listen(host, 0)
        servers.append(srv)
        got: dict = {}

        def accept(srv=srv, got=got):
            got["q"] = tcp_accept(srv, timeout_s=max(timeout_s, 30.0))

        acceptor = threading.Thread(target=accept, name="fed-accept")
        acceptor.start()
        got["p"] = tcp_connect(host, bound, timeout_s=max(timeout_s,
                                                          30.0))
        acceptor.join()
        links[(p, q)] = got
    link_index = {lk: n for n, lk in enumerate(plan.links())}
    parties = {}
    try:
        for name, labels in plan.parties:
            channels, peer_of = {}, {}
            for p, q in plan.party_links(name):
                peer = q if p == name else p
                side = links[(p, q)]["p" if name == p else "q"]
                seed = 11 + 2 * link_index[(p, q)] \
                    + (0 if name == p else 1)
                channels[peer] = ReliableChannel(
                    side, timeout_s=timeout_s, max_retries=max_retries,
                    backoff_max_s=_backoff_max(timeout_s),
                    fault=_mk_fault(fault, default_seed=seed))
                peer_of[(p, q)] = peer
            transcripts, journals = _party_files(
                plan, name, peer_of, transcript_dir, journal_dir)
            parties[name] = FederationParty(
                name, plan, {lab: data[lab] for lab in labels},
                (ledgers or {}).get(name), channels, journals=journals,
                transcripts=transcripts, recv_timeout_s=recv_timeout_s,
                engine=engine, device=device)
        return _drive_parties(parties)
    finally:
        for got in links.values():
            for side in got.values():
                side.close()
        for srv in servers:
            srv.close()


# ============================================ multi-process plumbing ====

class LinkBroker:
    """Demultiplexes inbound pair-link connections on one listening
    socket — the multi-process party advertises a single port, and each
    dialing peer identifies its link with one plaintext ``fed_id``
    frame before any protocol traffic. The broker routes the identified
    link to the waiting per-peer queue; a redial after a peer's crash
    lands the same way, which is exactly what the acceptor-side
    :class:`ReconnectingTcpLink` pops on reconnect."""

    def __init__(self, srv, party: str, expected):
        self.srv = srv
        self.party = party
        self._queues = {peer: queue.Queue() for peer in expected}
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, name=f"fed-accept-{party}", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop:
            try:
                link = tcp_accept(self.srv, timeout_s=0.5)
            except TransportTimeout:
                continue
            except OSError:
                return
            try:
                frame = json.loads(link.recv_bytes(timeout_s=5.0))
            except (TransportError, ValueError):
                link.close()
                continue
            q = (self._queues.get(frame.get("party"))
                 if isinstance(frame, dict)
                 and frame.get("kind") == "fed_id" else None)
            if q is None:
                link.close()
                continue
            q.put(link)

    def wait(self, peer: str, timeout_s: float):
        """Block until ``peer`` (re)dials this party's port."""
        try:
            return self._queues[peer].get(timeout=timeout_s)
        except queue.Empty:
            raise TransportTimeout(
                f"peer {peer!r} did not dial within {timeout_s:.3g}s"
            ) from None

    def close(self) -> None:
        self._stop = True
        try:
            self.srv.close()
        except OSError:
            pass


def dial_link(host: str, port: int, party: str, pair,
              timeout_s: float = 5.0):
    """Connect one pair link to a listening peer and identify it: the
    ``fed_id`` frame names the dialing party so the broker routes the
    connection before the protocol handshake starts."""
    link = tcp_connect(host, port, timeout_s=timeout_s)
    link.send_bytes(canonical_encode(
        {"kind": "fed_id", "party": party, "pair": list(pair)}))
    return link


def serve_federation_party(name: str, plan: FederationPlan, columns, *,
                           ledger: PrivacyLedger | None = None,
                           listen: tuple | None = None,
                           peers: dict | None = None,
                           transcript_dir: str | None = None,
                           journal_dir: str | None = None,
                           timeout_s: float = 5.0,
                           max_retries: int = 8,
                           connect_timeout_s: float = 30.0,
                           recv_timeout_s: float = 30.0,
                           engine: str = "exact",
                           on_listening=None,
                           registry: Registry | None = None,
                           instance: str | None = None,
                           on_party=None, device=None) -> FederationResult:
    """One real party process of a multi-process federation (the
    ``federation party`` command's body). Topology is plan-derived:
    for each link the *lower* party dials and the higher listens, so a
    party listens iff some lower-indexed peer shares a cell with it
    (``listen`` = (host, port), announced through ``on_listening``)
    and dials every higher-indexed link peer named in ``peers`` =
    ``{peer: (host, port)}``. With ``journal_dir`` every link is
    journaled and its TCP connection redials through peer restarts —
    rerunning this exact invocation after a crash resumes the matrix.
    The party computes on ``device`` (the card unless the caller names
    another)."""
    resolve_device(device)  # raise before any socket opens
    my_idx = plan.party_index(name)
    dial_peers, accept_peers, peer_of = {}, [], {}
    for p, q in plan.party_links(name):
        peer = q if p == name else p
        peer_of[(p, q)] = peer
        if plan.party_index(peer) > my_idx:
            dial_peers[peer] = (p, q)
        else:
            accept_peers.append(peer)
    broker = None
    srv = None
    if accept_peers:
        if listen is None:
            raise ValueError(f"party {name!r} is dialed by "
                             f"{accept_peers} and needs listen=(host, "
                             "port)")
        srv, bound = tcp_listen(listen[0], listen[1])
        broker = LinkBroker(srv, name, accept_peers)
        if on_listening is not None:
            on_listening(listen[0], bound)
    channels = {}
    links = []
    try:
        for peer, (p, q) in dial_peers.items():
            if peers is None or peer not in peers:
                raise ValueError(f"party {name!r} must dial {peer!r}; "
                                 "pass peers={...}")
            host, port = peers[peer]
            pair = (p, q)
            if journal_dir:
                jpath = os.path.join(
                    journal_dir,
                    f"journal.{name}.{plan.link_session(p, q)}.json")
                first = (None if os.path.exists(jpath) else dial_link(
                    host, port, name, pair,
                    timeout_s=connect_timeout_s))
                link = ReconnectingTcpLink(
                    lambda h=host, pt=port, pr=pair: dial_link(
                        h, pt, name, pr, timeout_s=5.0),
                    link=first, max_outage_s=connect_timeout_s)
            else:
                link = dial_link(host, port, name, pair,
                                 timeout_s=connect_timeout_s)
            links.append(link)
            channels[peer] = ReliableChannel(
                link, timeout_s=timeout_s, max_retries=max_retries,
                backoff_max_s=_backoff_max(timeout_s))
        for peer in accept_peers:
            pq = next(lk for lk, pr in peer_of.items() if pr == peer)
            if journal_dir:
                jpath = os.path.join(
                    journal_dir,
                    f"journal.{name}.{plan.link_session(*pq)}.json")
                first = (None if os.path.exists(jpath)
                         else broker.wait(peer, connect_timeout_s))
                link = ReconnectingTcpLink(
                    lambda pr=peer: broker.wait(pr, timeout_s=5.0),
                    link=first, max_outage_s=connect_timeout_s)
            else:
                link = broker.wait(peer, connect_timeout_s)
            links.append(link)
            channels[peer] = ReliableChannel(
                link, timeout_s=timeout_s, max_retries=max_retries,
                backoff_max_s=_backoff_max(timeout_s))
        transcripts, journals = _party_files(
            plan, name, peer_of, transcript_dir, journal_dir)
        party = FederationParty(
            name, plan, columns, ledger, channels, journals=journals,
            transcripts=transcripts, recv_timeout_s=recv_timeout_s,
            engine=engine, registry=registry, instance=instance,
            device=device)
        if on_party is not None:
            # a caller that reports on the live party (its /stats
            # snapshot) gets the object through this hook
            on_party(party)
        return party.run()
    finally:
        for link in links:
            link.close()
        if broker is not None:
            broker.close()
