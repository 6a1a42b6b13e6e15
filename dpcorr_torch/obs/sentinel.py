"""Live invariant sentinel: continuous ε-conservation + durability audit
(counterpart of ``dpcorr/obs/sentinel.py``, with its checkpoint format
and violation signatures: either package's sentinel resumes from the
other's checkpoint without alerting twice).

The other proof surfaces are *batch*: ``obs budget`` replays a finished
trail, ``obs provenance`` merges finished transcripts, ``protocol
scan`` and the fleet conservation gate run after the fact. This module
is the live form — a daemon that imports no torch (``python -m
dpcorr_torch obs watch``) and **tails the durable artifacts every
subsystem already writes** and re-proves the invariants incrementally,
within a poll of the write:

- serve / stream / party **audit trails** (:mod:`dpcorr_torch.obs.audit`
  JSONL): contiguous ``seq``, the ledger's charge-id idempotency
  (a re-charge must carry ``dedup`` — a bare duplicate spend is
  tampering), and the running per-party ε fold;
- **budget directories** (:mod:`dpcorr_torch.obs.budget_replay` is the
  shared fold core): each user's on-disk lifetime (snapshot + WAL,
  the exact recovery arithmetic) must equal the trail's ``user/``
  legs;
- **stream ingest WAL + release journal** (:mod:`dpcorr_torch.stream.wal`):
  monotone seqs, one release per window, byte-stable release
  artifacts;
- **protocol / federation transcripts + session journals**: a column
  label released as two distinct byte encodings is a correlation
  leak; an artifact charged in two rounds is an ε leak; an
  unparseable session journal breaks resume;
- scraped ``/metrics`` **ledger gauges**: the trail fold and the live
  ``dpcorr_ledger_spent_eps`` series must agree (ε conservation,
  continuously).

State is **bounded**: offsets + prefix digests per tailed file,
FIFO-capped charge-id / label-digest / window-digest tables, one float
per principal for the ε fold. Progress is checkpointed to an fsynced
JSON file after every poll, together with the signatures of violations
already raised — a restarted sentinel resumes at its offsets and never
re-alerts on re-read (the crash-exactness discipline applied to the
auditor itself).

Chaos-clean by construction: the *legal* artifacts of crash recovery
are explicitly not violations — a torn final line is simply never
consumed until its newline lands, a replayed charge arrives
``dedup``-flagged and spends nothing, a journal-skipped (refused)
window was never journaled at all, and the conservation check only
fires after the same mismatch is observed on two consecutive polls (a
scrape racing a charge is not drift). What *does* fire is typed with
:data:`VIOLATION_KINDS` — the provenance vocabulary plus four live
kinds — and each violation names the offending artifact/party, bumps
``dpcorr_sentinel_violations_total``, arms the offender's flight
recorder (``POST /obs/trigger`` reason=``sentinel_violation``) and
pages through the same multi-window burn-rate machinery as every other
SLO (:mod:`dpcorr_torch.obs.slo`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
import urllib.error
import urllib.request

from dpcorr_torch.obs.audit import EVENT_KINDS
from dpcorr_torch.obs.budget_replay import USER_PREFIX, fold_levels
from dpcorr_torch.obs.metrics import Registry, parse_exposition
from dpcorr_torch.obs.provenance import DIVERGENCE_KINDS

__all__ = ["Sentinel", "Violation", "VIOLATION_KINDS",
           "arm_offender_hook"]

#: The full violation vocabulary: every provenance divergence kind the
#: batch auditors speak, plus the four kinds only a live tailer can
#: see. Append-only, like DIVERGENCE_KINDS and TRIGGER_REASONS.
VIOLATION_KINDS = DIVERGENCE_KINDS + (
    "conservation-drift",  # trail fold != ledger gauge / directory fold
    "double-release",      # one window journaled twice, identical bytes
    "wal-regression",      # consumed bytes rewritten/shrunk, or a
                           # monotone seq went backwards
    "checkpoint-gap",      # a gap: missing seq or unparseable line
                           # mid-file (not a torn tail)
)

#: Idempotency memory caps — the sentinel's tables are FIFO-bounded so
#: an unbounded event log cannot grow the verifier (the ledger's own
#: _CHARGE_ID_CAP discipline, sized generously above it).
_SEEN_CAP = 65536
_DIGEST_CAP = 8192

_EPS_TOL = 1e-6


@dataclasses.dataclass(frozen=True)
class Violation:
    """One detected invariant break. ``signature`` identifies the
    violation across polls *and* restarts — it is what the checkpoint
    remembers so nothing ever alerts twice."""

    kind: str
    source: str    # watcher name, e.g. "stream1" — the offender
    artifact: str  # offending file / party / principal
    detail: str
    at: float

    def __post_init__(self):
        assert self.kind in VIOLATION_KINDS, self.kind

    @property
    def signature(self) -> str:
        blob = json.dumps([self.kind, self.source, self.artifact,
                           self.detail], sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["signature"] = self.signature
        return d


def _sha256_prefix(path: str, length: int) -> str:
    h = hashlib.sha256()
    remaining = length
    with open(path, "rb") as fh:
        while remaining > 0:
            chunk = fh.read(min(1 << 20, remaining))
            if not chunk:
                break
            remaining -= len(chunk)
            h.update(chunk)
    return h.hexdigest()


class _FifoSet:
    """Insertion-ordered membership with a FIFO cap (dict-keyed, the
    ledger's own idempotency-memory shape). Serializable."""

    def __init__(self, cap: int, items=()):
        self.cap = int(cap)
        self._d: dict[str, None] = {str(k): None for k in items}

    def add(self, key: str) -> None:
        self._d[str(key)] = None
        while len(self._d) > self.cap:
            self._d.pop(next(iter(self._d)))

    def discard(self, key: str) -> None:
        self._d.pop(str(key), None)

    def __contains__(self, key: str) -> bool:
        return str(key) in self._d

    def to_list(self) -> list[str]:
        return list(self._d)


class _FifoDict:
    """FIFO-capped str→value table (digest / total memories)."""

    def __init__(self, cap: int, items: dict | None = None):
        self.cap = int(cap)
        self._d: dict[str, object] = dict(items or {})

    def get(self, key: str, default=None):
        return self._d.get(str(key), default)

    def set(self, key: str, value) -> None:
        self._d[str(key)] = value
        while len(self._d) > self.cap:
            self._d.pop(next(iter(self._d)))

    def __contains__(self, key: str) -> bool:
        return str(key) in self._d

    def items(self):
        return self._d.items()

    def to_dict(self) -> dict:
        return dict(self._d)


class _Tail:
    """Incremental tailer over one append-only JSONL file with the
    repo's durability grammar baked in:

    - bytes up to ``offset`` were consumed; their sha256 is pinned, so
      any in-place rewrite or truncation of consumed history is a
      ``wal-regression`` (the one thing an append-only store can never
      legally do);
    - a final line without a trailing newline is a *torn tail* — the
      legal residue of a crash mid-append — and simply stays pending
      until its newline lands (or forever: an unacked write is not
      data);
    - a complete line that fails to parse is mid-file corruption —
      ``checkpoint-gap`` — exactly the case the stores themselves
      quarantine on recovery.

    ``on_record(record, line_bytes, emit)`` runs the store-specific
    checks per consumed line.
    """

    def __init__(self, source: str, path: str):
        self.source = source
        self.path = path
        self.offset = 0
        self.digest = hashlib.sha256(b"").hexdigest()
        self.poisoned = False  # structural break found; stop consuming

    # -- checkpoint plumbing ------------------------------------------
    def state(self) -> dict:
        return {"offset": self.offset, "digest": self.digest,
                "poisoned": self.poisoned}

    def restore(self, st: dict) -> None:
        self.offset = int(st.get("offset", 0))
        self.digest = str(st.get("digest", self.digest))
        self.poisoned = bool(st.get("poisoned", False))

    # -- one poll ------------------------------------------------------
    def poll(self, emit, on_record, at: float) -> int:
        """Consume every newly completed line; returns bytes consumed.
        ``emit(kind, artifact, detail)`` raises the violation."""
        if self.poisoned:
            return 0
        try:
            size = os.path.getsize(self.path)
        except OSError:
            size = 0
        if size < self.offset:
            self.poisoned = True
            emit("wal-regression", self.path,
                 f"file shrank to {size} bytes below the consumed "
                 f"offset {self.offset} — durable history was "
                 f"truncated or rewound")
            return 0
        if self.offset and _sha256_prefix(self.path,
                                          self.offset) != self.digest:
            self.poisoned = True
            emit("wal-regression", self.path,
                 f"consumed prefix ({self.offset} bytes) no longer "
                 f"matches its recorded sha256 — append-only history "
                 f"was rewritten in place")
            return 0
        if size == self.offset:
            return 0
        with open(self.path, "rb") as fh:
            fh.seek(self.offset)
            blob = fh.read(size - self.offset)
        # only consume through the last newline: the remainder is a
        # (possibly torn) tail still being written
        cut = blob.rfind(b"\n")
        if cut < 0:
            return 0
        consumed = blob[:cut + 1]
        for i, raw in enumerate(consumed.split(b"\n")[:-1]):
            line = raw.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                self.poisoned = True
                emit("checkpoint-gap", self.path,
                     f"unparseable line mid-file at byte "
                     f"{self.offset} (+{i} lines): {e} — not a torn "
                     f"tail; the store itself would quarantine this")
                return 0
            on_record(rec, line, emit)
        self.offset += len(consumed)
        self.digest = _sha256_prefix(self.path, self.offset)
        return len(consumed)


class _AuditWatcher:
    """Incremental :func:`dpcorr_torch.obs.audit.replay` with the live-only
    checks batch replay cannot ask: contiguous seq, and the rule that
    a duplicate spend of a remembered charge id must be
    ``dedup``-flagged (the ledger always flags its replays — a bare
    duplicate line is an injected double charge)."""

    def __init__(self, source: str, path: str):
        self.source = source
        self.tail = _Tail(source, path)
        self.last_seq: int | None = None
        self.spent: dict[str, float] = {}
        self.applied = _FifoSet(_SEEN_CAP)
        #: charge_id → total ε it charged (stream cross-check memory)
        self.charge_totals = _FifoDict(_DIGEST_CAP)

    def state(self) -> dict:
        return {"tail": self.tail.state(), "last_seq": self.last_seq,
                "spent": dict(self.spent),
                "applied": self.applied.to_list(),
                "charge_totals": self.charge_totals.to_dict()}

    def restore(self, st: dict) -> None:
        self.tail.restore(st.get("tail", {}))
        self.last_seq = st.get("last_seq")
        self.spent = {str(k): float(v)
                      for k, v in st.get("spent", {}).items()}
        self.applied = _FifoSet(_SEEN_CAP, st.get("applied", ()))
        self.charge_totals = _FifoDict(
            _DIGEST_CAP, st.get("charge_totals", {}))

    def levels(self) -> dict[str, dict]:
        return fold_levels(self.spent)

    def poll(self, emit, at: float) -> int:
        return self.tail.poll(emit, self._event, at)

    def _event(self, ev: dict, raw: bytes, emit) -> None:
        if not isinstance(ev, dict) or ev.get("kind") not in EVENT_KINDS:
            emit("checkpoint-gap", self.tail.path,
                 f"line is not an audit event: {ev!r:.120}")
            return
        seq = int(ev.get("seq", -1))
        if self.last_seq is not None:
            if seq <= self.last_seq:
                emit("wal-regression", self.tail.path,
                     f"audit seq went backwards: {seq} after "
                     f"{self.last_seq} (a duplicated or replayed line)")
            elif seq != self.last_seq + 1:
                emit("checkpoint-gap", self.tail.path,
                     f"audit seq gap: {seq} after {self.last_seq} — "
                     f"events were dropped from the trail")
        self.last_seq = max(seq, self.last_seq or seq)
        kind, cid = ev["kind"], ev.get("charge_id")
        # the ledger's idempotency arithmetic, incrementally
        # (mirrors audit._dedup_walk / replay exactly)
        if kind == "charge" and cid is not None:
            if cid in self.applied:
                if not ev.get("dedup"):
                    emit("double-charged-artifact", self.tail.path,
                         f"charge id {cid!r} spent twice without the "
                         f"ledger's dedup flag — an injected double "
                         f"charge, not a crash replay")
                return
            self.applied.add(cid)
        elif kind == "refund" and cid is not None:
            self.applied.discard(cid)
        if kind == "charge":
            total = 0.0
            for p, e in ev.get("charges", {}).items():
                self.spent[p] = self.spent.get(p, 0.0) + float(e)
                # the per-charge total is *party* ε — the derived
                # user/global legs mirror it, they don't add to it
                if not (p.startswith(USER_PREFIX)
                        or p.startswith("global/")):
                    total += float(e)
            if cid is not None:
                self.charge_totals.set(cid, total)
        elif kind == "refund":
            for p, e in ev.get("charges", {}).items():
                self.spent[p] = max(0.0,
                                    self.spent.get(p, 0.0) - float(e))


class _StreamWatcher:
    """Ingest-WAL + release-journal invariants for one stream workdir:
    monotone contiguous seqs on both logs, one journal entry per
    window (byte-stable: an identical re-append is ``double-release``,
    a perturbed one is ``re-noised-artifact``), and every journaled
    window's idempotent charge id present exactly once in the
    workdir's own audit trail with the entry's ``eps_window``."""

    def __init__(self, source: str, workdir: str):
        self.source = source
        self.workdir = workdir
        self.wal = _Tail(source, os.path.join(workdir, "wal.jsonl"))
        self.journal = _Tail(source,
                             os.path.join(workdir, "releases.jsonl"))
        self.audit = _AuditWatcher(source,
                                   os.path.join(workdir, "audit.jsonl"))
        self.wal_seq: int | None = None
        self.release_seq: int | None = None
        #: window_id → sha256 of the entry minus release_seq
        self.window_digests = _FifoDict(_DIGEST_CAP)
        #: journaled charges awaiting their audit line (one-poll grace:
        #: the journal append trails the charge, never leads it)
        self.pending_charges: dict[str, float] = {}

    def state(self) -> dict:
        return {"wal": self.wal.state(), "journal": self.journal.state(),
                "audit": self.audit.state(), "wal_seq": self.wal_seq,
                "release_seq": self.release_seq,
                "window_digests": self.window_digests.to_dict(),
                "pending_charges": dict(self.pending_charges)}

    def restore(self, st: dict) -> None:
        self.wal.restore(st.get("wal", {}))
        self.journal.restore(st.get("journal", {}))
        self.audit.restore(st.get("audit", {}))
        self.wal_seq = st.get("wal_seq")
        self.release_seq = st.get("release_seq")
        self.window_digests = _FifoDict(
            _DIGEST_CAP, st.get("window_digests", {}))
        self.pending_charges = {
            str(k): float(v)
            for k, v in st.get("pending_charges", {}).items()}

    def poll(self, emit, at: float) -> int:
        n = self.audit.poll(emit, at)
        # charges journaled on a *previous* poll must have their audit
        # line by now (the service charges before it journals) —
        # checked before this round's journal poll so a charge whose
        # trail append raced our last audit read gets one full round
        for cid, want in list(self.pending_charges.items()):
            got = self.audit.charge_totals.get(cid)
            if got is None:
                emit("tampered-charge", self.journal.path,
                     f"journaled window charge {cid!r} never appeared "
                     f"in the audit trail — a release without its ε")
            elif abs(float(got) - want) > _EPS_TOL:
                emit("eps-total-mismatch", self.journal.path,
                     f"charge {cid!r}: journal says eps_window={want}, "
                     f"audit trail charged {got}")
            del self.pending_charges[cid]
        n += self.wal.poll(emit, self._wal_record, at)
        n += self.journal.poll(emit, self._journal_record, at)
        return n

    def _wal_record(self, rec: dict, raw: bytes, emit) -> None:
        seq = int(rec.get("seq", 0))
        if self.wal_seq is not None:
            if seq <= self.wal_seq:
                emit("wal-regression", self.wal.path,
                     f"ingest WAL seq went backwards: {seq} after "
                     f"{self.wal_seq}")
            elif seq != self.wal_seq + 1:
                emit("checkpoint-gap", self.wal.path,
                     f"ingest WAL seq gap: {seq} after {self.wal_seq} "
                     f"— acked batches were dropped")
        self.wal_seq = max(seq, self.wal_seq or seq)

    def _journal_record(self, rec: dict, raw: bytes, emit) -> None:
        wid = str(rec.get("window_id"))
        body = {k: v for k, v in rec.items() if k != "release_seq"}
        digest = hashlib.sha256(
            json.dumps(body, sort_keys=True).encode()).hexdigest()
        prior = self.window_digests.get(wid)
        if prior is not None:
            if prior == digest:
                emit("double-release", self.journal.path,
                     f"window {wid} journaled twice with identical "
                     f"bytes — one release served as two")
            else:
                emit("re-noised-artifact", self.journal.path,
                     f"window {wid} re-journaled with different bytes "
                     f"— a re-noised substitute of a released "
                     f"artifact (noise averaging leak)")
            return
        self.window_digests.set(wid, digest)
        seq = int(rec.get("release_seq", 0))
        if self.release_seq is not None:
            if seq <= self.release_seq:
                emit("wal-regression", self.journal.path,
                     f"release_seq went backwards: {seq} after "
                     f"{self.release_seq} (window {wid})")
                # a known-tampered entry spawns no derived checks —
                # one injected line is one alert, not a cascade
                return
            if seq != self.release_seq + 1:
                emit("checkpoint-gap", self.journal.path,
                     f"release_seq gap: {seq} after {self.release_seq} "
                     f"(window {wid}) — a release vanished")
        self.release_seq = max(seq, self.release_seq or seq)
        cid = rec.get("charge_id")
        if cid is not None:
            got = self.audit.charge_totals.get(cid)
            want = float(rec.get("eps_window", 0.0))
            if got is None:
                # audit line may land this same poll round; grace it
                self.pending_charges[str(cid)] = want
            elif abs(float(got) - want) > _EPS_TOL:
                emit("eps-total-mismatch", self.journal.path,
                     f"charge {cid!r}: journal says eps_window={want}, "
                     f"audit trail charged {got}")


class _TranscriptWatcher:
    """Incremental form of the cross-pair correlation-leak gate
    (:func:`dpcorr_torch.protocol.scan.scan_federation`): per released
    column label, the canonical encoding's sha256 must be identical in
    every session that carries it, and each artifact may be charged in
    exactly one (session, round) venue."""

    def __init__(self, source: str, directory: str):
        self.source = source
        self.directory = directory
        self.tails: dict[str, _Tail] = {}
        self.label_digests = _FifoDict(_DIGEST_CAP)
        self.charge_venues = _FifoDict(_DIGEST_CAP)

    def state(self) -> dict:
        return {"tails": {p: t.state() for p, t in self.tails.items()},
                "label_digests": self.label_digests.to_dict(),
                "charge_venues": self.charge_venues.to_dict()}

    def restore(self, st: dict) -> None:
        for p, ts in st.get("tails", {}).items():
            t = _Tail(self.source, p)
            t.restore(ts)
            self.tails[p] = t
        self.label_digests = _FifoDict(
            _DIGEST_CAP, st.get("label_digests", {}))
        self.charge_venues = _FifoDict(
            _DIGEST_CAP, st.get("charge_venues", {}))

    def _discover(self) -> None:
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return
        for name in names:
            if not name.endswith(".jsonl"):
                continue
            path = os.path.join(self.directory, name)
            if path not in self.tails:
                self.tails[path] = _Tail(self.source, path)

    def poll(self, emit, at: float) -> int:
        self._discover()
        return sum(t.poll(emit, self._entry, at)
                   for t in sorted(self.tails.values(),
                                   key=lambda t: t.path))

    def _entry(self, entry: dict, raw: bytes, emit) -> None:
        from dpcorr_torch.protocol.messages import canonical_encode

        w = entry.get("wire") if isinstance(entry, dict) else None
        if not isinstance(w, dict):
            return
        sess = w.get("session", "?")
        payload = w.get("payload") or {}
        mtype = w.get("msg_type")
        if mtype == "release" and isinstance(payload.get("artifacts"),
                                             dict):
            for lab, group in payload["artifacts"].items():
                enc = (canonical_encode(group) if isinstance(group, dict)
                       else repr(group).encode())
                digest = hashlib.sha256(enc).hexdigest()
                prior = self.label_digests.get(lab)
                if prior is not None and prior != digest:
                    emit("re-noised-artifact", str(lab),
                         f"column {lab!r} released as different bytes "
                         f"in session {sess!r} than previously seen — "
                         f"re-noised releases of one column are "
                         f"subtractable")
                elif prior is None:
                    self.label_digests.set(lab, digest)
        if mtype in ("release", "result"):
            side = "x" if mtype == "release" else "y"
            for lab in payload.get("charged", ()) or ():
                key = f"{side}:{lab}"
                venue = [str(sess), str(payload.get("round"))]
                prior = self.charge_venues.get(key)
                if prior is not None and list(prior) != venue:
                    emit("double-charged-artifact", str(lab),
                         f"artifact ({side}, {lab!r}) charged in "
                         f"{prior} and again in {venue} — the plan "
                         f"charges each artifact exactly once")
                elif prior is None:
                    self.charge_venues.set(key, venue)


class _JournalFileWatcher:
    """Session-journal durability: every ``journal.*.json`` snapshot
    in the directory must stay a parseable JSON object (tmp + fsync +
    rename writes can leave no other legal state — an unparseable
    journal is tampering, and it breaks crash resume)."""

    def __init__(self, source: str, directory: str):
        self.source = source
        self.directory = directory

    def state(self) -> dict:
        return {}

    def restore(self, st: dict) -> None:
        pass

    def poll(self, emit, at: float) -> int:
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return 0
        for name in names:
            if not (name.startswith("journal.")
                    and name.endswith(".json")):
                continue
            path = os.path.join(self.directory, name)
            try:
                with open(path, encoding="utf-8") as fh:
                    doc = json.load(fh)
                if not isinstance(doc, dict):
                    raise ValueError("not an object")
            except (OSError, ValueError) as e:
                emit("checkpoint-gap", path,
                     f"session journal unreadable: {e} — resume from "
                     f"this journal is broken")
        return 0


class _ConservationCheck:
    """ε-conservation between an audit watcher's running fold and a
    live reference — the scraped ``dpcorr_ledger_spent_eps`` gauges
    and/or a budget directory's on-disk user balances. Debounced: the
    same mismatch must hold on two consecutive polls (a scrape racing
    a charge, or a trail line landing a poll behind its gauge, is not
    drift — drift is a disagreement that *persists* at quiescence)."""

    def __init__(self, source: str, audit: _AuditWatcher,
                 url: str | None = None,
                 budget_dir: str | None = None,
                 timeout_s: float = 5.0):
        self.source = source
        self.audit = audit
        self.url = url.rstrip("/") if url else None
        self.budget_dir = budget_dir
        self.timeout_s = timeout_s
        self._last_mismatch: dict[str, tuple] = {}

    def state(self) -> dict:
        return {}

    def restore(self, st: dict) -> None:
        pass

    def _debounced(self, key: str, pair: tuple, emit, artifact: str,
                   detail: str) -> None:
        if self._last_mismatch.get(key) == pair:
            emit("conservation-drift", artifact, detail)
            del self._last_mismatch[key]
        else:
            self._last_mismatch[key] = pair

    def poll(self, emit, at: float) -> int:
        levels = self.audit.levels()
        seen: set[str] = set()
        if self.url is not None:
            try:
                with urllib.request.urlopen(
                        f"{self.url}/metrics",
                        timeout=self.timeout_s) as resp:
                    series = parse_exposition(
                        resp.read().decode("utf-8"))
            except (urllib.error.URLError, OSError, ValueError):
                series = None  # a down instance is not ε drift
            if series is not None:
                gauges = {}
                for key, value in series.items():
                    if key.startswith('dpcorr_ledger_spent_eps{party="'):
                        party = key.split('party="', 1)[1].rsplit('"', 1)[0]
                        gauges[party] = value
                fold = dict(levels.get("party", {}))
                fold.update(levels.get("global", {}))
                for party in sorted(set(gauges) | set(fold)):
                    want, got = fold.get(party, 0.0), gauges.get(party,
                                                                 0.0)
                    key = f"gauge:{party}"
                    seen.add(key)
                    if abs(want - got) > _EPS_TOL:
                        self._debounced(
                            key, (round(want, 9), round(got, 9)), emit,
                            party,
                            f"audit-trail fold says {party!r} spent "
                            f"{want:.9g} but the live ledger gauge "
                            f"reads {got:.9g} — ε is not conserved")
        if self.budget_dir is not None and os.path.isdir(self.budget_dir):
            from dpcorr_torch.obs.budget_replay import read_user_balances

            replayed = {p[len(USER_PREFIX):]: s
                        for p, s in self.audit.spent.items()
                        if p.startswith(USER_PREFIX)}
            try:
                balances = read_user_balances(self.budget_dir)
            except ValueError as e:
                emit("checkpoint-gap", self.budget_dir,
                     f"budget directory unreadable: {e}")
                balances = {}
            for user in sorted(set(replayed) | set(balances)):
                want = replayed.get(user, 0.0)
                got = balances.get(user, {}).get("l", 0.0)
                key = f"dir:{user}"
                seen.add(key)
                if abs(want - got) > _EPS_TOL:
                    self._debounced(
                        key, (round(want, 9), round(got, 9)), emit,
                        f"{USER_PREFIX}{user}",
                        f"audit-trail fold says user {user!r} spent "
                        f"{want:.9g} lifetime but the budget "
                        f"directory reconstructs {got:.9g}")
        # a mismatch that healed (values moved) resets its debounce
        for key in list(self._last_mismatch):
            if key not in seen:
                del self._last_mismatch[key]
        return 0


def arm_offender_hook(urls, timeout_s: float = 5.0):
    """Violation hook: POST the violation to the *offending* source's
    ``/obs/trigger`` endpoint with reason ``sentinel_violation`` — the
    flight recorder dumps inside the offender, next to its rings
    (the :func:`dpcorr_torch.obs.slo.http_trigger_hook` shape). Never raises:
    an unreachable offender is already the incident."""
    def hook(violation: Violation) -> None:
        base = urls.get(violation.source)
        if base is None:
            return
        body = json.dumps({"reason": "sentinel_violation",
                           "detail": violation.to_dict()}).encode()
        req = urllib.request.Request(
            f"{base.rstrip('/')}/obs/trigger", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout_s):
                pass
        except (urllib.error.URLError, OSError):
            pass
    return hook


class Sentinel:
    """The live invariant watchdog: a set of incremental watchers, one
    fsynced checkpoint, one metrics registry, one burn-rate engine.

    Construct, attach sources (:meth:`add_stream`, :meth:`add_audit`,
    :meth:`add_transcripts`, :meth:`add_journals`), then drive
    :meth:`poll` on an interval (or :meth:`run`). Each poll consumes
    newly durable bytes, runs every check, pages on anything new, and
    checkpoints — so a killed sentinel restarted from the same
    checkpoint resumes mid-file and stays silent about everything it
    already raised.
    """

    CHECKPOINT_VERSION = 1

    def __init__(self, checkpoint: str, *,
                 registry: Registry | None = None,
                 instance: str = "sentinel",
                 urls: dict[str, str] | None = None,
                 on_violation=None, on_page=None,
                 clock=time.time, fsync: bool = True,
                 scrape_timeout_s: float = 5.0):
        self.checkpoint_path = checkpoint
        self.instance = instance
        self.urls = dict(urls or {})
        self.clock = clock
        self.fsync = fsync
        self.scrape_timeout_s = scrape_timeout_s
        self.registry = registry if registry is not None else Registry()
        self.on_violation = on_violation
        self._arm = arm_offender_hook(self.urls,
                                      timeout_s=scrape_timeout_s)
        self._watchers: dict[str, object] = {}
        self._alerted = _FifoSet(_SEEN_CAP)
        self.violations: list[Violation] = []  # new this run, in order

        self._info_g = self.registry.gauge(
            "dpcorr_sentinel_instance_info",
            "sentinel identity: constant 1 labelled by instance name",
            labelnames=("instance",))
        self._info_g.set(1, instance=instance)
        self._polls = self.registry.counter(
            "dpcorr_sentinel_polls_total", "Sentinel poll rounds")
        self._checks = self.registry.counter(
            "dpcorr_sentinel_checks_total",
            "Invariant checks performed (watcher-polls)")
        self._violations_c = self.registry.counter(
            "dpcorr_sentinel_violations_total",
            "Invariant violations by kind", labelnames=("kind",))
        self._bytes = self.registry.counter(
            "dpcorr_sentinel_consumed_bytes_total",
            "Durable bytes consumed and verified")
        self._watchers_g = self.registry.gauge(
            "dpcorr_sentinel_watchers", "Attached watchers")
        self._last_poll_g = self.registry.gauge(
            "dpcorr_sentinel_last_poll_ts",
            "Wall timestamp of the last completed poll")

        # violations page through the standard multi-window burn-rate
        # machinery (obs.slo): zero-tolerance error objective over the
        # sentinel's own exposition — any violation is an instant,
        # confirmed burn, and the page arms the flight recorder
        # through the engine's existing hook indirection.
        from dpcorr_torch.obs import slo as _slo

        self._engine = _slo.BurnRateEngine(
            [_slo.Objective(
                name="sentinel-violations", kind="error", target=1e-9,
                total_series=("dpcorr_sentinel_checks_total",),
                bad_series=("dpcorr_sentinel_violations_total",))],
            clock=self.clock,
            on_page=(on_page if on_page is not None
                     else _slo.recorder_trigger_hook(
                         sentinel=instance)))
        self._load_checkpoint()

    # -- wiring --------------------------------------------------------
    def add_stream(self, name: str, workdir: str,
                   url: str | None = None) -> None:
        """Watch one stream workdir (wal/releases/audit + budget_dir
        when present); ``url`` adds the live ledger-gauge conservation
        check and makes the stream armable on violation."""
        w = _StreamWatcher(name, workdir)
        self._watchers[f"{name}/stream"] = w
        bd = os.path.join(workdir, "budget_dir")
        self._watchers[f"{name}/conservation"] = _ConservationCheck(
            name, w.audit, url=url or self.urls.get(name),
            budget_dir=bd if os.path.isdir(bd) else None,
            timeout_s=self.scrape_timeout_s)
        if url is not None:
            self.urls[name] = url

    def add_audit(self, name: str, path: str, url: str | None = None,
                  budget_dir: str | None = None) -> None:
        """Watch one bare audit trail (a serve replica or a protocol
        party); ``url``/``budget_dir`` add the conservation legs."""
        w = _AuditWatcher(name, path)
        self._watchers[f"{name}/audit"] = w
        if url is not None or budget_dir is not None:
            self._watchers[f"{name}/conservation"] = _ConservationCheck(
                name, w, url=url or self.urls.get(name),
                budget_dir=budget_dir, timeout_s=self.scrape_timeout_s)
        if url is not None:
            self.urls[name] = url

    def add_transcripts(self, name: str, directory: str) -> None:
        """Watch a directory of pair-link transcripts for byte-stable
        reuse and exactly-once artifact charging."""
        self._watchers[f"{name}/transcripts"] = _TranscriptWatcher(
            name, directory)

    def add_journals(self, name: str, directory: str) -> None:
        """Watch a directory of session-journal snapshots."""
        self._watchers[f"{name}/journals"] = _JournalFileWatcher(
            name, directory)

    # -- checkpoint ----------------------------------------------------
    def _load_checkpoint(self) -> None:
        try:
            with open(self.checkpoint_path, encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return
        if doc.get("version") != self.CHECKPOINT_VERSION:
            return
        self._alerted = _FifoSet(_SEEN_CAP, doc.get("alerted", ()))
        self._pending_restore = doc.get("watchers", {})
        for key, st in self._pending_restore.items():
            w = self._watchers.get(key)
            if w is not None:
                w.restore(st)

    def _restore_late(self) -> None:
        """Watchers attached after construction pick up their state on
        the first poll (the CLI builds the sentinel, then wires)."""
        pend = getattr(self, "_pending_restore", None)
        if not pend:
            return
        for key, st in pend.items():
            w = self._watchers.get(key)
            if w is not None:
                w.restore(st)
        self._pending_restore = None

    def save_checkpoint(self) -> None:
        doc = {"version": self.CHECKPOINT_VERSION,
               "instance": self.instance,
               "alerted": self._alerted.to_list(),
               "watchers": {k: w.state()
                            for k, w in self._watchers.items()}}
        d = os.path.dirname(self.checkpoint_path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{self.checkpoint_path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, sort_keys=True)
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())
        os.replace(tmp, self.checkpoint_path)

    # -- polling -------------------------------------------------------
    def poll(self, at: float | None = None) -> list[Violation]:
        """One verification round over every watcher; returns the NEW
        violations (never anything already alerted — this run or any
        checkpointed previous run)."""
        self._restore_late()
        t = float(at) if at is not None else self.clock()
        new: list[Violation] = []

        def emitter(source: str):
            def emit(kind: str, artifact: str, detail: str) -> None:
                v = Violation(kind=kind, source=source,
                              artifact=str(artifact), detail=detail,
                              at=t)
                if v.signature in self._alerted:
                    return
                self._alerted.add(v.signature)
                new.append(v)
            return emit

        # tails first, conservation second: the cross-checks must see
        # the fold *including* everything this round consumed
        ordered = sorted(self._watchers)
        for pass_cons in (False, True):
            for key in ordered:
                w = self._watchers[key]
                if isinstance(w, _ConservationCheck) != pass_cons:
                    continue
                self._checks.inc()
                self._bytes.inc(w.poll(emitter(w.source), t))
        for v in new:
            self.violations.append(v)
            self._violations_c.inc(kind=v.kind)
            self._arm(v)
            if self.on_violation is not None:
                self.on_violation(v)
        self._polls.inc()
        self._watchers_g.set(float(len(self._watchers)))
        self._last_poll_g.set(t)
        # feed the burn-rate engine off our own exposition — the same
        # series a remote SLO evaluator would scrape
        from dpcorr_torch.obs.fleet import parse_families

        self._engine.observe(
            {self.instance: parse_families(self.registry.render())},
            at=t)
        self._engine.evaluate(at=t)
        self.save_checkpoint()
        return new

    def run(self, interval_s: float = 1.0,
            max_polls: int | None = None,
            stop: threading.Event | None = None) -> int:
        """The daemon loop; returns the CI exit code (1 if this run
        raised any violation)."""
        polls = 0
        while True:
            self.poll()
            polls += 1
            if max_polls is not None and polls >= max_polls:
                break
            if stop is not None and stop.wait(interval_s):
                break
            if stop is None:
                time.sleep(interval_s)
        return self.rc

    @property
    def rc(self) -> int:
        return 1 if self.violations else 0

    def stats(self) -> dict:
        """The ``/stats`` snapshot for the sentinel's own obs
        endpoint (:mod:`dpcorr_torch.obs.endpoint`)."""
        return {
            "kind": "sentinel",
            "instance": self.instance,
            "watchers": sorted(self._watchers),
            "violations": [v.to_dict() for v in self.violations[-64:]],
            "violations_total": len(self.violations),
            "pages": [a.to_dict() for a in self._engine.alerts[-16:]],
            "checkpoint": self.checkpoint_path,
        }
