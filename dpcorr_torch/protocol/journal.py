"""Durable per-session journal: everything a restarted party needs.

Counterpart of ``dpcorr/protocol/journal.py``, in its file format: a
journal written by either package resumes in the other.

The protocol runtime (party.py) is a straight-line script — handshake,
one gated release, one result — so its durable state is small and
append-mostly: which session this is, the resume token, every outbound
wire payload with its charge metadata and ack status, every inbound
body in arrival order, and the finished result. The journal persists
that state with the exact discipline the ledger uses (``{path}.tmp.{pid}``
→ ``fsync`` → ``os.replace``), so a crash leaves either the previous
snapshot or the new one — never a torn file.

Two identities do the heavy lifting on resume:

- **slot ↔ seq.** Outbound slot *k* (0-based order of ``send`` calls)
  is always wire seq *k+1*, because *every* outbound protocol message
  is journaled — including the hello. A restarted party pins each
  replayed send to its journaled seq, so the peer's ReliableChannel
  dedupe set recognises retransmits across the crash.
- **journaled wire bytes are replayed verbatim.** A recomputed message
  would differ (trace headers carry fresh span ids); replaying the
  journaled dict byte-for-byte keeps the peer's view identical to an
  uninterrupted run.

stdlib-only on purpose: journals are read where torch is not installed
and must never pull in the model stack.
"""

from __future__ import annotations

import json
import os
import secrets

from dpcorr_torch.obs.budget_replay import sweep_stale_tmp

_VERSION = 1


class JournalError(ValueError):
    """Journal exists but cannot back this session (corrupt file, or a
    different session/role/spec than the caller is running)."""


def _fresh_state() -> dict:
    return {
        "version": _VERSION,
        "session": None,
        "role": None,
        "spec_hash": None,
        "resume_token": None,
        "trace_id": None,
        "status": "new",          # new -> running -> finished
        "outbound": [],            # [{slot, seq, wire, charges, charge_id, acked}]
        "inbound": [],             # [{seq, body}] in arrival order
        "result": None,
        "meta": {},
    }


class SessionJournal:
    """Crash-safe session state at ``path`` (JSON snapshot).

    Single-threaded by design — party.py drives one session from one
    thread; the journal's only concurrency concern is the *crash*, which
    the tmp+fsync+rename write handles.
    """

    def __init__(self, path: str):
        self.path = str(path)
        # a crash between tmp-write and os.replace strands a
        # ``{path}.tmp.{pid}`` orphan; the dead writer never finishes
        # it, so clear them before loading (same discipline as the
        # ledger snapshot and budget-directory shards)
        sweep_stale_tmp(self.path)
        self._state = self._load()

    # -- persistence -------------------------------------------------

    def _load(self) -> dict:
        if not os.path.exists(self.path):
            return _fresh_state()
        try:
            with open(self.path, encoding="utf-8") as fh:
                state = json.load(fh)
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
            quarantine = self.path + ".corrupt"
            os.replace(self.path, quarantine)
            raise JournalError(
                f"session journal {self.path} is corrupt ({e}); moved to "
                f"{quarantine} — delete it to start the session over, or "
                "restore a good snapshot to resume") from e
        if not isinstance(state, dict) or state.get("version") != _VERSION:
            raise JournalError(
                f"session journal {self.path} has unsupported version "
                f"{state.get('version') if isinstance(state, dict) else state!r}"
                f" (want {_VERSION})")
        return state

    def _persist(self) -> None:
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(self._state, fh, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)

    # -- lifecycle ---------------------------------------------------

    def begin(self, session: str, role: str, spec_hash: str) -> bool:
        """Bind the journal to one (session, role, spec). Returns True
        when this is a resume of prior progress, False for a fresh
        session. A journal for a *different* session/role/spec refuses
        loudly — silently mixing two sessions' state could double-spend.
        """
        st = self._state
        if st["status"] == "new" and st["session"] is None:
            st.update(session=session, role=role, spec_hash=spec_hash,
                      status="running")
            self._persist()
            return False
        for key, want in (("session", session), ("role", role),
                          ("spec_hash", spec_hash)):
            if st[key] != want:
                raise JournalError(
                    f"journal {self.path} belongs to {key}={st[key]!r}, "
                    f"not {key}={want!r}; refusing to mix sessions")
        if st["status"] == "new":
            st["status"] = "running"
            self._persist()
        return True

    @property
    def status(self) -> str:
        return self._state["status"]

    @property
    def session(self):
        return self._state["session"]

    @property
    def trace_id(self):
        return self._state["trace_id"]

    def set_trace(self, trace_id: str) -> None:
        if self._state["trace_id"] != trace_id:
            self._state["trace_id"] = trace_id
            self._persist()

    @property
    def resume_token(self):
        return self._state["resume_token"]

    def ensure_token(self) -> str:
        """Mint (once) the session-resume token the peers exchange in
        the hello; stable across restarts so a resumed handshake can
        authenticate as the same session."""
        if self._state["resume_token"] is None:
            self._state["resume_token"] = secrets.token_hex(16)
            self._persist()
        return self._state["resume_token"]

    def adopt_token(self, token: str) -> None:
        """Peer-supplied token (the non-minting side journals it)."""
        if self._state["resume_token"] != token:
            self._state["resume_token"] = token
            self._persist()

    # -- outbound ----------------------------------------------------

    @property
    def outbound(self) -> list:
        return self._state["outbound"]

    def outbound_entry(self, slot: int):
        out = self._state["outbound"]
        return out[slot] if slot < len(out) else None

    def prepare_outbound(self, slot: int, wire: dict, charges=None,
                         charge_id=None) -> dict:
        """Journal outbound slot ``slot`` before anything irreversible
        (charge, send) happens. Idempotent: re-preparing an existing
        slot returns the journaled entry untouched — the journaled wire
        wins over a recomputed one."""
        out = self._state["outbound"]
        if slot < len(out):
            return out[slot]
        if slot != len(out):
            raise JournalError(
                f"outbound slots must be journaled in order; have "
                f"{len(out)}, got slot {slot}")
        entry = {"slot": slot, "seq": slot + 1, "wire": wire,
                 "charges": charges, "charge_id": charge_id,
                 "acked": False}
        out.append(entry)
        self._persist()
        return entry

    def mark_acked(self, slot: int) -> None:
        entry = self._state["outbound"][slot]
        if not entry["acked"]:
            entry["acked"] = True
            self._persist()

    # -- inbound -----------------------------------------------------

    @property
    def inbound(self) -> list:
        return self._state["inbound"]

    def inbound_entry(self, slot: int):
        ib = self._state["inbound"]
        return ib[slot] if slot < len(ib) else None

    def record_inbound(self, seq: int, body: dict) -> None:
        """ReliableChannel ``on_deliver`` hook: journal each NEW inbound
        message durably *before* the channel acks it, so an ack can
        never outrun durability (ack-then-crash would lose the message
        forever — the peer stops retransmitting acked seqs)."""
        ib = self._state["inbound"]
        if any(e["seq"] == seq for e in ib):
            return
        ib.append({"seq": seq, "body": body})
        self._persist()

    def delivered_seqs(self) -> set:
        return {e["seq"] for e in self._state["inbound"]}

    # -- result ------------------------------------------------------

    @property
    def result(self):
        return self._state["result"]

    def set_result(self, result: dict) -> None:
        self._state["result"] = result
        self._persist()

    def finish(self) -> None:
        if self._state["status"] != "finished":
            self._state["status"] = "finished"
            self._persist()

    # -- metadata ----------------------------------------------------

    @property
    def meta(self) -> dict:
        return self._state["meta"]

    def set_meta(self, **fields) -> None:
        self._state["meta"].update(fields)
        self._persist()
