"""Versioned protocol messages, canonical bytes, transcript log.

Counterpart of ``dpcorr/protocol/messages.py``: the same bytes.

Everything that crosses the wire is one :class:`Message` serialized by
:func:`canonical_encode` — ``json.dumps`` with sorted keys, no
whitespace, ``allow_nan=False`` — so a given logical message has
exactly one byte representation. That determinism is load-bearing
twice: transcript replay is byte-comparable across runs (the
determinism test diffs serialized payloads, not floats), and the
transcript scanner can reason about payload bytes without a parser
ambiguity. Arrays cross as an explicit tagged envelope
(:func:`encode_array`): dtype + shape + base64 of the raw
little-endian buffer — lossless for float32, so the wire never
perturbs a release bit.

The :class:`Transcript` is each party's own JSONL log of every frame it
sent or received — direction, sequence number, wire size, retries,
latency, the ε charged for gated sends, the trace ID, and the full wire
dict. It is deliberately *complete*: the no-raw-columns audit
(protocol.scan) works on transcripts alone, so anything omitted here
would be invisible to the audit. Torch-free on purpose: the scanner
imports this module where torch is not installed.
"""

from __future__ import annotations

import base64
import json
import os
import threading
import time
from dataclasses import asdict, dataclass, field

PROTOCOL_VERSION = 1

#: Closed message vocabulary. ``hello``/``hello_ack`` pin the spec hash
#: (both parties prove they run the same design point before any ε is
#: spent); ``release`` carries the releaser's DP payload; ``result``
#: carries the finisher's (ρ̂, CI) back; ``error`` aborts (budget
#: refusal, validation failure) — it never carries arrays.
MSG_TYPES = ("hello", "hello_ack", "release", "result", "error")


def canonical_encode(obj: dict) -> bytes:
    """The one byte encoding of a wire object: key-sorted, minimal
    separators, NaN/Inf rejected (they would deserialize
    non-canonically and a NaN release is a protocol bug, not data)."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      allow_nan=False).encode("utf-8")


def encode_array(values, kind: str) -> dict:
    """Array → wire envelope. ``kind`` names *what DP release* the
    array is (e.g. ``"noisy_sign_batch_means"``) — the scanner and the
    receiving party validate it against the family's release schema, so
    an array without a declared release kind cannot cross. Accepts
    anything numpy can view as an array; always ships little-endian."""
    import numpy as np

    a = np.asarray(values)
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return {
        "__array__": 1,
        "kind": str(kind),
        "dtype": str(a.dtype),
        "shape": list(a.shape),
        "b64": base64.b64encode(np.ascontiguousarray(a).tobytes()).decode(
            "ascii"),
    }


def decode_array(env: dict):
    """Inverse of :func:`encode_array` (numpy array out)."""
    import numpy as np

    if not isinstance(env, dict) or env.get("__array__") != 1:
        raise ValueError("not an array envelope")
    a = np.frombuffer(base64.b64decode(env["b64"]),
                      dtype=np.dtype(env["dtype"]))
    return a.reshape(tuple(env["shape"])).copy()


def iter_arrays(payload):
    """Yield every array envelope in a payload, depth-first — the
    scanner's enumeration (arrays anywhere else than where the schema
    allows are a violation, so enumeration must be exhaustive)."""
    if isinstance(payload, dict):
        if payload.get("__array__") == 1:
            yield payload
            return
        for v in payload.values():
            yield from iter_arrays(v)
    elif isinstance(payload, (list, tuple)):
        for v in payload:
            yield from iter_arrays(v)


@dataclass(frozen=True)
class Message:
    """One protocol message. ``headers`` carries the sender's span
    context (obs.wire_headers) so one trace covers both processes;
    ``payload`` is type-specific (see :mod:`dpcorr_torch.protocol.party`)."""

    msg_type: str
    sender: str                      # role ("x"|"y") or federation party
    session: str                     # spec-derived session id
    payload: dict = field(default_factory=dict)
    headers: dict = field(default_factory=dict)
    version: int = PROTOCOL_VERSION

    def __post_init__(self):
        if self.msg_type not in MSG_TYPES:
            raise ValueError(f"unknown msg_type {self.msg_type!r}; "
                             f"expected one of {MSG_TYPES}")
        # two-party sessions use the role letters; federation pair-links
        # (protocol.federation) send under the party's own name
        if not isinstance(self.sender, str) or not self.sender:
            raise ValueError(f"sender must be a non-empty string, "
                             f"got {self.sender!r}")

    def to_wire(self) -> dict:
        return asdict(self)

    @classmethod
    def from_wire(cls, obj: dict) -> "Message":
        if not isinstance(obj, dict):
            raise ValueError("message body must be a JSON object")
        v = obj.get("version")
        if v != PROTOCOL_VERSION:
            raise ValueError(
                f"protocol version mismatch: peer sent {v!r}, "
                f"this runtime speaks {PROTOCOL_VERSION}")
        return cls(msg_type=obj["msg_type"], sender=obj["sender"],
                   session=obj["session"],
                   payload=obj.get("payload", {}),
                   headers=obj.get("headers", {}),
                   version=v)

    def encode(self) -> bytes:
        return canonical_encode(self.to_wire())


class Transcript:
    """Per-party JSONL log of every frame sent/received.

    One line per delivered message: ``{ts, dir, seq, type, bytes,
    retries, latency_s, eps, trace_id, wire}`` where ``wire`` is the
    full wire dict (the scanner audits bytes, not summaries) and
    ``eps`` is the total ε charged for that send (gated sends only,
    else 0). Append-only, line-buffered, lock around the write so the
    runner's two in-process parties can share a process safely.
    """

    def __init__(self, path: str | None):
        self.path = path
        # immutable after construction: the lock-free fast path in
        # record() keys off this, never off the guarded handle
        self.enabled = bool(path)
        self._lock = threading.Lock()
        self._fh = None  # guarded by: _lock
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def record(self, direction: str, msg: Message, seq: int,
               n_bytes: int, retries: int = 0, latency_s: float = 0.0,
               eps: float = 0.0, charge_id: str | None = None,
               replayed: bool = False) -> None:
        if not self.enabled:
            return
        entry = {
            "ts": time.time(), "dir": direction, "seq": seq,
            "type": msg.msg_type, "bytes": n_bytes, "retries": retries,
            "latency_s": latency_s, "eps": eps,
            "trace_id": msg.headers.get("trace_id"),
            "wire": msg.to_wire(),
        }
        # resume-only columns stay absent on the normal path so a
        # crash-free transcript is byte-shaped exactly as before
        if charge_id is not None:
            entry["charge_id"] = charge_id
        if replayed:
            entry["replayed"] = True
        line = json.dumps(entry, sort_keys=True)
        with self._lock:
            if self._fh is not None:
                self._fh.write(line + "\n")

    def meta(self, **fields) -> None:
        """Append a non-message header line ``{"ts", "meta": {...}}`` —
        fault seeds, chaos plans, resume markers. Meta lines make every
        chaos run reproducible from the artifact alone; readers of the
        message stream (:func:`read_transcript`) skip them."""
        if not self.enabled or not fields:
            return
        line = json.dumps({"ts": time.time(), "meta": fields},
                          sort_keys=True)
        with self._lock:
            if self._fh is not None:
                self._fh.write(line + "\n")

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def read_transcript(path: str) -> list[dict]:
    """Load a transcript's *message* lines (meta header lines are
    skipped — they carry no wire traffic); raises ValueError naming the
    first bad line (the audit must fail loudly on a corrupt log, not
    skip lines)."""
    entries = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{i}: bad transcript line: {e}") from e
            if isinstance(obj, dict) and "meta" in obj and "dir" not in obj:
                continue
            if not isinstance(obj, dict) or "dir" not in obj \
                    or "wire" not in obj:
                raise ValueError(f"{path}:{i}: not a transcript entry")
            entries.append(obj)
    return entries


def read_transcript_meta(path: str) -> dict:
    """Merge all meta header lines of a transcript (later lines win on
    key collision). The reproducibility contract: the fault seed and
    chaos plan a run was executed under are recoverable from here."""
    merged: dict = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(obj, dict) and isinstance(obj.get("meta"), dict) \
                    and "dir" not in obj:
                merged.update(obj["meta"])
    return merged
