"""Transports and the reliable channel: framing, retry, dedupe, chaos.

Counterpart of ``dpcorr/protocol/transport.py``: the same frames, so a
port party and a JAX party can share a link.

Two links with one contract (``send_bytes``/``recv_bytes`` with a
deadline): :class:`InProcTransport` is a queue pair for tests and the
single-command runner; TCP frames each payload with a 4-byte big-endian
length prefix over a loopback/remote socket (``tcp_listen`` /
``tcp_connect``). Neither link is reliable from the protocol's point of
view — the chaos layer can drop, delay or duplicate any outbound frame
— so reliability lives one layer up:

:class:`ReliableChannel` implements at-least-once delivery with
receiver-side dedupe, which composes to exactly-once *processing*:

- every application message gets a monotonically increasing sequence
  number and is retransmitted on an exponential backoff schedule until
  the matching ack arrives or the retry budget is exhausted
  (:class:`TransportError` — the caller's signal to refund);
- the receiver acks *every* delivery, including duplicates (the ack
  itself may have been the dropped frame), but hands each sequence
  number to the application at most once. Idempotent redelivery is
  therefore a transport property; parties never see duplicates.

Fault injection (:class:`FaultInjector`) sits on the *outbound* edge of
both messages and acks, driven by its own seeded ``random.Random`` —
chaos runs are reproducible and the estimators' key-tree is untouched (faults
must never perturb estimator noise, that would break the bit-identity
acceptance under fault injection).

Single-owner discipline: a channel is used by one party thread; locks
live in the queue/socket primitives underneath.
"""

from __future__ import annotations

import json
import queue
import random
import socket
import struct
import time


class TransportError(Exception):
    """Delivery gave up: timeout with retry budget exhausted, peer
    closed, or malformed frame. The gate refunds on this."""


class TransportTimeout(TransportError):
    """Nothing arrived within the window — the link itself is (as far
    as we know) healthy. Distinguished from its base class because the
    reconnecting link must NOT tear down a socket over mere idleness:
    only hard failures (reset, EOF, refused) justify a redial."""


class SessionResumeRefused(TransportError):
    """The peer explicitly rejected a session re-attach (session or
    token mismatch). Distinct from silence — an unanswered resume may
    just mean the peer already finished and left, which the party
    runtime tolerates; a refusal is a configuration error and must
    never be downgraded to peer-gone replay."""


class FaultInjector:
    """Deterministic outbound chaos: drop / delay / duplicate.

    ``drop``/``duplicate`` are per-frame probabilities, ``delay_s`` a
    fixed pre-send sleep applied with probability ``delay_rate``
    (default: every frame when ``delay_s > 0``). Uses stdlib
    ``random.Random(seed)``: reproducible, and independent of the
    estimators' key-tree by construction.
    """

    def __init__(self, drop: float = 0.0, delay_s: float = 0.0,
                 duplicate: float = 0.0, delay_rate: float = 1.0,
                 seed: int = 0):
        for name, p in (("drop", drop), ("duplicate", duplicate),
                        ("delay_rate", delay_rate)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        self.drop = drop
        self.delay_s = delay_s
        self.duplicate = duplicate
        self.delay_rate = delay_rate
        self._rng = random.Random(seed)
        self.dropped = 0
        self.delayed = 0
        self.duplicated = 0

    def plan(self) -> tuple[int, float]:
        """(copies_to_send, pre_send_delay_s) for one outbound frame.
        0 copies = dropped, 2 = duplicated."""
        copies = 1
        if self.drop and self._rng.random() < self.drop:
            self.dropped += 1
            copies = 0
        elif self.duplicate and self._rng.random() < self.duplicate:
            self.duplicated += 1
            copies = 2
        delay = 0.0
        if self.delay_s and copies and self._rng.random() < self.delay_rate:
            self.delayed += 1
            delay = self.delay_s
        return copies, delay

    def stats(self) -> dict:
        return {"dropped": self.dropped, "delayed": self.delayed,
                "duplicated": self.duplicated}


# ------------------------------------------------------------ in-proc ----
class _QueueLink:
    """One direction-pair endpoint over two queues."""

    def __init__(self, out_q: "queue.Queue[bytes]",
                 in_q: "queue.Queue[bytes]"):
        self._out = out_q
        self._in = in_q

    def send_bytes(self, data: bytes) -> None:
        self._out.put(data)

    def recv_bytes(self, timeout_s: float) -> bytes:
        try:
            return self._in.get(timeout=timeout_s)
        except queue.Empty:
            raise TransportTimeout(
                f"in-proc recv timed out after {timeout_s:.3g}s") from None

    def close(self) -> None:
        pass


class InProcTransport:
    """A connected pair of queue links (``.a`` ↔ ``.b``) for two
    parties in one process — the test/runner transport."""

    def __init__(self):
        qa: queue.Queue[bytes] = queue.Queue()
        qb: queue.Queue[bytes] = queue.Queue()
        self.a = _QueueLink(qa, qb)
        self.b = _QueueLink(qb, qa)


# ---------------------------------------------------------------- tcp ----
_LEN = struct.Struct(">I")
_MAX_FRAME = 64 * 1024 * 1024  # sanity bound; a release is << this


class TcpLink:
    """Length-prefixed framing over one connected socket: 4-byte BE
    payload length then the payload.

    Partial reads are buffered *across calls*: a recv timeout mid-frame
    must keep the bytes already read, or the next call would interpret
    payload bytes as a length prefix and the stream would desynchronize
    permanently — under retransmission-heavy chaos a timeout landing
    mid-frame is the common case, not the corner."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._buf = bytearray()  # partial-frame carry-over between calls
        try:
            self.peer = "%s:%s" % self._sock.getpeername()[:2]
        except OSError:
            self.peer = "<unknown peer>"

    def send_bytes(self, data: bytes) -> None:
        try:
            self._sock.sendall(_LEN.pack(len(data)) + data)
        except OSError as e:
            raise TransportError(
                f"tcp send to {self.peer} failed: {e}") from e

    def _fill(self, need: int, deadline: float) -> None:
        """Grow the buffer to ``need`` bytes; on timeout the buffer
        keeps whatever arrived (frame reassembly resumes next call)."""
        while len(self._buf) < need:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TransportTimeout(f"tcp recv from {self.peer} timed out")
            self._sock.settimeout(remaining)
            try:
                chunk = self._sock.recv(65536)
            except socket.timeout:
                raise TransportTimeout(
                    f"tcp recv from {self.peer} timed out") from None
            except OSError as e:
                raise TransportError(
                    f"tcp recv from {self.peer} failed: {e}") from e
            if not chunk:
                # EOF mid-frame is a *short read* — the peer died (or
                # reset) partway through a handshake or message, a hard
                # failure, never a timeout
                raise TransportError(
                    f"peer {self.peer} closed connection"
                    + (" mid-frame" if self._buf else ""))
            self._buf.extend(chunk)

    def recv_bytes(self, timeout_s: float) -> bytes:
        deadline = time.monotonic() + timeout_s
        self._fill(_LEN.size, deadline)
        (n,) = _LEN.unpack(self._buf[:_LEN.size])
        if n > _MAX_FRAME:
            raise TransportError(f"frame length {n} exceeds bound")
        self._fill(_LEN.size + n, deadline)
        data = bytes(self._buf[_LEN.size:_LEN.size + n])
        del self._buf[:_LEN.size + n]
        return data

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def tcp_listen(host: str = "127.0.0.1", port: int = 0):
    """Bind a listener; returns ``(server_socket, bound_port)``. Port 0
    picks an ephemeral port — the runner/tests read it back."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(1)
    return srv, srv.getsockname()[1]


def tcp_accept(srv: socket.socket, timeout_s: float = 30.0) -> TcpLink:
    srv.settimeout(timeout_s)
    try:
        sock, _ = srv.accept()
    except socket.timeout:
        raise TransportTimeout(
            f"no peer connected within {timeout_s:.3g}s") from None
    return TcpLink(sock)


def tcp_connect(host: str, port: int, timeout_s: float = 30.0) -> TcpLink:
    """Connect with exponential-backoff retry until ``timeout_s``.

    Retries only the failures that mean "not up *yet*": refused /
    reset / aborted (the listener hasn't bound, or is restarting after
    a crash) and connect timeouts. Anything else — unroutable host,
    permission denied, bad address — fails immediately as a typed
    :class:`TransportError` naming the peer, because no amount of
    waiting fixes it and a silent retry loop would just burn the
    deadline before reporting the same error less clearly."""
    deadline = time.monotonic() + timeout_s
    delay = 0.05
    while True:
        try:
            sock = socket.create_connection((host, port), timeout=5.0)
            return TcpLink(sock)
        except (ConnectionError, socket.timeout, TimeoutError) as e:
            if time.monotonic() >= deadline:
                raise TransportTimeout(
                    f"could not connect to {host}:{port} within "
                    f"{timeout_s:.3g}s: {e}") from e
            time.sleep(delay)
            delay = min(delay * 2.0, 1.0)
        except OSError as e:
            raise TransportError(
                f"connect to {host}:{port} failed: {e}") from e


class ReconnectingTcpLink:
    """A link that survives its socket: on a *hard* failure (reset,
    EOF, refused) it closes the broken socket and redials, surfacing
    the gap to the :class:`ReliableChannel` as :class:`TransportTimeout`
    — which the channel already treats as "retransmit later". Timeouts
    pass through untouched (an idle peer is not a dead peer).

    ``dial`` is role-appropriate: the connecting side passes a
    ``tcp_connect`` closure, the listening side a ``tcp_accept`` closure
    over its still-open server socket. Each successful redial yields a
    *fresh* :class:`TcpLink`, which deliberately discards any partial
    frame buffered from the dead socket: frames are single ``sendall``
    calls, so a new connection always starts at a frame boundary.

    ``max_outage_s`` bounds how long the link keeps trying before a
    hard :class:`TransportError` escapes (the caller's refund path);
    the outage clock starts at the first failure and resets on any
    successful redial.
    """

    def __init__(self, dial, link: TcpLink | None = None,
                 max_outage_s: float = 30.0,
                 backoff_base_s: float = 0.05):
        self._dial = dial
        self._link = link
        self.max_outage_s = max_outage_s
        self.backoff_base_s = backoff_base_s
        self._outage_since: float | None = None
        self.reconnects = 0

    @property
    def peer(self) -> str:
        return self._link.peer if self._link is not None else "<disconnected>"

    def _mark_down(self, cause: Exception) -> None:
        if self._link is not None:
            self._link.close()
            self._link = None
        now = time.monotonic()
        if self._outage_since is None:
            self._outage_since = now
        if now - self._outage_since > self.max_outage_s:
            raise TransportError(
                f"link down for over {self.max_outage_s:.3g}s "
                f"(last error: {cause})") from cause

    def _ensure(self, deadline: float) -> TcpLink:
        """Redial until connected, ``deadline`` or the outage budget —
        whichever lands first wins."""
        delay = self.backoff_base_s
        while self._link is None:
            now = time.monotonic()
            if self._outage_since is not None \
                    and now - self._outage_since > self.max_outage_s:
                raise TransportError(
                    f"link down for over {self.max_outage_s:.3g}s")
            if now >= deadline:
                raise TransportTimeout("reconnect still pending")
            try:
                self._link = self._dial()
                self.reconnects += 1
                self._outage_since = None
            except TransportError:
                time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
                delay = min(delay * 2.0, 1.0)
        return self._link

    def send_bytes(self, data: bytes) -> None:
        """Best-effort: a frame lost to a dying socket is simply not
        acked, and the channel's retransmit loop re-sends it — exactly
        the at-least-once contract. Only an exhausted outage budget
        escapes."""
        if self._link is None:
            try:
                self._ensure(time.monotonic() + self.backoff_base_s)
            except TransportTimeout:
                return  # still down; the retransmit loop will be back
        try:
            self._link.send_bytes(data)
        except TransportError as e:
            self._mark_down(e)

    def recv_bytes(self, timeout_s: float) -> bytes:
        deadline = time.monotonic() + timeout_s
        while True:
            link = self._ensure(deadline)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TransportTimeout("recv window exhausted mid-reconnect")
            try:
                return link.recv_bytes(remaining)
            except TransportTimeout:
                raise
            except TransportError as e:
                self._mark_down(e)

    def close(self) -> None:
        if self._link is not None:
            self._link.close()
            self._link = None


# ---------------------------------------------------- reliable channel ----
class ReliableChannel:
    """At-least-once frames + receive dedupe = exactly-once processing.

    ``send`` blocks until the peer acks (retransmitting on exponential
    backoff) and returns a receipt ``{seq, retries, latency_s, bytes}``
    for the transcript; ``recv`` blocks until the next *new* message
    arrives, transparently re-acking duplicates. Frames are
    ``{"kind": "msg"|"ack", "seq": int, "body": ...}`` in the canonical
    encoding, plus the crash-resume pair ``{"kind": "resume", "session",
    "token"}`` / ``{"kind": "resume_ack", "ok"}``. One owner thread per
    channel.

    Crash-resume support (used by the durable session journal):

    - ``on_deliver(seq, body)`` fires for each NEW inbound message
      *before* its ack goes out, so a journaling receiver is durable
      before the sender stops retransmitting — an ack can never outrun
      the journal.
    - ``restore(send_seq, delivered)`` reloads the dedupe state a
      journal preserved; ``send(body, seq=...)`` pins a replayed
      message to its original seq so the peer's dedupe set recognises
      it across the crash.
    - ``resume(session, token)`` is the restarted side's re-attach
      handshake; the surviving side answers from wherever it happens to
      be blocked (send/recv/drain all route frames through one
      dispatcher) after the owning party has set ``session_info``.
    """

    def __init__(self, link, timeout_s: float = 5.0, max_retries: int = 8,
                 backoff_base_s: float = 0.05, backoff_max_s: float = 2.0,
                 fault: FaultInjector | None = None, on_deliver=None):
        self._link = link
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.fault = fault
        self.on_deliver = on_deliver
        self.session_info: dict | None = None  # {"session","token"}
        self._resume_ok: bool | None = None
        self.peer_resumed = False  # we acked a peer's re-attach
        self._send_seq = 0
        self._acked: set[int] = set()       # acks seen (may arrive early)
        self._delivered: set[int] = set()   # peer seqs handed up already
        self._ready: list[dict] = []        # new msgs seen while awaiting ack
        self.sent_msgs = 0
        self.total_retries = 0

    def restore(self, send_seq: int, delivered: set[int]) -> None:
        """Reload journal-preserved channel state after a restart: the
        next auto-assigned outbound seq continues after ``send_seq``,
        and every journaled inbound seq is pre-marked delivered so the
        peer's retransmits are re-acked but never handed up twice."""
        self._send_seq = int(send_seq)
        self._delivered = set(delivered)

    # -- outbound edge (messages AND acks pass through the chaos layer) --
    def _put(self, frame: dict) -> None:
        data = json.dumps(frame, sort_keys=True,
                          separators=(",", ":")).encode("utf-8")
        copies, delay = (self.fault.plan() if self.fault is not None
                         else (1, 0.0))
        if delay:
            time.sleep(delay)
        for _ in range(copies):
            self._link.send_bytes(data)

    def _ack(self, seq: int) -> None:
        self._put({"kind": "ack", "seq": seq})

    def _take(self, timeout_s: float) -> dict:
        data = self._link.recv_bytes(timeout_s)
        try:
            frame = json.loads(data.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise TransportError(f"malformed frame: {e}") from e
        if not isinstance(frame, dict) or "kind" not in frame:
            raise TransportError("malformed frame: missing kind")
        if frame["kind"] in ("msg", "ack") and "seq" not in frame:
            raise TransportError("malformed frame: missing seq")
        return frame

    def _dispatch(self, frame: dict) -> None:
        """Route one inbound frame, whatever loop we happen to be in —
        send, recv, drain and resume all funnel through here so a
        surviving party answers a peer's resume handshake from wherever
        it is blocked. Unknown kinds are ignored (forward compat)."""
        kind = frame["kind"]
        if kind == "ack":
            self._acked.add(int(frame["seq"]))
        elif kind == "msg":
            self._admit(frame)
        elif kind == "resume":
            self._answer_resume(frame)
        elif kind == "resume_ack":
            self._resume_ok = bool(frame.get("ok", False))

    def _answer_resume(self, frame: dict) -> None:
        """Validate a peer's re-attach request against the session the
        owning party registered. No ``session_info`` yet → stay silent
        (the initiator keeps retrying); wrong session/token → explicit
        refusal, the initiator must not replay into the wrong session."""
        info = self.session_info
        if info is None:
            return
        ok = (frame.get("session") == info.get("session")
              and frame.get("token") == info.get("token"))
        if ok:
            # the restarted peer is about to replay its unacked sends;
            # the owning party must linger past its own completion so
            # those replays get re-acked (party._linger keys on this)
            self.peer_resumed = True
        self._put({"kind": "resume_ack", "ok": ok,
                   "session": info.get("session")})

    def _admit(self, frame: dict) -> None:
        """Handle one inbound msg frame: journal NEW messages durably
        (``on_deliver``) *before* the ack goes out — once acked, the
        peer stops retransmitting, so durability must come first — then
        always (re-)ack, since the previous ack may be the frame chaos
        dropped; enqueue the body at most once."""
        seq = int(frame["seq"])
        if seq not in self._delivered:
            if self.on_deliver is not None:
                self.on_deliver(seq, frame.get("body"))
            self._delivered.add(seq)
            self._ready.append({"seq": seq, "body": frame.get("body")})
        self._ack(seq)

    def send(self, body: dict, seq: int | None = None) -> dict:
        """Deliver ``body`` reliably; returns the transcript receipt.
        Raises :class:`TransportError` once ``max_retries``
        retransmissions all miss their ack window.

        ``seq`` pins a replayed message to its journaled sequence
        number (crash resume); new messages leave it unset and take the
        next auto-incremented seq."""
        if seq is None:
            self._send_seq += 1
            seq = self._send_seq
        else:
            self._send_seq = max(self._send_seq, seq)
        frame = {"kind": "msg", "seq": seq, "body": body}
        n_bytes = len(json.dumps(frame, sort_keys=True,
                                 separators=(",", ":")).encode("utf-8"))
        t0 = time.perf_counter()
        for attempt in range(self.max_retries + 1):
            self._put(frame)
            deadline = time.monotonic() + min(
                self.backoff_base_s * (2.0 ** attempt), self.backoff_max_s)
            while True:
                if seq in self._acked:
                    self._acked.discard(seq)
                    self.sent_msgs += 1
                    self.total_retries += attempt
                    return {"seq": seq, "retries": attempt,
                            "latency_s": time.perf_counter() - t0,
                            "bytes": n_bytes}
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break  # retransmit
                try:
                    got = self._take(remaining)
                except TransportTimeout:
                    break  # timeout inside this attempt's window
                self._dispatch(got)  # ack, or peer traffic crossing ours
        raise TransportError(
            f"message seq={seq} unacknowledged after "
            f"{self.max_retries + 1} attempts")

    def resume(self, session: str, token: str,
               timeout_s: float | None = None,
               max_wait_s: float | None = None) -> None:
        """Re-attach a restarted party: retransmit the resume frame
        until the survivor acknowledges (or refuses) it. Runs *before*
        any journal replay — a replayed release must not race the
        peer's recognition of who is talking.

        ``max_wait_s`` bounds the whole exchange rather than each
        attempt: a peer that legitimately finished and exited will
        never answer, and the caller needs a deadline after which it
        can fall back to completing from its journal alone
        (party._attach_journal's peer-gone path)."""
        self._resume_ok = None
        frame = {"kind": "resume", "session": session, "token": token}
        per_attempt = timeout_s if timeout_s is not None else self.timeout_s
        overall = (None if max_wait_s is None
                   else time.monotonic() + max_wait_s)
        for attempt in range(self.max_retries + 1):
            if overall is not None and time.monotonic() >= overall:
                break
            self._put(frame)
            deadline = time.monotonic() + max(
                per_attempt,
                min(self.backoff_base_s * (2.0 ** attempt),
                    self.backoff_max_s))
            if overall is not None:
                deadline = min(deadline, overall)
            while self._resume_ok is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    got = self._take(remaining)
                except TransportTimeout:
                    break
                self._dispatch(got)
            if self._resume_ok is False:
                raise SessionResumeRefused(
                    f"peer refused session resume for {session!r} "
                    "(session/token mismatch)")
            if self._resume_ok:
                return
        raise TransportError(
            f"session resume for {session!r} unanswered "
            + (f"after {max_wait_s:.1f}s" if max_wait_s is not None
               else f"after {self.max_retries + 1} attempts"))

    def recv(self, timeout_s: float | None = None) -> dict:
        """Next new message ``{"seq": int, "body": dict}`` — duplicates
        re-acked and filtered here, stray acks absorbed."""
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self.timeout_s)
        while True:
            if self._ready:
                return self._ready.pop(0)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TransportTimeout("recv timed out awaiting message")
            got = self._take(remaining)
            self._dispatch(got)

    def drain(self, idle_s: float | None = None,
              max_s: float | None = None) -> None:
        """Linger after the conversation's last inbound message: keep
        re-acking retransmissions until the link stays quiet for
        ``idle_s`` (bounded by ``max_s``). Without this, the party that
        receives the session's final message can exit while its ack is
        still the frame chaos dropped — the peer then retransmits into
        a closed conversation and its send fails spuriously (the
        two-generals tail; a linger window is the standard answer).

        The defaults derive from this channel's own retry config (the
        two ends are configured symmetrically): the idle window must
        exceed the peer's worst inter-retransmit gap — one full ack
        wait plus one maxed backoff — or the drain gives up between two
        of the peer's late-backoff attempts and it strands exactly the
        sends it exists to save; ``max_s`` covers the peer's entire
        retry span so the linger can outlive a worst-case sequence of
        dropped acks."""
        gap = self.timeout_s + self.backoff_max_s
        if idle_s is None:
            idle_s = gap + 0.25
        if max_s is None:
            max_s = (self.max_retries + 1) * gap
        deadline = time.monotonic() + max_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            try:
                got = self._take(min(idle_s, remaining))
            except TransportError:
                return
            self._dispatch(got)

    def close(self) -> None:
        self._link.close()
