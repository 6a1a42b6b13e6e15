"""The fleet front end: one HTTP router over N serve replicas.

Counterpart of ``dpcorr/serve/fleet/frontend.py``. It computes nothing
on a device, and routes over replicas of either package alike.

Routing is three concentric hints, strongest first:

1. **Lease ownership** — a request carrying a ``user`` is routed to
   the replica whose lease file currently covers the user's budget
   shard (the shard is computed with the budget directory's own ring
   arithmetic, :func:`dpcorr_torch.serve.budget_dir.build_ring`; the
   lease table is re-read on a short cadence). Routing to the owner makes
   ``ShardNotOwnedError`` the exception, not the rule.
2. **Shard affinity** — an unowned shard hashes onto the replica ring
   (consistent hashing over replica names), and the chosen replica
   acquires the lease on first touch (``acquire_on_demand``), so
   ownership converges onto the routing and stays stable as replicas
   come and go.
3. **Health** — replicas publish ``/readyz`` and the front end keeps
   per-replica circuit state (consecutive transport failures open the
   circuit; a cooldown probe closes it), so traffic flows around a
   dead or cold replica without waiting for its lease to expire.

Refusals pass through untouched — status code, body and
``Retry-After`` header — so
:class:`~dpcorr_torch.serve.client.RetryingClient` pointed at the front
end behaves exactly as if pointed at a replica. The one code a client
never sees is 421 (``ShardNotOwnedError``): the front end forwards to the owner the
refusing replica named, and only after the hop budget is exhausted
degrades to a 503 with a Retry-After, which the client's existing
breaker-retry path already handles. Requests without an idempotency
key or pinned seed get a generated ``fe:`` key before the first hop,
so a failover retry is charge-once even for raw (non-RetryingClient)
clients.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

from dpcorr_torch.serve.budget_dir import (
    _hash64,
    build_ring,
    ring_shard_index,
)
from dpcorr_torch.serve.fleet import lease as lease_mod

_HOP_HEADER = "X-Dpcorr-Fleet-Hops"


class _Circuit:
    """Per-replica transport circuit: consecutive failures open it,
    a cooldown probe half-opens it. Guarded by the frontend lock."""

    def __init__(self, fail_threshold: int, cooldown_s: float):
        self.fail_threshold = fail_threshold
        self.cooldown_s = cooldown_s
        self.failures = 0
        self.open_until = 0.0
        self.opened = 0

    def ok(self) -> None:
        self.failures = 0
        self.open_until = 0.0

    def fail(self, now: float) -> None:
        self.failures += 1
        if self.failures >= self.fail_threshold:
            self.open_until = now + self.cooldown_s
            self.opened += 1

    def allows(self, now: float) -> bool:
        # past open_until the circuit half-opens: one probe rides
        return now >= self.open_until

    def snapshot(self, now: float) -> dict:
        return {"failures": self.failures, "opened": self.opened,
                "open": now < self.open_until}


class FleetFrontend:
    """Routing core (transport-agnostic): :meth:`route` takes a raw
    ``POST /estimate`` body and returns ``(status, headers, body)``.
    :func:`make_frontend_http_server` wraps it for the wire.

    ``replicas`` maps instance name → base url; the supervisor's
    ``on_up`` callback re-targets restarted replicas through
    :meth:`set_replica`. ``lease_dir`` (shared with the replicas)
    supplies the shard count and ownership table; without it, routing
    falls back to user-keyed affinity over healthy replicas.
    """

    def __init__(self, replicas: dict[str, str],
                 lease_dir: str | None = None, *,
                 affinity_points: int = 16, fail_threshold: int = 3,
                 cooldown_s: float = 1.0, table_ttl_s: float = 0.5,
                 timeout_s: float = 60.0, max_hops: int = 4,
                 retry_after_s: float = 0.5,
                 clock=time.monotonic):
        self.lease_dir = lease_dir
        self.affinity_points = int(affinity_points)
        self.timeout_s = float(timeout_s)
        self.max_hops = int(max_hops)
        self.retry_after_s = float(retry_after_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._urls: dict[str, str] = {}        # guarded by: _lock
        self._circuits: dict[str, _Circuit] = {}  # guarded by: _lock
        self._ready: dict[str, bool] = {}      # guarded by: _lock
        self._rr = 0                           # guarded by: _lock
        self._counts: dict[str, int] = {}      # guarded by: _lock
        self._fail_threshold = int(fail_threshold)
        self._cooldown_s = float(cooldown_s)
        self._table_ttl_s = float(table_ttl_s)
        self._table: dict[int, dict] = {}      # guarded by: _lock
        self._table_at = -1e18                 # guarded by: _lock
        self._ring = None  # (keys, shards) once the lease meta exists
        for name, url in replicas.items():
            self.set_replica(name, url)

    # -- fleet membership --------------------------------------------

    def set_replica(self, name: str, url: str) -> None:
        """Add or re-target a replica (the supervisor's on_up hook —
        a restarted replica on ``--port 0`` keeps its name, changes
        its url). Resets its circuit: a fresh boot deserves traffic."""
        with self._lock:
            self._urls[name] = url.rstrip("/")
            self._circuits[name] = _Circuit(self._fail_threshold,
                                            self._cooldown_s)
            self._ready.setdefault(name, True)

    def drop_replica(self, name: str) -> None:
        with self._lock:
            self._urls.pop(name, None)
            self._circuits.pop(name, None)
            self._ready.pop(name, None)

    def set_ready(self, name: str, ready: bool) -> None:
        with self._lock:
            if name in self._urls:
                self._ready[name] = bool(ready)

    def _count(self, what: str, k: int = 1) -> None:
        with self._lock:
            self._counts[what] = self._counts.get(what, 0) + k

    # -- shard arithmetic / lease table ------------------------------

    def _shard_of(self, user: str) -> int | None:
        if self.lease_dir is None:
            return None
        if self._ring is None:
            meta = lease_mod.read_meta(self.lease_dir)
            if meta is None:
                return None  # no replica has bound yet
            self._ring = build_ring(int(meta["shards"]))
        return ring_shard_index(user, *self._ring)

    def _lease_owner(self, shard: int) -> tuple[str | None, str | None]:
        """(owner, url) for a shard whose lease is live, else Nones."""
        if self.lease_dir is None:
            return None, None
        with self._lock:
            stale = self.clock() - self._table_at > self._table_ttl_s
        if stale:
            table = lease_mod.lease_table(self.lease_dir)
            with self._lock:
                self._table = table
                self._table_at = self.clock()
        with self._lock:
            rec = self._table.get(shard)
        if rec is None:
            return None, None
        if time.time() >= float(rec.get("expires_at", 0.0)):
            return None, None
        return rec.get("owner"), rec.get("url")

    def _affinity(self, key: str, names: list[str]) -> list[str]:
        """Consistent-hash order of ``names`` for ``key``: the ring
        walk from the key's position — stable under membership
        change, which is the whole point."""
        if not names:
            return []
        points = sorted((_hash64(f"replica:{n}:{r}"), n)
                        for n in names for r in range(self.affinity_points))
        h = _hash64(key)
        order: list[str] = []
        start = 0
        while start < len(points) and points[start][0] <= h:
            start += 1
        for i in range(len(points)):
            n = points[(start + i) % len(points)][1]
            if n not in order:
                order.append(n)
        return order

    def _candidates(self, user: str | None) -> list[str]:
        """Route order: lease owner first, then shard-affinity walk,
        then the remaining healthy replicas; round-robin for userless
        requests."""
        now = self.clock()
        with self._lock:
            healthy = [n for n, u in sorted(self._urls.items())
                       if self._ready.get(n, True)
                       and self._circuits[n].allows(now)]
            everyone = sorted(self._urls)
            self._rr += 1
            rr = self._rr
        pool = healthy if healthy else everyone  # last resort: probe
        if not pool:
            return []
        if user is None:
            return pool[rr % len(pool):] + pool[:rr % len(pool)]
        shard = self._shard_of(user)
        key = user if shard is None else f"shard:{shard}"
        order = self._affinity(key, pool)
        if shard is not None:
            owner, _url = self._lease_owner(shard)
            if owner in order:
                order.remove(owner)
                order.insert(0, owner)
        return order

    # -- the hop loop ------------------------------------------------

    def _post(self, url: str, body: bytes, hops: int):
        req = urllib.request.Request(
            f"{url}/estimate", data=body,
            headers={"Content-Type": "application/json",
                     _HOP_HEADER: str(hops)})
        return urllib.request.urlopen(req, timeout=self.timeout_s)

    def _mark(self, name: str, ok: bool) -> None:
        with self._lock:
            c = self._circuits.get(name)
            if c is None:
                return
            if ok:
                c.ok()
            else:
                c.fail(self.clock())

    def route(self, body: bytes) -> tuple[int, list[tuple[str, str]],
                                          bytes]:
        """One logical ``POST /estimate``: pick candidates, hop until
        a replica answers (any HTTP status except 421 is an answer —
        passthrough), forward 421s to the named owner, and degrade to
        a retryable 503 when the hop budget runs out."""
        try:
            parsed = json.loads(body)
            user = parsed.get("user")
        except (json.JSONDecodeError, UnicodeDecodeError, AttributeError):
            user, parsed = None, None
        if (parsed is not None and parsed.get("idempotency_key") is None
                and parsed.get("seed") is None):
            # failover identity for raw clients: every hop/retry of
            # this logical request now dedups server-side
            import secrets as _secrets

            parsed["idempotency_key"] = f"fe:{_secrets.token_hex(16)}"
            body = json.dumps(parsed).encode()
        self._count("requests")
        tried: list[str] = []
        queue = self._candidates(None if user is None else str(user))
        hops = 0
        while queue and hops < self.max_hops:
            name = queue.pop(0)
            if name in tried:
                continue
            tried.append(name)
            hops += 1
            with self._lock:
                url = self._urls.get(name)
            if url is None:
                continue
            try:
                with self._post(url, body, hops) as r:
                    payload = r.read()
                    self._mark(name, ok=True)
                    self._count(f"routed:{name}")
                    return (r.status, self._passthrough(r.headers),
                            payload)
            except urllib.error.HTTPError as e:
                payload = e.read()
                self._mark(name, ok=True)  # the wire worked
                if e.code == 421:
                    self._count("forwards")
                    nxt = self._owner_from_421(payload)
                    if nxt is not None and nxt not in tried:
                        queue.insert(0, nxt)
                    continue
                self._count(f"routed:{name}")
                return e.code, self._passthrough(e.headers), payload
            except (urllib.error.URLError, ConnectionError,
                    TimeoutError, OSError):
                self._mark(name, ok=False)
                self._count("transport_errors")
                continue
        self._count("no_owner")
        blob = json.dumps({
            "error": "no healthy replica could serve the request "
                     f"(tried {tried or 'none'})",
            "refused": "breaker"}).encode()
        ra = str(max(1, int(self.retry_after_s + 0.999)))
        return 503, [("Content-Type", "application/json"),
                     ("Retry-After", ra)], blob

    @staticmethod
    def _passthrough(headers) -> list[tuple[str, str]]:
        out = [("Content-Type", "application/json")]
        ra = headers.get("Retry-After") if headers is not None else None
        if ra is not None:
            out.append(("Retry-After", ra))
        return out

    def _owner_from_421(self, payload: bytes) -> str | None:
        """The refusing replica names the current owner; route there
        next if we know it (by name), or learn its url on the fly."""
        try:
            body = json.loads(payload)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return None
        owner = body.get("owner")
        url = body.get("owner_url")
        with self._lock:
            if owner is not None and owner in self._urls:
                return owner
            if owner is not None and url:
                self._urls[owner] = url.rstrip("/")
                self._circuits[owner] = _Circuit(self._fail_threshold,
                                                 self._cooldown_s)
                self._ready[owner] = True
                return owner
        return None

    # -- health polling ----------------------------------------------

    def poll_ready(self) -> dict[str, bool]:
        """One readiness sweep (call on a cadence, or rely on circuit
        state alone): GET /readyz per replica, 200 → ready."""
        with self._lock:
            targets = dict(self._urls)
        out: dict[str, bool] = {}
        for name, url in targets.items():
            try:
                with urllib.request.urlopen(f"{url}/readyz",
                                            timeout=2.0) as r:
                    out[name] = r.status == 200
            except urllib.error.HTTPError:
                out[name] = False
            except (urllib.error.URLError, ConnectionError, OSError):
                out[name] = False
            self.set_ready(name, out[name])
        return out

    # -- views -------------------------------------------------------

    def stats(self) -> dict:
        now = self.clock()
        if self.lease_dir is not None:
            table = lease_mod.lease_table(self.lease_dir)
        else:
            table = {}
        with self._lock:
            return {
                "replicas": {
                    n: {"url": self._urls[n],
                        "ready": self._ready.get(n, True),
                        "circuit": self._circuits[n].snapshot(now)}
                    for n in sorted(self._urls)},
                "counts": dict(self._counts),
                "leases": {
                    str(s): {"owner": rec.get("owner"),
                             "epoch": rec.get("epoch"),
                             "expires_in_s": round(
                                 float(rec.get("expires_at", 0.0))
                                 - time.time(), 3)}
                    for s, rec in sorted(table.items())},
            }


def make_frontend_http_server(frontend: FleetFrontend,
                              host: str = "127.0.0.1", port: int = 0):
    """Build (not start) the front end's HTTP server — same contract
    as :func:`dpcorr_torch.serve.server.make_http_server`."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, headers, blob: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Length", str(len(blob)))
            for name, value in headers:
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):  # noqa: N802 (stdlib handler casing)
            hdr = [("Content-Type", "application/json")]
            if self.path == "/stats":
                self._reply(200, hdr,
                            json.dumps(frontend.stats()).encode())
            elif self.path == "/healthz":
                self._reply(200, hdr, b'{"ok": true}')
            elif self.path == "/readyz":
                ready = frontend.poll_ready()
                ok = any(ready.values())
                self._reply(200 if ok else 503, hdr,
                            json.dumps({"ready": ok,
                                        "replicas": ready}).encode())
            else:
                self._reply(404, hdr, json.dumps(
                    {"error": f"no route {self.path}"}).encode())

        def do_POST(self):  # noqa: N802
            if self.path != "/estimate":
                self._reply(404, [("Content-Type", "application/json")],
                            json.dumps(
                                {"error": f"no route {self.path}"}
                            ).encode())
                return
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            code, headers, payload = frontend.route(body)
            self._reply(code, headers, payload)

        def log_message(self, *args):  # quiet by default
            pass

    return ThreadingHTTPServer((host, port), Handler)
