"""Durable shard leases: exactly-one-writer for fleet budget shards.

Counterpart of ``dpcorr/serve/fleet/lease.py``, with its file formats: a
lease directory written by either package is read, renewed and taken over
by the other.

The :class:`~dpcorr_torch.serve.budget_dir.BudgetDirectory` keeps per-user
balances in per-shard WAL+snapshot journals that assume ONE writer. A
fleet shares the directory on disk, so something must make "one writer
per shard" true across N replicas and survive any of them dying
mid-write. That something is this module:

- one **lease file** per shard (``shard-0007.lease``, JSON, written
  tmp+fsync+rename so it is never torn), naming the owning replica, an
  **epoch** that increments on every ownership change, and an
  ``expires_at`` wall-clock deadline;
- a **heartbeat** (``renew``) that extends ``expires_at`` while the owner
  is alive; a silent owner loses the shard TTL seconds after its last
  renewal, and only then may another replica take over;
- an ``O_CREAT|O_EXCL`` **claim file** per (shard, epoch) so two replicas
  racing for an expired lease resolve to exactly one winner before either
  touches the lease file — the loser walks away without writing anything.
  The ``fleet.pre_lease_commit`` chaos point sits between winning the
  claim and committing the lease: a crash there leaves a stale claim that
  the next claimant breaks (atomically, by rename) once it is TTL-old;
- **epoch fencing** on the admission path: ``ensure_owned`` re-reads the
  lease whenever its in-memory grant is within the safety margin of
  expiry, and a file showing a different owner or a newer epoch means
  this replica's grant is history — it closes the shard journal
  (``on_lost``) and refuses the charge charge-free with
  :class:`ShardNotOwnedError`, which carries the current owner so the
  front end can forward instead of failing.

Charges stay exactly-once across takeover because the lease only gates
WHO may write; WHAT was written is replayed from the shard's own WAL by
the next owner, and per-request charge_ids dedup a retry of a dying
replica's charge no matter which replica serves it.

Nothing here computes on a device: the front end reads lease tables,
tests script the clock.
"""

from __future__ import annotations

import json
import os
import threading
import time

from dpcorr_torch import chaos
from dpcorr_torch.serve.budget_dir import _atomic_write

_LEASE_VERSION = 1
_META_NAME = "meta.json"


class ShardNotOwnedError(Exception):
    """This replica does not hold the lease for the user's budget
    shard. Raised BEFORE anything is charged — the refusal is
    charge-free by construction — and carries the current owner (when
    the lease file names one) so the caller can forward the request
    instead of failing it."""

    def __init__(self, shard: int, owner: str | None = None,
                 owner_url: str | None = None,
                 retry_after_s: float | None = None):
        self.shard = int(shard)
        self.owner = owner
        self.owner_url = owner_url
        self.retry_after_s = retry_after_s
        who = f"held by {owner!r}" if owner else "not held here"
        super().__init__(f"budget shard {self.shard} {who}")


def _read_json(path: str) -> dict | None:
    """A lease/claim file, or None when absent (or unreadable — lease
    files are written atomically, so a torn read means "not there
    yet"; the claim protocol, not this read, decides ownership)."""
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except (FileNotFoundError, json.JSONDecodeError, UnicodeDecodeError,
            OSError):
        return None


def read_meta(lease_dir: str) -> dict | None:
    return _read_json(os.path.join(str(lease_dir), _META_NAME))


def lease_table(lease_dir: str) -> dict[int, dict]:
    """Every shard's current lease record, keyed by shard index — the
    front end's routing table. Purely a directory scan; expired
    entries are included (``expires_at`` is the reader's to judge)."""
    out: dict[int, dict] = {}
    try:
        names = os.listdir(str(lease_dir))
    except FileNotFoundError:
        return out
    for name in names:
        if not (name.startswith("shard-") and name.endswith(".lease")):
            continue
        rec = _read_json(os.path.join(str(lease_dir), name))
        if rec is None:
            continue
        try:
            out[int(rec["shard"])] = rec
        except (KeyError, TypeError, ValueError):
            continue
    return out


class LeaseManager:
    """One replica's view of the shard leases under ``lease_dir``.

    ``owner`` is the replica's stable instance name (stable across
    restart, so a rebooted replica reclaims its own expired leases
    instantly); ``url`` is advertised in the lease file for forwarding.
    ``clock`` is injectable (tests script expiry). With
    ``acquire_on_demand`` (the default), ``ensure_owned`` takes over a
    free or expired shard on first touch, so ownership converges onto
    whichever replicas actually receive the traffic.
    """

    def __init__(self, lease_dir: str, owner: str,
                 n_shards: int | None = None, *,
                 url: str | None = None, ttl_s: float = 3.0,
                 clock=time.time, acquire_on_demand: bool = True):
        if ttl_s <= 0.0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        self.lease_dir = str(lease_dir)
        os.makedirs(self.lease_dir, exist_ok=True)
        self.owner = str(owner)
        self.url = url
        self.ttl_s = float(ttl_s)
        self.clock = clock
        self.acquire_on_demand = acquire_on_demand
        self.n_shards: int | None = None
        self._on_lost = None
        self._lock = threading.RLock()
        self._mine: dict[int, dict] = {}  # guarded by: _lock
        self._counts: dict[str, int] = {}  # guarded by: _lock
        if n_shards is not None:
            self.bind(n_shards)

    # -- binding -----------------------------------------------------

    def bind(self, n_shards: int, on_lost=None) -> None:
        """Pin the shard count (it must match the budget directory's
        persisted count — re-ringing users would split balances) and
        install the lease-lost callback (the directory closes the
        shard journal there)."""
        n_shards = int(n_shards)
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        meta = read_meta(self.lease_dir)
        if meta is None:
            _atomic_write(os.path.join(self.lease_dir, _META_NAME),
                          json.dumps({"version": _LEASE_VERSION,
                                      "shards": n_shards}))
        elif int(meta.get("shards", -1)) != n_shards:
            raise ValueError(
                f"lease dir {self.lease_dir} pins "
                f"{meta.get('shards')} shards, directory has "
                f"{n_shards}: one fleet, one ring")
        self.n_shards = n_shards
        if on_lost is not None:
            self._on_lost = on_lost

    # -- paths / reads -----------------------------------------------

    def _lease_path(self, shard: int) -> str:
        return os.path.join(self.lease_dir, f"shard-{shard:04d}.lease")

    def _claim_path(self, shard: int, epoch: int) -> str:
        return os.path.join(self.lease_dir,
                            f"shard-{shard:04d}.claim.{epoch}")

    def owner_of(self, shard: int) -> dict | None:
        """The shard's lease record as persisted (owner may be
        expired — the caller judges ``expires_at``)."""
        return _read_json(self._lease_path(shard))

    def _count(self, what: str, k: int = 1) -> None:
        with self._lock:
            self._counts[what] = self._counts.get(what, 0) + k

    # -- the claim protocol ------------------------------------------

    def _win_claim(self, path: str, now: float) -> bool:
        """Exactly-one-winner for a (shard, epoch) takeover. The claim
        file is created ``O_CREAT|O_EXCL`` — atomic on POSIX — and a
        crashed claimant's stale claim (TTL-old by its embedded stamp)
        is consumed by an atomic rename, so at most one breaker
        proceeds to retry the exclusive create."""
        flags = os.O_CREAT | os.O_EXCL | os.O_WRONLY
        try:
            fd = os.open(path, flags, 0o644)
        except FileExistsError:
            st = _read_json(path)
            ts = None if st is None else st.get("ts")
            fresh = ts is not None and now < float(ts) + self.ttl_s
            if fresh:
                return False  # someone else is mid-takeover, live
            tomb = f"{path}.stale.{self.owner}.{os.getpid()}"
            try:
                os.rename(path, tomb)  # atomic: one breaker wins
            except FileNotFoundError:
                pass  # another breaker consumed it first
            else:
                try:
                    os.unlink(tomb)
                except FileNotFoundError:
                    pass
            try:
                fd = os.open(path, flags, 0o644)
            except FileExistsError:
                return False
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            fh.write(json.dumps({"owner": self.owner, "ts": now}))
            fh.flush()
            os.fsync(fh.fileno())
        return True

    # -- lifecycle ---------------------------------------------------

    def acquire(self, shard: int) -> bool:
        """Try to take shard ``shard``: free, expired, or already ours
        (a restart reclaiming its own name re-grants even before
        expiry — same owner, no second writer). Returns False without
        writing anything when another replica holds it validly or
        wins the claim race."""
        shard = int(shard)
        with self._lock:
            now = self.clock()
            cur = self.owner_of(shard)
            if cur is not None:
                valid = now < float(cur["expires_at"])
                if valid and cur["owner"] != self.owner:
                    return False
                if valid and cur["owner"] == self.owner:
                    # ours already (this process or our previous
                    # incarnation): adopt the live grant as-is
                    self._mine[shard] = {
                        "epoch": int(cur["epoch"]),
                        "expires_at": float(cur["expires_at"])}
                    self._count("reclaimed")
                    return True
            epoch = (int(cur["epoch"]) if cur is not None else 0) + 1
            claim = self._claim_path(shard, epoch)
            # the claim must be durable before the grant proceeds
            # dpcorr-lint: ignore[blocking-under-lock] — the claim must be durable before the grant proceeds
            if not self._win_claim(claim, now):
                return False
            # claim won but nothing granted yet: a crash here (the
            # chaos point below) leaves only the stale claim, which
            # the next claimant breaks after TTL — no lease is ever
            # half-written
            chaos.point("fleet.pre_lease_commit")
            rec = {"version": _LEASE_VERSION, "shard": shard,
                   "owner": self.owner, "url": self.url,
                   "epoch": epoch, "granted_at": now,
                   "expires_at": now + self.ttl_s}
            # the lease must be durable before the grant is visible
            # dpcorr-lint: ignore[blocking-under-lock] — the lease must be durable before the grant is visible
            _atomic_write(self._lease_path(shard), json.dumps(rec))
            try:
                os.unlink(claim)
            except FileNotFoundError:
                pass
            self._mine[shard] = {"epoch": epoch,
                                 "expires_at": rec["expires_at"]}
            self._count("acquired")
            if epoch > 1:
                self._count("takeovers")
            return True

    def renew(self, shard: int) -> bool:
        """Heartbeat one held shard. The file is re-read first: a
        different owner or epoch means we were fenced while silent —
        the grant is dropped (``on_lost`` fires), never revived."""
        shard = int(shard)
        with self._lock:
            mine = self._mine.get(shard)
            if mine is None:
                return False
            now = self.clock()
            cur = self.owner_of(shard)
            if (cur is None or cur["owner"] != self.owner
                    or int(cur["epoch"]) != mine["epoch"]
                    or now >= float(cur["expires_at"])):
                self._lost(shard)
                return False
            rec = dict(cur)
            rec["url"] = self.url
            rec["renewed_at"] = now
            rec["expires_at"] = now + self.ttl_s
            # the heartbeat must be durable before the grant is extended
            # dpcorr-lint: ignore[blocking-under-lock] — the heartbeat must be durable before the grant is extended
            _atomic_write(self._lease_path(shard), json.dumps(rec))
            mine["expires_at"] = rec["expires_at"]
            self._count("renewed")
            return True

    def renew_all(self) -> int:
        with self._lock:
            # each renew's durable write is the heartbeat itself
            # dpcorr-lint: ignore[blocking-under-lock] — each renew's durable write is the heartbeat itself
            return sum(self.renew(s) for s in sorted(self._mine))

    def _lost(self, shard: int) -> None:
        # callers hold _lock (an RLock); not re-taken, so on_lost sees
        # the same hold depth
        # dpcorr-lint: ignore[lock-unguarded-write] — callers hold _lock (RLock); not re-taken so on_lost sees the same hold depth
        self._mine.pop(shard, None)
        self._count("lost")
        if self._on_lost is not None:
            self._on_lost(shard)

    def ensure_owned(self, shard: int, *,
                     acquire: bool | None = None) -> None:
        """The admission-path gate: cheap in-memory check while the
        grant is comfortably live (a TTL/4 safety margin keeps a
        charge from landing after a fence), one file re-read when in
        doubt, optional on-demand takeover of a free shard, and a
        charge-free :class:`ShardNotOwnedError` naming the real owner
        otherwise."""
        shard = int(shard)
        if self.n_shards is not None and not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range "
                             f"[0, {self.n_shards})")
        with self._lock:
            now = self.clock()
            margin = self.ttl_s * 0.25
            mine = self._mine.get(shard)
            if mine is not None and now < mine["expires_at"] - margin:
                return
            cur = self.owner_of(shard)
            if (mine is not None and cur is not None
                    and cur["owner"] == self.owner
                    and int(cur["epoch"]) == mine["epoch"]
                    and now < float(cur["expires_at"]) - margin):
                # a concurrent renew advanced the file; adopt it
                mine["expires_at"] = float(cur["expires_at"])
                return
            if mine is not None:
                self._lost(shard)
            want = (acquire if acquire is not None
                    else self.acquire_on_demand)
            # on-demand takeover: the admission path waits out the
            # durable grant
            # dpcorr-lint: ignore[blocking-under-lock] — on-demand takeover: the admission path must wait out the durable grant
            if want and self.acquire(shard):
                return
            self._count("refused")
            cur = self.owner_of(shard)
            owner = cur.get("owner") if cur is not None else None
            url = cur.get("url") if cur is not None else None
            if cur is not None:
                left = float(cur["expires_at"]) - now
                retry = min(self.ttl_s, max(0.05, left))
            else:
                retry = 0.1
            raise ShardNotOwnedError(
                shard, owner=owner if owner != self.owner else None,
                owner_url=url, retry_after_s=retry)

    def release(self, shard: int) -> None:
        """Graceful handback: the lease is rewritten already-expired
        (same epoch — the next owner still bumps it), so a successor
        takes over immediately instead of waiting out the TTL."""
        shard = int(shard)
        with self._lock:
            mine = self._mine.pop(shard, None)
            if mine is None:
                return
            cur = self.owner_of(shard)
            if (cur is not None and cur["owner"] == self.owner
                    and int(cur["epoch"]) == mine["epoch"]):
                rec = dict(cur)
                rec["expires_at"] = self.clock()
                rec["released"] = True
                # the handback must be durable before the journal closes
                # dpcorr-lint: ignore[blocking-under-lock] — the handback must be durable before the journal closes
                _atomic_write(self._lease_path(shard), json.dumps(rec))
            self._count("released")
            if self._on_lost is not None:
                self._on_lost(shard)

    def release_all(self) -> None:
        with self._lock:
            for shard in sorted(self._mine):
                # each release's durable write is the handback itself
                # dpcorr-lint: ignore[blocking-under-lock] — each release's durable write is the handback itself
                self.release(shard)

    # -- views -------------------------------------------------------

    def owned(self) -> list[int]:
        with self._lock:
            return sorted(self._mine)

    def snapshot(self) -> dict:
        """The /stats ``leases`` block: what this replica holds, at
        which epochs, plus lifecycle counters."""
        with self._lock:
            return {"owner": self.owner,
                    "n_shards": self.n_shards,
                    "ttl_s": self.ttl_s,
                    "owned": sorted(self._mine),
                    "epochs": {str(s): m["epoch"]
                               for s, m in sorted(self._mine.items())},
                    "counts": dict(self._counts)}


class LeaseKeeper:
    """The replica's lease heartbeat loop: renew everything held, then
    scan for shards to pick up — our own from a previous incarnation
    (instantly), free/expired ones up to ``target`` (the supervisor
    passes ceil(shards/N) so a first-booted replica doesn't hoard the
    whole ring), and ANY shard orphaned longer than ``rescue_after_s``
    regardless of target (a dead replica's users must not wait for
    fleet-size arithmetic). ``step()`` is callable directly so tests
    drive it under scripted clocks; ``start()`` runs it on a daemon
    thread every ``interval_s`` (default TTL/3)."""

    def __init__(self, manager: LeaseManager, *,
                 interval_s: float | None = None,
                 target: int | None = None,
                 rescue_after_s: float | None = None):
        self.manager = manager
        self.interval_s = (float(interval_s) if interval_s is not None
                           else manager.ttl_s / 3.0)
        self.target = target
        self.rescue_after_s = (float(rescue_after_s)
                               if rescue_after_s is not None
                               else 2.0 * manager.ttl_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def step(self) -> None:
        m = self.manager
        if m.n_shards is None:
            return
        m.renew_all()
        held = len(m.owned())
        mine = set(m.owned())
        for shard in range(m.n_shards):
            if shard in mine:
                continue
            now = m.clock()
            cur = m.owner_of(shard)
            expired = cur is None or now >= float(cur["expires_at"])
            if not expired:
                continue
            was_mine = cur is not None and cur["owner"] == m.owner
            orphaned = (cur is not None and
                        now >= float(cur["expires_at"]) +
                        self.rescue_after_s)
            if (was_mine or self.target is None or held < self.target
                    or orphaned):
                if m.acquire(shard):
                    held += 1

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name=f"lease-keeper-{self.manager.owner}",
            daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.step()
            except Exception:  # keep the heartbeat alive; admission
                pass           # still fences via ensure_owned
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
