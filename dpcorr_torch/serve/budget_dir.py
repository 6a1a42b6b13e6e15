"""Sharded per-user budget directory: crash-safe ε accounting at scale.

Counterpart of ``dpcorr/serve/budget_dir.py``, with its file formats
(``meta.json``, shard snapshots, WALs): a directory written by either
package is recovered by the other. It imports no torch.

The per-party ledger (serve.ledger) answers "how much has this *data
owner* spent"; a multi-tenant deployment also has to answer "how much
has this *user* spent" for millions of principals, under the same
refuse-before-execute, never-double-charge discipline — a budget store
that loses or duplicates a charge across a crash is a privacy
violation, not just a bug. Three pieces:

- :class:`BudgetDirectory` — users consistent-hashed onto shards
  (sha256 ring, deterministic across processes; the shard count is
  pinned in ``meta.json`` so a reopen can never re-route a user).
  Each shard is a **write-ahead journal**: an appended, fsynced WAL
  line per mutation, folded periodically into a tmp+fsync+rename
  snapshot (compaction), with the snapshot/WAL pair versioned by a
  generation number so a crash *between* the snapshot rename and the
  WAL reset can never replay already-folded entries. Charge/refund
  lines carry the user's window start and burst so a recovery that
  must re-create a user from the WAL alone (not yet compacted into a
  snapshot) restores the true window — never ``w=0.0``, which would
  fire a spurious renewal on the first post-restart charge. Cold
  users are LRU-evicted to a per-shard spill file that is only a
  within-process memory-relief cache — restart recovery is always
  snapshot + WAL, so a crash mid-eviction loses nothing; the spill is
  rewritten compactly at compaction and whenever dead (rehydrated)
  lines outnumber live ones, and an unparseable spill fails the whole
  shard loudly (every later call re-raises the quarantine error)
  rather than silently forgetting evicted users' spend. Charges carry
  idempotent ``charge_id``s exactly like protocol/journal.py: a
  resumed session's re-charge is a durable no-op.
- **Renewal/decay** — :class:`RenewalPolicy`: each user's window spend
  resets every ``period_s`` (daily ε refresh), carrying unused
  headroom forward as burst credit up to ``burst_cap``. The clock is
  injectable, so policies are testable under a scripted clock.
  Renewals are journaled as absolute resulting state (idempotent to
  replay), riding the **same fsynced append** as the charge they
  admit — a refused charge journals nothing, renewal included — and
  draw **no** audit event: the audit trail tracks the monotone
  *lifetime* spend, which renewal does not touch — that is what keeps
  the audit replay (``obs.audit.replay_levels``) an exact equality over the
  sharded trails.
- :class:`CompositeLedger` — composes per-user + per-party + global
  budgets into **one atomic charge with one refund path**. User legs
  live under the reserved ``user/`` principal namespace, the global
  cap under ``global/total`` (charged inside the *same*
  ``PrivacyLedger.charge`` as the party legs, hence atomic with them);
  :meth:`CompositeLedger.charge` augments a per-party charge dict with
  the derived legs, charges the directory first and compensates it on
  a party/global refusal, so a refused request consumes zero ε at
  every level. :meth:`CompositeLedger.refund` performs the same
  augmentation, so the coalescer's shed-refund path and the protocol
  gate's transport-failure refund reverse every leg symmetrically
  without knowing the directory exists.

Crash windows (all four registered as chaos points; kill-and-restart at
each recovers to exact per-user balances):

- ``budget.pre_journal`` — before the WAL append: nothing durable, the
  resumed session's re-charge applies exactly once.
- ``budget.post_journal`` — after the fsynced append, before the
  in-memory apply: recovery replays the WAL, the re-charge dedups on
  its charge_id.
- ``budget.mid_compaction`` — after the new snapshot renamed, before
  the WAL reset: the WAL's generation is now *behind* the snapshot's,
  so recovery discards it instead of double-applying folded entries.
- ``budget.mid_eviction`` — after the cold-spill append, before the
  resident drop: the spill file is non-authoritative (reset on open),
  so the authoritative snapshot+WAL state is untouched.

WAL appends are a single ``write``+``flush``+``fsync`` per admission;
the chaos points bracket that write, so every registered window leaves
either no entry or a complete fsynced line. Any *unparseable* shard
file — snapshot, WAL, or spill — is quarantined whole to a
``.corrupt`` sidecar and refused loudly (:class:`DirectoryCorruptError`)
rather than half-applied, with the same stale-``.tmp`` sweep the
ledger uses.

This module is the *write* side; the snapshot/WAL arithmetic that
recovery and auditing share — :func:`load_shard`,
:func:`read_user_balances`, the ``.corrupt`` quarantine — lives in
:mod:`dpcorr_torch.obs.budget_replay`, so the auditor and the live
directory can never drift on what a shard file means.

With ``lease=`` (a :class:`~dpcorr_torch.serve.fleet.lease.LeaseManager`)
the directory is shared on disk by a fleet of replicas: a shard's journal
opens lazily and only while this process holds the shard's lease, a
charge on a shard held elsewhere raises ``ShardNotOwnedError`` before
anything is charged, and per-charge ids make a retry across a takeover
count once.
"""

from __future__ import annotations

import bisect
import dataclasses
import fcntl
import hashlib
import json
import os
import threading
import time
from collections import OrderedDict
from typing import Mapping

from dpcorr_torch import chaos
from dpcorr_torch.obs.audit import AuditTrail
from dpcorr_torch.obs.budget_replay import (
    DIR_VERSION as _DIR_VERSION,
    GLOBAL_KEY,
    RESERVED_PREFIXES,
    USER_PREFIX,
    DirectoryCorruptError,
    corrupt_error as _corrupt,
    fresh_user as _fresh_user,
    load_shard,
    sweep_stale_tmp,
)
from dpcorr_torch.serve.ledger import BudgetExceededError, PrivacyLedger

__all__ = [
    "GLOBAL_KEY", "RESERVED_PREFIXES", "USER_PREFIX",
    "BudgetDirectory", "CompositeLedger", "DirectoryCorruptError",
    "RenewalPolicy", "is_reserved", "party_view", "user_view",
]

#: idempotency memory per shard, mirroring serve.ledger's bound: far
#: above any live session's outstanding charges, capped only so a
#: long-lived shard snapshot cannot grow unboundedly.
_CHARGE_ID_CAP = 4096


def is_reserved(principal: str) -> bool:
    """True for directory-managed principals (``user/``, ``global/``)."""
    return principal.startswith(RESERVED_PREFIXES)


def party_view(charges: Mapping[str, float]) -> dict[str, float]:
    """The per-party legs of a (possibly augmented) charge dict — what
    actually crossed the wire / reached a kernel, for cost attribution
    and transcript matching."""
    return {k: float(v) for k, v in charges.items() if not is_reserved(k)}


def user_view(charges: Mapping[str, float]) -> dict[str, float]:
    """The per-user legs, keyed by bare user id."""
    return {k[len(USER_PREFIX):]: float(v) for k, v in charges.items()
            if k.startswith(USER_PREFIX)}


@dataclasses.dataclass(frozen=True)
class RenewalPolicy:
    """Per-user window refresh: every ``period_s`` the window spend
    resets and unused headroom carries forward as burst credit, capped
    at ``burst_cap`` (0.0 = plain daily refresh, no carry). Admission
    checks the window spend against ``user_budget + burst``."""

    period_s: float = 86400.0
    burst_cap: float = 0.0

    def __post_init__(self):
        if self.period_s <= 0.0:
            raise ValueError(f"period_s must be positive, got "
                             f"{self.period_s}")
        if self.burst_cap < 0.0:
            raise ValueError(f"burst_cap must be >= 0, got "
                             f"{self.burst_cap}")


def _hash64(s: str) -> int:
    """Deterministic placement hash (never Python's salted hash())."""
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")


def build_ring(n_shards: int,
               replicas: int = 16) -> tuple[list[int], list[int]]:
    """The directory's consistent-hash ring as ``(keys, shard_ids)``.

    Module-level so a router can compute ``user -> shard`` with the
    exact arithmetic the directory routes by, without opening any
    journal."""
    points = sorted((_hash64(f"shard-{i}:{r}"), i)
                    for i in range(n_shards) for r in range(replicas))
    return [h for h, _ in points], [i for _, i in points]


def ring_shard_index(user: str, ring_keys: list[int],
                     ring_shards: list[int]) -> int:
    """Route ``user`` on a ring built by :func:`build_ring`."""
    j = bisect.bisect_right(ring_keys, _hash64(user)) % len(ring_keys)
    return ring_shards[j]


def _atomic_write(path: str, text: str, fsync: bool = True) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(text)
        fh.flush()
        if fsync:
            os.fsync(fh.fileno())
    os.replace(tmp, path)


class _Shard:
    """One shard: resident user table + WAL + snapshot + cold spill.

    All state is guarded by one lock; every mutation is journaled
    (write-ahead) before it is applied in memory.
    """

    def __init__(self, base: str, user_budget: float,
                 renewal: RenewalPolicy, clock, fsync: bool,
                 max_resident: int | None, compact_every: int | None):
        self.snap_path = base + ".json"
        self.wal_path = base + ".wal"
        self.cold_path = base + ".cold"
        self.user_budget = float(user_budget)
        self.renewal = renewal
        self.clock = clock
        self.fsync = fsync
        self.max_resident = max_resident
        self.compact_every = compact_every
        self._lock = threading.Lock()
        self._users: OrderedDict[str, dict] = OrderedDict()  # guarded by: _lock
        self._cold_index: dict[str, int] = {}  # guarded by: _lock
        self._charge_ids: dict[str, None] = {}  # guarded by: _lock
        self._gen = 0  # guarded by: _lock
        self._dirty = 0  # guarded by: _lock
        self._cold_end = 0  # guarded by: _lock
        self._cold_dead = 0  # dead (superseded) spill lines, guarded by: _lock
        self._failed: DirectoryCorruptError | None = None  # guarded by: _lock
        self.counters = {  # guarded by: _lock
            "charges": 0, "refunds": 0, "dedups": 0, "refusals": 0,
            "renewals": 0, "evictions": 0, "rehydrations": 0,
            "compactions": 0, "charged_eps": 0.0, "refunded_eps": 0.0,
        }
        # recovery is the shared core (obs.budget_replay):
        # snapshot + generation-checked WAL replay, quarantining
        # anything unparseable. Constructor-only, so no concurrency and
        # no chaos points — the registered crash windows are in the
        # live mutation paths; recovery itself must run to completion.
        rec = load_shard(base)
        self._gen = rec["gen"]
        self._users = OrderedDict(rec["users"])
        self._charge_ids = dict(rec["charge_ids"])
        while len(self._charge_ids) > _CHARGE_ID_CAP:
            self._charge_ids.pop(next(iter(self._charge_ids)))
        self._dirty = rec["wal_entries"]
        if rec["wal_fresh_needed"]:
            self._write_fresh_wal_locked()
        # within-process spill cache, reset on open
        # dpcorr-lint: ignore[durability-bare-write] — within-process spill cache, reset on open
        self._cold = open(self.cold_path, "w+", encoding="utf-8")  # guarded by: _lock
        self._evict_down_locked(fire_chaos=False)

    # -- journaling --------------------------------------------------

    def _write_fresh_wal_locked(self) -> None:
        _atomic_write(self.wal_path,
                      json.dumps({"k": "wal", "gen": self._gen}) + "\n",
                      fsync=self.fsync)

    def _wal_append_locked(self, entries: list[dict]) -> None:
        data = "".join(json.dumps(e) + "\n" for e in entries)
        with open(self.wal_path, "a", encoding="utf-8") as fh:
            fh.write(data)
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())

    def _remember_locked(self, charge_id: str) -> None:
        self._charge_ids[charge_id] = None
        while len(self._charge_ids) > _CHARGE_ID_CAP:
            self._charge_ids.pop(next(iter(self._charge_ids)))

    # -- residency ---------------------------------------------------

    def _check_failed_locked(self) -> None:
        if self._failed is not None:
            raise self._failed

    def _touch_locked(self, user: str) -> dict:
        st = self._users.get(user)
        if st is not None:
            self._users.move_to_end(user)
            return st
        off = self._cold_index.pop(user, None)
        if off is not None:
            st = self._read_cold_locked(user, off)
            self.counters["rehydrations"] += 1
            # the user's spill line is now dead; reclaimed once dead
            # lines outnumber live ones (_evict_down_locked)
            self._cold_dead += 1
        else:
            st = _fresh_user(float(self.clock()))
        self._users[user] = st
        return st

    def _read_cold_locked(self, user: str, off: int) -> dict:
        try:
            self._cold.seek(off)
            entry = json.loads(self._cold.readline())
            if entry["u"] != user:
                raise ValueError(f"spill offset {off} holds "
                                 f"{entry['u']!r}, wanted {user!r}")
            st = entry["st"]
            return {"s": float(st["s"]), "l": float(st["l"]),
                    "b": float(st["b"]), "w": float(st["w"])}
        except (json.JSONDecodeError, OSError, KeyError, TypeError,
                ValueError) as e:
            # fail the whole shard, not just this read: evicted users'
            # in-memory state lived only in the spill, so continuing
            # would silently forget their spend. Every later mutation
            # or read re-raises the same loud quarantine error; a
            # restart recovers from the authoritative snapshot + WAL.
            self._cold.close()
            self._failed = _corrupt(self.cold_path, str(e))
            raise self._failed from e

    def _peek_locked(self, user: str) -> dict | None:
        """Read-only view: no LRU touch, no rehydration churn."""
        st = self._users.get(user)
        if st is not None:
            return st
        off = self._cold_index.get(user)
        if off is not None:
            return self._read_cold_locked(user, off)
        return None

    def _evict_down_locked(self, fire_chaos: bool = True) -> None:
        if self.max_resident is None:
            return
        while len(self._users) > self.max_resident:
            user = next(iter(self._users))
            st = self._users[user]
            off = self._cold_end
            line = json.dumps({"u": user, "st": st}) + "\n"
            self._cold.seek(off)
            self._cold.write(line)
            self._cold.flush()
            self._cold_end = off + len(line)
            if fire_chaos:
                # the spill append landed but the user is still
                # resident: the authoritative snapshot+WAL state is
                # untouched, so a kill here loses nothing
                chaos.point("budget.mid_eviction")
            del self._users[user]
            self._cold_index[user] = off
            self.counters["evictions"] += 1
        # rehydration leaves the old spill line behind and _cold_end
        # only advances, so under residency churn dead lines would
        # otherwise grow the file forever; rewriting once they
        # outnumber live ones bounds it at ~2x the live set
        if self._cold_dead > max(16, len(self._cold_index)):
            self._write_cold_locked(
                {u: self._read_cold_locked(u, off)
                 for u, off in self._cold_index.items()})

    def _write_cold_locked(self, states: dict[str, dict]) -> None:
        """Rewrite the spill to hold exactly ``states``, compactly."""
        self._cold.seek(0)
        self._cold.truncate()
        self._cold_end = 0
        self._cold_dead = 0
        self._cold_index = {}
        for user, st in states.items():
            line = json.dumps({"u": user, "st": st}) + "\n"
            self._cold.write(line)
            self._cold_index[user] = self._cold_end
            self._cold_end += len(line)
        self._cold.flush()

    # -- renewal -----------------------------------------------------

    def _pending_renewal_locked(self, st: dict
                                ) -> tuple[float, float] | None:
        """The post-renewal ``(window_start, burst)`` for ``st`` when a
        window refresh is due, else None — computed WITHOUT mutating
        anything: admission is checked against this view first, and
        the renewal is journaled together with the charge it admits in
        one fsynced append, so a refused request leaves no durable
        trace at all (not even the renewal)."""
        now = float(self.clock())
        if now < st["w"] + self.renewal.period_s:
            return None
        periods = int((now - st["w"]) // self.renewal.period_s)
        s, b = st["s"], st["b"]
        # after two spend-free iterations the carry is at a fixed
        # point, so a long-idle user needs at most a few steps
        for _ in range(min(periods, 4)):
            b = min(self.renewal.burst_cap,
                    max(0.0, self.user_budget + b - s))
            s = 0.0
        return st["w"] + self.renewal.period_s * periods, b

    # -- mutations ---------------------------------------------------

    def charge(self, user: str, eps: float,
               charge_id: str | None = None) -> bool:
        """Admit-or-refuse one user-leg charge. Returns True when the
        charge applied, False when ``charge_id`` dedup'd it; raises
        :class:`~dpcorr_torch.serve.ledger.BudgetExceededError` (level
        ``user``) when the window budget + burst would be overdrawn —
        without journaling or applying anything (a due renewal is
        checked against, but journaled and applied only together with
        an admitted charge, so refusals are trace-free exactly)."""
        if eps < 0.0:
            raise ValueError(f"negative charge {eps} for user {user!r}")
        with self._lock:
            self._check_failed_locked()
            if charge_id is not None and charge_id in self._charge_ids:
                self.counters["dedups"] += 1
                return False
            st = self._touch_locked(user)
            renewed = self._pending_renewal_locked(st)
            win_s = 0.0 if renewed is not None else st["s"]
            win_b = renewed[1] if renewed is not None else st["b"]
            cap = self.user_budget + win_b
            # strict > with tolerance, matching the party ledger: a
            # charge landing exactly on the cap is admitted
            if win_s + eps > cap + 1e-12:
                self.counters["refusals"] += 1
                raise BudgetExceededError(USER_PREFIX + user, win_s,
                                          eps, cap)
            lines = []
            if renewed is not None:
                lines.append({"k": "n", "u": user, "w": renewed[0],
                              "b": renewed[1]})
            # the entry carries the (post-renewal) window state: a
            # recovery that has to re-CREATE this user from the WAL
            # (no snapshot line yet) must restore the true window
            # start — rebuilding with w=0.0 would fire a spurious
            # renewal on the first post-restart charge and let the
            # window budget be overspent
            lines.append({"k": "c", "u": user, "e": eps,
                          "id": charge_id,
                          "w": renewed[0] if renewed is not None
                          else st["w"], "b": win_b})
            chaos.point("budget.pre_journal")
            # WAL-before-ack: fsync order IS the serialization order
            # dpcorr-lint: ignore[blocking-under-lock] — WAL-before-ack: fsync order IS the serialization order
            self._wal_append_locked(lines)
            chaos.point("budget.post_journal")
            if renewed is not None:
                st["w"], st["b"] = renewed
                st["s"] = 0.0
                self.counters["renewals"] += 1
            st["s"] += eps
            st["l"] += eps
            if charge_id is not None:
                self._remember_locked(charge_id)
            self.counters["charges"] += 1
            self.counters["charged_eps"] += eps
            self._dirty += len(lines)
            self._evict_down_locked()
            # compaction must see a quiesced shard
            # dpcorr-lint: ignore[blocking-under-lock] — compaction must see a quiesced shard
            self._maybe_compact_locked()
            return True

    def refund(self, user: str, eps: float,
               charge_id: str | None = None) -> None:
        """Reverse a user-leg charge whose query never executed.
        Clamps at zero like the party ledger (a stray refund can only
        over-count, never under-count) and forgets the charge_id so a
        genuinely new charge may reuse it."""
        if eps < 0.0:
            raise ValueError(f"negative refund {eps} for user {user!r}")
        with self._lock:
            self._check_failed_locked()
            st = self._touch_locked(user)
            # w/b carried for the same WAL-only re-creation case as
            # charge entries
            # WAL-before-ack: fsync order IS the serialization order
            # dpcorr-lint: ignore[blocking-under-lock] — WAL-before-ack: fsync order IS the serialization order
            self._wal_append_locked(
                [{"k": "r", "u": user, "e": eps, "id": charge_id,
                  "w": st["w"], "b": st["b"]}])
            st["s"] = max(0.0, st["s"] - eps)
            st["l"] = max(0.0, st["l"] - eps)
            if charge_id is not None:
                self._charge_ids.pop(charge_id, None)
            self.counters["refunds"] += 1
            self.counters["refunded_eps"] += eps
            self._dirty += 1
            self._evict_down_locked()
            # compaction must see a quiesced shard
            # dpcorr-lint: ignore[blocking-under-lock] — compaction must see a quiesced shard
            self._maybe_compact_locked()

    # -- compaction --------------------------------------------------

    def _maybe_compact_locked(self) -> None:
        if self.compact_every is None or self._dirty < self.compact_every:
            return
        self._compact_locked()

    def _compact_locked(self) -> None:
        users = dict(self._users)
        cold_states = {user: self._read_cold_locked(user, off)
                       for user, off in self._cold_index.items()}
        users.update(cold_states)
        gen = self._gen + 1
        state = {"version": _DIR_VERSION, "gen": gen, "users": users,
                 "charge_ids": list(self._charge_ids)}
        _atomic_write(self.snap_path, json.dumps(state),
                      fsync=self.fsync)
        # the torn window: snapshot now says gen+1, the WAL still says
        # gen — recovery discards the stale WAL instead of replaying
        # entries the snapshot already folded in
        chaos.point("budget.mid_compaction")
        self._gen = gen
        self._write_fresh_wal_locked()
        self._dirty = 0
        self.counters["compactions"] += 1
        # every spilled state was just read anyway — rewrite the spill
        # compactly so dead bytes from rehydration churn are reclaimed
        self._write_cold_locked(cold_states)

    # -- views -------------------------------------------------------

    def spent(self, user: str) -> float:
        with self._lock:
            self._check_failed_locked()
            st = self._peek_locked(user)
            return st["s"] if st is not None else 0.0

    def lifetime(self, user: str) -> float:
        with self._lock:
            self._check_failed_locked()
            st = self._peek_locked(user)
            return st["l"] if st is not None else 0.0

    def headroom(self, user: str) -> float:
        with self._lock:
            self._check_failed_locked()
            st = self._peek_locked(user)
            if st is None:
                return self.user_budget
            return self.user_budget + st["b"] - st["s"]

    def stats_locked_view(self) -> dict:
        with self._lock:
            return {"resident": len(self._users),
                    "evicted": len(self._cold_index),
                    "counters": dict(self.counters)}

    def close(self) -> None:
        with self._lock:
            if not self._cold.closed:  # quarantine already closed it
                self._cold.close()


class BudgetDirectory:
    """Consistent-hash directory of :class:`_Shard` budget journals.

    ``root`` is a directory; the shard count is written to
    ``meta.json`` on first creation and **pinned** — a reopen adopts
    the persisted count (re-hashing users onto a different ring would
    silently split balances). All reads/writes are routed by a sha256
    ring (``replicas`` points per shard), deterministic across
    processes and restarts.
    """

    def __init__(self, root: str, shards: int = 8,
                 user_budget: float = 1.0,
                 renewal: RenewalPolicy | None = None,
                 max_resident: int | None = None,
                 compact_every: int | None = 256,
                 replicas: int = 16, clock=time.time,
                 fsync: bool = True,
                 audit: AuditTrail | None = None,
                 lease=None):
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        self.root = str(root)
        self.audit = audit
        os.makedirs(self.root, exist_ok=True)
        meta_path = os.path.join(self.root, "meta.json")
        # replicas of a fleet open one directory at once: the sweep and
        # the first write of meta.json run under an exclusive lock on
        # the directory itself (no file of its own: the layout stays the
        # JAX package's), or one replica's sweep unlinks another's tmp
        # file before its rename and that replica dies at boot
        lock_fd = os.open(self.root, os.O_RDONLY)
        try:
            fcntl.flock(lock_fd, fcntl.LOCK_EX)
            sweep_stale_tmp(meta_path)
            if os.path.exists(meta_path):
                try:
                    with open(meta_path, encoding="utf-8") as fh:
                        meta = json.load(fh)
                    shards = int(meta["shards"])
                except (json.JSONDecodeError, UnicodeDecodeError, OSError,
                        KeyError, TypeError, ValueError) as e:
                    raise _corrupt(meta_path, str(e)) from e
            else:
                _atomic_write(meta_path, json.dumps(
                    {"version": _DIR_VERSION, "shards": shards}))
        finally:
            os.close(lock_fd)  # releases the lock
        self.n_shards = shards
        self.renewal = renewal if renewal is not None else RenewalPolicy()
        self.user_budget = float(user_budget)
        self._mk = lambda i: _Shard(
            os.path.join(self.root, f"shard-{i:04d}"),
            self.user_budget, self.renewal, clock, fsync,
            max_resident, compact_every)
        self._lease = lease
        self._open_lock = threading.Lock()
        if lease is None:
            # single-owner mode: every shard journal opens eagerly
            self._shards: list[_Shard | None] = \
                [self._mk(i) for i in range(shards)]
        else:
            # fleet mode: the directory is SHARED on disk; a shard's
            # journal opens lazily and only while this process holds
            # its lease, so two replicas never have the same WAL open
            self._shards = [None] * shards
            lease.bind(shards, on_lost=self.drop_shard)
        self._ring_keys, self._ring_shards = build_ring(shards, replicas)

    def shard_index(self, user: str) -> int:
        return ring_shard_index(user, self._ring_keys, self._ring_shards)

    def _shard_at(self, i: int) -> _Shard:
        """The open shard journal (reopened after :meth:`drop_shard`),
        gated on lease ownership when the directory is fleet-shared:
        raises the lease layer's ``ShardNotOwnedError`` (charge-free —
        nothing was touched) when another replica owns shard ``i``."""
        if self._lease is not None:
            self._lease.ensure_owned(i)
        s = self._shards[i]
        if s is None:
            with self._open_lock:
                s = self._shards[i]
                if s is None:
                    s = self._mk(i)
                    self._shards[i] = s
        return s

    def drop_shard(self, i: int) -> None:
        """Close shard ``i``'s journal (in fleet mode: its lease was lost
        or released); the next touch reopens it from its snapshot and WAL,
        in fleet mode only after the lease is held again."""
        with self._open_lock:
            s = self._shards[i]
            self._shards[i] = None
        if s is not None:
            s.close()

    def _shard(self, user: str) -> _Shard:
        return self._shard_at(self.shard_index(user))

    # -- accounting --------------------------------------------------

    def charge(self, user: str, eps: float,
               trace_id: str | None = None,
               charge_id: str | None = None) -> bool:
        """Charge one user leg; audit-recorded under the ``user/``
        principal after the WAL append is durable (the same
        observe-after-persist ordering the party ledger keeps).
        Returns whether the charge applied (False = the shard already
        held ``charge_id`` and this call spent nothing)."""
        key = USER_PREFIX + user
        try:
            applied = self._shard(user).charge(user, eps,
                                               charge_id=charge_id)
        except BudgetExceededError as e:
            if self.audit is not None:
                self.audit.record("refusal", {key: eps},
                                  trace_id=trace_id, party=key,
                                  spent=e.spent, budget=e.budget)
            raise
        if self.audit is not None:
            detail = {} if charge_id is None else {"charge_id": charge_id}
            if not applied:
                detail["dedup"] = True
            self.audit.record("charge", {key: eps}, trace_id=trace_id,
                              **detail)
        return applied

    def refund(self, user: str, eps: float,
               trace_id: str | None = None,
               charge_id: str | None = None,
               reason: str | None = None) -> None:
        key = USER_PREFIX + user
        self._shard(user).refund(user, eps, charge_id=charge_id)
        if self.audit is not None:
            detail = {} if charge_id is None else {"charge_id": charge_id}
            if reason is not None:
                detail["reason"] = reason
            self.audit.record("refund", {key: eps}, trace_id=trace_id,
                              **detail)

    # -- views -------------------------------------------------------

    def spent(self, user: str) -> float:
        return self._shard(user).spent(user)

    def lifetime(self, user: str) -> float:
        return self._shard(user).lifetime(user)

    def headroom(self, user: str) -> float:
        return self._shard(user).headroom(user)

    def counters(self) -> dict:
        totals: dict = {}
        resident = evicted = 0
        for s in self._shards:
            if s is None:  # dropped (or, in fleet mode, not held)
                continue
            view = s.stats_locked_view()
            resident += view["resident"]
            evicted += view["evicted"]
            for k, v in view["counters"].items():
                totals[k] = totals.get(k, 0) + v
        totals["resident_users"] = resident
        totals["evicted_users"] = evicted
        return totals

    def snapshot(self) -> dict:
        """Point-in-time directory view (the /stats block's shape)."""
        c = self.counters()
        return {"shards": self.n_shards,
                "user_budget": self.user_budget,
                "renew_period_s": self.renewal.period_s,
                "burst_cap": self.renewal.burst_cap,
                "resident_users": c.pop("resident_users"),
                "evicted_users": c.pop("evicted_users"),
                "counters": c}

    def close(self) -> None:
        for i in range(self.n_shards):
            self.drop_shard(i)


def _leg_id(charge_id: str | None, key: str) -> str | None:
    """Derived per-leg charge_id: keeps the directory's idempotency
    keyed to the same logical charge as the party ledger's, without
    the two stores sharing an id namespace."""
    return None if charge_id is None else f"{charge_id}#{key}"


class CompositeLedger:
    """Per-user + per-party + global admission as one atomic charge.

    Drop-in for :class:`~dpcorr_torch.serve.ledger.PrivacyLedger` wherever a
    charge/refund sink is expected (the coalescer's refund path, the
    protocol :class:`~dpcorr_torch.protocol.gate.ReleaseGate`): ``charge``
    augments the per-party dict with a ``user/<id>`` leg (the bound
    ``user``, or per-request via :meth:`charge_request`) and a
    ``global/total`` leg, each equal to the total party ε of the
    charge. The global leg is charged inside the *same*
    ``PrivacyLedger.charge`` as the party legs (as a reserved
    principal with its own budget override), so party+global are
    atomic by construction; the user leg is charged first in the
    directory and compensated on any party/global refusal — hence a
    refused request consumes zero ε at every level, and the refusal's
    :class:`~dpcorr_torch.serve.ledger.BudgetExceededError` names which
    level refused (``e.level``: user | party | global).

    ``refund`` performs the same augmentation, so a caller holding
    only the original per-party dict (the gate's transport-failure
    path) and a caller holding the augmented dict (the coalescer's
    shed path) both reverse every leg — one refund path.
    """

    def __init__(self, ledger: PrivacyLedger,
                 directory: BudgetDirectory | None,
                 user: str | None = None,
                 global_budget: float | None = None):
        self.ledger = ledger
        self.directory = directory
        self.user = user
        self.global_budget = (None if global_budget is None
                              else float(global_budget))
        if self.global_budget is not None:
            # the reserved principal rides the party ledger's own
            # atomic check+spend+persist — no second commit point
            ledger.per_party[GLOBAL_KEY] = self.global_budget
        self._lock = threading.Lock()
        self._refusals = {"user": 0, "party": 0, "global": 0}  # guarded by: _lock

    # -- augmentation ------------------------------------------------

    def augment(self, charges: Mapping[str, float],
                user: str | None = None) -> dict[str, float]:
        """Add the derived user/global legs to a per-party charge
        dict. Idempotent: legs already present are left untouched, so
        an augmented dict can round-trip through the coalescer's
        refund path unchanged."""
        out = {k: float(v) for k, v in charges.items()}
        total = sum(v for k, v in out.items() if not is_reserved(k))
        uid = user if user is not None else self.user
        if uid is not None \
                and not any(k.startswith(USER_PREFIX) for k in out):
            out[USER_PREFIX + uid] = total
        if self.global_budget is not None and GLOBAL_KEY not in out:
            out[GLOBAL_KEY] = total
        return out

    # -- the one atomic charge / one refund path ---------------------

    def charge(self, charges: Mapping[str, float],
               trace_id: str | None = None,
               charge_id: str | None = None) -> list[str]:
        """All-or-nothing across every level. User legs charge the
        directory first (idempotent per-leg charge_ids derived from
        ``charge_id``); the party+global legs then charge the wrapped
        ledger atomically. ANY in-process failure of a later leg — a
        budget refusal, but equally an OSError or corruption error
        persisting the party snapshot — compensates the directory legs
        THIS call applied and re-raises, so no exception path leaves a
        user leg charged for a query that never executed. A leg the
        directory deduped (its derived charge_id already durable — a
        retry of a charge a dying replica made) spent nothing here, so
        compensation must not reverse it: the earlier charge stands
        until the logical request succeeds (then the success dedups
        too — exactly one spend) or is abandoned (over-count, the
        privacy-safe direction). Only a hard process death between the
        two stores escapes compensation (``SimulatedCrash`` is a
        BaseException for exactly this reason): recovered the same way
        when a ``charge_id`` is present. Returns the deduped user-leg
        keys so callers can strip them from the dict they would later
        refund."""
        aug = self.augment(charges)
        user_legs = [(k, v) for k, v in aug.items()
                     if k.startswith(USER_PREFIX)]
        rest = {k: v for k, v in aug.items()
                if not k.startswith(USER_PREFIX)}
        done: list[tuple[str, float]] = []
        deduped: list[str] = []
        try:
            if self.directory is not None:
                for key, eps in user_legs:
                    applied = self.directory.charge(
                        key[len(USER_PREFIX):], eps, trace_id=trace_id,
                        charge_id=_leg_id(charge_id, key))
                    if applied:
                        done.append((key, eps))
                    else:
                        deduped.append(key)
            self.ledger.charge(rest, trace_id=trace_id,
                               charge_id=charge_id)
        except Exception as e:
            if isinstance(e, BudgetExceededError):
                with self._lock:
                    self._refusals[e.level] = \
                        self._refusals.get(e.level, 0) + 1
                reason = f"refused_{e.level}"
            else:
                reason = "charge_failed"
            for key, eps in done:
                self.directory.refund(key[len(USER_PREFIX):], eps,
                                      trace_id=trace_id,
                                      charge_id=_leg_id(charge_id, key),
                                      reason=reason)
            raise
        return deduped

    def charge_request(self, req, trace_id: str | None = None,
                       charge_id: str | None = None) -> dict[str, float]:
        """Charge one request's spend across every level; returns the
        AUGMENTED charge dict — the server carries it through the
        coalescer so a shed refund reverses every leg. ``charge_id``
        (the request's durable retry identity) makes the user legs
        idempotent: a retry, even after a restart, dedups against the
        WAL-recovered charge_id set instead of double-spending. Deduped legs are
        stripped from the returned dict — this attempt did not make
        that spend, so no shed-path refund of this attempt may reverse
        it."""
        from dpcorr_torch.serve.ledger import request_charges

        charges = self.augment(request_charges(req),
                               user=getattr(req, "user", None))
        deduped = self.charge(charges, trace_id=trace_id,
                              charge_id=charge_id)
        if deduped:
            charges = {k: v for k, v in charges.items()
                       if k not in deduped}
        return charges

    def refund(self, charges: Mapping[str, float],
               trace_id: str | None = None,
               charge_id: str | None = None,
               reason: str | None = None) -> None:
        """The one refund path: augments exactly like :meth:`charge`
        (no-op on an already-augmented dict) and reverses every leg —
        directory and ledger — for a query that provably never
        executed."""
        aug = self.augment(charges)
        if self.directory is not None:
            for k, v in aug.items():
                if k.startswith(USER_PREFIX):
                    self.directory.refund(k[len(USER_PREFIX):], v,
                                          trace_id=trace_id,
                                          charge_id=_leg_id(charge_id,
                                                            k),
                                          reason=reason)
        rest = {k: v for k, v in aug.items()
                if not k.startswith(USER_PREFIX)}
        self.ledger.refund(rest, trace_id=trace_id, charge_id=charge_id,
                           reason=reason)

    # -- passthrough views -------------------------------------------

    def spent(self, principal: str) -> float:
        if principal.startswith(USER_PREFIX) and self.directory is not None:
            return self.directory.spent(principal[len(USER_PREFIX):])
        return self.ledger.spent(principal)

    def remaining(self, principal: str) -> float:
        if principal.startswith(USER_PREFIX) and self.directory is not None:
            return self.directory.headroom(principal[len(USER_PREFIX):])
        return self.ledger.remaining(principal)

    def budget_for(self, party: str) -> float:
        return self.ledger.budget_for(party)

    def snapshot(self) -> dict:
        return self.ledger.snapshot()

    def refusals_by_level(self) -> dict[str, int]:
        with self._lock:
            return dict(self._refusals)

    def directory_snapshot(self) -> dict | None:
        """The /stats ``budget_dir`` block: shard/residency/counter
        view plus which level refused how often."""
        if self.directory is None:
            return None
        snap = self.directory.snapshot()
        snap["refusals_by_level"] = self.refusals_by_level()
        return snap

    @property
    def audit(self):
        return self.ledger.audit

    def close(self) -> None:
        if self.directory is not None:
            self.directory.close()
