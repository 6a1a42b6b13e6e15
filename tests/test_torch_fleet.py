"""The port's serve fleet (``dpcorr_torch.serve.fleet``) against
``dpcorr.serve.fleet``, on the CPU.

- the cases of the JAX package's ``tests/test_fleet_serve.py`` on the
  port: durable shard leases under scripted clocks (grant, renew, expire,
  takeover, epoch fencing, the ``fleet.pre_lease_commit`` crash), the
  lease-gated budget directory, the front-end router against canned
  in-thread replicas, and the supervisor against a stub child that
  imports nothing of either package;
- the two packages on one lease directory and one budget directory: each
  reads, renews and takes over the other's leases, charges stay exact
  across a takeover between packages, and both front ends order the
  candidates alike;
- the lease-mode server: two replicas in process behind a front end, the
  421 refusal naming the owner and the client's mapping of it, and
  ``fleet up`` refusing to come up without a card.

All checks are exact: integer counts, epochs, byte-equal files and
binary-equal ε.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from dpcorr_torch import chaos
from dpcorr_torch.chaos import ChaosPlan, SimulatedCrash
from dpcorr_torch.obs.budget_replay import read_user_balances
from dpcorr_torch.serve.budget_dir import BudgetDirectory
from dpcorr_torch.serve.fleet import (
    FleetFrontend,
    LeaseKeeper,
    LeaseManager,
    ReplicaDiedError,
    ReplicaSpec,
    ShardNotOwnedError,
    Supervisor,
    lease_table,
    make_frontend_http_server,
)


class Clock:
    """A scripted wall clock shared by every lease party in a test."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(autouse=True)
def _no_chaos():
    chaos.clear()
    yield
    chaos.clear()


def mgr(tmp_path, owner: str, clock: Clock, *, ttl: float = 10.0,
        n_shards: int | None = 4, cls=LeaseManager, **kw):
    return cls(str(tmp_path / "leases"), owner, n_shards=n_shards,
               ttl_s=ttl, clock=clock, **kw)


def _claims(lease_dir: str) -> list[str]:
    return sorted(n for n in os.listdir(lease_dir) if ".claim." in n)


# ---------------------------------------------------------------- lease --
def test_acquire_free_shard_grants_epoch_one(tmp_path):
    clock = Clock()
    a = mgr(tmp_path, "rep-a", clock)
    assert a.acquire(0)
    rec = a.owner_of(0)
    assert rec["owner"] == "rep-a"
    assert rec["epoch"] == 1
    assert rec["expires_at"] == clock.t + 10.0
    assert a.owned() == [0]
    assert _claims(a.lease_dir) == []  # the claim was consumed on commit


def test_renew_extends_expiry_without_epoch_bump(tmp_path):
    clock = Clock()
    a = mgr(tmp_path, "rep-a", clock)
    assert a.acquire(1)
    clock.advance(6.0)
    assert a.renew(1)
    rec = a.owner_of(1)
    assert rec["epoch"] == 1
    assert rec["expires_at"] == clock.t + 10.0
    # silent past expiry: the renew refuses instead of reviving
    clock.advance(11.0)
    assert not a.renew(1)
    assert a.owned() == []


def test_valid_lease_is_exclusive(tmp_path):
    clock = Clock()
    a = mgr(tmp_path, "rep-a", clock)
    b = mgr(tmp_path, "rep-b", clock)
    assert a.acquire(2)
    assert not b.acquire(2)
    rec = b.owner_of(2)
    assert rec["owner"] == "rep-a" and rec["epoch"] == 1


def test_expired_lease_taken_over_with_epoch_bump(tmp_path):
    clock = Clock()
    a = mgr(tmp_path, "rep-a", clock)
    b = mgr(tmp_path, "rep-b", clock)
    assert a.acquire(2)
    clock.advance(10.5)  # past a's ttl, a never renewed
    assert b.acquire(2)
    rec = b.owner_of(2)
    assert rec["owner"] == "rep-b"
    assert rec["epoch"] == 2
    assert b.snapshot()["counts"]["takeovers"] == 1


def test_restart_reclaims_own_live_lease_same_epoch(tmp_path):
    clock = Clock()
    a = mgr(tmp_path, "rep-a", clock)
    assert a.acquire(0)
    # the same instance name rebooting before expiry: no second writer
    # is introduced, so the grant is adopted as-is
    a2 = mgr(tmp_path, "rep-a", clock)
    assert a2.acquire(0)
    assert a2.owner_of(0)["epoch"] == 1
    assert a2.snapshot()["counts"]["reclaimed"] == 1


def test_release_hands_over_without_ttl_wait(tmp_path):
    clock = Clock()
    lost: list[int] = []
    a = mgr(tmp_path, "rep-a", clock)
    a.bind(4, on_lost=lost.append)
    b = mgr(tmp_path, "rep-b", clock)
    assert a.acquire(3)
    a.release(3)
    assert lost == [3]
    # no clock advance at all — the released lease is already expired
    assert b.acquire(3)
    assert b.owner_of(3)["epoch"] == 2


def test_ensure_owned_fences_stale_holder_charge_free(tmp_path):
    clock = Clock()
    lost: list[int] = []
    a = mgr(tmp_path, "rep-a", clock)
    a.bind(4, on_lost=lost.append)
    b = mgr(tmp_path, "rep-b", clock, ttl=10.0)
    b.url = "http://b:1"
    assert a.acquire(1)
    a.ensure_owned(1)  # comfortably live: no fence
    clock.advance(10.5)
    assert b.acquire(1)  # epoch 2, b's grant
    with pytest.raises(ShardNotOwnedError) as ei:
        a.ensure_owned(1)
    assert ei.value.owner == "rep-b"
    assert ei.value.owner_url == "http://b:1"
    assert ei.value.retry_after_s is not None
    assert lost == [1]  # the shard journal was told to close
    assert a.owned() == []


def test_ensure_owned_acquires_free_shard_on_demand(tmp_path):
    clock = Clock()
    a = mgr(tmp_path, "rep-a", clock)
    a.ensure_owned(2)
    assert a.owned() == [2]
    with pytest.raises(ValueError):
        a.ensure_owned(4)  # out of the bound ring


def test_crash_at_pre_lease_commit_leaves_only_a_stale_claim(tmp_path):
    clock = Clock()
    a = mgr(tmp_path, "rep-a", clock)
    chaos.install(ChaosPlan(point="fleet.pre_lease_commit", hit=1,
                            mode="raise"))
    with pytest.raises(SimulatedCrash):
        a.acquire(0)
    chaos.clear()
    # the claim was won but no lease was ever committed — nothing is
    # half-written
    assert a.owner_of(0) is None
    assert _claims(a.lease_dir) == ["shard-0000.claim.1"]
    # a live claim blocks a rival for TTL...
    b = mgr(tmp_path, "rep-b", clock)
    assert not b.acquire(0)
    # ...then is broken atomically and the shard is granted fresh
    clock.advance(10.5)
    assert b.acquire(0)
    rec = b.owner_of(0)
    assert rec["owner"] == "rep-b" and rec["epoch"] == 1
    assert _claims(a.lease_dir) == []


def test_lease_table_scans_records(tmp_path):
    clock = Clock()
    a = mgr(tmp_path, "rep-a", clock)
    b = mgr(tmp_path, "rep-b", clock)
    assert a.acquire(0) and b.acquire(3)
    table = lease_table(a.lease_dir)
    assert sorted(table) == [0, 3]
    assert table[0]["owner"] == "rep-a"
    assert table[3]["owner"] == "rep-b"


def test_keeper_respects_target_then_rescues_orphans(tmp_path):
    clock = Clock()
    a = mgr(tmp_path, "rep-a", clock)
    b = mgr(tmp_path, "rep-b", clock)
    ka = LeaseKeeper(a, target=2, rescue_after_s=20.0)
    kb = LeaseKeeper(b, target=2, rescue_after_s=20.0)
    ka.step()
    assert len(a.owned()) == 2  # target, not the whole ring
    kb.step()
    assert len(b.owned()) == 2
    # a goes silent; b keeps heartbeating in sub-TTL steps. Expired but
    # not yet orphaned shards stay untouched (b is at target)...
    for _ in range(4):
        clock.advance(4.0)
        kb.step()
    assert len(b.owned()) == 2
    # ...until the orphan deadline passes, then b rescues them all
    for _ in range(4):
        clock.advance(4.0)
        kb.step()
    assert len(b.owned()) == 4
    table = lease_table(b.lease_dir)
    assert sorted(table) == [0, 1, 2, 3]
    assert all(rec["owner"] == "rep-b" for rec in table.values())
    # exactly a's two shards changed hands (epoch 2); b kept its own
    assert sorted(rec["epoch"] for rec in table.values()) == [1, 1, 2, 2]


def test_bind_pins_the_shard_count(tmp_path):
    clock = Clock()
    mgr(tmp_path, "rep-a", clock)
    with pytest.raises(ValueError, match="one fleet, one ring"):
        mgr(tmp_path, "rep-b", clock, n_shards=8)


def test_keeper_thread_renews_on_its_own(tmp_path):
    """The heartbeat runs on the keeper's thread, not on a request path:
    with a real clock and no traffic the lease stays live past several
    TTLs, and ``stop`` ends the thread."""
    m = LeaseManager(str(tmp_path / "leases"), "rep-a", n_shards=2,
                     ttl_s=1.0)
    k = LeaseKeeper(m, interval_s=0.05)
    k.start()
    try:
        time.sleep(2.5)
        assert m.owned() == [0, 1]
        assert all(time.time() < rec["expires_at"]
                   for rec in lease_table(m.lease_dir).values())
        assert m.snapshot()["counts"]["renewed"] >= 4
    finally:
        k.stop()
    assert k._thread is None


# ----------------------------------------------- lease-gated directory --
def test_directory_charge_fenced_after_takeover(tmp_path):
    clock = Clock()
    root = str(tmp_path / "budget")
    la = mgr(tmp_path, "rep-a", clock, n_shards=None)
    da = BudgetDirectory(root, shards=4, user_budget=100.0,
                         clock=clock, fsync=False, lease=la)
    assert da.charge("u1", 1.0, charge_id="c1")
    shard = da.shard_index("u1")
    assert shard in la.owned()
    before = da.spent("u1")
    # a rival waits out the TTL and takes the shard over
    lb = mgr(tmp_path, "rep-b", clock, n_shards=None)
    db = BudgetDirectory(root, shards=4, user_budget=100.0,
                         clock=clock, fsync=False, lease=lb)
    clock.advance(10.5)
    lb.ensure_owned(shard)
    # the stale holder's late charge is refused charge-free, naming the
    # real owner
    with pytest.raises(ShardNotOwnedError) as ei:
        da.charge("u1", 1.0, charge_id="c2")
    assert ei.value.owner == "rep-b"
    # the new owner replayed the WAL: balance exact, and the dying
    # holder's charge_id dedups a retry instead of double-charging
    assert db.spent("u1") == before == 1.0
    assert db.charge("u1", 1.0, charge_id="c1") is False
    assert db.spent("u1") == 1.0
    assert db.charge("u1", 1.0, charge_id="c2") is True
    assert db.spent("u1") == 2.0


def test_directory_opens_only_held_shards(tmp_path):
    """Fleet mode opens no journal at construction; a charge opens just
    its own shard, and losing the lease closes it again."""
    clock = Clock()
    la = mgr(tmp_path, "rep-a", clock, n_shards=None)
    d = BudgetDirectory(str(tmp_path / "budget"), shards=4,
                        user_budget=10.0, clock=clock, fsync=False,
                        lease=la)
    assert d._shards == [None] * 4
    d.charge("u1", 0.5, charge_id="c1")
    shard = d.shard_index("u1")
    assert [i for i, s in enumerate(d._shards) if s is not None] == [shard]
    la.release(shard)
    assert d._shards == [None] * 4


# ---------------------------------------------------------- both packages --
def test_leases_contend_across_packages(tmp_path):
    """A JAX and a port manager on one lease directory under one scripted
    clock: grant, exclusion, renew, expiry, takeover with an epoch bump
    and fencing, each reading the other's files."""
    from dpcorr.serve.fleet import LeaseManager as JaxLeaseManager
    from dpcorr.serve.fleet import ShardNotOwnedError as JaxNotOwned

    clock = Clock()
    j = mgr(tmp_path, "jax-a", clock, cls=JaxLeaseManager)
    t = mgr(tmp_path, "torch-b", clock)
    t.url = "http://torch-b:1"
    assert j.acquire(0) and t.acquire(1)
    assert not t.acquire(0) and not j.acquire(1)
    assert t.owner_of(0) == j.owner_of(0)
    clock.advance(6.0)
    assert j.renew(0) and t.renew(1)
    clock.advance(6.0)  # 0 renewed at +6: live; 1 renewed at +6: live
    assert not t.acquire(0) and not j.acquire(1)
    clock.advance(10.5)  # both expired
    assert t.acquire(0)  # the port takes over the JAX grant
    assert j.acquire(1)  # and the JAX manager the port's
    assert t.owner_of(0)["owner"] == "torch-b"
    assert t.owner_of(0)["epoch"] == j.owner_of(1)["epoch"] == 2
    with pytest.raises(JaxNotOwned) as je:
        j.ensure_owned(0)
    assert (je.value.owner, je.value.owner_url) == ("torch-b",
                                                    "http://torch-b:1")
    with pytest.raises(ShardNotOwnedError) as te:
        t.ensure_owned(1, acquire=False)
    assert te.value.owner == "jax-a"
    # the two packages' lease tables agree record for record
    from dpcorr.serve.fleet import lease_table as jax_lease_table

    assert jax_lease_table(t.lease_dir) == lease_table(t.lease_dir)


def test_stale_claim_of_either_package_is_broken_by_the_other(tmp_path):
    from dpcorr import chaos as jchaos
    from dpcorr.serve.fleet import LeaseManager as JaxLeaseManager

    clock = Clock()
    t = mgr(tmp_path, "torch-a", clock)
    chaos.install(ChaosPlan("fleet.pre_lease_commit", mode="raise"))
    with pytest.raises(SimulatedCrash):
        t.acquire(0)
    chaos.clear()
    j = mgr(tmp_path, "jax-b", clock, cls=JaxLeaseManager)
    assert not j.acquire(0)
    clock.advance(10.5)
    assert j.acquire(0) and j.owner_of(0)["epoch"] == 1
    assert _claims(t.lease_dir) == []
    # and the other way round, on shard 1
    jchaos.install(jchaos.ChaosPlan("fleet.pre_lease_commit", mode="raise"))
    try:
        with pytest.raises(jchaos.SimulatedCrash):
            j.acquire(1)
    finally:
        jchaos.clear()
    assert not t.acquire(1)
    clock.advance(10.5)
    assert t.acquire(1) and t.owner_of(1)["owner"] == "torch-a"
    assert _claims(t.lease_dir) == []


def test_directories_charge_across_a_takeover_between_packages(tmp_path):
    """A JAX and a port lease-mode directory charge one shared directory
    in turn; after each takeover the new owner recovers the other's WAL,
    and the balances equal the expectation exactly."""
    from dpcorr.serve.budget_dir import BudgetDirectory as JaxDirectory
    from dpcorr.serve.fleet import LeaseManager as JaxLeaseManager

    clock = Clock()
    root = str(tmp_path / "budget")
    dirs = {
        "jax": JaxDirectory(root, shards=4, user_budget=100.0, clock=clock,
                            fsync=False, lease=mgr(
                                tmp_path, "jax", clock, n_shards=None,
                                cls=JaxLeaseManager)),
        "torch": BudgetDirectory(root, shards=4, user_budget=100.0,
                                 clock=clock, fsync=False, lease=mgr(
                                     tmp_path, "torch", clock,
                                     n_shards=None)),
    }
    users = [f"u{i}" for i in range(12)]
    want: dict[str, float] = {}
    for turn, who in enumerate(["jax", "torch", "jax", "torch"]):
        d = dirs[who]
        for k, u in enumerate(users):
            eps = 0.25 * (1 + (k + turn) % 3)
            assert d.charge(u, eps, charge_id=f"{turn}-{u}")
            want[u] = want.get(u, 0.0) + eps
        # a retry of the previous turn's charges on the new owner dedups
        if turn:
            for u in users:
                assert d.charge(u, 1.0, charge_id=f"{turn - 1}-{u}") \
                    is False
        assert {u: d.spent(u) for u in users} == want
        clock.advance(10.5)  # the holder goes silent; the other takes over
    bal = read_user_balances(root)
    assert {u: b["l"] for u, b in bal.items()} == want


def _stub_urls(names):
    return {n: f"http://127.0.0.1:{9000 + i}" for i, n in enumerate(names)}


def test_frontends_order_candidates_alike(tmp_path):
    """The port's and the JAX package's front ends give the same candidate
    order for 64 users: lease owners first, then the shard-affinity walk,
    then the rest — and the same round-robin for userless requests."""
    from dpcorr.serve.fleet import FleetFrontend as JaxFrontend

    clock = Clock(time.time())
    lease_dir = str(tmp_path / "leases")
    names = ["rep-0", "rep-1", "rep-2"]
    m = LeaseManager(lease_dir, "rep-2", n_shards=8, clock=clock)
    assert m.acquire(1) and m.acquire(6)
    LeaseManager(lease_dir, "rep-0", n_shards=8, clock=clock).acquire(3)
    ours = FleetFrontend(_stub_urls(names), lease_dir=lease_dir)
    theirs = JaxFrontend(_stub_urls(names), lease_dir=lease_dir)
    for u in range(64):
        user = f"user-{u}"
        assert ours._shard_of(user) == theirs._shard_of(user)
        assert ours._candidates(user) == theirs._candidates(user), user
    owners = {ours._candidates(f"user-{u}")[0] for u in range(64)
              if ours._shard_of(f"user-{u}") in (1, 6)}
    assert owners == {"rep-2"}
    for _ in range(4):
        assert ours._candidates(None) == theirs._candidates(None)
    # without a lease dir: user-keyed affinity, still alike
    ours = FleetFrontend(_stub_urls(names))
    theirs = JaxFrontend(_stub_urls(names))
    assert [ours._candidates(f"user-{u}") for u in range(64)] == \
        [theirs._candidates(f"user-{u}") for u in range(64)]


# -------------------------------------------------------------- frontend --
class _StubReplica:
    """A canned /estimate endpoint with scriptable status and headers."""

    def __init__(self, status=200, body=None, headers=(), hook=None):
        self.status = status
        self.body = body if body is not None else {"ok": True}
        self.headers = list(headers)
        self.hook = hook
        self.hits = 0
        stub = self

        class H(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length", 0))
                payload = self.rfile.read(n)
                stub.hits += 1
                status, body = stub.status, stub.body
                if stub.hook is not None:
                    status, body = stub.hook(payload)
                blob = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                for k, v in stub.headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_frontend_passes_replica_response_through():
    rep = _StubReplica(status=200, body={"estimate": 0.5})
    try:
        fe = FleetFrontend({"rep-0": rep.url})
        status, headers, payload = fe.route(b'{"user": "u"}')
        assert status == 200
        assert json.loads(payload) == {"estimate": 0.5}
        assert fe.stats()["counts"]["routed:rep-0"] == 1
    finally:
        rep.close()


def test_frontend_injects_failover_idempotency_key():
    seen: list[dict] = []

    def hook(payload):
        seen.append(json.loads(payload))
        return 200, {"ok": True}

    rep = _StubReplica(hook=hook)
    try:
        fe = FleetFrontend({"rep-0": rep.url})
        fe.route(b'{"user": "u"}')
        assert seen[0]["idempotency_key"].startswith("fe:")
        # a client-chosen identity is never overwritten, nor a pinned seed
        fe.route(b'{"user": "u", "idempotency_key": "mine"}')
        assert seen[1]["idempotency_key"] == "mine"
        fe.route(b'{"user": "u", "seed": 7}')
        assert "idempotency_key" not in seen[2]
    finally:
        rep.close()


def test_frontend_affinity_keeps_a_user_on_one_replica():
    reps = [_StubReplica() for _ in range(3)]
    try:
        fe = FleetFrontend({f"rep-{i}": r.url for i, r in enumerate(reps)})
        for _ in range(6):
            status, _, _ = fe.route(b'{"user": "sticky-user"}')
            assert status == 200
        assert sorted(r.hits for r in reps) == [0, 0, 6]
    finally:
        for r in reps:
            r.close()


def test_frontend_forwards_421_and_learns_the_owner():
    owner = _StubReplica(status=200, body={"estimate": 1.0})
    refuser = _StubReplica(
        status=421, body={"refused": "not-owner", "owner": "rep-owner",
                          "owner_url": None})
    refuser.body["owner_url"] = owner.url
    try:
        fe = FleetFrontend({"rep-0": refuser.url})  # owner unknown
        status, _, payload = fe.route(b'{"user": "u"}')
        assert status == 200
        assert json.loads(payload) == {"estimate": 1.0}
        assert refuser.hits == 1 and owner.hits == 1
        s = fe.stats()
        assert s["counts"]["forwards"] == 1
        assert "rep-owner" in s["replicas"]
    finally:
        owner.close()
        refuser.close()


def test_frontend_passes_retry_after_through():
    rep = _StubReplica(status=503, body={"refused": "queue_full"},
                       headers=[("Retry-After", "7")])
    try:
        fe = FleetFrontend({"rep-0": rep.url})
        status, headers, _ = fe.route(b'{"user": "u"}')
        assert status == 503
        assert ("Retry-After", "7") in headers
    finally:
        rep.close()


def test_frontend_circuit_sidelines_a_dead_replica():
    rep = _StubReplica()
    try:
        # rep-dead points at a port nothing listens on
        fe = FleetFrontend({"rep-0": rep.url,
                            "rep-dead": "http://127.0.0.1:9"},
                           fail_threshold=2, cooldown_s=60.0)
        for _ in range(8):
            status, _, _ = fe.route(b"{}")
            assert status == 200  # the hop loop always lands on rep-0
        assert fe.stats()["counts"]["transport_errors"] == 2
        # past the threshold the circuit keeps the dead name out of the
        # candidate order entirely
        assert "rep-dead" not in fe._candidates(None)
    finally:
        rep.close()


def test_frontend_503s_when_no_replica_answers():
    fe = FleetFrontend({"rep-dead": "http://127.0.0.1:9"})
    status, headers, payload = fe.route(b'{"user": "u"}')
    assert status == 503
    assert json.loads(payload)["refused"] == "breaker"
    assert any(k == "Retry-After" for k, _ in headers)


def test_frontend_gives_up_after_max_hops():
    """Every replica refusing with 421 and no owner to forward to: after
    ``max_hops`` tries the front end answers a retryable 503."""
    reps = [_StubReplica(status=421, body={"refused": "not_owner",
                                           "owner": None})
            for _ in range(3)]
    try:
        fe = FleetFrontend({f"rep-{i}": r.url for i, r in enumerate(reps)},
                           max_hops=2)
        status, headers, _ = fe.route(b'{"user": "u"}')
        assert status == 503 and ("Retry-After", "1") in headers
        assert sum(r.hits for r in reps) == 2
        assert fe.stats()["counts"]["no_owner"] == 1
    finally:
        for r in reps:
            r.close()


def test_frontend_http_server_routes_and_reports():
    rep = _StubReplica(status=200, body={"estimate": 0.25})
    fe = FleetFrontend({"rep-0": rep.url})
    httpd = make_frontend_http_server(fe)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(urllib.request.Request(
                f"{base}/estimate", data=b'{"user": "u"}'), timeout=30) as r:
            assert json.load(r) == {"estimate": 0.25}
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            assert json.load(r)["counts"]["requests"] == 1
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert ei.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        rep.close()


# ------------------------------------------------------------ supervisor --
_STUB_REPLICA_SRC = """\
import json, sys, time
print(json.dumps({"serving": {"host": "127.0.0.1", "port": 45678}}))
sys.stdout.flush()
time.sleep(120)
"""


def test_supervisor_restarts_dead_replica_with_identical_argv(tmp_path):
    ups: list[tuple[str, str]] = []
    downs: list[str] = []
    spec = ReplicaSpec(name="stub",
                       argv=[sys.executable, "-c", _STUB_REPLICA_SRC],
                       stderr_path=str(tmp_path / "stub.log"))
    argv_before = list(spec.argv)
    sup = Supervisor([spec], poll_s=0.05, backoff_s=0.05,
                     on_up=lambda n, url, b: ups.append((n, url)),
                     on_down=lambda n, rc: downs.append(n))
    sup.start()
    try:
        assert ups == [("stub", "http://127.0.0.1:45678")]
        pid = sup.pid("stub")
        assert sup.kill("stub") == pid
        assert sup.wait_restarted("stub", 1, timeout_s=30.0)
        assert sup.restarts["stub"] == 1
        assert downs == ["stub"]
        assert len(ups) == 2  # the reboot re-announced itself
        assert sup.pid("stub") != pid
        assert sup.specs["stub"].argv == argv_before  # same argv, verbatim
        assert sup.launched["stub"] == [argv_before, argv_before]
    finally:
        sup.stop()
    assert sup.urls() == {}


def test_supervisor_boot_failure_names_replica_and_log(tmp_path):
    """A replica that dies before its banner stops the whole boot: the
    error names the replica and its log, and its healthy sibling is not
    left running."""
    log = str(tmp_path / "bad.log")
    good = ReplicaSpec(name="good",
                       argv=[sys.executable, "-c", _STUB_REPLICA_SRC])
    bad = ReplicaSpec(name="bad", argv=[sys.executable, "-c",
                                        "import sys; sys.exit(3)"],
                      stderr_path=log)
    sup = Supervisor([good, bad], banner_deadline_s=30.0)
    with pytest.raises(ReplicaDiedError, match=r"bad exited rc=3.*bad\.log"):
        sup.start()
    assert sup.pid("good") is None and sup.urls() == {}


def test_fleet_up_without_a_card_names_the_dead_replica(tmp_path):
    """``fleet up`` on the card (its default) where there is none ends
    with the supervisor's ReplicaDiedError naming the replica and its
    log: nothing comes up on the CPU instead."""
    import subprocess

    from test_torch_cli import _child_env

    env = _child_env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "dpcorr_torch", "fleet", "up",
         "--workdir", str(tmp_path / "fleet"), "--replicas", "1",
         "--user-shards", "2", "--port", "0"],
        capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode != 0
    log = os.path.join(str(tmp_path / "fleet"), "r0.log")
    assert f"ReplicaDiedError: replica r0 exited rc=1 before printing " \
           f"its banner; see {log}" in proc.stderr
    assert "no CUDA device" in open(log).read()
    assert json.loads(proc.stdout.splitlines()[0])["fleet_up"]["device"] \
        == "cuda"


# ------------------------------------------------ lease-mode server ----
def _fleet_server(tmp_path, name: str, ttl: float = 30.0):
    """A lease-mode replica in process, bound first (as ``serve`` binds)
    so the lease files advertise its URL from the first grant."""
    import socket

    from dpcorr_torch.serve import DpcorrServer, make_http_server

    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.bind(("127.0.0.1", 0))
    sock.listen(16)
    port = sock.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    srv = DpcorrServer(budget=1e9, device="cpu", max_delay_s=0.001,
                       user_dir=str(tmp_path / "budget"), user_budget=1e9,
                       user_shards=4, user_fsync=False,
                       audit=str(tmp_path / f"{name}_audit.jsonl"),
                       instance=name, lease_dir=str(tmp_path / "leases"),
                       lease_ttl_s=ttl, lease_target=2, advertise_url=url)
    httpd = make_http_server(srv, port=port, sock=sock)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return srv, httpd, url


def _user_req(user: str, seed: int):
    from dpcorr_torch.serve import EstimateRequest

    z = np.random.default_rng(seed).standard_normal((2, 96))
    return EstimateRequest("ni_sign", z[0], 0.5 * z[0] + z[1], 1.0, 0.5,
                           user=user, seed=seed)


def test_lease_mode_servers_behind_a_front_end(tmp_path):
    """Two lease-mode replicas in process share one budget directory
    behind a front end: every request answers 200, each shard is leased
    by exactly one replica, a request sent straight to a non-owner gets
    421 naming the owner (the client maps it to ShardNotOwnedError,
    which it retries), ``not_owner`` is counted, and the directory's
    balances equal the charges."""
    from dpcorr_torch.serve import HttpEstimateClient, request_charges
    from dpcorr_torch.serve.client import RETRIABLE

    with pytest.raises(ValueError, match="requires --user-dir"):
        from dpcorr_torch.serve import DpcorrServer

        DpcorrServer(device="cpu", lease_dir=str(tmp_path / "l"))
    a, ha, ua = _fleet_server(tmp_path, "rep-a")
    b, hb, ub = _fleet_server(tmp_path, "rep-b")
    fe = FleetFrontend({"rep-a": ua, "rep-b": ub},
                       lease_dir=str(tmp_path / "leases"))
    fhttpd = make_frontend_http_server(fe)
    threading.Thread(target=fhttpd.serve_forever, daemon=True).start()
    front = HttpEstimateClient(
        f"http://127.0.0.1:{fhttpd.server_address[1]}", timeout_s=60.0)
    try:
        deadline = time.time() + 20
        while len(lease_table(str(tmp_path / "leases"))) < 4:
            assert time.time() < deadline, "keepers never leased the ring"
            time.sleep(0.05)
        owners = {s: r["owner"] for s, r in
                  lease_table(str(tmp_path / "leases")).items()}
        assert sorted(owners) == [0, 1, 2, 3]
        assert sorted(owners.values()) == ["rep-a", "rep-a",
                                           "rep-b", "rep-b"]
        users = [f"user-{i}" for i in range(8)]
        reqs = [_user_req(u, 100 + i) for i, u in enumerate(users)]
        for r in reqs:
            front.estimate(r, timeout=60)
        snap = {n: s.stats_snapshot() for n, s in (("rep-a", a),
                                                   ("rep-b", b))}
        assert sum(s["requests_total"] for s in snap.values()) == len(reqs)
        assert sorted(snap["rep-a"]["leases"]["owned"]
                      + snap["rep-b"]["leases"]["owned"]) == [0, 1, 2, 3]
        # straight to the replica that does not own the user's shard
        shard = a.ledger.directory.shard_index(users[0])
        stray, stray_url = ((b, ub) if owners[shard] == "rep-a"
                            else (a, ua))
        with pytest.raises(ShardNotOwnedError) as ei:
            HttpEstimateClient(stray_url, timeout_s=60.0).estimate(
                _user_req(users[0], 999), timeout=60)
        assert ei.value.owner == owners[shard]
        assert ei.value.owner_url == (ua if owners[shard] == "rep-a"
                                      else ub)
        assert isinstance(ei.value, RETRIABLE)
        assert stray.stats_snapshot()["refused"]["not_owner"] == 1
        per_req = sum(request_charges(reqs[0]).values())
        bal = read_user_balances(str(tmp_path / "budget"))
        assert {u: v["l"] for u, v in bal.items()} == {
            u: per_req for u in users}
    finally:
        fhttpd.shutdown()
        fhttpd.server_close()
        for h, s in ((ha, a), (hb, b)):
            h.shutdown()
            h.server_close()
            s.close()
    # close handed every lease back (already expired, same epoch)
    assert all(r.get("released") for r in
               lease_table(str(tmp_path / "leases")).values())


def test_fleet_modules_import_nothing_of_jax():
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1] / "dpcorr_torch"
    for path in [*sorted((root / "serve" / "fleet").glob("*.py")),
                 root / "obs" / "fleet.py", root / "obs" / "slo.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "dpcorr"), (path, n)
