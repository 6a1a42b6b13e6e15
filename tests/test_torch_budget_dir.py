"""The port's per-user budget directory (``dpcorr_torch.serve.budget_dir``
and ``dpcorr_torch.obs.budget_replay``): the cases of
``tests/test_budget_dir.py`` run on the port — WAL-journaled shard
accounting, renewal under a scripted clock, LRU eviction and rehydration,
the four crash windows, corrupt-file quarantine, the CompositeLedger's
one atomic charge and one refund path — and the two packages' files read
both ways: the same ring, the same shard files, the same balances."""

import json
import os

import numpy as np
import pytest

from dpcorr_torch import chaos
from dpcorr_torch.chaos import ChaosPlan, SimulatedCrash
from dpcorr_torch.obs.audit import (
    AuditTrail,
    read_events,
    replay,
    replay_levels,
)
from dpcorr_torch.obs.budget_replay import (
    GLOBAL_KEY,
    USER_PREFIX,
    DirectoryCorruptError,
    apply_wal_entry,
    fold_levels,
    read_user_balances,
)
from dpcorr_torch.serve.budget_dir import (
    BudgetDirectory,
    CompositeLedger,
    RenewalPolicy,
    build_ring,
    is_reserved,
    party_view,
    ring_shard_index,
    user_view,
)
from dpcorr_torch.serve.ledger import BudgetExceededError, PrivacyLedger
from dpcorr_torch.serve.request import EstimateRequest


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    chaos.clear()
    yield
    chaos.clear()


def _dir(tmp_path, **kw):
    kw.setdefault("shards", 1)
    kw.setdefault("fsync", False)
    return BudgetDirectory(str(tmp_path / "dir"), **kw)


# ------------------------------------------------------ accounting ----
def test_charge_spent_lifetime_headroom(tmp_path):
    d = _dir(tmp_path, user_budget=1.0)
    d.charge("alice", 0.25)
    d.charge("alice", 0.25)
    d.charge("bob", 0.5)
    assert d.spent("alice") == pytest.approx(0.5)
    assert d.lifetime("alice") == pytest.approx(0.5)
    assert d.headroom("alice") == pytest.approx(0.5)
    assert d.spent("bob") == pytest.approx(0.5)
    assert d.spent("nobody") == 0.0
    assert d.headroom("nobody") == 1.0
    c = d.counters()
    assert c["charges"] == 3
    assert c["charged_eps"] == pytest.approx(1.0)


def test_charge_id_dedup_and_refund_forgets(tmp_path):
    d = _dir(tmp_path)
    d.charge("u", 0.25, charge_id="c1")
    d.charge("u", 0.25, charge_id="c1")  # resumed re-run: no-op
    assert d.spent("u") == pytest.approx(0.25)
    assert d.counters()["dedups"] == 1
    d.refund("u", 0.25, charge_id="c1")  # forgets the id
    assert d.spent("u") == 0.0
    d.charge("u", 0.25, charge_id="c1")  # genuinely new charge
    assert d.spent("u") == pytest.approx(0.25)


def test_refund_clamps_at_zero(tmp_path):
    d = _dir(tmp_path)
    d.charge("u", 0.25)
    d.refund("u", 9.0)  # stray refund over-counts, never under-counts
    assert d.spent("u") == 0.0
    assert d.lifetime("u") == 0.0


def test_negative_amounts_refused(tmp_path):
    d = _dir(tmp_path)
    with pytest.raises(ValueError):
        d.charge("u", -0.1)
    with pytest.raises(ValueError):
        d.refund("u", -0.1)


def test_refusal_is_charge_free_and_not_journaled(tmp_path):
    d = _dir(tmp_path, user_budget=0.5)
    d.charge("u", 0.5)  # landing exactly on the cap is admitted
    with pytest.raises(BudgetExceededError) as ei:
        d.charge("u", 0.25)
    assert ei.value.level == "user"
    assert ei.value.party == USER_PREFIX + "u"
    assert d.spent("u") == pytest.approx(0.5)
    assert d.counters()["refusals"] == 1
    d.close()
    # nothing about the refusal reached disk: reopen sees the admitted
    # spend only
    d2 = _dir(tmp_path, user_budget=0.5)
    assert d2.spent("u") == pytest.approx(0.5)


# --------------------------------------------------------- renewal ----
def test_renewal_resets_window_and_carries_burst(tmp_path):
    now = {"t": 1000.0}
    d = _dir(tmp_path, user_budget=0.5,
             renewal=RenewalPolicy(period_s=100.0, burst_cap=0.3),
             clock=lambda: now["t"])
    d.charge("u", 0.2)
    now["t"] = 1100.0  # one period later: window resets, 0.3 unused
    d.charge("u", 0.0)  # zero-ε touch triggers the renewal
    assert d.spent("u") == 0.0
    assert d.headroom("u") == pytest.approx(0.8)  # budget + burst
    assert d.lifetime("u") == pytest.approx(0.2)  # lifetime untouched
    d.charge("u", 0.7)  # admitted only thanks to the burst credit
    now["t"] = 1200.0
    d.charge("u", 0.0)
    # carry = min(cap, budget + burst - spend) = min(0.3, 0.1)
    assert d.headroom("u") == pytest.approx(0.6)
    assert d.counters()["renewals"] == 2


def test_renewal_long_idle_reaches_fixed_point(tmp_path):
    now = {"t": 0.0}
    d = _dir(tmp_path, user_budget=0.5,
             renewal=RenewalPolicy(period_s=100.0, burst_cap=0.3),
             clock=lambda: now["t"])
    d.charge("u", 0.4)
    now["t"] = 100.0 * 50  # 50 idle periods collapse to the fixed point
    d.charge("u", 0.0)
    assert d.spent("u") == 0.0
    assert d.headroom("u") == pytest.approx(0.8)
    assert d.counters()["renewals"] == 1


def test_renewal_survives_reopen(tmp_path):
    now = {"t": 1000.0}
    clock = lambda: now["t"]  # noqa: E731
    d = _dir(tmp_path, user_budget=0.5,
             renewal=RenewalPolicy(period_s=100.0, burst_cap=0.3),
             clock=clock)
    d.charge("u", 0.2)
    now["t"] = 1100.0
    d.charge("u", 0.0)
    d.close()
    # the "n" journal line carried the absolute renewed state
    d2 = _dir(tmp_path, user_budget=0.5,
              renewal=RenewalPolicy(period_s=100.0, burst_cap=0.3),
              clock=clock)
    assert d2.spent("u") == 0.0
    assert d2.headroom("u") == pytest.approx(0.8)
    assert d2.lifetime("u") == pytest.approx(0.2)


def test_renewal_policy_validation():
    with pytest.raises(ValueError):
        RenewalPolicy(period_s=0.0)
    with pytest.raises(ValueError):
        RenewalPolicy(burst_cap=-1.0)


def test_renewal_boundary_charge_lands_in_new_window_only(tmp_path):
    """A charge whose clock sits *exactly* on the renewal boundary
    (now == window_start + period_s) renews first and then charges: the
    spend belongs entirely to the new window, never to both. This is
    the alignment contract the stream service leans on when it pins the
    directory clock to window starts with period_s == hop_s — the epoch
    boundary IS the renewal boundary."""
    now = {"t": 1000.0}
    d = _dir(tmp_path, user_budget=0.5,
             renewal=RenewalPolicy(period_s=100.0),
             clock=lambda: now["t"])
    d.charge("u", 0.3)
    assert d.spent("u") == pytest.approx(0.3)
    now["t"] = 1100.0  # exactly w + period_s: boundary-inclusive renewal
    d.charge("u", 0.2)
    # the new window holds only the new charge — 0.3 did not leak in
    assert d.spent("u") == pytest.approx(0.2)
    assert d.headroom("u") == pytest.approx(0.3)
    # and the old window's spend was not forgotten either: lifetime
    # counts both, renewals fired exactly once
    assert d.lifetime("u") == pytest.approx(0.5)
    assert d.counters()["renewals"] == 1
    # one tick *before* the next boundary stays in the current window
    now["t"] = 1199.0
    d.charge("u", 0.1)
    assert d.spent("u") == pytest.approx(0.3)
    assert d.counters()["renewals"] == 1


def test_renewal_epoch_aligned_stream_of_window_releases(tmp_path):
    """Stream-service alignment: the directory clock steps through
    window-start epochs (0, hop, 2*hop, ...) with period_s == hop_s, so
    each release epoch maps to exactly one renewal window. Every epoch
    sees the full per-window headroom and each window's charge is
    counted exactly once (lifetime == sum of all charges)."""
    hop = 10.0
    per_window = 0.4
    now = {"t": 0.0}
    d = _dir(tmp_path, user_budget=0.5,
             renewal=RenewalPolicy(period_s=hop),
             clock=lambda: now["t"])
    for epoch in range(5):
        now["t"] = epoch * hop
        # without a boundary renewal the second epoch would already be
        # refused (0.4 + 0.4 > 0.5) — every admission past epoch 0 is
        # itself proof the charge landed in a fresh window
        d.charge("u", per_window)
        # ... and the fresh window holds exactly this epoch's charge
        assert d.spent("u") == pytest.approx(per_window)
        assert d.headroom("u") == pytest.approx(0.5 - per_window)
    assert d.lifetime("u") == pytest.approx(5 * per_window)
    assert d.counters()["renewals"] == 4  # epochs 1..4 each renewed once


# ------------------------------------------- persistence / routing ----
def test_reopen_recovers_exact_balances(tmp_path):
    d = _dir(tmp_path, shards=4)
    for i in range(40):
        d.charge(f"u{i}", 0.125, charge_id=f"c{i}")
    d.refund("u3", 0.125, charge_id="c3")
    d.close()
    d2 = _dir(tmp_path, shards=4)
    assert d2.spent("u3") == 0.0
    for i in [0, 1, 7, 39]:
        if i != 3:
            assert d2.spent(f"u{i}") == pytest.approx(0.125)
    bal = read_user_balances(str(tmp_path / "dir"))
    assert len(bal) == 40
    assert bal["u7"]["l"] == pytest.approx(0.125)


def test_shard_count_pinned_in_meta(tmp_path):
    d = _dir(tmp_path, shards=4)
    d.charge("alice", 0.1)
    idx = d.shard_index("alice")
    d.close()
    # a reopen asking for a different count adopts the pinned one —
    # re-hashing users onto a different ring would split balances
    d2 = _dir(tmp_path, shards=16)
    assert d2.n_shards == 4
    assert d2.shard_index("alice") == idx
    assert d2.spent("alice") == pytest.approx(0.1)


def test_compaction_folds_wal_into_snapshot(tmp_path):
    d = _dir(tmp_path, compact_every=1)
    d.charge("u", 0.25, charge_id="c1")
    d.charge("u", 0.25, charge_id="c2")
    assert d.counters()["compactions"] == 2
    d.close()
    snap = json.load(open(tmp_path / "dir" / "shard-0000.json"))
    assert snap["gen"] == 2
    assert snap["users"]["u"]["s"] == pytest.approx(0.5)
    assert "c2" in snap["charge_ids"]
    wal = (tmp_path / "dir" / "shard-0000.wal").read_text().splitlines()
    assert json.loads(wal[0])["gen"] == 2
    assert len(wal) == 1  # fresh after the fold
    d2 = _dir(tmp_path, compact_every=1)
    assert d2.spent("u") == pytest.approx(0.5)
    d2.charge("u", 0.25, charge_id="c2")  # snapshot kept the id
    assert d2.spent("u") == pytest.approx(0.5)


def test_eviction_and_rehydration_preserve_balances(tmp_path):
    d = _dir(tmp_path, max_resident=2)
    for i in range(8):
        d.charge(f"u{i}", 0.125)
    c = d.counters()
    assert c["evictions"] >= 6
    assert c["resident_users"] == 2
    assert c["evicted_users"] == 6
    # peek reads the spill without rehydration churn
    assert d.spent("u0") == pytest.approx(0.125)
    d.charge("u0", 0.125)  # rehydrates, then evicts someone else
    assert d.counters()["rehydrations"] == 1
    assert d.spent("u0") == pytest.approx(0.25)
    d.close()
    d2 = _dir(tmp_path, max_resident=2)  # spill is non-authoritative
    for i in range(8):
        assert d2.spent(f"u{i}") == pytest.approx(
            0.25 if i == 0 else 0.125)


# --------------------------------------------------- crash windows ----
def test_matrix_registers_budget_points():
    for p in ("budget.pre_journal", "budget.post_journal",
              "budget.mid_compaction", "budget.mid_eviction"):
        assert p in chaos.MATRIX_POINTS


@pytest.mark.parametrize("point,on_disk", [
    # killed before the WAL append: nothing durable, the re-charge
    # applies once; killed after: the line is durable, the re-charge
    # dedups — either way recovery lands on exactly one application
    ("budget.pre_journal", 0.0),
    ("budget.post_journal", 0.25),
    ("budget.mid_compaction", 0.25),
    ("budget.mid_eviction", 0.25),
])
def test_crash_window_recovers_charge_once(tmp_path, point, on_disk):
    knobs = {"compact_every": 1 if point == "budget.mid_compaction"
             else None,
             "max_resident": 0 if point == "budget.mid_eviction"
             else None}
    d = _dir(tmp_path, **knobs)
    chaos.install(ChaosPlan(point=point, hit=1, mode="raise"))
    with pytest.raises(SimulatedCrash):
        d.charge("u", 0.25, charge_id="victim")
    chaos.clear()
    assert read_user_balances(str(tmp_path / "dir")) \
        .get("u", {}).get("l", 0.0) == pytest.approx(on_disk)
    # the restart: reopen and re-issue the interrupted charge under
    # its charge_id — exactly once regardless of where the kill hit
    d2 = _dir(tmp_path, **knobs)
    d2.charge("u", 0.25, charge_id="victim")
    assert d2.spent("u") == pytest.approx(0.25)
    assert d2.lifetime("u") == pytest.approx(0.25)


def test_crash_mid_compaction_discards_stale_wal(tmp_path):
    d = _dir(tmp_path, compact_every=2)
    d.charge("u", 0.25, charge_id="c1")
    chaos.install(ChaosPlan(point="budget.mid_compaction", hit=1,
                            mode="raise"))
    with pytest.raises(SimulatedCrash):
        d.charge("u", 0.25, charge_id="c2")
    chaos.clear()
    # torn window: snapshot says gen 1, WAL still says gen 0 and holds
    # both charge lines the snapshot already folded in
    snap = json.load(open(tmp_path / "dir" / "shard-0000.json"))
    assert snap["gen"] == 1
    wal = (tmp_path / "dir" / "shard-0000.wal").read_text().splitlines()
    assert json.loads(wal[0])["gen"] == 0 and len(wal) == 3
    d2 = _dir(tmp_path, compact_every=2)  # discards, never double-applies
    assert d2.spent("u") == pytest.approx(0.5)
    d2.charge("u", 0.25, charge_id="c2")  # snapshot kept the ids too
    assert d2.spent("u") == pytest.approx(0.5)


def test_wal_only_user_keeps_window_start_across_reopen(tmp_path):
    # the 'c' line carries the window start: a user whose state lives
    # only in the WAL (never compacted, no 'n' line) must not be
    # rebuilt with w=0.0 — the first post-restart charge would see
    # ~10k elapsed periods, fire a spurious renewal that zeroes the
    # window spend, and the user could overspend the window budget
    now = {"t": 1_000_000.0}
    kw = dict(user_budget=0.5, compact_every=None,
              renewal=RenewalPolicy(period_s=100.0),
              clock=lambda: now["t"])
    d = _dir(tmp_path, **kw)
    d.charge("u", 0.4)
    d.close()
    bal = read_user_balances(str(tmp_path / "dir"))
    assert bal["u"]["w"] == pytest.approx(1_000_000.0)
    now["t"] = 1_000_050.0  # still inside the same window
    d2 = _dir(tmp_path, **kw)
    assert d2.spent("u") == pytest.approx(0.4)
    with pytest.raises(BudgetExceededError):  # 0.4 + 0.2 > 0.5
        d2.charge("u", 0.2)
    assert d2.spent("u") == pytest.approx(0.4)
    assert d2.counters()["renewals"] == 0


def test_refund_created_user_carries_window_start(tmp_path):
    now = {"t": 5000.0}
    d = _dir(tmp_path, clock=lambda: now["t"])
    d.refund("u", 1.0)  # clamps to zero, creates the user
    d.close()
    bal = read_user_balances(str(tmp_path / "dir"))
    assert bal["u"]["w"] == pytest.approx(5000.0)


def test_refused_renewal_is_trace_free(tmp_path):
    now = {"t": 1000.0}
    d = _dir(tmp_path, user_budget=0.5,
             renewal=RenewalPolicy(period_s=100.0),
             clock=lambda: now["t"])
    d.charge("u", 0.4)
    wal = tmp_path / "dir" / "shard-0000.wal"
    before = wal.read_text()
    now["t"] = 1100.0  # a renewal is due, but the charge must refuse
    with pytest.raises(BudgetExceededError) as ei:
        d.charge("u", 0.6)  # over the renewed cap of 0.5
    assert ei.value.spent == 0.0  # checked against the renewed view
    assert wal.read_text() == before  # nothing journaled, not even 'n'
    assert d.counters()["renewals"] == 0
    d.charge("u", 0.3)  # admitted: renewal rides the same append
    assert d.spent("u") == pytest.approx(0.3)
    assert d.counters()["renewals"] == 1


def test_cold_spill_dead_lines_reclaimed(tmp_path):
    d = _dir(tmp_path, max_resident=0, compact_every=None)
    for _ in range(200):  # every charge rehydrates + re-evicts "u"
        d.charge("u", 0.001)
    cold = tmp_path / "dir" / "shard-0000.cold"
    lines = cold.read_text().splitlines()
    assert len(lines) <= 40  # bounded, not one dead line per charge
    assert d.spent("u") == pytest.approx(0.2)
    assert d.counters()["rehydrations"] == 199


def test_compaction_truncates_spill(tmp_path):
    d = _dir(tmp_path, max_resident=0, compact_every=5)
    for i in range(5):
        d.charge(f"u{i}", 0.1)  # the 5th mutation compacts
    cold = tmp_path / "dir" / "shard-0000.cold"
    lines = [json.loads(ln) for ln in cold.read_text().splitlines()]
    assert len(lines) == 5  # exactly the live evicted set, no dead bytes
    assert {e["u"] for e in lines} == {f"u{i}" for i in range(5)}
    d.close()
    d2 = _dir(tmp_path, max_resident=0, compact_every=5)
    for i in range(5):
        assert d2.spent(f"u{i}") == pytest.approx(0.1)


# ---------------------------------------------- corrupt quarantine ----
def test_corrupt_snapshot_quarantined_loudly(tmp_path):
    d = _dir(tmp_path, compact_every=1)
    d.charge("u", 0.25)
    d.close()
    snap = tmp_path / "dir" / "shard-0000.json"
    snap.write_text("{not json")
    with pytest.raises(DirectoryCorruptError) as ei:
        _dir(tmp_path, compact_every=1)
    msg = str(ei.value)
    assert "corrupt" in msg and "replay_levels" in msg  # actionable
    assert os.path.exists(str(snap) + ".corrupt")
    assert not os.path.exists(str(snap))


def test_truncated_wal_quarantined_loudly(tmp_path):
    d = _dir(tmp_path)
    d.charge("u", 0.25)
    d.close()
    wal = tmp_path / "dir" / "shard-0000.wal"
    with open(wal, "a") as fh:
        fh.write('{"k": "c", "u": "u", "e"')  # torn mid-line
    with pytest.raises(DirectoryCorruptError):
        _dir(tmp_path)
    assert os.path.exists(str(wal) + ".corrupt")
    assert not os.path.exists(str(wal))


def test_wal_generation_ahead_of_snapshot_is_corrupt(tmp_path):
    root = tmp_path / "dir"
    root.mkdir()
    (root / "meta.json").write_text('{"version": 1, "shards": 1}')
    (root / "shard-0000.wal").write_text('{"k": "wal", "gen": 5}\n')
    with pytest.raises(DirectoryCorruptError):
        _dir(tmp_path)


def test_stale_tmp_swept_on_open(tmp_path):
    d = _dir(tmp_path, compact_every=1)
    d.charge("u", 0.25)
    d.close()
    stale = tmp_path / "dir" / "shard-0000.json.tmp.12345"
    stale.write_text("half a snapshot that never committed")
    d2 = _dir(tmp_path, compact_every=1)
    assert not stale.exists()
    assert d2.spent("u") == pytest.approx(0.25)


def test_corrupt_spill_fails_shard_loudly_then_reopen_recovers(tmp_path):
    d = _dir(tmp_path, max_resident=0)
    d.charge("u", 0.25)
    cold = tmp_path / "dir" / "shard-0000.cold"
    cold.write_text("{torn garbage\n")
    with pytest.raises(DirectoryCorruptError):
        d.spent("u")  # the peek reads the spill
    assert os.path.exists(str(cold) + ".corrupt")
    # the shard is failed, not limping on a closed file handle: every
    # later operation re-raises the same loud quarantine error, never
    # a raw "I/O operation on closed file" ValueError
    with pytest.raises(DirectoryCorruptError):
        d.charge("v", 0.1)
    with pytest.raises(DirectoryCorruptError):
        d.headroom("u")
    d.close()  # must not raise on the already-closed spill handle
    # evicted users' authoritative state is snapshot + WAL, so a
    # restart recovers exact balances from a fresh (reset) spill
    d2 = _dir(tmp_path, max_resident=0)
    assert d2.spent("u") == pytest.approx(0.25)


def test_corrupt_meta_quarantined(tmp_path):
    root = tmp_path / "dir"
    root.mkdir()
    (root / "meta.json").write_text("{garbage")
    with pytest.raises(DirectoryCorruptError):
        _dir(tmp_path)
    assert (root / "meta.json.corrupt").exists()


# ------------------------------------------------- replay helpers ----
def test_apply_wal_entry_semantics(tmp_path):
    users, ids = {}, {}
    apply_wal_entry({"k": "c", "u": "u", "e": 0.5, "id": "a"},
                    users, ids, "wal")
    apply_wal_entry({"k": "c", "u": "u", "e": 0.5, "id": "a"},
                    users, ids, "wal")  # dedup
    assert users["u"]["s"] == pytest.approx(0.5)
    apply_wal_entry({"k": "r", "u": "u", "e": 9.0, "id": "a"},
                    users, ids, "wal")  # clamps, forgets the id
    assert users["u"]["s"] == 0.0 and "a" not in ids
    apply_wal_entry({"k": "n", "u": "u", "w": 7.0, "b": 0.3},
                    users, ids, "wal")
    assert users["u"] == {"s": 0.0, "l": 0.0, "b": 0.3, "w": 7.0}
    # creation-state-carrying entries: a WAL-only user is re-created
    # with the journaled window start and burst, not w=0, b=0
    apply_wal_entry({"k": "c", "u": "v", "e": 0.1, "id": "b",
                     "w": 50.0, "b": 0.2}, users, ids, "wal")
    assert users["v"]["w"] == 50.0
    assert users["v"]["b"] == pytest.approx(0.2)
    # a dedup'd charge does not create the user (live-path parity)
    apply_wal_entry({"k": "c", "u": "ghost", "e": 0.1, "id": "b"},
                    users, ids, "wal")
    assert "ghost" not in users
    bad_wal = tmp_path / "w.wal"
    bad_wal.write_text('{"k": "??", "u": "u"}\n')
    with pytest.raises(DirectoryCorruptError):
        apply_wal_entry({"k": "??", "u": "u"}, users, ids,
                        str(bad_wal))
    assert not bad_wal.exists()  # quarantined whole
    assert (tmp_path / "w.wal.corrupt").exists()


def test_views_and_fold_levels():
    aug = {"pa": 0.5, "pb": 0.25, USER_PREFIX + "alice": 0.75,
           GLOBAL_KEY: 0.75}
    assert party_view(aug) == {"pa": 0.5, "pb": 0.25}
    assert user_view(aug) == {"alice": 0.75}
    assert is_reserved(GLOBAL_KEY) and is_reserved(USER_PREFIX + "x")
    assert not is_reserved("party-x")
    lv = fold_levels(aug)
    assert lv["party"] == {"pa": 0.5, "pb": 0.25}
    assert lv["user"] == {"alice": 0.75}
    assert lv["global"] == {GLOBAL_KEY: 0.75}


# ------------------------------------------------ composite ledger ----
def _composite(tmp_path, budget=100.0, user_budget=1.0,
               global_budget=None, audit=None):
    led = PrivacyLedger(budget, audit=audit)
    d = BudgetDirectory(str(tmp_path / "dir"), shards=2,
                        user_budget=user_budget, fsync=False,
                        audit=audit)
    return CompositeLedger(led, d, user="alice",
                           global_budget=global_budget)


def test_augment_adds_legs_and_is_idempotent(tmp_path):
    comp = _composite(tmp_path, global_budget=10.0)
    aug = comp.augment({"pa": 0.5, "pb": 0.25})
    assert aug[USER_PREFIX + "alice"] == pytest.approx(0.75)
    assert aug[GLOBAL_KEY] == pytest.approx(0.75)
    assert comp.augment(aug) == aug  # round-trips unchanged
    assert comp.augment({"pa": 0.5}, user="bob") == {
        "pa": 0.5, USER_PREFIX + "bob": 0.5, GLOBAL_KEY: 0.5}


def test_composite_charge_lands_every_leg(tmp_path):
    comp = _composite(tmp_path, global_budget=10.0)
    comp.charge({"pa": 0.5, "pb": 0.25}, charge_id="c1")
    assert comp.ledger.spent("pa") == pytest.approx(0.5)
    assert comp.directory.spent("alice") == pytest.approx(0.75)
    assert comp.spent(USER_PREFIX + "alice") == pytest.approx(0.75)
    assert comp.ledger.spent(GLOBAL_KEY) == pytest.approx(0.75)
    comp.charge({"pa": 0.5, "pb": 0.25}, charge_id="c1")  # dedups whole
    assert comp.directory.spent("alice") == pytest.approx(0.75)


@pytest.mark.parametrize("level,kw,charges", [
    # party cap refuses: the user leg already applied is compensated
    ("party", dict(budget=0.5, user_budget=100.0), {"pa": 0.75}),
    # global cap refuses: each party leg fits, their sum does not
    ("global", dict(global_budget=0.5, user_budget=100.0),
     {"pa": 0.4, "pb": 0.4}),
    # user cap refuses before anything reaches the party ledger
    ("user", dict(user_budget=0.5), {"pa": 0.75}),
])
def test_refusal_consumes_zero_everywhere(tmp_path, level, kw, charges):
    comp = _composite(tmp_path, **kw)
    with pytest.raises(BudgetExceededError) as ei:
        comp.charge(charges, charge_id="c1")
    assert ei.value.level == level
    assert comp.directory.spent("alice") == 0.0
    for p in charges:
        assert comp.ledger.spent(p) == 0.0
    assert comp.refusals_by_level()[level] == 1
    comp.charge({"pa": 0.1}, charge_id="c1")  # compensation freed the id
    assert comp.directory.spent("alice") == pytest.approx(0.1)


def test_composite_compensates_on_non_budget_ledger_failure(tmp_path):
    comp = _composite(tmp_path)

    def boom(*a, **kw):
        raise OSError("disk full persisting the party snapshot")

    comp.ledger.charge = boom
    with pytest.raises(OSError):
        comp.charge({"pa": 0.5})
    # the user leg must not stay charged for a query that never ran —
    # server requests carry no charge_id, so nothing else would ever
    # reverse it
    assert comp.directory.spent("alice") == 0.0
    c = comp.directory.counters()
    assert c["charges"] == 1 and c["refunds"] == 1


def test_composite_simulated_crash_skips_compensation(tmp_path):
    # SimulatedCrash stands in for a process KILL: compensating after
    # it would journal refunds a real kill could never have written,
    # and the chaos exact-balance assertions rely on that fidelity.
    # The recovery story is the idempotent re-charge instead.
    comp = _composite(tmp_path)
    chaos.install(ChaosPlan(point="ledger.pre_persist", hit=1,
                            mode="raise"))
    with pytest.raises(SimulatedCrash):
        comp.charge({"pa": 0.5}, charge_id="c1")
    chaos.clear()
    assert comp.directory.spent("alice") == pytest.approx(0.5)
    comp.charge({"pa": 0.5}, charge_id="c1")  # the restart's re-issue
    assert comp.directory.spent("alice") == pytest.approx(0.5)  # dedup
    assert comp.ledger.spent("pa") == pytest.approx(0.5)


def test_refund_reverses_every_leg_from_bare_dict(tmp_path):
    comp = _composite(tmp_path, global_budget=10.0)
    comp.charge({"pa": 0.5, "pb": 0.25}, charge_id="c1")
    # the gate's transport-failure path holds only the per-party dict;
    # the one refund path re-derives the directory and global legs
    comp.refund({"pa": 0.5, "pb": 0.25}, charge_id="c1", reason="shed")
    assert comp.ledger.spent("pa") == 0.0
    assert comp.ledger.spent(GLOBAL_KEY) == 0.0
    assert comp.directory.spent("alice") == 0.0


def test_charge_request_returns_augmented_dict(tmp_path):
    comp = _composite(tmp_path)
    r = np.random.default_rng(0)
    req = EstimateRequest(family="ni_sign", x=r.normal(size=32),
                          y=r.normal(size=32), eps1=0.25, eps2=0.125,
                          party_x="pa", party_y="pb", normalise=False,
                          user="bob")
    aug = comp.charge_request(req)
    total = aug["pa"] + aug["pb"]
    assert aug[USER_PREFIX + "bob"] == pytest.approx(total)
    assert comp.directory.spent("bob") == pytest.approx(total)
    comp.refund(aug, reason="deadline")  # the coalescer's shed path
    assert comp.directory.spent("bob") == 0.0
    assert comp.ledger.spent("pa") == 0.0


def test_directory_snapshot_shape(tmp_path):
    comp = _composite(tmp_path, user_budget=0.5)
    comp.charge({"pa": 0.25})
    with pytest.raises(BudgetExceededError):
        comp.charge({"pa": 0.5})
    snap = comp.directory_snapshot()
    assert snap["shards"] == 2
    assert snap["resident_users"] == 1
    assert snap["refusals_by_level"] == {"user": 1, "party": 0,
                                         "global": 0}
    assert snap["counters"]["charged_eps"] == pytest.approx(0.25)


# ------------------------------------------------ audit / obs CLI ----
def test_audit_replay_matches_disk_balances(tmp_path):
    audit = AuditTrail(str(tmp_path / "audit.jsonl"))
    comp = _composite(tmp_path, audit=audit)
    comp.charge({"pa": 0.5}, charge_id="c1")
    comp.charge({"pa": 0.25}, charge_id="c2")
    comp.refund({"pa": 0.25}, charge_id="c2", reason="shed")
    comp.close()
    spent = replay(read_events(str(tmp_path / "audit.jsonl")))
    lv = fold_levels(spent)
    assert lv["user"]["alice"] == pytest.approx(0.5)
    assert lv["party"]["pa"] == pytest.approx(0.5)
    bal = read_user_balances(str(tmp_path / "dir"))
    assert bal["alice"]["l"] == pytest.approx(lv["user"]["alice"])


def test_replay_levels_checks_the_directory(tmp_path):
    """The audit trail folded by level equals the directory's lifetimes;
    a trail line with no matching disk spend is a mismatch."""
    audit_path = str(tmp_path / "audit.jsonl")
    audit = AuditTrail(audit_path)
    comp = _composite(tmp_path, audit=audit)
    comp.charge({"pa": 0.5}, charge_id="c1")
    comp.close()
    bal = read_user_balances(str(tmp_path / "dir"))
    lv = replay_levels(read_events(audit_path))
    assert lv["user"] == {u: b["l"] for u, b in bal.items()} == {
        "alice": 0.5}
    audit.record("charge", {USER_PREFIX + "ghost": 1.0})
    lv = replay_levels(read_events(audit_path))
    assert lv["user"] != {u: b["l"] for u, b in bal.items()}


def test_lease_is_refused_until_the_fleet_is_ported(tmp_path):
    """The fleet is ported, so a lease is no longer refused: it binds the
    directory in fleet mode (the shard count pinned in the lease dir),
    which opens no shard journal until that shard's lease is held."""
    from dpcorr_torch.serve.fleet import LeaseManager

    leases = LeaseManager(str(tmp_path / "leases"), "rep-a")
    d = _dir(tmp_path, shards=2, lease=leases)
    assert leases.n_shards == 2
    assert not [n for n in os.listdir(tmp_path / "dir")
                if n.startswith("shard-")]
    d.charge("alice", 0.5, charge_id="c1")
    assert leases.owned() == [d.shard_index("alice")]
    assert d.spent("alice") == 0.5


# ------------------------------------------------- both packages ----
def test_ring_equals_jax_for_10000_users():
    from dpcorr.serve import budget_dir as jbd

    for shards in (1, 8, 64):
        keys, ids = build_ring(shards)
        assert (keys, ids) == jbd.build_ring(shards)
        for i in range(0, 10_000, 1 if shards == 8 else 97):
            user = f"user-{i}"
            assert ring_shard_index(user, keys, ids) \
                == jbd.ring_shard_index(user, keys, ids)


def _drive(cls, root, now):
    """One scripted history: charges with ids, a dedup, a refund, a
    renewal, evictions and compactions, over 4 shards."""
    d = cls(str(root), shards=4, user_budget=1.0,
            renewal=RenewalPolicy(period_s=100.0, burst_cap=0.25)
            if cls is BudgetDirectory else _jax_renewal(100.0, 0.25),
            max_resident=3, compact_every=5, fsync=False,
            clock=lambda: now["t"])
    for i in range(24):
        d.charge(f"u{i % 9}", 0.125, charge_id=f"c{i}")
    d.charge("u1", 0.125, charge_id="c1")
    d.refund("u2", 0.125, charge_id="c2")
    now["t"] += 150.0
    d.charge("u3", 0.0625, charge_id="late")
    return d


def _jax_renewal(period, burst):
    from dpcorr.serve.budget_dir import RenewalPolicy as JRenewal

    return JRenewal(period_s=period, burst_cap=burst)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_directory_files_read_by_both_packages(tmp_path, writer):
    """The same history written by either package: byte-equal shard
    files, the same balances through either reader, and the other
    package's directory resumes it (a repeated charge id dedups)."""
    from dpcorr.obs.budget_replay import read_user_balances as jread
    from dpcorr.serve.budget_dir import BudgetDirectory as JDir

    roots = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    for name, cls in (("jax", JDir), ("port", BudgetDirectory)):
        _drive(cls, roots[name], {"t": 1000.0}).close()
    names = sorted(p.name for p in roots["jax"].iterdir())
    assert names == sorted(p.name for p in roots["port"].iterdir())
    for name in names:
        if not name.endswith(".cold"):
            assert (roots["jax"] / name).read_bytes() \
                == (roots["port"] / name).read_bytes(), name
    root = str(roots[writer])
    assert read_user_balances(root) == jread(root)
    other = BudgetDirectory if writer == "jax" else JDir
    d = other(root, shards=4, user_budget=1.0, fsync=False,
              clock=lambda: 1150.0)
    before = d.lifetime("u5")
    assert d.charge("u5", 0.125, charge_id="c5") is False
    assert d.lifetime("u5") == before
    d.close()


@pytest.mark.parametrize("point", ["budget.pre_journal",
                                   "budget.post_journal",
                                   "budget.mid_compaction",
                                   "budget.mid_eviction"])
def test_jax_recovers_a_port_directory_crashed_at_each_point(tmp_path,
                                                              point):
    """A port directory killed at each budget point is recovered by the
    JAX package's directory, and the re-issued charge applies once."""
    from dpcorr.serve.budget_dir import BudgetDirectory as JDir

    knobs = {"compact_every": 1 if point == "budget.mid_compaction"
             else None,
             "max_resident": 0 if point == "budget.mid_eviction"
             else None}
    d = _dir(tmp_path, **knobs)
    chaos.install(ChaosPlan(point=point, hit=1, mode="raise"))
    with pytest.raises(SimulatedCrash):
        d.charge("u", 0.25, charge_id="victim")
    chaos.clear()
    j = JDir(str(tmp_path / "dir"), shards=1, fsync=False, **knobs)
    j.charge("u", 0.25, charge_id="victim")
    assert j.lifetime("u") == pytest.approx(0.25)
    j.close()


def test_replicas_opening_one_directory_at_once_all_boot(tmp_path):
    """A fleet's replicas open one shared directory together. Each one's
    boot sweep of stale ``meta.json.tmp.*`` files must not unlink the
    tmp file another is about to rename (the replica then died at
    boot): 6 forked processes open a fresh directory at once, 12 times,
    and every one of them boots."""
    import multiprocessing as mp

    from dpcorr_torch.serve.fleet import LeaseManager

    ctx = mp.get_context("fork")

    def boot(root, name, barrier):
        barrier.wait()
        BudgetDirectory(os.path.join(root, "dir"), shards=4, fsync=False,
                        lease=LeaseManager(os.path.join(root, "leases"),
                                           name))

    for r in range(12):
        root = str(tmp_path / f"round-{r}")
        os.makedirs(root)
        barrier = ctx.Barrier(6)
        procs = [ctx.Process(target=boot, args=(root, f"rep-{i}", barrier))
                 for i in range(6)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(60)
        assert [p.exitcode for p in procs] == [0] * 6, f"round {r}"


def test_users_drill_gates_hold():
    """benchmarks/serve_load.py's directory drill through the port
    (``perf_stream.users_drill``) at 4,096 users over 8 shards of 64
    resident: every gate exact, evictions and rehydrations above 0."""
    from dpcorr_torch.perf_stream import users_drill

    out = users_drill(4096, 8, 64)
    assert out["ok"], out["gates"]
    assert out["evictions"] > 0 and out["rehydrations"] > 0
