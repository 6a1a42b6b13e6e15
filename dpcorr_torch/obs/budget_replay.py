"""Read half of the sharded per-user budget directory, and the durability
helpers the ε-ledger shares with it.

Counterpart of ``dpcorr/obs/budget_replay.py``, with its file formats:
``serve/budget_dir.py`` is the write side (sharded per-user ε accounting
with a generation-numbered snapshot + write-ahead journal per shard);
this module is the read side and the *recovery core* the write side
itself uses, so the auditor and the live directory can never drift on
what a shard file *means*. It imports no torch: a directory written by
either package is read here, on a host with no card.

Also home to the durability helpers the per-party ledger and the shard
files share: the stale-``.tmp`` sweep and the ``.corrupt`` quarantine —
an unparseable durable file is moved aside whole and refused loudly,
never half-applied.
"""

from __future__ import annotations

import json
import os
from typing import Mapping

#: shard snapshot / WAL / meta format version (serve.budget_dir).
DIR_VERSION = 1

#: reserved principal namespaces the composite ledger routes by —
#: party names must never collide with these. scan.ledger_balance
#: filters them when matching wire ε (which is party-leg-only), and
#: :func:`fold_levels` splits a replayed spend table along them.
USER_PREFIX = "user/"
GLOBAL_KEY = "global/total"
RESERVED_PREFIXES = (USER_PREFIX, "global/")


class DirectoryCorruptError(ValueError):
    """A budget-directory shard file could not be parsed. The bad file
    has been quarantined to a ``.corrupt`` sidecar; the message says
    exactly what to do next — never half-applied."""


def sweep_stale_tmp(path: str) -> None:
    """Remove ``{path}.tmp.*`` crash artifacts: a tmp file that was
    never renamed belongs to a write that never committed, and a dead
    writer will never finish it. Shared by the ledger snapshot
    (serve.ledger) and the budget directory's shard files.

    Writers stamp their pid into the suffix (``{path}.tmp.{pid}``), so
    a tmp bearing *our own* pid belongs to a writer in this very
    process — alive by definition, possibly mid-persist on another
    thread (in-proc crash-resume harnesses reopen a journal while the
    pre-crash thread is still draining) — and is skipped."""
    d = os.path.dirname(path) or "."
    prefix = os.path.basename(path) + ".tmp."
    own = str(os.getpid())
    try:
        names = os.listdir(d)
    except OSError:
        return
    for name in names:
        if name.startswith(prefix) and name[len(prefix):] != own:
            try:
                os.unlink(os.path.join(d, name))
            except OSError:
                pass


def quarantine_corrupt(path: str) -> str:
    """Move an unparseable durable file aside to ``{path}.corrupt`` so
    a restart can never half-apply it; returns the sidecar path. The
    caller raises its own loud, actionable error naming the sidecar."""
    quarantined = path + ".corrupt"
    os.replace(path, quarantined)
    return quarantined


def corrupt_error(path: str, why: str) -> DirectoryCorruptError:
    """Quarantine ``path`` and build the loud error to raise."""
    quarantined = quarantine_corrupt(path)
    return DirectoryCorruptError(
        f"budget shard file {path!r} is corrupt ({why}); the bad file "
        f"was moved to {quarantined!r} — nothing was half-applied. To "
        "recover, rebuild per-user balances from the audit trail "
        "(`dpcorr_torch.obs.audit.replay_levels`) or restore a good "
        "snapshot; delete the sidecar only if losing this shard's "
        "spend history is acceptable.")


def fresh_user(now: float) -> dict:
    """Per-user state record. ``s``: current-window spend, ``l``:
    lifetime spend (monotone mod refunds — the audit-replay quantity),
    ``b``: burst credit, ``w``: window start."""
    return {"s": 0.0, "l": 0.0, "b": 0.0, "w": now}


def apply_wal_entry(entry: dict, users: dict,
                    charge_ids: dict, wal_path: str) -> None:
    """Apply one WAL entry to a user table — the single definition of
    what a journal line *means*, shared by live recovery and the
    torch-free reader. Charges dedup on ``charge_id`` exactly like the
    live path (before creating the user, also like the live path);
    refunds clamp at zero and forget the id; renewals carry absolute
    resulting state, so replay is idempotent. ``c``/``r`` entries
    carry the user's window start ``w`` and burst ``b``, consulted
    only when the entry has to *create* the user (state still
    WAL-only, no snapshot line yet): recreating with ``w=0.0`` would
    make the first post-restart charge see billions of elapsed
    periods and fire a spurious renewal that zeroes the window spend,
    letting the user overspend their window budget."""
    kind = entry["k"]
    user = str(entry["u"])
    if kind == "c":
        cid = entry.get("id")
        if cid is not None and cid in charge_ids:
            return
    st = users.get(user)
    if st is None:
        st = users[user] = fresh_user(float(entry.get("w", 0.0)))
        st["b"] = float(entry.get("b", 0.0))
    if kind == "c":
        eps = float(entry["e"])
        st["s"] += eps
        st["l"] += eps
        if cid is not None:
            charge_ids[cid] = None
    elif kind == "r":
        eps = float(entry["e"])
        st["s"] = max(0.0, st["s"] - eps)
        st["l"] = max(0.0, st["l"] - eps)
        cid = entry.get("id")
        if cid is not None:
            charge_ids.pop(cid, None)
    elif kind == "n":
        st["s"] = 0.0
        st["b"] = float(entry["b"])
        st["w"] = float(entry["w"])
    else:
        raise corrupt_error(wal_path, f"unknown entry kind {kind!r}")


def load_shard(base: str) -> dict:
    """Recover one shard's authoritative state from ``{base}.json``
    (snapshot) + ``{base}.wal`` (journal). Returns ``{"gen", "users",
    "charge_ids", "wal_entries", "wal_fresh_needed"}`` —
    ``wal_fresh_needed`` tells the write side the WAL must be
    rewritten (absent, or stale from a crash mid-compaction: its
    generation is behind the snapshot's, so every entry is already
    folded in and replaying would double-apply). Raises
    :class:`DirectoryCorruptError` (after quarantining the bad file)
    on anything unparseable — a torn shard is refused loudly, never
    half-applied."""
    snap_path, wal_path = base + ".json", base + ".wal"
    sweep_stale_tmp(snap_path)
    sweep_stale_tmp(wal_path)
    gen = 0
    users: dict = {}
    charge_ids: dict = {}
    if os.path.exists(snap_path):
        try:
            with open(snap_path, encoding="utf-8") as fh:
                state = json.load(fh)
            if state.get("version") != DIR_VERSION:
                raise ValueError(f"version {state.get('version')!r}")
            gen = int(state["gen"])
            users = {str(u): {"s": float(st["s"]), "l": float(st["l"]),
                              "b": float(st["b"]), "w": float(st["w"])}
                     for u, st in state["users"].items()}
            charge_ids = {str(c): None
                          for c in state.get("charge_ids", [])}
        except (json.JSONDecodeError, UnicodeDecodeError, OSError,
                KeyError, TypeError, ValueError) as e:
            raise corrupt_error(snap_path, str(e)) from e
    entries = _read_wal(wal_path, gen)
    if entries is None:
        return {"gen": gen, "users": users, "charge_ids": charge_ids,
                "wal_entries": 0, "wal_fresh_needed": True}
    for entry in entries:
        apply_wal_entry(entry, users, charge_ids, wal_path)
    return {"gen": gen, "users": users, "charge_ids": charge_ids,
            "wal_entries": len(entries), "wal_fresh_needed": False}


def _read_wal(wal_path: str, snap_gen: int):
    if not os.path.exists(wal_path):
        return None
    try:
        with open(wal_path, encoding="utf-8") as fh:
            lines = fh.read().splitlines()
    except (OSError, UnicodeDecodeError) as e:
        raise corrupt_error(wal_path, str(e)) from e
    if not lines:
        return None
    try:
        header = json.loads(lines[0])
        if header.get("k") != "wal":
            raise ValueError(f"bad header {lines[0]!r}")
        gen = int(header["gen"])
        entries = [json.loads(ln) for ln in lines[1:]]
    except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
        raise corrupt_error(wal_path, str(e)) from e
    if gen < snap_gen:
        # crash between the snapshot rename and the WAL reset
        # (budget.mid_compaction window): discard, never double-apply
        return None
    if gen > snap_gen:
        raise corrupt_error(wal_path,
                            f"generation {gen} is ahead of snapshot "
                            f"generation {snap_gen}")
    return entries


def directory_shards(root: str) -> int:
    """Shard count pinned in the directory's ``meta.json``."""
    meta_path = os.path.join(root, "meta.json")
    try:
        with open(meta_path, encoding="utf-8") as fh:
            return int(json.load(fh)["shards"])
    except (json.JSONDecodeError, UnicodeDecodeError, OSError,
            KeyError, TypeError, ValueError) as e:
        raise corrupt_error(meta_path, str(e)) from e


def read_user_balances(root: str) -> dict[str, dict]:
    """Fold every shard's authoritative state into one ``user →
    {"s", "l", "b", "w"}`` table — read-only, torch-free, no cold-spill
    or live-directory machinery. Exact per-user balances are asserted
    against it, and the audit-trail replay
    (:func:`dpcorr_torch.obs.audit.replay_levels`) is compared to it."""
    balances: dict[str, dict] = {}
    for i in range(directory_shards(root)):
        shard = load_shard(os.path.join(root, f"shard-{i:04d}"))
        balances.update(shard["users"])
    return balances


def fold_levels(spent: Mapping[str, float]) -> dict[str, dict]:
    """Split a replayed spend table (obs.audit.replay) into the three
    budget levels: ``party`` (data owners), ``user`` (bare user ids,
    ``user/`` prefix stripped), ``global``."""
    out: dict[str, dict] = {"party": {}, "user": {}, "global": {}}
    for principal, eps in spent.items():
        if principal.startswith(USER_PREFIX):
            out["user"][principal[len(USER_PREFIX):]] = eps
        elif principal.startswith("global/"):
            out["global"][principal] = eps
        else:
            out["party"][principal] = eps
    return out
