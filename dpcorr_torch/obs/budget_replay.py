"""Durability helpers of the ε-ledger's snapshot file.

Counterpart of the two helpers of ``dpcorr/obs/budget_replay.py`` that
the per-party ledger (:mod:`dpcorr_torch.serve.ledger`) uses: the
stale-``.tmp`` sweep and the ``.corrupt`` quarantine. An unparseable
durable file is moved aside whole and refused loudly, never
half-applied. The budget directory's shard reader, which shares them in
the JAX package, is not ported yet; its reserved principal prefixes are
here because the protocol's auditor filters them.
"""

from __future__ import annotations

import os

#: reserved principal namespaces of the JAX package's per-user budget
#: directory: party names never collide with them, and the protocol's
#: ledger balance (``protocol.scan.ledger_balance``) leaves them out when
#: it matches wire ε, which is party-leg-only.
RESERVED_PREFIXES = ("user/", "global/")


def sweep_stale_tmp(path: str) -> None:
    """Remove ``{path}.tmp.*`` crash artifacts: a tmp file that was
    never renamed belongs to a write that never committed, and a dead
    writer will never finish it (the ledger snapshot, serve.ledger).

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
