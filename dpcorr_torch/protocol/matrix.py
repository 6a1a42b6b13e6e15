"""Federation planning: the k×k correlation matrix as pair sessions.

Counterpart of ``dpcorr/protocol/matrix.py``: the same schedules, ε
arithmetic, ``fed_hash`` and plan JSON.

The two-party runtime (protocol.party) answers one cell — the DP
correlation between one X column and one Y column. A deployment holds
many columns across many parties and wants the full k×k matrix. This
module is the *pure scheduling* half of that federation (the runtime
half is protocol.federation): a :class:`FederationPlan` takes N parties
× their column labels and compiles every matrix cell into either a
local computation (both columns at one party) or a round on a **pair
link** — one multiplexed channel per party pair carrying all of that
pair's cells as tagged sub-sessions.

Three properties are decided here, statically, so the runtime never
has to coordinate:

- **Roles.** Columns are globally ordered (party order, then label
  order); the cell (i, j), i < j, runs column i as the protocol's
  ``"x"`` role and column j as ``"y"``. Every column of a federation
  shares one ε, so ``split_roles`` resolves to the x side for every
  family — the lower-indexed party is always the releaser on a link,
  and a link needs exactly one release round-trip per batch of cells.

- **Release reuse.** A column's DP release is a function of its key
  label and values alone (utils.rng.column_root), so every pair that
  needs it reuses the *same bytes* — re-noising a column per pair would
  be both an ε leak and a correlation leak (protocol.scan's cross-pair
  gate). The plan assigns each release **artifact** — ``("x", label)``
  for the wire release, ``("y", label)`` for the finisher's in-finish
  own release — to the single venue that charges it: the first cell
  (in cell order) that uses it. Everything downstream reuses it free.
  Total spend is therefore the column-release optimum
  :meth:`optimal_eps` — for k columns under one ε, ``2·f·ε·(k−1)``
  against the naive per-cell ``f·ε·k·(k−1)`` — strictly less for
  k ≥ 3.

- **Determinism.** Schedules, rounds, artifact assignments and charge
  ids are all pure functions of the public plan, so a party killed
  mid-matrix re-derives the identical schedule on restart and its
  per-link journals resume exactly-once (protocol.journal).

Deliberately torch-free: ``federation plan`` and the transcript scanner
run where the estimators cannot. The release factor is re-derived here
(like scan.wire_schema) and pinned against ``serve.ledger.release_factor``
by tests/test_torch_federation.py.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from dpcorr_torch.protocol.messages import canonical_encode


def _factor(family: str, normalise: bool) -> float:
    """Jax-free mirror of ``serve.ledger.release_factor`` (the private
    centering double-spend for sign families; pinned by test)."""
    return 2.0 if (family in ("ni_sign", "int_sign") and normalise) else 1.0


def _norm_parties(parties) -> tuple[tuple[str, tuple[str, ...]], ...]:
    if isinstance(parties, dict):
        items = list(parties.items())
    else:
        items = [(name, labels) for name, labels in parties]
    return tuple((str(name), tuple(str(c) for c in labels))
                 for name, labels in items)


@dataclass(frozen=True)
class FederationPlan:
    """The public design point of one k×k federation — every party must
    hold the byte-identical plan (the link handshake pins its hash,
    exactly like the two-party spec hash)."""

    family: str
    n: int
    eps: float
    parties: tuple  # ((party, (label, ...)), ...) — order is public
    alpha: float = 0.05
    normalise: bool = True
    seed: int = 2025
    noise_mode: str = "replay"
    max_cells_per_round: int = 0  # 0: all of a link's cells in one round
    fed: str = ""

    def __post_init__(self):
        object.__setattr__(self, "parties", _norm_parties(self.parties))
        names = [p for p, _ in self.parties]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate party names in {names}")
        labels = [c for _, cols in self.parties for c in cols]
        if len(set(labels)) != len(labels):
            raise ValueError(f"column labels must be globally unique, "
                             f"got {labels}")
        if len(labels) < 2:
            raise ValueError("a federation needs at least 2 columns")
        if not float(self.eps) > 0.0:
            raise ValueError("eps must be positive")
        if self.fed == "":
            object.__setattr__(self, "fed",
                               f"fed-{self.fed_hash()[:12]}")

    # ------------------------------------------------------- identity ----
    def to_public(self) -> dict:
        return {"family": self.family, "n": int(self.n),
                "eps": float(self.eps),
                "parties": [[p, list(cols)] for p, cols in self.parties],
                "alpha": float(self.alpha),
                "normalise": bool(self.normalise),
                "seed": int(self.seed), "noise_mode": self.noise_mode,
                "max_cells_per_round": int(self.max_cells_per_round)}

    def fed_hash(self) -> str:
        return hashlib.sha256(canonical_encode(self.to_public())).hexdigest()

    def trace_id(self) -> str:
        """Deterministic federation-wide trace ID: every
        party derives the same 64-bit hex id from the public plan, so
        all k processes — and a crash-resumed rerun of any of them —
        join ONE trace with zero coordination. Same width as the
        tracer's random ids (``secrets.token_hex(8)``)."""
        return self.fed_hash()[:16]

    @classmethod
    def from_public(cls, pub: dict) -> "FederationPlan":
        return cls(family=pub["family"], n=int(pub["n"]),
                   eps=float(pub["eps"]), parties=pub["parties"],
                   alpha=float(pub.get("alpha", 0.05)),
                   normalise=bool(pub.get("normalise", True)),
                   seed=int(pub.get("seed", 2025)),
                   noise_mode=pub.get("noise_mode", "replay"),
                   max_cells_per_round=int(
                       pub.get("max_cells_per_round", 0)))

    # -------------------------------------------------------- columns ----
    def columns(self) -> tuple[tuple[str, str], ...]:
        """Global column order: (owner, label) per column. The order is
        the role rule — cell (i, j) runs i as "x", j as "y"."""
        return tuple((p, c) for p, cols in self.parties for c in cols)

    @property
    def k(self) -> int:
        return len(self.columns())

    def owner(self, i: int) -> str:
        return self.columns()[i][0]

    def label(self, i: int) -> str:
        return self.columns()[i][1]

    def party_index(self, name: str) -> int:
        for idx, (p, _) in enumerate(self.parties):
            if p == name:
                return idx
        raise ValueError(f"unknown party {name!r}")

    def party_labels(self, name: str) -> tuple[str, ...]:
        return dict(self.parties)[name]

    # ---------------------------------------------------------- cells ----
    def cells(self) -> tuple[tuple[int, int], ...]:
        k = self.k
        return tuple((i, j) for i in range(k) for j in range(i + 1, k))

    def cell_venue(self, i: int, j: int):
        """Where cell (i, j) runs: ``("local", P)`` when one party owns
        both columns, else ``("link", P, Q)`` with P the owner of the
        x column — parties are ordered, so the x-column owner is always
        the link's lower party and the link needs one direction of
        release only."""
        p, q = self.owner(i), self.owner(j)
        if p == q:
            return ("local", p)
        return ("link", p, q)

    def local_cells(self, party: str) -> tuple[tuple[int, int], ...]:
        return tuple((i, j) for i, j in self.cells()
                     if self.cell_venue(i, j) == ("local", party))

    # ---------------------------------------------------------- links ----
    def links(self) -> tuple[tuple[str, str], ...]:
        """Party pairs with at least one cross-party cell, each ordered
        (releaser, finisher) = (lower party, higher party)."""
        seen: list[tuple[str, str]] = []
        for i, j in self.cells():
            v = self.cell_venue(i, j)
            if v[0] == "link" and (v[1], v[2]) not in seen:
                seen.append((v[1], v[2]))
        return tuple(seen)

    def party_links(self, name: str) -> tuple[tuple[str, str], ...]:
        return tuple(lk for lk in self.links() if name in lk)

    def link_session(self, p: str, q: str) -> str:
        return f"{self.fed}-{p}-{q}"

    def link_rounds(self, p: str, q: str) -> tuple[tuple, ...]:
        """The link's cells chunked into rounds (each round: one batched
        release message, one batched result message). With
        ``max_cells_per_round == 0`` the whole link is one round."""
        cells = tuple((i, j) for i, j in self.cells()
                      if self.cell_venue(i, j) == ("link", p, q))
        size = self.max_cells_per_round or len(cells)
        if size <= 0:
            return ()
        return tuple(cells[a:a + size] for a in range(0, len(cells), size))

    def round_x_labels(self, p: str, q: str, r: int) -> tuple[str, ...]:
        """Release artifacts one round's envelope carries, in first-use
        order, each exactly once."""
        out: list[str] = []
        for i, _j in self.link_rounds(p, q)[r]:
            if self.label(i) not in out:
                out.append(self.label(i))
        return tuple(out)

    # ------------------------------------------------------ artifacts ----
    def artifact_venues(self) -> dict:
        """``(side, label) -> venue`` charging that artifact: the venue
        of the first cell (in cell order) that uses it. ``side`` is the
        protocol role the column plays — "x" artifacts are the wire
        release, "y" artifacts the finisher's in-finish own release.
        Pure plan arithmetic, so every party (and every restart)
        derives the identical charge assignment."""
        venues: dict = {}
        for i, j in self.cells():
            v = self.cell_venue(i, j)
            venues.setdefault(("x", self.label(i)), (v, (i, j)))
            venues.setdefault(("y", self.label(j)), (v, (i, j)))
        return {art: v for art, (v, _cell) in venues.items()}

    def _round_of(self, p: str, q: str, cell) -> int:
        for r, cells in enumerate(self.link_rounds(p, q)):
            if cell in cells:
                return r
        raise ValueError(f"cell {cell} not on link {p}-{q}")

    def _charged_labels(self, p: str, q: str, r: int,
                        side: str) -> tuple[str, ...]:
        """Labels whose ``side`` artifact this round's gated message
        pays for (release message for "x", result message for "y")."""
        venues: dict = {}
        for i, j in self.cells():
            v = self.cell_venue(i, j)
            venues.setdefault(("x", self.label(i)), (v, (i, j)))
            venues.setdefault(("y", self.label(j)), (v, (i, j)))
        out = []
        for (s, label), (venue, cell) in venues.items():
            if s != side or venue != ("link", p, q):
                continue
            if self._round_of(p, q, cell) == r:
                out.append(label)
        return tuple(out)

    def round_charges(self, p: str, q: str, r: int) -> dict:
        """The two gated messages of one round: who pays what.
        ``release`` is charged by P (new "x" artifacts), ``result`` by
        Q (new "y" artifacts). Reused artifacts appear in the envelope
        but never here — that is the whole optimization."""
        f = _factor(self.family, self.normalise)
        rel = self._charged_labels(p, q, r, "x")
        res = self._charged_labels(p, q, r, "y")
        return {
            "release": {"labels": rel,
                        "charges": ({p: f * self.eps * len(rel)}
                                    if rel else {})},
            "result": {"labels": res,
                       "charges": ({q: f * self.eps * len(res)}
                                   if res else {})},
        }

    def local_charges(self, party: str) -> dict:
        """Artifacts first used by ``party``'s local cells — charged
        once by the owner under a deterministic id, no wire send."""
        f = _factor(self.family, self.normalise)
        arts = tuple(sorted(
            art for art, venue in self.artifact_venues().items()
            if venue == ("local", party)))
        eps = f * self.eps * len(arts)
        return {"artifacts": arts,
                "charges": ({party: eps} if arts else {}),
                "charge_id": f"{self.fed}:{party}:local"}

    # ------------------------------------------------------ ε arithmetic ----
    def optimal_eps(self) -> float:
        """Total ε of the column-release-reuse schedule: each artifact
        charged exactly once. Under one shared ε and a full matrix this
        is ``2·f·ε·(k−1)``."""
        f = _factor(self.family, self.normalise)
        return f * self.eps * len(self.artifact_venues())

    def naive_eps(self) -> float:
        """What per-cell charging would cost (both roles pay per cell,
        like k·(k−1)/2 independent two-party sessions): the baseline
        the benchmark and CI gate against."""
        f = _factor(self.family, self.normalise)
        return 2.0 * f * self.eps * len(self.cells())

    def party_eps(self) -> dict[str, float]:
        """Per-party share of :meth:`optimal_eps` — what each party's
        ledger must show after a clean (or resumed) matrix."""
        f = _factor(self.family, self.normalise)
        out = {p: 0.0 for p, _ in self.parties}
        for (_side, label), _venue in self.artifact_venues().items():
            for p, cols in self.parties:
                if label in cols:
                    out[p] += f * self.eps
        return out

    # ---------------------------------------- two-party equivalence ----
    def cell_spec(self, i: int, j: int):
        """The :class:`~dpcorr_torch.protocol.party.ProtocolSpec` of the
        *independent two-party run* equivalent to cell (i, j): same
        per-column key labels, so the federation matrix is bit-identical
        to k·(k−1)/2 separate sessions (the acceptance contract).
        Imported lazily: planning stays torch-free."""
        from dpcorr_torch.protocol.party import ProtocolSpec

        return ProtocolSpec(
            family=self.family, n=self.n, eps1=self.eps, eps2=self.eps,
            alpha=self.alpha, normalise=self.normalise, seed=self.seed,
            noise_mode=self.noise_mode,
            party_x=self.owner(i), party_y=self.owner(j),
            session=f"{self.fed}-cell-{i}-{j}",
            key_x=self.label(i), key_y=self.label(j))

    def describe(self) -> dict:
        """The ``federation plan`` JSON: schedule, venues and the
        ε arithmetic, all derived — nothing here is state."""
        venues = {f"{side}:{label}": list(v if v[0] == "link" else v)
                  for (side, label), v in self.artifact_venues().items()}
        return {
            "fed": self.fed,
            "fed_hash": self.fed_hash(),
            "plan": self.to_public(),
            "k": self.k,
            "cells": [list(c) for c in self.cells()],
            "links": [
                {"pair": [p, q],
                 "session": self.link_session(p, q),
                 "rounds": [[list(c) for c in cells]
                            for cells in self.link_rounds(p, q)]}
                for p, q in self.links()],
            "local": {p: [list(c) for c in self.local_cells(p)]
                      for p, _ in self.parties
                      if self.local_cells(p)},
            "artifact_venues": venues,
            "eps": {"optimal": self.optimal_eps(),
                    "naive_per_cell": self.naive_eps(),
                    "per_party": self.party_eps()},
        }
