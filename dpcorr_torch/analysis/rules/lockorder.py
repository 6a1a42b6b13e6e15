"""Lock-order and blocking-under-lock analysis (``--deep``).

Built on the interprocedural model (analysis/callgraph.py): every
``threading.Lock``/``RLock`` created in the tree is a node, and every
place the code acquires lock B while lexically — or through a resolved
call chain — holding lock A is an edge A→B. Two rules:

- ``lock-order-cycle`` — the edge graph has a cycle: two threads
  taking the component's locks from different entry points can
  deadlock. The finding names every edge of the cycle with the full
  file:line acquisition chain for each direction, so the report shows
  *both* paths (the pair of stacks a deadlock debugger would show you,
  computed before the deadlock exists). A self-edge on a plain
  ``Lock`` (re-acquiring a non-reentrant lock you already hold) is
  reported as a 1-cycle: that one is not a race, it is a guaranteed
  hang.
- ``blocking-under-lock`` — a call that can block on the outside world
  (``fsync``, ``subprocess``, socket I/O, ``Future.result()``,
  ``Thread.join()``, ``time.sleep``, ``Event.wait``) is reachable
  while a lock is held. Holding a lock across I/O turns one slow disk
  into a stalled lock convoy. The repo's WAL-before-ack design *does*
  fsync under the admission locks on purpose — those sites carry a
  ``# dpcorr-lint: ignore[blocking-under-lock]`` with a justification,
  which is exactly the reviewable escape hatch this rule exists to
  force.

Findings are anchored at the outermost frame that holds the lock (the
acquisition or call site in the holder), with the rest of the path in
the chain — so a suppression sits next to the lock that makes the
blocking call a decision, not next to the innocent helper.
"""

from __future__ import annotations

from typing import Iterator

from dpcorr_torch.analysis.callgraph import BLOCKING_KINDS, ProjectModel
from dpcorr_torch.analysis.core import ProjectChecker, Violation

#: blocking effect kinds worth flagging under a lock (a subset of the
#: model's effect kinds — ``replace``/``sweep``/``quarantine`` are fast
#: metadata ops and are durability-rule business, not convoy risks).
_FLAGGED = frozenset(BLOCKING_KINDS)


def _site_line(site: str) -> tuple[str, int]:
    """``"dpcorr_torch/serve/ledger.py:162 (PrivacyLedger.charge)"`` →
    (path, 162)."""
    head = site.split(" ", 1)[0]
    path, _, line = head.rpartition(":")
    return path, int(line)


class LockOrderChecker(ProjectChecker):
    name = "lockorder"
    rules = {
        "lock-order-cycle": "two acquisition paths take the same locks "
                            "in opposite orders (potential deadlock)",
        "blocking-under-lock": "fsync/subprocess/socket/result()/join() "
                               "reachable while a lock is held",
    }

    def check_project(self, model: ProjectModel) -> Iterator[Violation]:
        yield from self._cycles(model)
        yield from self._blocking(model)

    # ------------------------------------------------------- cycles ----
    def _cycles(self, model: ProjectModel) -> Iterator[Violation]:
        for cycle in model.lock_cycles():
            a, b, chain = cycle[0]
            path, line = _site_line(chain[0])
            if len(cycle) == 1:
                yield Violation(
                    "lock-order-cycle", path, line,
                    f"re-acquires non-reentrant lock {a} while already "
                    f"holding it — this path self-deadlocks",
                    chain=tuple(chain))
            else:
                locks = " -> ".join([e[0] for e in cycle] + [a])
                full_chain: list[str] = []
                for (ea, eb, ec) in cycle:
                    full_chain.append(f"[{ea} -> {eb}]")
                    full_chain.extend(ec)
                yield Violation(
                    "lock-order-cycle", path, line,
                    f"lock-order cycle {locks}: each bracketed path "
                    f"below acquires the second lock while holding the "
                    f"first — two threads entering from different "
                    f"edges can deadlock",
                    chain=tuple(full_chain))

    # ------------------------------------------------ blocking calls ----
    def _blocking(self, model: ProjectModel) -> Iterator[Violation]:
        seen: set[tuple[str, int, str]] = set()
        for fi in model.functions.values():
            for eff in fi.effects:
                if eff.kind in _FLAGGED and eff.held:
                    key = (fi.relpath, eff.lineno, eff.kind)
                    if key in seen:
                        continue
                    seen.add(key)
                    yield Violation(
                        "blocking-under-lock", fi.relpath, eff.lineno,
                        f"{eff.text} ({eff.kind}) blocks while holding "
                        f"{', '.join(eff.held)}",
                        chain=(fi.site(eff.lineno),))
            for cs in fi.calls:
                if not cs.held or cs.target is None:
                    continue
                effects = model.transitive_effects(cs.target)
                for kind in sorted(_FLAGGED & set(effects)):
                    key = (fi.relpath, cs.lineno, kind)
                    if key in seen:
                        continue
                    seen.add(key)
                    chain = (fi.site(cs.lineno),) + effects[kind]
                    yield Violation(
                        "blocking-under-lock", fi.relpath, cs.lineno,
                        f"{cs.text} reaches a {kind} call while "
                        f"holding {', '.join(cs.held)}",
                        chain=chain)
