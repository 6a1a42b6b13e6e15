"""Interprocedural budget discipline (``--deep``).

rules/budget.py checks charge→enqueue dominance and refund guards one
function at a time, and deliberately stays silent when the charge and
the enqueue live in different functions — which, since the
CompositeLedger/gate refactors, is the *common* shape: an admission
method calls ``self._admit()`` (which charges) and then hands the work
to ``self.coalescer.submit(...)``, or charges directly and launches
through a private ``_launch()`` helper. This pass closes that gap by
inlining callee summaries through the call graph (depth-capped):

- ``budget-deep-uncharged-enqueue`` — composing the function with its
  resolved callees, an enqueue (direct or inherited from a callee)
  executes before the first charge: work can launch unpaid even
  though each individual function looked fine.
- ``budget-deep-missing-refund`` — a post-charge enqueue inherited
  across a function boundary is refund-guarded neither where it
  physically lives nor at the call site that inherits it: a refusal
  would strand the charge.

Findings where every charge *and* every enqueue is direct are left to
the intra-function rule (no double reporting), and an enqueue whose
originating call site also produces a charge (e.g. a call to
``gate.send_release``, which charges, sends and refunds internally) is
trusted to that callee — the intra rule already audits its body.
"""

from __future__ import annotations

import ast
from typing import Iterator

from dpcorr_torch.analysis.callgraph import FunctionInfo, ProjectModel
from dpcorr_torch.analysis.core import ProjectChecker, Violation, \
    attr_chain, walk_same_scope
from dpcorr_torch.analysis.rules.budget import (
    CHARGE_FNS,
    _is_enqueue_call,
    _is_ledger_call,
)

#: how many call-graph levels charges/enqueues are inlined through.
_DEPTH = 3


def _refund_guarded(fi: FunctionInfo, lineno: int) -> bool:
    """True when a ``try`` in ``fi`` lexically contains line ``lineno``
    in its body and has a handler that reaches a refund (any call whose
    name chain mentions ``refund`` — the repo convention the shed rule
    also keys on)."""
    for node in walk_same_scope(fi.node):
        if not isinstance(node, ast.Try):
            continue
        in_body = any(getattr(sub, "lineno", None) == lineno
                      for stmt in node.body for sub in ast.walk(stmt))
        if not in_body:
            continue
        for handler in node.handlers:
            for stmt in handler.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call) and any(
                            "refund" in part
                            for part in attr_chain(sub.func)):
                        return True
    return False


class DeepBudgetChecker(ProjectChecker):
    name = "deepbudget"
    rules = {
        "budget-deep-uncharged-enqueue": "across function boundaries, "
                                         "an enqueue executes before "
                                         "the first ledger charge",
        "budget-deep-missing-refund": "a cross-function post-charge "
                                      "enqueue has no refund guard at "
                                      "either level",
    }

    def applies_to(self, relpath: str) -> bool:
        parts = relpath.split("/")
        return ("serve" in parts or "protocol" in parts
                or "stream" in parts)

    def check_project(self, model: ProjectModel) -> Iterator[Violation]:
        self._direct_memo: dict[str, tuple] = {}
        for key, fi in model.functions.items():
            if not self.applies_to(fi.relpath):
                continue
            yield from self._check_fn(model, key, fi)

    # ----------------------------------------------- direct summary ----
    def _direct(self, model: ProjectModel, key: str) -> tuple:
        """(charge_linenos, [(enqueue_lineno, text, guarded)])."""
        if key in self._direct_memo:
            return self._direct_memo[key]
        fi = model.functions[key]
        charges: list[int] = []
        enqueues: list[tuple[int, str, bool]] = []
        for node in walk_same_scope(fi.node):
            if not isinstance(node, ast.Call):
                continue
            if _is_ledger_call(node, CHARGE_FNS):
                charges.append(node.lineno)
            elif _is_enqueue_call(node):
                enqueues.append((node.lineno,
                                 ".".join(attr_chain(node.func)),
                                 _refund_guarded(fi, node.lineno)))
        self._direct_memo[key] = (charges, enqueues)
        return self._direct_memo[key]

    def _effective(self, model: ProjectModel, key: str, depth: int,
                   stack: frozenset) -> tuple[list, list]:
        """Inlined view: (charges, enqueues) as
        ([(line_in_f, chain)], [(line_in_f, chain, text, guarded)])."""
        fi = model.functions[key]
        d_charges, d_enqueues = self._direct(model, key)
        charges = [(ln, ()) for ln in d_charges]
        enqueues = [(ln, (), text, g) for ln, text, g in d_enqueues]
        if depth <= 0:
            return charges, enqueues
        for cs in fi.calls:
            if cs.target is None or cs.target in stack \
                    or cs.target not in model.functions:
                continue
            sub_c, sub_e = self._effective(model, cs.target, depth - 1,
                                           stack | {key})
            site = fi.site(cs.lineno)
            for _, chain in sub_c:
                charges.append((cs.lineno, (site,) + chain))
            for _, chain, text, g in sub_e:
                enqueues.append((cs.lineno, (site,) + chain, text, g))
        return charges, enqueues

    # ------------------------------------------------- one function ----
    def _check_fn(self, model: ProjectModel, key: str,
                  fi: FunctionInfo) -> Iterator[Violation]:
        charges, enqueues = self._effective(model, key, _DEPTH,
                                            frozenset({key}))
        if not charges or not enqueues:
            return
        if all(not c[1] for c in charges) and \
                all(not e[1] for e in enqueues):
            return                 # purely intra: rules/budget.py owns it
        charge_lines = sorted({ln for ln, _ in charges})
        first_charge = charge_lines[0]
        seen: set[tuple[int, str]] = set()
        for line, chain, text, guarded in enqueues:
            if line in charge_lines:
                continue           # same call site charges too: the
            if (line, text) in seen:  # callee is internally consistent
                continue
            seen.add((line, text))
            if line < first_charge:
                yield Violation(
                    "budget-deep-uncharged-enqueue", fi.relpath, line,
                    f"{text} launches work at line {line} but the "
                    f"first ledger charge in {fi.qualname}'s composed "
                    f"view is at line {first_charge} — a crash (or "
                    f"refusal) in between runs the work unpaid",
                    chain=chain or (fi.site(line),))
            elif not guarded and not _refund_guarded(fi, line):
                yield Violation(
                    "budget-deep-missing-refund", fi.relpath, line,
                    f"{text} can refuse after the ledger was charged "
                    f"(line {first_charge}) and no refund guard exists "
                    f"in {fi.qualname} or where the enqueue lives — "
                    f"a refusal would strand the charge",
                    chain=chain or (fi.site(line),))
