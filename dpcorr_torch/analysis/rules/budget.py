"""Budget discipline: charge-before-noise, refund-on-refusal
(serve/, protocol/ and stream/).

The serving layer's privacy invariant (serve.server module docstring)
is structural: the ledger must be charged — and durably persisted —
*before* a request can reach any noise-drawing execution path, and any
post-charge refusal (queue backpressure, closed coalescer) must reverse
the charge so shed load cannot drain budgets. The protocol layer has
the same invariant with the wire in place of the execution engine: a
release may be handed to the transport (``channel.send``) only after
``ledger.charge``, and a transport failure must refund — that is
exactly ``protocol.gate.ReleaseGate``, and these rules keep it the
*only* shape that lints. The stream layer repeats it once more with
the window releaser in place of the wire: a closable window reaches
``releaser.release`` only after its one atomic per-window charge, and
an in-process release failure must refund
(``stream.service.StreamService._release_window_locked``). Two rules, scoped
to functions that *hold a ledger*
(reference ``ledger``/``self.ledger``) — the admission layer —
because below the admission boundary (the coalescer, the kernel cache,
a channel handed in by the gate) requests are charged by contract:

- ``budget-uncharged-noise`` — an admission-layer function launches
  work (``coalescer.submit`` / ``cache.run_batch`` / ``channel.send``)
  with no ``ledger.charge``/``charge_request`` earlier in the
  function: a query could execute — or a release cross the wire —
  without its spend on disk.
- ``budget-missing-refund`` — the launch is not wrapped in a ``try``
  whose handler reaches ``ledger.refund``: an enqueue refusal (or a
  transport failure) after a successful charge would consume ε for a
  query that was never answered.
- ``budget-shed-missing-refund`` — a function settles a future with a
  *refusal* exception (``...set_exception(ServerOverloadedError(...))``
  and friends) without any ``*refund*`` call in the same function.
  Post-admission sheds — deadline expiry, priority eviction,
  close-drain — happen *below* the ledger (the coalescer refunds via a
  helper handed the charges at submit), so this rule keys on the call
  *name* rather than a ledger receiver: every shed site must at least
  route through something named refund; this is the shape that keeps
  the next shed site honest.
- ``budget-multi-charge-missing-refund`` — a function charges two
  *distinct* budget receivers (``ledger`` and the per-user
  ``directory``, serve.budget_dir) and any charge after the first
  receiver's is not inside a ``try`` whose handler reaches a refund:
  a refusal from the second store would leave the first one charged —
  the exact partial-spend the CompositeLedger's compensation path
  exists to prevent. The directory is itself a budget receiver for
  every rule here: ``directory.charge`` dominates an enqueue the same
  way ``ledger.charge`` does.
"""

from __future__ import annotations

import ast
from typing import Iterator

from dpcorr_torch.analysis.core import (
    Checker,
    Module,
    Violation,
    attr_chain,
    walk_all,
    walk_same_scope,
)

#: method names that hand an admitted request to the execution layer —
#: in protocol/, a release to the transport; in stream/, a charged
#: window to the releaser.
ENQUEUE_FNS = frozenset({"submit", "run_batch", "send", "send_release",
                         "release"})
#: receivers those methods count on (any element of the access chain).
ENQUEUE_RECEIVERS = frozenset({"coalescer", "cache", "channel",
                               "transport", "releaser"})

CHARGE_FNS = frozenset({"charge", "charge_request"})
REFUND_FNS = frozenset({"refund"})
#: budget receivers: the per-party ledger and the per-user budget
#: directory (serve.budget_dir) are both charge/refund sinks.
LEDGER_NAMES = frozenset({"ledger", "directory"})

#: exception classes that refuse an ALREADY-ADMITTED (hence charged)
#: request — settling a future with one of these is a shed site.
REFUSAL_EXCS = frozenset({"ServerOverloadedError", "ServerClosedError",
                          "DeadlineExpiredError", "CircuitOpenError"})


def _is_ledger_call(call: ast.Call, fns: frozenset[str]) -> bool:
    chain = attr_chain(call.func)
    return (len(chain) >= 2 and chain[-1] in fns
            and any(part in LEDGER_NAMES for part in chain[:-1]))


def _is_enqueue_call(call: ast.Call) -> bool:
    chain = attr_chain(call.func)
    return (len(chain) >= 2 and chain[-1] in ENQUEUE_FNS
            and any(part in ENQUEUE_RECEIVERS for part in chain[:-1]))


class BudgetChecker(Checker):
    name = "budget"
    rules = {
        "budget-uncharged-noise": "execution launched without a "
                                  "dominating ledger.charge in the "
                                  "admission layer",
        "budget-missing-refund": "post-charge enqueue not guarded by a "
                                 "refund-on-failure handler",
        "budget-shed-missing-refund": "future settled with a refusal "
                                      "exception in a function with no "
                                      "refund call",
        "budget-multi-charge-missing-refund": "charges two budget "
                                              "receivers without a "
                                              "compensating refund "
                                              "handler on the later "
                                              "charge",
    }

    def applies_to(self, relpath: str) -> bool:
        parts = relpath.split("/")
        return ("serve" in parts or "protocol" in parts
                or "stream" in parts)

    def check(self, module: Module) -> Iterator[Violation]:
        for fn in walk_all(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield from self._check_shed_sites(module, fn)
            if not self._holds_ledger(fn):
                continue
            yield from self._check_fn(module, fn)

    def _check_shed_sites(self, module: Module, fn) -> Iterator[Violation]:
        """``budget-shed-missing-refund``: shed sites live below the
        admission layer (no ledger in scope), so the evidence of a
        refund is a call whose *name* contains ``refund`` — the
        coalescer's ``self._refund(...)`` helper, or ``ledger.refund``
        itself at admission sites."""
        sheds = [node for node in walk_same_scope(fn)
                 if isinstance(node, ast.Call)
                 and self._is_refusal_set_exception(node)]
        if not sheds:
            return
        if any(isinstance(node, ast.Call)
               and any("refund" in part
                       for part in attr_chain(node.func))
               for node in walk_same_scope(fn)):
            return
        for node in sheds:
            exc = attr_chain(node.args[0].func)[-1]
            yield Violation(
                "budget-shed-missing-refund", module.relpath, node.lineno,
                f"set_exception({exc}(...)) sheds an admitted request "
                f"but no refund call appears in this function — its "
                f"charge would be consumed for a query never answered")

    @staticmethod
    def _is_refusal_set_exception(call: ast.Call) -> bool:
        chain = attr_chain(call.func)
        if not chain or chain[-1] != "set_exception" or not call.args:
            return False
        arg = call.args[0]
        if not isinstance(arg, ast.Call):
            return False
        exc_chain = attr_chain(arg.func)
        return bool(exc_chain) and exc_chain[-1] in REFUSAL_EXCS

    @staticmethod
    def _holds_ledger(fn) -> bool:
        """Admission-layer test: the function itself references a
        ledger (``self.ledger`` / a local named ``ledger``)."""
        for node in walk_same_scope(fn):
            chain = ()
            if isinstance(node, ast.Attribute):
                chain = attr_chain(node)
            elif isinstance(node, ast.Name):
                chain = (node.id,)
            if any(part in LEDGER_NAMES for part in chain):
                return True
        return False

    @staticmethod
    def _charge_receiver(call: ast.Call) -> str:
        """Which budget receiver a charge call hits (``ledger`` /
        ``directory``) — the first chain part that names one."""
        for part in attr_chain(call.func):
            if part in LEDGER_NAMES:
                return part
        return "?"

    def _check_multi_charge(self, module: Module, fn,
                            charges: list[ast.Call]) -> Iterator[Violation]:
        """``budget-multi-charge-missing-refund``: once a function has
        charged one receiver, every charge against a *different*
        receiver is a partial-spend hazard — a refusal there must be
        able to compensate the first store, so the later charge has to
        sit in a ``try`` whose handler reaches a refund."""
        if len({self._charge_receiver(c) for c in charges}) < 2:
            return
        first = min(charges, key=lambda c: c.lineno)
        for call in charges:
            if self._charge_receiver(call) == \
                    self._charge_receiver(first):
                continue
            if not self._refund_guarded(fn, call):
                yield Violation(
                    "budget-multi-charge-missing-refund", module.relpath,
                    call.lineno,
                    f"{'.'.join(attr_chain(call.func))} charges a "
                    f"second budget receiver after "
                    f"{self._charge_receiver(first)} was charged — a "
                    f"refusal here would leave the first store spent; "
                    f"wrap it in a try whose handler refunds the "
                    f"applied legs")

    def _check_fn(self, module: Module, fn) -> Iterator[Violation]:
        charge_calls = []
        for node in walk_same_scope(fn):
            if isinstance(node, ast.Call) and _is_ledger_call(node,
                                                              CHARGE_FNS):
                charge_calls.append(node)
        yield from self._check_multi_charge(module, fn, charge_calls)
        charge_lines = [c.lineno for c in charge_calls]
        first_charge = min(charge_lines) if charge_lines else None
        for node in walk_same_scope(fn):
            if not (isinstance(node, ast.Call) and _is_enqueue_call(node)):
                continue
            if first_charge is None or node.lineno < first_charge:
                yield Violation(
                    "budget-uncharged-noise", module.relpath, node.lineno,
                    f"{'.'.join(attr_chain(node.func))} launches "
                    f"execution but no ledger.charge dominates it in "
                    f"this admission-layer function")
                continue
            if not self._refund_guarded(fn, node):
                yield Violation(
                    "budget-missing-refund", module.relpath, node.lineno,
                    f"{'.'.join(attr_chain(node.func))} can refuse "
                    f"after the ledger was charged — wrap it in a try "
                    f"whose handler calls ledger.refund")

    @staticmethod
    def _refund_guarded(fn, enqueue: ast.Call) -> bool:
        """True when some ``try`` lexically containing the enqueue has
        a handler that reaches ``ledger.refund``."""
        for node in walk_same_scope(fn):
            if not isinstance(node, ast.Try):
                continue
            in_body = any(sub is enqueue for stmt in node.body
                          for sub in ast.walk(stmt))
            if not in_body:
                continue
            for handler in node.handlers:
                for stmt in handler.body:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call) and \
                                _is_ledger_call(sub, REFUND_FNS):
                            return True
        return False
