"""Telemetry discipline: metric naming and span lifecycle.

The obs layer (``dpcorr_torch.obs``) works because every producer
speaks one dialect: series are ``dpcorr_``-prefixed snake_case (so a
dashboard can subscribe to ``dpcorr_*`` and get everything, and two
subsystems can't collide with an unprefixed ``requests_total``), and
every span that is opened is closed on all paths (a leaked span never
emits, so the request it covered simply vanishes from the trace — the
exact blind spot the flight recorder exists to remove). Two rules:

- ``metric-name-style`` — a Counter/Gauge/Histogram constructed outside
  ``dpcorr_torch/obs/`` (direct constructor or ``registry.counter/gauge/
  histogram``) whose string-literal name is not ``dpcorr_`` + snake_case.
- ``span-no-finally`` — a ``tracer.start_span(...)`` whose span is not
  provably closed on all paths: the result must be bound to a name and
  that name's ``.end()`` must appear inside a ``finally`` block in the
  same scope (the ``with tracer.span(...)`` form is always fine and
  preferred).

Sites with a genuinely cross-scope lifecycle (a request root span ended
by the flush thread, a protocol session span ended in the session's own
finally) carry a suppression with its reason — reviewed once, greppable
forever.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from dpcorr_torch.analysis.core import (
    Checker,
    Module,
    Violation,
    call_chain,
    imported_names,
    walk_all,
)

#: what a series published through the shared registry must look like
METRIC_NAME_RE = re.compile(r"^dpcorr_[a-z0-9_]*$")

#: registry factory methods (Registry.counter/gauge/histogram)
FACTORY_TAILS = frozenset({"counter", "gauge", "histogram"})

#: direct-constructor origins (from dpcorr_torch.obs.metrics import Counter)
CONSTRUCTOR_ORIGINS = frozenset({
    "dpcorr_torch.obs.metrics.Counter",
    "dpcorr_torch.obs.metrics.Gauge",
    "dpcorr_torch.obs.metrics.Histogram",
    "dpcorr_torch.obs.Counter",
    "dpcorr_torch.obs.Gauge",
    "dpcorr_torch.obs.Histogram",
})

_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


class MetricsChecker(Checker):
    name = "metrics"
    rules = {
        "metric-name-style": "metric name must be dpcorr_-prefixed "
                             "snake_case (the JAX package's series names "
                             "— one namespace for every producer)",
        "span-no-finally": "start_span(...) without a .end() in a "
                           "finally in the same scope — a leaked span "
                           "never emits; use `with tracer.span(...)` "
                           "or close in a finally",
    }

    def applies_to(self, relpath: str) -> bool:
        # everywhere EXCEPT the obs package itself: obs/ defines the
        # instruments (and its own tests exercise bad names on purpose
        # via fixtures, which live under tests/ and are out of scope)
        return "dpcorr_torch/obs/" not in relpath

    def check(self, module: Module) -> Iterator[Violation]:
        imports = imported_names(module.tree)
        yield from self._check_names(module, imports)
        yield from self._check_spans(module, imports)

    # -- metric-name-style ----------------------------------------------
    def _check_names(self, module: Module, imports,
                     ) -> Iterator[Violation]:
        for node in walk_all(module.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = call_chain(node)
            if not chain:
                continue
            origin = ".".join((imports.get(chain[0], chain[0]),)
                              + chain[1:])
            is_factory = (len(chain) >= 2 and chain[-1] in FACTORY_TAILS)
            is_ctor = origin in CONSTRUCTOR_ORIGINS
            if not (is_factory or is_ctor):
                continue
            if not node.args:
                continue
            first = node.args[0]
            if not (isinstance(first, ast.Constant)
                    and isinstance(first.value, str)):
                continue  # dynamic names are the registry's problem
            name = first.value
            if is_factory and not is_ctor and not name.startswith("dpcorr"):
                # an unrelated object's .counter("x") — only treat the
                # factory form as a metric when the name already claims
                # the namespace OR the receiver is registry-shaped
                if not any(tok in chain[0].lower()
                           for tok in ("registry", "reg", "metrics")):
                    continue
            if not METRIC_NAME_RE.fullmatch(name):
                yield Violation(
                    "metric-name-style", module.relpath, node.lineno,
                    f"metric name {name!r} must match "
                    f"^dpcorr_[a-z0-9_]*$ — the shared /metrics "
                    f"namespace is dpcorr_-prefixed snake_case")

    # -- span-no-finally ------------------------------------------------
    def _check_spans(self, module: Module, imports,
                     ) -> Iterator[Violation]:
        scopes = [module.tree] + [n for n in walk_all(module.tree)
                                  if isinstance(n, _SCOPES)]
        for scope in scopes:
            yield from self._scan_scope(module, scope)

    def _scan_scope(self, module: Module, scope) -> Iterator[Violation]:
        opens: list[tuple[ast.Call, str | None]] = []
        closed_in_finally: set[str] = set()
        for node in _walk_scope(scope):
            if isinstance(node, ast.Try) and node.finalbody:
                for fin in node.finalbody:
                    for sub in ast.walk(fin):
                        if (isinstance(sub, ast.Call)
                                and isinstance(sub.func, ast.Attribute)
                                and sub.func.attr == "end"
                                and isinstance(sub.func.value, ast.Name)):
                            closed_in_finally.add(sub.func.value.id)
            if not isinstance(node, ast.Call):
                continue
            # match the attribute tail directly: `tracer().start_span`
            # and `self.tracer.start_span` both count (call_chain breaks
            # on the intermediate call in the former)
            if not (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "start_span"):
                continue
            opens.append((node, _bound_name(node, scope)))
        for call, target in opens:
            if target is not None and target in closed_in_finally:
                continue
            yield Violation(
                "span-no-finally", module.relpath, call.lineno,
                "span opened with start_span() is not closed in a "
                "finally in this scope — on an exception path it "
                "leaks (never emitted); prefer `with tracer.span(...)`")


def _walk_scope(scope) -> Iterator[ast.AST]:
    """Walk ``scope`` without descending into nested function scopes
    (a closure has its own lifecycle and is scanned as its own scope)."""
    roots = (scope.body if isinstance(scope, (ast.Module, *_SCOPES))
             and not isinstance(scope, ast.Lambda) else [scope])
    if isinstance(scope, ast.Lambda):
        roots = [scope.body]
    stack = list(roots)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, _SCOPES):
            continue  # a nested def/lambda is its own scope
        stack.extend(ast.iter_child_nodes(node))


def _bound_name(call: ast.Call, scope) -> str | None:
    """The simple name ``x`` when the call is the value of ``x = ...``
    in this scope, else None (attribute targets, list comprehensions
    and bare expressions cannot be tracked and stay flagged)."""
    for node in _walk_scope(scope):
        if (isinstance(node, ast.Assign) and node.value is call
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            return node.targets[0].id
    return None
