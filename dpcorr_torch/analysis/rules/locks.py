"""Lock discipline: ``# guarded by: <lock>`` declarations, enforced.

The threaded layers (serve coalescer/ledger/stats/kernel cache, obs
tracer/registry/audit trail) already follow a convention: shared
mutable state is documented as guarded by an instance lock and touched
only under ``with self.<lock>``. This rule makes the convention
checkable. Declare at the attribute's construction site::

    self._spent: dict[str, float] = {}  # guarded by: _lock

and every other access of ``self._spent`` inside the class must sit
lexically inside ``with self.<lock>:`` (a ``threading.Condition``
wrapping the lock counts — ``with self._cond`` acquires it). Two
rules, split so reads can be triaged separately from writes:

- ``lock-unguarded-write`` — assignment, ``del``, subscript store, or
  a mutating method call (``append``/``pop``/``update``/...) outside
  the guard: a torn write other threads can observe.
- ``lock-unguarded-read`` — a plain read outside the guard: may see a
  torn/stale value (Python's GIL makes many such reads *atomic* but
  not *coherent* with multi-step updates).

Exemptions, matching the repo's conventions: ``__init__`` (no
concurrency before construction completes) and methods named
``*_locked`` (documented caller-holds-the-lock helpers — the call
sites are checked instead, because the calls appear under the guard).
Nested functions defined under a guard are scanned as *unguarded*:
closures outlive the ``with`` block that created them.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from dpcorr_torch.analysis.core import Checker, Module, Violation, parent, \
    walk_all

_DECL_RE = re.compile(r"#\s*guarded by:\s*(\w+)")

#: method names that mutate their receiver in place.
MUTATOR_FNS = frozenset({
    "add", "append", "appendleft", "clear", "discard", "extend",
    "insert", "move_to_end", "pop", "popitem", "popleft", "remove",
    "reverse", "rotate", "setdefault", "sort", "update",
    "write", "writelines", "close", "flush", "truncate",
})


class LockChecker(Checker):
    name = "locks"
    rules = {
        "lock-unguarded-write": "declared-guarded attribute mutated "
                                "outside `with self.<lock>`",
        "lock-unguarded-read": "declared-guarded attribute read "
                               "outside `with self.<lock>`",
    }

    def applies_to(self, relpath: str) -> bool:
        # every package under dpcorr_torch/ (the stream service, chaos
        # plans and the compile cache share state across threads as
        # the serve/obs/protocol layers do); the bare segment names keep
        # the test fixtures, which mirror the layout without the leading
        # dpcorr_torch/, in scope
        parts = relpath.split("/")
        return ("dpcorr_torch" in parts or "serve" in parts or "obs" in parts
                or "protocol" in parts or "stream" in parts
                or relpath.endswith("utils/compile.py"))

    def check(self, module: Module) -> Iterator[Violation]:
        classes = {cls.name: cls for cls in walk_all(module.tree)
                   if isinstance(cls, ast.ClassDef)}
        for cls in classes.values():
            yield from self._check_class(module, cls, classes)
        yield from self._check_module(module)

    # ------------------------------------------------- declarations ----
    def _declared(self, module: Module, cls: ast.ClassDef,
                  ) -> dict[str, str]:
        """attr → guard name, from ``self.X = ...  # guarded by: G``
        lines anywhere in the class body."""
        declared: dict[str, str] = {}
        for node in ast.walk(cls):
            targets: list[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = [node.target]
            for t in targets:
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                m = _DECL_RE.search(module.line_text(node.lineno))
                if m:
                    declared[t.attr] = m.group(1)
        return declared

    # ------------------------------------------------------ checking ----
    def _check_class(self, module: Module, cls: ast.ClassDef,
                     classes: dict[str, ast.ClassDef],
                     ) -> Iterator[Violation]:
        # declarations are inherited: a subclass in the same module is
        # held to the guards its (lexically visible) bases declared
        declared: dict[str, str] = {}
        for c in self._mro_local(cls, classes):
            declared.update(self._declared(module, c))
        if not declared:
            return
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if item.name in ("__init__", "__post_init__") \
                    or item.name.endswith("_locked"):
                continue
            yield from self._scan(module, declared, item.body,
                                  held=frozenset())

    def _scan(self, module: Module, declared: dict[str, str],
              stmts, held: frozenset[str]) -> Iterator[Violation]:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # closures escape the current guard (see module doc)
                yield from self._scan(module, declared, stmt.body,
                                      held=frozenset())
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                now = set(held)
                for it in stmt.items:
                    attr = self._self_attr(it.context_expr)
                    if attr:
                        now.add(attr)
                yield from self._scan(module, declared, stmt.body,
                                      frozenset(now))
                continue
            for field, value in ast.iter_fields(stmt):
                blocks = {"body", "orelse", "finalbody"}
                if field in blocks and isinstance(value, list):
                    yield from self._scan(module, declared, value, held)
                elif field == "handlers":
                    for h in value:
                        yield from self._scan(module, declared, h.body,
                                              held)
                else:
                    yield from self._scan_expr(module, declared,
                                               value, held)

    def _scan_expr(self, module: Module, declared, value,
                   held: frozenset[str]) -> Iterator[Violation]:
        nodes = value if isinstance(value, list) else [value]
        for node in nodes:
            if not isinstance(node, ast.AST):
                continue
            for sub in ast.walk(node):
                if not (isinstance(sub, ast.Attribute)
                        and isinstance(sub.value, ast.Name)
                        and sub.value.id == "self"
                        and sub.attr in declared):
                    continue
                guard = declared[sub.attr]
                if guard in held:
                    continue
                kind = self._access_kind(sub)
                yield Violation(
                    f"lock-unguarded-{kind}", module.relpath, sub.lineno,
                    f"self.{sub.attr} is declared `# guarded by: "
                    f"{guard}` but this {kind} is outside "
                    f"`with self.{guard}`")

    # --------------------------------------- module-level globals ----
    def _check_module(self, module: Module) -> Iterator[Violation]:
        """Module globals declared ``NAME = ...  # guarded by: _LOCK``
        (the chaos plan registry is the motivating case) are held to
        ``with <lock>:`` inside every module-level function. Import
        time is single-threaded, so top-level statements are exempt —
        like ``__init__`` for instance attributes."""
        declared: dict[str, str] = {}
        for node in module.tree.body:
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = [node.target]
            else:
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    m = _DECL_RE.search(module.line_text(node.lineno))
                    if m:
                        declared[t.id] = m.group(1)
        if not declared:
            return
        for item in module.tree.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and not item.name.endswith("_locked"):
                yield from self._scan_globals(module, declared,
                                              item.body, frozenset())

    def _scan_globals(self, module: Module, declared: dict[str, str],
                      stmts, held: frozenset[str],
                      ) -> Iterator[Violation]:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._scan_globals(module, declared,
                                              stmt.body, frozenset())
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                now = set(held)
                for it in stmt.items:
                    if isinstance(it.context_expr, ast.Name):
                        now.add(it.context_expr.id)
                yield from self._scan_globals(module, declared,
                                              stmt.body, frozenset(now))
                continue
            for field, value in ast.iter_fields(stmt):
                blocks = {"body", "orelse", "finalbody"}
                if field in blocks and isinstance(value, list):
                    yield from self._scan_globals(module, declared,
                                                  value, held)
                elif field == "handlers":
                    for h in value:
                        yield from self._scan_globals(module, declared,
                                                      h.body, held)
                else:
                    yield from self._scan_global_expr(module, declared,
                                                      value, held)

    def _scan_global_expr(self, module: Module, declared, value,
                          held: frozenset[str]) -> Iterator[Violation]:
        nodes = value if isinstance(value, list) else [value]
        for node in nodes:
            if not isinstance(node, ast.AST):
                continue
            for sub in ast.walk(node):
                if not (isinstance(sub, ast.Name)
                        and sub.id in declared):
                    continue
                guard = declared[sub.id]
                if guard in held:
                    continue
                kind = self._name_access_kind(sub)
                yield Violation(
                    f"lock-unguarded-{kind}", module.relpath, sub.lineno,
                    f"module global {sub.id} is declared `# guarded "
                    f"by: {guard}` but this {kind} is outside "
                    f"`with {guard}`")

    @staticmethod
    def _name_access_kind(name_node: ast.Name) -> str:
        if isinstance(name_node.ctx, (ast.Store, ast.Del)):
            return "write"
        up = parent(name_node)
        if isinstance(up, ast.Subscript) \
                and isinstance(up.ctx, (ast.Store, ast.Del)):
            return "write"
        if isinstance(up, ast.AugAssign) and up.target is name_node:
            return "write"
        if isinstance(up, ast.Attribute) and up.attr in MUTATOR_FNS:
            call = parent(up)
            if isinstance(call, ast.Call) and call.func is up:
                return "write"
        return "read"

    @staticmethod
    def _mro_local(cls: ast.ClassDef,
                   classes: dict[str, ast.ClassDef]) -> list[ast.ClassDef]:
        """The class plus its same-module ancestors, bases first."""
        out, queue = [], [cls]
        while queue:
            c = queue.pop(0)
            if c in out:
                continue
            out.append(c)
            for base in c.bases:
                if isinstance(base, ast.Name) and base.id in classes:
                    queue.append(classes[base.id])
        return list(reversed(out))

    @staticmethod
    def _self_attr(expr) -> str | None:
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self":
            return expr.attr
        return None

    @staticmethod
    def _access_kind(attr_node: ast.Attribute) -> str:
        """'write' for stores/deletes/subscript-stores/mutator calls,
        'read' otherwise."""
        if isinstance(attr_node.ctx, (ast.Store, ast.Del)):
            return "write"
        up = parent(attr_node)
        # self.X[...] = / del self.X[...]
        if isinstance(up, ast.Subscript) \
                and isinstance(up.ctx, (ast.Store, ast.Del)):
            return "write"
        # self.X += ...
        if isinstance(up, ast.AugAssign) and up.target is attr_node:
            return "write"
        # self.X.append(...) and friends
        if isinstance(up, ast.Attribute) and up.attr in MUTATOR_FNS:
            call = parent(up)
            if isinstance(call, ast.Call) and call.func is up:
                return "write"
        return "read"
