"""Linter core: parsed modules, checker registry, suppressions, baseline.

``python -m dpcorr_torch lint`` is a plugin-based static pass over the
port's own source enforcing the invariants its runtime layers can only
uphold by convention. The counterpart of ``dpcorr.analysis.core``: the
rule ids and the suppression marker are the JAX package's letter for
letter, so one vocabulary reads in both trees; the scopes name this
package and the torch-idiom families read torch.

- **RNG hygiene** (analysis.rules.rng) — the named-stream key-tree
  discipline of ``dpcorr_torch.utils.rng``.
- **Budget discipline** (analysis.rules.budget) — charge-before-noise
  and refund-on-refusal in the serving layer.
- **Lock discipline** (analysis.rules.locks) — ``# guarded by: _lock``
  attribute declarations checked against every access site.
- **Capture purity** (analysis.rules.purity) — no host side effects or
  closure mutation inside captured (CUDA graph, ``torch.compile``,
  ``torch.func.vmap``, ``torch.jit``) code.

Everything here is stdlib-only (``ast``): the lint imports no torch, so
it runs where torch is not installed and pays no torch import.

Two escape hatches, both explicit and reviewable:

- a line comment ``# dpcorr-lint: ignore[rule-a,rule-b]`` (or a bare
  ``ignore`` for any rule) suppresses findings on that line, or — as a
  standalone comment — on the line below it;
- a committed baseline file (``.dpcorr_torch-lint-baseline.json``)
  grandfathers triaged findings so the gate fails only on *new*
  violations. Entries match on (rule, path, source text), not line
  numbers, so unrelated edits don't invalidate them; regenerate with
  ``--write-baseline``. The port's baseline holds no entry.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Iterable, Iterator, Sequence

#: marker for "every rule suppressed on this line"
ALL_RULES = "*"

_SUPPRESS_RE = re.compile(
    r"#\s*dpcorr-lint:\s*ignore(?:\[([A-Za-z0-9_,\- ]+)\])?")

_BASELINE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Violation:
    """One finding: a rule broken at a specific line of a file."""

    rule: str
    path: str  # repo-relative, posix separators
    line: int
    message: str
    code: str = ""  # the stripped source line (baseline match key)
    #: interprocedural findings carry the file:line hop chain that
    #: reaches the offending site (``--deep``; empty for local rules).
    chain: tuple = ()

    def render(self) -> str:
        out = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        for hop in self.chain:
            out += f"\n      via {hop}"
        return out


class Module:
    """One parsed source file as handed to every checker: the AST (with
    parent links), the raw lines, and the per-line suppression table."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        # parent links let rules see an access site's enclosing context
        # (e.g. "is this Attribute the receiver of a mutating call");
        # single-stack traversal: one iter_child_nodes pass per node
        stack: list[ast.AST] = [self.tree]
        while stack:
            node = stack.pop()
            for child in ast.iter_child_nodes(node):
                child._dpcorr_parent = node  # type: ignore[attr-defined]
                stack.append(child)
        self.suppressions = _suppression_table(self.lines)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def suppressed(self, rule: str, lineno: int) -> bool:
        for ln in (lineno, lineno - 1):
            rules = self.suppressions.get(ln)
            if rules is None:
                continue
            if ALL_RULES in rules or rule in rules:
                # a standalone comment suppresses the line below it; an
                # inline comment suppresses its own line only
                if ln == lineno or self.line_text(ln).startswith("#"):
                    return True
        return False


def _suppression_table(lines: Sequence[str]) -> dict[int, set[str]]:
    table: dict[int, set[str]] = {}
    for i, line in enumerate(lines, 1):
        if "dpcorr-lint" not in line:  # fast path: regex only on hits
            continue
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        names = m.group(1)
        if names is None:
            table[i] = {ALL_RULES}
        else:
            table[i] = {n.strip() for n in names.split(",") if n.strip()}
    return table


class Checker:
    """One checker family (a plugin). Subclasses declare their rules
    and implement :meth:`check`; :meth:`applies_to` scopes the family
    to the part of the tree where its invariant lives (path-segment
    based, so the test fixtures mirror the layout instead of needing a
    parallel configuration language)."""

    #: family name (``--rules`` selector)
    name: str = ""
    #: rule id → one-line description (``--list-rules``)
    rules: dict[str, str] = {}

    def applies_to(self, relpath: str) -> bool:
        return True

    def check(self, module: Module) -> Iterator[Violation]:
        raise NotImplementedError


class ProjectChecker(Checker):
    """A ``--deep`` checker: sees the whole parsed project at once (the
    interprocedural model from :mod:`dpcorr_torch.analysis.callgraph`) instead
    of one module at a time. ``applies_to`` still scopes which findings
    survive (by the *finding's* path), so fixtures compose the same way
    as for per-module rules."""

    def check(self, module: Module) -> Iterator[Violation]:
        return iter(())

    def check_project(self, model) -> Iterator[Violation]:
        raise NotImplementedError


# -------------------------------------------------------- AST helpers ----
def attr_chain(node: ast.AST) -> tuple[str, ...]:
    """``self.coalescer.submit`` → ``("self", "coalescer", "submit")``;
    empty tuple when the expression is not a plain name/attribute path
    (calls, subscripts and literals all break the chain)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def call_chain(call: ast.Call) -> tuple[str, ...]:
    """The called name as a chain (``torch.cuda.synchronize`` →
    ``("torch", "cuda", "synchronize")``)."""
    return attr_chain(call.func)


def imported_names(tree: ast.Module) -> dict[str, str]:
    """Name → dotted origin for every import binding in the module
    (``import numpy as np`` → ``{"np": "numpy"}``; ``from
    dpcorr_torch.utils import rng`` → ``{"rng":
    "dpcorr_torch.utils.rng"}``). Rules use this to tell stdlib
    ``random`` from the port's key-tree and to spot re-exported draw
    wrappers. Cached on the tree: several rule families ask for the
    same module's imports."""
    cached = getattr(tree, "_dpcorr_imports", None)
    if cached is not None:
        return cached
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out[alias.asname or alias.name.split(".")[0]] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
    tree._dpcorr_imports = out  # type: ignore[attr-defined]
    return out


def parent(node: ast.AST) -> ast.AST | None:
    return getattr(node, "_dpcorr_parent", None)


def walk_all(tree: ast.AST) -> Iterator[ast.AST]:
    """``ast.walk``, memoized on the root node. Nearly every rule
    family sweeps the full module tree at least once; Module keeps the
    trees alive, so the first sweep pays for all of them."""
    cached = getattr(tree, "_dpcorr_all", None)
    if cached is None:
        cached = list(ast.walk(tree))
        try:
            tree._dpcorr_all = cached  # type: ignore[attr-defined]
        except AttributeError:
            pass
    return iter(cached)


def walk_same_scope(node: ast.AST) -> Iterator[ast.AST]:
    """Like ``ast.walk`` but does not descend into nested function
    scopes (defs/lambdas) — the unit most rules reason over. The root
    node itself is yielded (and descended into) even when it is a
    function. Memoized on the root node: every rule family walks the
    same function scopes, and the trees outlive the walk (Module holds
    them), so one traversal serves all checkers."""
    cached = getattr(node, "_dpcorr_scope", None)
    if cached is None:
        cached = [node]
        stack = [node]
        while stack:
            for child in ast.iter_child_nodes(stack.pop()):
                cached.append(child)
                if not isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.Lambda)):
                    stack.append(child)
        try:
            node._dpcorr_scope = cached  # type: ignore[attr-defined]
        except AttributeError:
            pass
    return iter(cached)


# ------------------------------------------------------------ running ----
def iter_py_files(paths: Iterable[str], root: str) -> Iterator[str]:
    """Yield root-relative paths of every ``.py`` under ``paths``
    (files or directories), skipping caches and hidden directories."""
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(full):
            yield os.path.relpath(full, root)
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = sorted(d for d in dirnames
                                 if not d.startswith(".")
                                 and d != "__pycache__")
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    yield os.path.relpath(os.path.join(dirpath, fn), root)


def default_checkers(deep: bool = False) -> list[Checker]:
    """The shipped checker families (imported lazily so ``core`` has no
    import cycle with the rule modules). ``deep`` adds the
    interprocedural families (``--deep``)."""
    from dpcorr_torch.analysis.rules import ALL_CHECKERS, DEEP_CHECKERS

    out = [cls() for cls in ALL_CHECKERS]
    if deep:
        out.extend(cls() for cls in DEEP_CHECKERS)
    return out


def run_lint(paths: Sequence[str], root: str,
             checkers: Sequence[Checker] | None = None,
             rule_filter: Sequence[str] | None = None,
             deep: bool = False) -> list[Violation]:
    """Lint every ``.py`` under ``paths`` (relative to ``root``) and
    return suppression-filtered violations in (path, line) order.
    ``rule_filter`` restricts to the named checker families. ``deep``
    additionally builds the interprocedural model over every parsed
    module and runs the :class:`ProjectChecker` families on it."""
    if checkers is None:
        checkers = default_checkers(deep=deep)
    if rule_filter:
        wanted = set(rule_filter)
        unknown = wanted - {c.name for c in checkers}
        if unknown:
            raise ValueError(f"unknown checker families: {sorted(unknown)}")
        checkers = [c for c in checkers if c.name in wanted]
    violations: list[Violation] = []
    modules: list[Module] = []
    for relpath in iter_py_files(paths, root):
        full = os.path.join(root, relpath)
        with open(full, encoding="utf-8") as f:
            source = f.read()
        try:
            module = Module(full, relpath, source)
        except SyntaxError as e:
            violations.append(Violation(
                "syntax-error", relpath.replace(os.sep, "/"),
                e.lineno or 1, f"cannot parse: {e.msg}"))
            continue
        modules.append(module)
        for checker in checkers:
            if isinstance(checker, ProjectChecker):
                continue
            if not checker.applies_to(module.relpath):
                continue
            for v in checker.check(module):
                if not module.suppressed(v.rule, v.line):
                    violations.append(dataclasses.replace(
                        v, code=module.line_text(v.line)))
    if deep:
        from dpcorr_torch.analysis.callgraph import ProjectModel

        model = ProjectModel(modules, root)
        by_relpath = {m.relpath: m for m in modules}
        for checker in checkers:
            if not isinstance(checker, ProjectChecker):
                continue
            for v in checker.check_project(model):
                if not checker.applies_to(v.path):
                    continue
                mod = by_relpath.get(v.path)
                if mod is not None and mod.suppressed(v.rule, v.line):
                    continue
                code = mod.line_text(v.line) if mod is not None else ""
                violations.append(dataclasses.replace(v, code=code))
    violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return violations


# ----------------------------------------------------------- baseline ----
def load_baseline(path: str) -> list[dict]:
    with open(path, encoding="utf-8") as f:
        state = json.load(f)
    if state.get("version") != _BASELINE_VERSION:
        raise ValueError(f"baseline {path!r} has version "
                         f"{state.get('version')!r}, "
                         f"expected {_BASELINE_VERSION}")
    return list(state["entries"])


def write_baseline(violations: Sequence[Violation], path: str) -> None:
    """Persist the current findings as the grandfathered set. Sorted
    and line-stamped for reviewability; matching ignores the line."""
    entries = [{"rule": v.rule, "path": v.path, "line": v.line,
                "code": v.code, "message": v.message}
               for v in violations]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": _BASELINE_VERSION, "entries": entries},
                  f, indent=1, sort_keys=True)
        f.write("\n")


def apply_baseline(violations: Sequence[Violation],
                   entries: Iterable[dict],
                   ) -> tuple[list[Violation], int, list[dict]]:
    """Split findings into (new, matched-count, stale-entries).

    An entry absorbs at most one finding with the same (rule, path,
    source text) — multiplicity is preserved, line numbers are not
    compared (pure moves must not resurrect triaged findings). Stale
    entries (nothing matched them — the violation was fixed) are
    reported so the baseline can be re-tightened with
    ``--write-baseline``; they never fail the gate.
    """
    budget: dict[tuple[str, str, str], int] = {}
    for e in entries:
        budget[(e["rule"], e["path"], e["code"])] = \
            budget.get((e["rule"], e["path"], e["code"]), 0) + 1
    new: list[Violation] = []
    matched = 0
    for v in violations:
        key = (v.rule, v.path, v.code)
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            matched += 1
        else:
            new.append(v)
    stale = [{"rule": r, "path": p, "code": c, "count": n}
             for (r, p, c), n in sorted(budget.items()) if n > 0]
    return new, matched, stale
