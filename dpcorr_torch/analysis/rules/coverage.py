"""Chaos-point coverage cross-check (``--deep``).

``chaos.KNOWN_POINTS`` is the append-only registry of crash windows
the recovery story claims to survive. A point only earns its keep when
(a) some *live* code path actually calls ``chaos.point("...")`` for it
— a point whose instrumentation site became unreachable after a
refactor tests nothing — and (b) something actually *sweeps* it: the
``python -m dpcorr_torch chaos`` step-kill matrix (``MATRIX_POINTS``) or a named
reference in a benchmark/test/CI sweep. Two rules, both anchored at
the point's registry line in chaos.py so the finding reads like a
registry audit:

- ``chaos-unreachable-point`` — no ``chaos.point("x")`` call site
  exists, or none is reachable (through the call graph, including
  ``Thread(target=...)`` references) from any public entrypoint.
- ``chaos-unswept-point`` — the point is reachable but absent from
  ``MATRIX_POINTS`` and never referenced by name under ``tests/``,
  ``benchmarks/`` or ``.github/`` — no job will ever kill there, so
  the crash window can rot silently.

The registry is located structurally (a module-level ``KNOWN_POINTS``
tuple of string literals), so fixtures can carry their own miniature
registry.
"""

from __future__ import annotations

import ast
import os
from typing import Iterator

from dpcorr_torch.analysis.callgraph import ProjectModel
from dpcorr_torch.analysis.core import Module, ProjectChecker, Violation, \
    attr_chain, walk_same_scope

#: directories under --root whose text constitutes "swept by a job".
_SWEEP_DIRS = ("tests", "benchmarks", ".github")
_SWEEP_EXTS = (".py", ".yml", ".yaml", ".sh", ".toml", ".cfg")


def _registry(module: Module) -> tuple[dict[str, int], set[str]] | None:
    """(point → registry lineno, matrix set) when the module carries a
    ``KNOWN_POINTS`` tuple of string literals."""
    known: dict[str, int] = {}
    matrix: set[str] = set()
    for node in module.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name = node.targets[0].id
        if name == "KNOWN_POINTS" and isinstance(node.value,
                                                 (ast.Tuple, ast.List)):
            for el in node.value.elts:
                if isinstance(el, ast.Constant) and \
                        isinstance(el.value, str):
                    known[el.value] = el.lineno
        elif name == "MATRIX_POINTS" and isinstance(node.value,
                                                    (ast.Tuple,
                                                     ast.List)):
            try:
                matrix = set(ast.literal_eval(node.value))
            except (ValueError, SyntaxError):
                matrix = set()
    return (known, matrix) if known else None


class ChaosCoverageChecker(ProjectChecker):
    name = "coverage"
    rules = {
        "chaos-unreachable-point": "registered chaos point with no "
                                   "point() call site reachable from "
                                   "a public entrypoint",
        "chaos-unswept-point": "reachable chaos point absent from "
                               "MATRIX_POINTS and from every "
                               "benchmark/test/CI sweep",
    }

    def check_project(self, model: ProjectModel) -> Iterator[Violation]:
        registries = [(m, reg) for m in model.modules
                      if (reg := _registry(m)) is not None]
        if not registries:
            return
        # every chaos.point("x") call site, with its enclosing function
        sites: dict[str, list[tuple[str, int]]] = {}
        for key, fi in model.functions.items():
            for node in walk_same_scope(fi.node):
                if not (isinstance(node, ast.Call) and node.args):
                    continue
                chain = attr_chain(node.func)
                if not chain or chain[-1] != "point":
                    continue
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, str):
                    sites.setdefault(arg.value, []).append(
                        (key, node.lineno))
        # public surface: non-underscore functions, plus dunders of
        # public classes (constructed/invoked from outside the model —
        # tests build the server, the runtime calls __enter__ etc.)
        entrypoints = []
        for key, fi in model.functions.items():
            if not fi.name.startswith("_"):
                entrypoints.append(key)
            elif fi.name.startswith("__") and fi.name.endswith("__"):
                cls = fi.qualname.rpartition(".")[0]
                if not cls.startswith("_"):
                    entrypoints.append(key)
        live = model.reachable(entrypoints)
        corpus = self._sweep_corpus(model.root)
        for module, (known, matrix) in registries:
            for point, lineno in known.items():
                point_sites = sites.get(point, [])
                reachable = [s for s in point_sites if s[0] in live]
                if not reachable:
                    where = ", ".join(
                        f"{model.functions[k].relpath}:{ln}"
                        for k, ln in point_sites) or "nowhere"
                    yield Violation(
                        "chaos-unreachable-point", module.relpath,
                        lineno,
                        f"chaos point {point!r} is registered but no "
                        f"chaos.point() site for it is reachable from "
                        f"a public entrypoint (instrumented at: "
                        f"{where}) — the crash window it names is "
                        f"untested dead code",
                        chain=tuple(f"{model.functions[k].relpath}:{ln}"
                                    f" ({model.functions[k].qualname})"
                                    for k, ln in point_sites))
                    continue
                if point in matrix or point in corpus:
                    continue
                yield Violation(
                    "chaos-unswept-point", module.relpath, lineno,
                    f"chaos point {point!r} is live (e.g. "
                    f"{model.functions[reachable[0][0]].relpath}:"
                    f"{reachable[0][1]}) but is not in MATRIX_POINTS "
                    f"and no test/benchmark/CI sweep names it — no "
                    f"job ever kills there, so its recovery path can "
                    f"rot silently",
                    chain=tuple(f"{model.functions[k].relpath}:{ln}"
                                f" ({model.functions[k].qualname})"
                                for k, ln in reachable))

    @staticmethod
    def _sweep_corpus(root: str) -> str:
        """Concatenated text of every sweep-capable file under the
        root's tests/, benchmarks/ and .github/ trees."""
        parts: list[str] = []
        for d in _SWEEP_DIRS:
            base = os.path.join(root, d)
            for dirpath, dirnames, filenames in os.walk(base):
                dirnames[:] = [n for n in dirnames
                               if not n.startswith(".")
                               and n != "__pycache__"]
                for fn in filenames:
                    if fn.endswith(_SWEEP_EXTS):
                        try:
                            with open(os.path.join(dirpath, fn),
                                      encoding="utf-8",
                                      errors="replace") as f:
                                parts.append(f.read())
                        except OSError:
                            continue
        return "\n".join(parts)
