"""Capture purity: no host side effects inside captured code.

Counterpart of ``dpcorr.analysis.rules.purity`` (the ``jit-*`` rule ids
are the JAX package's). Eager torch has no ``jit``; its traced contexts
are the places where Python runs **once** and what it did on the device
is replayed afterwards:

- the body of ``with torch.cuda.graph(g):`` (a CUDA graph capture: a
  replay reruns the kernels, never the Python);
- a function handed to ``torch.cuda.make_graphed_callables``,
  ``torch.compile``, ``torch.func.vmap`` (``torch.vmap``) or
  ``torch.jit.trace | script`` — as a call argument (following
  ``partial(...)`` and nested wrappers, resolving bare names to local
  ``def``s) or as a decorator.

A host effect inside one is frozen at capture just as one inside ``jit``
is frozen at trace: ``time.time()`` records the capture's clock,
``print`` fires once, a Python/NumPy ``random`` draw becomes one
constant (breaking reproducibility *and* the DP noise analysis), and
mutating closed-over Python state happens at capture, not per replay.
Two rules:

- ``jit-impure-call`` — a call with host side effects (wall clocks,
  ``print``, stdlib/NumPy RNG, ``os.urandom``/``secrets``, file I/O)
  lexically inside a captured context.
- ``jit-closure-mutation`` — ``global``/``nonlocal`` declarations, an
  in-place mutator call on a closed-over (free) name, or an attribute
  store rooted at one, inside a captured context. A subscript store is
  not counted: into a tensor (``static[:] = x``) it is a device write
  the capture records, which is the point of capturing.
"""

from __future__ import annotations

import ast
from typing import Iterator

from dpcorr_torch.analysis.core import (
    Checker,
    Module,
    Violation,
    attr_chain,
    call_chain,
    imported_names,
    walk_all,
    walk_same_scope,
)

#: transforms that capture or trace their function argument(s).
TRACER_ORIGINS = frozenset({
    "torch.cuda.make_graphed_callables", "torch.compile",
    "torch.func.vmap", "torch.vmap", "torch.jit.trace", "torch.jit.script",
})
#: context managers whose ``with`` body is captured.
CAPTURE_ORIGINS = frozenset({"torch.cuda.graph"})

#: dotted-origin prefixes whose calls are host side effects.
IMPURE_PREFIXES = (
    "time.", "random.", "numpy.random.", "os.urandom", "secrets.",
    "datetime.datetime.now", "datetime.date.today", "uuid.",
)
IMPURE_BUILTINS = frozenset({"print", "input", "open", "exec", "eval"})

#: in-place mutators for the closure-mutation rule.
MUTATOR_FNS = frozenset({
    "add", "append", "appendleft", "clear", "discard", "extend",
    "insert", "pop", "popitem", "remove", "reverse", "setdefault",
    "sort", "update", "write",
})

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


class PurityChecker(Checker):
    name = "purity"
    rules = {
        "jit-impure-call": "host side effect (clock/print/stdlib RNG/"
                           "I/O) inside captured code (CUDA graph, "
                           "torch.compile, vmap, torch.jit)",
        "jit-closure-mutation": "closed-over state mutated inside "
                                "captured code",
    }

    def check(self, module: Module) -> Iterator[Violation]:
        imports = imported_names(module.tree)
        defs = self._local_defs(module.tree)
        traced: list[ast.AST] = []
        seen: set[int] = set()

        def mark(node) -> None:
            if node is not None and id(node) not in seen:
                seen.add(id(node))
                traced.append(node)

        for node in walk_all(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for deco in node.decorator_list:
                    if self._is_tracer(deco, imports):
                        mark(node)
            if isinstance(node, ast.Call) and \
                    self._is_tracer(node, imports):
                for arg in self._fn_args(node):
                    mark(self._resolve(arg, defs))
            if isinstance(node, ast.With) and any(
                    self._is_capture(it.context_expr, imports)
                    for it in node.items):
                mark(node)
        # expand to nested scopes once, deduped — a lambda inside a
        # capture that is *also* handed to torch.compile is checked once
        scopes: dict[int, ast.AST] = {}
        for ctx in traced:
            scopes.setdefault(id(ctx), ctx)
            for node in ast.walk(ctx):
                if node is not ctx and isinstance(node, _FUNCS):
                    scopes.setdefault(id(node), node)
        for scope in scopes.values():
            yield from self._check_scope(module, scope, imports)

    # --------------------------------------------- traced-context set ----
    @staticmethod
    def _local_defs(tree) -> dict[str, ast.AST]:
        return {n.name: n for n in ast.walk(tree)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

    def _is_tracer(self, node, imports) -> bool:
        """Is this decorator/call expression a capturing transform?"""
        if isinstance(node, ast.Call):
            return self._is_tracer(node.func, imports) \
                or self._is_partial_of_tracer(node, imports)
        chain = attr_chain(node)
        return bool(chain) and self._origin(chain, imports) in \
            TRACER_ORIGINS

    def _is_capture(self, expr, imports) -> bool:
        if not isinstance(expr, ast.Call):
            return False
        chain = call_chain(expr)
        return bool(chain) and self._origin(chain, imports) in \
            CAPTURE_ORIGINS

    def _is_partial_of_tracer(self, call: ast.Call, imports) -> bool:
        chain = attr_chain(call.func)
        if not chain or chain[-1] != "partial":
            return False
        return bool(call.args) and self._is_tracer(call.args[0], imports)

    def _fn_args(self, call: ast.Call):
        """The candidate function-valued arguments of a tracing call;
        :meth:`_resolve` discards the non-function ones."""
        args = list(call.args)
        chain = attr_chain(call.func)
        if chain and chain[-1] == "partial":
            args = args[1:]  # partial(torch.compile, ...) — skip it
        yield from args

    def _resolve(self, arg, defs) -> ast.AST | None:
        if isinstance(arg, ast.Lambda):
            return arg
        if isinstance(arg, ast.Name):
            return defs.get(arg.id)
        if isinstance(arg, ast.Call):
            # nested wrapper: vmap(f) inside torch.compile(vmap(f))
            for inner in arg.args:
                r = self._resolve(inner, defs)
                if r is not None:
                    return r
        return None

    # ------------------------------------------------------- checking ----
    def _check_scope(self, module: Module, scope, imports,
                     ) -> Iterator[Violation]:
        """Check one captured scope against its own local-binding set
        (nested defs/lambdas were expanded into their own scopes). A
        ``with`` capture's locals are the names its body binds: the
        enclosing function's are closed over as far as the replay is
        concerned."""
        local = self._local_bindings(scope)
        roots = scope.body if isinstance(scope, ast.With) else [scope]
        for root in roots:
            for node in walk_same_scope(root):
                if node is scope:
                    continue
                yield from self._check_node(module, node, imports, local)

    def _check_node(self, module: Module, node, imports, local,
                    ) -> Iterator[Violation]:
        if isinstance(node, (ast.Global, ast.Nonlocal)):
            kw = "global" if isinstance(node, ast.Global) else "nonlocal"
            yield Violation(
                "jit-closure-mutation", module.relpath, node.lineno,
                f"`{kw} {', '.join(node.names)}` inside captured code — "
                f"the rebind happens at capture, not per replay")
            return
        if isinstance(node, ast.Call):
            chain = call_chain(node)
            if chain:
                origin = self._origin(chain, imports)
                impure = (
                    any(origin == p.rstrip(".") or origin.startswith(p)
                        for p in IMPURE_PREFIXES)
                    or (len(chain) == 1 and chain[0] in IMPURE_BUILTINS
                        and chain[0] not in local))
                if impure:
                    yield Violation(
                        "jit-impure-call", module.relpath, node.lineno,
                        f"{'.'.join(chain)}(...) has host side effects "
                        f"— it runs once at capture, not per replay")
                # mutating method on a free variable
                if len(chain) >= 2 and chain[-1] in MUTATOR_FNS \
                        and chain[0] not in local and chain[0] != "self":
                    yield Violation(
                        "jit-closure-mutation", module.relpath,
                        node.lineno,
                        f"{'.'.join(chain)}(...) mutates closed-over "
                        f"state inside captured code")
            return
        # attribute store rooted at a free variable
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if not isinstance(t, ast.Attribute):
                    continue
                root = t
                while isinstance(root, ast.Attribute):
                    root = root.value
                if isinstance(root, ast.Name) and root.id not in local \
                        and root.id != "self":
                    yield Violation(
                        "jit-closure-mutation", module.relpath,
                        node.lineno,
                        f"store into closed-over {root.id!r} inside "
                        f"captured code")

    @staticmethod
    def _local_bindings(scope) -> set[str]:
        """Names bound in this scope: a function's params plus every
        Store target (conservatively including comprehension vars); a
        ``with`` capture's ``as`` names and body bindings."""
        names: set[str] = set()
        if isinstance(scope, ast.With):
            roots = list(scope.body)
            for it in scope.items:
                if it.optional_vars is not None:
                    roots.append(it.optional_vars)
        else:
            args = scope.args
            for a in (args.posonlyargs + args.args + args.kwonlyargs
                      + ([args.vararg] if args.vararg else [])
                      + ([args.kwarg] if args.kwarg else [])):
                names.add(a.arg)
            roots = [scope]
        for root in roots:
            for node in walk_same_scope(root):
                if isinstance(node, ast.Name) and isinstance(node.ctx,
                                                             ast.Store):
                    names.add(node.id)
                elif isinstance(node, ast.ExceptHandler) and node.name:
                    names.add(node.name)
                elif isinstance(node, (ast.Import, ast.ImportFrom)):
                    for alias in node.names:
                        names.add(alias.asname
                                  or alias.name.split(".")[0])
        return names

    @staticmethod
    def _origin(chain: tuple[str, ...], imports: dict[str, str]) -> str:
        root = imports.get(chain[0], chain[0])
        return ".".join((root,) + chain[1:])
