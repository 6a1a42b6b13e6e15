"""RNG hygiene: the named-stream key-tree discipline (utils.rng).

Counterpart of ``dpcorr.analysis.rules.rng`` over the port's key-tree
(threefry2x32, bit-equal to the JAX package's). The
determinism *and* privacy contract is the key-tree ``master → design
point → replication → named substream``: every noise draw has a
collision-resistant address and no key is ever consumed twice
(Mironov-style attacks start exactly at reused or ad-hoc keys). Three
rules, with the JAX package's ids:

- ``rng-key-reuse`` — one key variable fed to two draw calls in the
  same function without an intervening ``split``/reassignment: the two
  draws are perfectly correlated, which voids the DP noise analysis
  (and silently biases even non-private statistics). The draws are the
  key-consuming samplers of ``dpcorr_torch.utils.rng`` (``normal``,
  ``uniform``, ``random_bits`` and the rest of ``jax.random``'s
  counterparts there) and ``dpcorr_torch.ops.noise.laplace``.
- ``rng-literal-seed`` — a literal integer seeding a key constructor
  (``rng.master_key``) or a torch generator (``manual_seed``) in
  library code: seeds must flow from configuration (``SimConfig.seed``,
  ``--seed``) so runs are reproducible *and* re-seedable; a buried
  constant is neither.
- ``rng-raw-api`` — outside ``utils/rng.py``, a direct ``rng.fold_in``
  / ``rng.fold_in_words`` or torch's own generator (``torch.manual_seed``,
  ``torch.Generator(...)``, the global ``torch.rand | randn | randint |
  randperm | normal``), the counterparts of ``jax.random.key`` /
  ``PRNGKey`` / ``fold_in``: key construction and stream addressing go
  through the named-stream API (``rng.master_key``/``stream``/
  ``design_key``/``chunk_key``/``rep_keys``/``kernel_seeds``) so stream
  addresses stay stable across code movement and auditable in one
  place, and no draw escapes the key-tree.
"""

from __future__ import annotations

import ast
from typing import Iterator

from dpcorr_torch.analysis.core import (
    Checker,
    Module,
    Violation,
    call_chain,
    imported_names,
    walk_all,
    walk_same_scope,
)

_RNG = "dpcorr_torch.utils.rng"

#: key-consuming draws (dotted origins): the key-tree's samplers and the
#: repo-local wrappers that consume their first argument like one.
DRAW_ORIGINS = frozenset({
    *(f"{_RNG}.{fn}" for fn in (
        "bernoulli", "choice", "exponential", "normal", "permutation",
        "randint", "random_bits", "uniform")),
    "dpcorr_torch.ops.noise.laplace",
})

#: raw key derivation and torch's own generator: dotted origin → the
#: named-stream API to use instead.
RAW_API = {
    f"{_RNG}.fold_in": "rng.design_key / rng.stream",
    f"{_RNG}.fold_in_words": "rng.design_key / rng.stream",
    **{f"torch.{fn}": "rng.master_key and a named stream"
       for fn in ("manual_seed", "Generator", "rand", "randn", "randint",
                  "randperm", "normal")},
}

#: seed constructors a literal seed must not reach (``manual_seed`` by
#: its tail: ``torch.manual_seed`` and a generator's method alike).
SEED_ORIGINS = frozenset({f"{_RNG}.master_key"})


def _is_rng_file(relpath: str) -> bool:
    return relpath.endswith("utils/rng.py")


class RngChecker(Checker):
    name = "rng"
    rules = {
        "rng-key-reuse": "a PRNG key fed to two draws without an "
                         "intervening split/reassignment",
        "rng-literal-seed": "literal integer seed reaching a key "
                            "constructor in library code",
        "rng-raw-api": "rng.fold_in/fold_in_words or torch's own "
                       "generator outside utils/rng.py (use the "
                       "named-stream API)",
    }

    def check(self, module: Module) -> Iterator[Violation]:
        imports = imported_names(module.tree)
        yield from self._raw_api(module)
        yield from self._literal_seeds(module)
        for fn in walk_all(module.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda)):
                yield from self._key_reuse(module, fn, imports)

    # ---------------------------------------------------- rng-raw-api ----
    def _raw_api(self, module: Module) -> Iterator[Violation]:
        if _is_rng_file(module.relpath):
            return
        imports = imported_names(module.tree)
        for node in walk_all(module.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = call_chain(node)
            if not chain:
                continue
            origin = self._origin(chain, imports)
            fix = RAW_API.get(origin)
            if fix is not None:
                yield Violation(
                    "rng-raw-api", module.relpath, node.lineno,
                    f"raw {origin} outside utils/rng.py — "
                    f"use the named-stream API ({fix})")

    # ----------------------------------------------- rng-literal-seed ----
    def _literal_seeds(self, module: Module) -> Iterator[Violation]:
        if _is_rng_file(module.relpath):
            return
        imports = imported_names(module.tree)
        for node in walk_all(module.tree):
            if not isinstance(node, ast.Call):
                continue
            # the attribute tail, so `torch.Generator(...).manual_seed(7)`
            # counts though its chain breaks at the inner call
            tail = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else getattr(node.func, "id", ""))
            chain = call_chain(node)
            if tail != "manual_seed" and not (
                    chain and self._origin(chain, imports) in SEED_ORIGINS):
                continue
            seed = node.args[0] if node.args else None
            for kw in node.keywords:
                if kw.arg in ("seed", "s"):
                    seed = kw.value
            if isinstance(seed, ast.Constant) and isinstance(seed.value,
                                                             int):
                yield Violation(
                    "rng-literal-seed", module.relpath, node.lineno,
                    f"literal seed {seed.value} passed to "
                    f"{tail} — thread the seed from configuration")

    # -------------------------------------------------- rng-key-reuse ----
    def _key_reuse(self, module: Module, fn, imports: dict[str, str],
                   ) -> Iterator[Violation]:
        """Structured linear scan over one function scope: a bare-name
        key consumed by a second draw without an intervening rebind is
        a violation. Branches of an ``if`` are scanned independently
        (exclusive paths may each draw once) and merged; loop bodies
        are scanned once (a key reused *across* iterations is invisible
        statically — the named-stream API is the defense there)."""
        body = fn.body if not isinstance(fn, ast.Lambda) else [fn.body]
        violations: list[Violation] = []
        self._scan(body if isinstance(body, list) else [body],
                   set(), imports, violations, module)
        yield from violations

    def _scan(self, stmts, consumed: set[str], imports, out, module):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue  # nested scopes are scanned on their own
            if isinstance(stmt, ast.If):
                self._scan_expr(stmt.test, consumed, imports, out, module)
                a, b = set(consumed), set(consumed)
                self._scan(stmt.body, a, imports, out, module)
                self._scan(stmt.orelse, b, imports, out, module)
                # a branch that leaves the function contributes nothing
                # to the fall-through state (early-return guard draws
                # must not poison the main path)
                if not self._terminates(stmt.body):
                    consumed |= a
                if not self._terminates(stmt.orelse):
                    consumed |= b
                continue
            if isinstance(stmt, (ast.For, ast.While, ast.AsyncFor)):
                test = stmt.iter if isinstance(
                    stmt, (ast.For, ast.AsyncFor)) else stmt.test
                self._scan_expr(test, consumed, imports, out, module)
                a = set(consumed)
                self._scan(stmt.body, a, imports, out, module)
                self._scan(stmt.orelse, a, imports, out, module)
                consumed |= a
                continue
            if isinstance(stmt, ast.Try):
                a = set(consumed)
                self._scan(stmt.body, a, imports, out, module)
                for h in stmt.handlers:
                    self._scan(h.body, set(a), imports, out, module)
                self._scan(stmt.orelse, a, imports, out, module)
                self._scan(stmt.finalbody, a, imports, out, module)
                consumed |= a
                continue
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                self._scan(stmt.body, consumed, imports, out, module)
                continue
            # expression statements / assignments: find draws in source
            # order, then apply rebinds
            self._scan_expr(stmt, consumed, imports, out, module)
            for target in self._bound_names(stmt):
                consumed.discard(target)

    def _scan_expr(self, node, consumed: set[str], imports, out, module):
        """Record draws in one expression/simple statement, without
        descending into nested function scopes."""
        if node is None:
            return
        for sub in walk_same_scope(node):
            if isinstance(sub, ast.Call):
                key = self._consumed_key(sub, imports)
                if key is not None:
                    if key in consumed:
                        out.append(Violation(
                            "rng-key-reuse", module.relpath, sub.lineno,
                            f"key {key!r} already consumed by an "
                            f"earlier draw in this function — split "
                            f"or derive a named stream first"))
                    else:
                        consumed.add(key)

    def _consumed_key(self, call: ast.Call, imports) -> str | None:
        """The bare variable name this call consumes as a PRNG key, or
        None when the call is not a draw / takes a derived key. Only
        draws resolved to the key-tree count: torch's and NumPy's global
        generators take no key (they are the raw-API rule's business),
        and a bare local helper named ``normal`` is not a key
        consumer."""
        chain = call_chain(call)
        if not chain:
            return None
        if self._origin(chain, imports) not in DRAW_ORIGINS \
                or not call.args:
            return None
        first = call.args[0]
        if isinstance(first, ast.Name):
            return first.id
        return None

    @staticmethod
    def _terminates(stmts) -> bool:
        """Does this block unconditionally leave the enclosing scope?"""
        return bool(stmts) and isinstance(
            stmts[-1], (ast.Return, ast.Raise, ast.Break, ast.Continue))

    @staticmethod
    def _bound_names(stmt: ast.AST):
        """Names (re)bound by this statement — a rebind resets the
        consumed state of that name."""
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) and isinstance(node.ctx,
                                                         ast.Store):
                yield node.id

    @staticmethod
    def _origin(chain: tuple[str, ...], imports: dict[str, str]) -> str:
        """Resolve a call chain to its dotted origin through the
        module's import bindings (``rng.fold_in`` with ``from
        dpcorr_torch.utils import rng`` →
        ``dpcorr_torch.utils.rng.fold_in``)."""
        root = imports.get(chain[0], chain[0])
        return ".".join((root,) + chain[1:])
