"""Hot-path sync discipline: no per-iteration host syncs in rep loops.

Counterpart of ``dpcorr.analysis.rules.sync`` in torch's idiom. The
replication hot path (sim → grid dispatch → parallel backend → plan
executor → the card's measurement scripts) is fast *because* dispatch
is asynchronous: blocks queue on the card while the host prepares the
next one, and the host blocks once, at the reduction boundary
(``sim.RepBlockPipeline.run``, ``plan.Executor.fetch``,
``dpcorr_transfer_fetches_total``). A ``.item()``, ``.cpu()`` or
``torch.cuda.synchronize()`` inside a loop body silently turns that
pipeline back into lock-step round-trips without any code *looking*
wrong. One rule:

- ``sync-in-loop`` — a host-synchronizing call lexically inside a
  ``for``/``while`` body or a comprehension, in a hot-path module
  (``sim.py``, ``grid.py``, ``parallel/``, ``plan/``, the
  ``perf_*.py`` measurement modules and ``chip_smoke.py``'s kernel
  table, the port's counterparts of ``bench.py`` and ``benchmarks/``).
  The host syncs are torch's counterparts of ``block_until_ready``,
  ``np.asarray`` and ``jax.device_get``: the tensor methods ``.item()``,
  ``.tolist()``, ``.cpu()`` and ``.numpy()``; any ``.synchronize()``
  (``torch.cuda.synchronize``, an event's, a stream's); and
  ``numpy.asarray``/``numpy.array``, which copy a tensor to the host.

Intentional boundaries — a completion barrier at the end of a fetch
phase, a drain loop that *measures* sync latency, host arrays folded
on the host — carry an explicit ``# dpcorr-lint: ignore[sync-in-loop]``
so every deliberate sync site is greppable and reviewed.
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
)

#: call-chain tails that force a host sync regardless of origin (the
#: tensor methods, and ``torch.cuda.synchronize`` / ``event.synchronize``)
SYNC_TAILS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})

#: dotted origins that copy device values to host (and therefore block)
SYNC_ORIGINS = frozenset({
    "numpy.asarray",
    "numpy.array",
})

_LOOPS = (ast.For, ast.AsyncFor, ast.While)
_COMPS = (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)


class SyncChecker(Checker):
    name = "sync"
    rules = {
        "sync-in-loop": "host sync (.item/.tolist/.cpu/.numpy/"
                        "synchronize/np.asarray) inside a rep-loop body "
                        "— fetch once at the reduction boundary",
    }

    def applies_to(self, relpath: str) -> bool:
        # the replication hot path only: these are the modules where a
        # per-iteration sync is a throughput bug rather than a style
        # choice (analysis code, tests and the serving layer fetch
        # values because they *need* them on host). The plan layer is
        # in scope as the shared dispatch/fetch boundary (Executor.fetch
        # is the one sanctioned sync — and it is not in a loop).
        parts = relpath.split("/")
        return (parts[-1] in ("sim.py", "grid.py", "chip_smoke.py")
                or parts[-1].startswith("perf_")
                or "parallel" in parts or "plan" in parts)

    def check(self, module: Module) -> Iterator[Violation]:
        imports = imported_names(module.tree)
        seen: set[tuple[int, int]] = set()
        for node in walk_all(module.tree):
            if isinstance(node, _LOOPS):
                roots = node.body
            elif isinstance(node, ast.DictComp):
                roots = [node.key, node.value]
            elif isinstance(node, _COMPS):
                roots = [node.elt]
            else:
                continue
            for root in roots:
                yield from self._scan(module, root, imports, seen)

    def _scan(self, module: Module, root, imports, seen,
              ) -> Iterator[Violation]:
        """Yield sync calls under ``root``, skipping nested function
        scopes (a closure defined in a loop runs when *called*, and its
        own call sites are scanned wherever they sit) and deduplicating
        across nested loops."""
        stack = [root]
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(node))
            if not isinstance(node, ast.Call):
                continue
            chain = self._chain(node)
            if not chain:
                continue
            origin = ".".join((imports.get(chain[0], chain[0]),)
                              + chain[1:])
            if chain[-1] not in SYNC_TAILS and origin not in SYNC_ORIGINS:
                continue
            key = (node.lineno, node.col_offset)
            if key in seen:
                continue
            seen.add(key)
            yield Violation(
                "sync-in-loop", module.relpath, node.lineno,
                f"{'.'.join(chain)}(...) forces a host sync inside a "
                f"loop body — dispatch stays async until the reduction "
                f"boundary (one fetch per run, obs.transfer)")

    @staticmethod
    def _chain(call: ast.Call) -> tuple[str, ...]:
        """The call chain, or for a method on an expression that is not
        a plain name (``x.sum().item()``, ``t[i].cpu()``) just the
        method name: the tensor methods sync whatever their receiver."""
        chain = call_chain(call)
        if not chain and isinstance(call.func, ast.Attribute) and \
                call.func.attr in SYNC_TAILS:
            return (call.func.attr,)
        return chain
