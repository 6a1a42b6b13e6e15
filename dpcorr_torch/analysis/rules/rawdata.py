"""No raw columns on the wire: taint from column names to serializers.

The protocol layer's core privacy claim (``protocol/__init__``) is that only
DP *releases* ever reach a serializer — the raw x/y columns stay inside
their party process. The runtime proof is the transcript scan
(protocol.scan); this rule is the static half: inside ``protocol/``,
flag any ``encode_array``/``canonical_encode`` call whose payload
argument is *tainted* by a raw-column name.

Taint seeds are names that, by repo convention, hold raw sample data
(``x``, ``y``, ``col``, ``column``, ``raw_x`` …, and any attribute
ending in one of those, e.g. ``self.column``). Taint propagates
through plain aliasing — assignment, subscripts/slices of a tainted
value, and value-preserving passthroughs (``np.asarray``, ``astype``,
``sign``, ``clip``, ``reshape`` …: a sign or clip image of a column is
still that column's data). It deliberately does **not** propagate
through arithmetic (``BinOp``) or reductions: adding calibrated noise
or aggregating to batch means is exactly what turns a column into a
release, and flagging those would make every legitimate release a
finding.

One rule:

- ``raw-column-serialize`` — a wire serializer receives data reachable
  from a raw column by aliasing alone: that payload would put sample
  values on the socket verbatim.
"""

from __future__ import annotations

import ast
from typing import Iterator

from dpcorr_torch.analysis.core import Checker, Module, Violation, \
    attr_chain, walk_all

#: names that hold raw sample data by repo convention.
RAW_NAMES = frozenset({
    "x", "y", "xs", "ys", "col", "column", "raw", "raw_x", "raw_y",
    "x_raw", "y_raw", "x_col", "y_col",
})

#: callables that return their input's values (possibly re-typed or
#: re-shaped) — aliasing, not anonymization.
PASSTHROUGH_FNS = frozenset({
    "asarray", "array", "ascontiguousarray", "astype", "clip",
    "clip_sym", "copy", "ravel", "reshape", "sign", "tolist", "float32",
})

#: the wire boundary: anything handed to these may leave the process.
SERIALIZE_FNS = frozenset({"encode_array", "canonical_encode"})


def _is_raw_name(node: ast.AST, tainted: set[str]) -> bool:
    chain = attr_chain(node)
    if not chain:
        return False
    if chain[-1] in RAW_NAMES:
        return True
    return len(chain) == 1 and chain[0] in tainted


class RawDataChecker(Checker):
    name = "rawdata"
    rules = {
        "raw-column-serialize": "a wire serializer receives data "
                                "aliased from a raw column (no noise "
                                "between the sample and the socket)",
    }

    def applies_to(self, relpath: str) -> bool:
        return "protocol" in relpath.split("/")

    def check(self, module: Module) -> Iterator[Violation]:
        for fn in walk_all(module.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_fn(module, fn)

    def _check_fn(self, module: Module, fn) -> Iterator[Violation]:
        # one forward pass in source order: straight-line taint is all
        # the rule needs (protocol code builds payloads linearly), and
        # order-sensitivity keeps `col = noise(col)` rebindings honest.
        tainted: set[str] = set()
        sites = sorted(
            (node for node in ast.walk(fn)
             if isinstance(node, (ast.Assign, ast.Call))),
            key=lambda n: (n.lineno, n.col_offset))
        for node in sites:
            if isinstance(node, ast.Assign):
                if self._tainted_expr(node.value, tainted):
                    for tgt in node.targets:
                        for name in ast.walk(tgt):
                            if isinstance(name, ast.Name):
                                tainted.add(name.id)
                else:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            tainted.discard(tgt.id)
                continue
            chain = attr_chain(node.func)
            if chain and chain[-1] in SERIALIZE_FNS and node.args:
                if self._tainted_expr(node.args[0], tainted):
                    yield Violation(
                        "raw-column-serialize", module.relpath,
                        node.lineno,
                        f"{'.'.join(chain)} receives a value aliased "
                        f"from a raw column — only DP releases may be "
                        f"serialized for the wire")

    def _tainted_expr(self, node: ast.AST, tainted: set[str]) -> bool:
        if isinstance(node, (ast.Name, ast.Attribute)):
            return _is_raw_name(node, tainted)
        if isinstance(node, ast.Subscript):
            return self._tainted_expr(node.value, tainted)
        if isinstance(node, ast.Starred):
            return self._tainted_expr(node.value, tainted)
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if not chain:
                return False
            if chain[-1] in PASSTHROUGH_FNS:
                # np.sign(col) / col.astype(...): receiver or any
                # argument carries the taint through
                if len(chain) > 1 and _is_raw_name(
                        node.func.value, tainted):
                    return True
                return any(self._tainted_expr(a, tainted)
                           for a in node.args)
            return False
        # BinOp / reductions / comprehensions: anonymizing by intent
        return False
