"""Durability discipline for the WAL/journal/snapshot namespaces
(``--deep``).

The crash-exactness story of the serving and stream layers rests on two write
idioms, both already canonical in the tree:

- **append + flush + fsync** before acknowledging (stream/wal.py
  ``_append_line``, serve/budget_dir.py ``_wal_append_locked``);
- **tmp + fsync + os.replace** for snapshots (obs ``_atomic_write``,
  serve/ledger.py ``_persist_locked``, protocol/journal.py
  ``_persist``), with a stale-``.tmp`` sweep on startup and a
  ``.corrupt`` quarantine on the load path
  (obs/budget_replay.py ``sweep_stale_tmp``/``quarantine_corrupt``).

This rule family makes the idioms checkable so the next durable
artifact cannot be added with a bare ``open(..., "w")``. A module is in
the durable namespace when its filename names one of the durable
artifact kinds (``wal``/``journal``/``ledger``/``budget``/``snapshot``/
``checkpoint`` — path-based, like every other scope in this linter).
Within such a module:

- ``durability-bare-write`` — a write-mode ``open`` whose function
  cannot reach the required discipline through the call graph: an
  append with no ``fsync`` reachable, a ``.tmp`` write missing
  ``fsync`` or ``os.replace``, or a direct ``"w"`` on the durable path
  (the torn-file shape ``os.replace`` exists to prevent).
- ``durability-unsynced-ack`` — an appending function returns a value
  (the ack: a seq, an offset) on a path where no ``fsync`` happened
  after the append — the caller proceeds believing the record is
  durable while it still sits in the page cache.
- ``durability-missing-sweep`` — the module replaces into its
  namespace but no function in it reaches a stale-``.tmp`` sweep: a
  crash between tmp-write and replace leaves orphans forever.
- ``durability-missing-quarantine`` — the module replaces into its
  namespace but has no ``.corrupt`` quarantine on its load path: a
  torn artifact would be re-parsed (and crash-loop) instead of being
  set aside for forensics.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from dpcorr_torch.analysis.callgraph import FunctionInfo, ProjectModel
from dpcorr_torch.analysis.core import ProjectChecker, Violation, \
    attr_chain, walk_same_scope

#: filename pattern that places a module in the durable namespace.
_DURABLE_RE = re.compile(
    r"(wal|journal|ledger|budget|snapshot|checkpoint)", re.IGNORECASE)


def _is_durable_module(relpath: str) -> bool:
    parts = relpath.split("/")
    if "analysis" in parts:        # the linter's own rule modules
        return False
    return bool(_DURABLE_RE.search(parts[-1]))


def _open_mode(call: ast.Call) -> str | None:
    """The mode string of an ``open``-like call, or None when it can't
    be determined statically."""
    chain = attr_chain(call.func)
    args = list(call.args)
    mode_node = None
    if chain == ("open",):
        if len(args) >= 2:
            mode_node = args[1]
    elif args:
        mode_node = args[0]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode_node = kw.value
    if mode_node is None:
        return "r" if chain == ("open",) and len(args) < 2 else None
    if isinstance(mode_node, ast.Constant) and \
            isinstance(mode_node.value, str):
        return mode_node.value
    return None


def _target_text(call: ast.Call) -> str:
    chain = attr_chain(call.func)
    if chain == ("open",) and call.args:
        try:
            return ast.unparse(call.args[0])
        except Exception:
            return ""
    return ".".join(chain[:-1])


class DurabilityChecker(ProjectChecker):
    name = "durability"
    rules = {
        "durability-bare-write": "write into a durable namespace "
                                 "without the append+fsync or "
                                 "tmp+fsync+os.replace idiom",
        "durability-unsynced-ack": "append function returns (acks) "
                                   "before any fsync of the record",
        "durability-missing-sweep": "os.replace namespace with no "
                                    "stale-.tmp sweep reachable",
        "durability-missing-quarantine": "os.replace namespace with no "
                                         ".corrupt quarantine on the "
                                         "load path",
    }

    def check_project(self, model: ProjectModel) -> Iterator[Violation]:
        for module in model.modules:
            if _is_durable_module(module.relpath):
                yield from self._check_module(model, module.relpath)

    # -------------------------------------------------- one module ----
    def _check_module(self, model: ProjectModel,
                      relpath: str) -> Iterator[Violation]:
        fns = [fi for fi in model.functions.values()
               if fi.relpath == relpath]
        replace_lines: list[int] = []
        has_sweep = has_quarantine = False
        for fi in fns:
            effects = model.transitive_effects(fi.key)
            if "sweep" in effects:
                has_sweep = True
            if "quarantine" in effects:
                has_quarantine = True
            for eff in fi.effects:
                if eff.kind == "replace":
                    replace_lines.append(eff.lineno)
            yield from self._check_fn(model, fi)
        if not replace_lines:
            return
        module = model.by_relpath[relpath]
        anchor = min(replace_lines)
        if not has_sweep:
            yield Violation(
                "durability-missing-sweep", relpath, anchor,
                "this module os.replace()s durable artifacts but never "
                "reaches a stale-.tmp sweep (obs.budget_replay."
                "sweep_stale_tmp) — a crash between tmp-write and "
                "replace leaves orphan .tmp files forever")
        if not has_quarantine and ".corrupt" not in module.source:
            yield Violation(
                "durability-missing-quarantine", relpath, anchor,
                "this module os.replace()s durable artifacts but has "
                "no .corrupt quarantine on its load path (obs."
                "budget_replay.quarantine_corrupt) — a torn artifact "
                "would crash-loop instead of being set aside")

    # ------------------------------------------------ one function ----
    def _check_fn(self, model: ProjectModel,
                  fi: FunctionInfo) -> Iterator[Violation]:
        opens: list[tuple[ast.Call, str, str]] = []
        for node in walk_same_scope(fi.node):
            if isinstance(node, ast.Call):
                chain = attr_chain(node.func)
                if chain and chain[-1] == "open":
                    mode = _open_mode(node)
                    if mode and any(c in mode for c in "wax+"):
                        opens.append((node, mode, _target_text(node)))
        if not opens:
            return
        effects = model.transitive_effects(fi.key)
        fsync_chain = effects.get("fsync")
        replace_chain = effects.get("replace")
        for call, mode, target in opens:
            if "a" in mode:
                if fsync_chain is None:
                    yield Violation(
                        "durability-bare-write", fi.relpath, call.lineno,
                        f"appends to durable path {target or '<path>'} "
                        f"but no fsync is reachable from "
                        f"{fi.qualname} — the record can be lost from "
                        f"the page cache on crash",
                        chain=(fi.site(call.lineno),))
                else:
                    yield from self._check_ack(model, fi, call)
            elif "tmp" in target.lower():
                # covers both literal ".tmp" suffixes and the repo's
                # convention of a `tmp = path + ".tmp"` local — the
                # unparsed target is then just the variable name
                missing = [k for k, c in (("fsync", fsync_chain),
                                          ("os.replace", replace_chain))
                           if c is None]
                if missing:
                    yield Violation(
                        "durability-bare-write", fi.relpath, call.lineno,
                        f"tmp-writes {target} but "
                        f"{' and '.join(missing)} "
                        f"{'is' if len(missing) == 1 else 'are'} not "
                        f"reachable from {fi.qualname} — the "
                        f"tmp+fsync+os.replace idiom is incomplete",
                        chain=(fi.site(call.lineno),))
            else:
                yield Violation(
                    "durability-bare-write", fi.relpath, call.lineno,
                    f"bare open({target or '<path>'}, {mode!r}) in a "
                    f"durable namespace — write a .tmp sibling, fsync, "
                    f"then os.replace (a crash mid-write here tears "
                    f"the artifact in place)",
                    chain=(fi.site(call.lineno),))

    def _check_ack(self, model: ProjectModel, fi: FunctionInfo,
                   open_call: ast.Call) -> Iterator[Violation]:
        """fsync-before-ack: every value-return after the append must
        have an fsync-reaching line between the open and the return."""
        fsync_lines = sorted(
            {eff.lineno for eff in fi.effects if eff.kind == "fsync"} |
            {cs.lineno for cs in fi.calls if cs.target is not None
             and "fsync" in model.transitive_effects(cs.target)})
        for node in walk_same_scope(fi.node):
            if not (isinstance(node, ast.Return)
                    and node.value is not None):
                continue
            if isinstance(node.value, ast.Constant) and \
                    node.value.value is None:
                continue
            if node.lineno <= open_call.lineno:
                continue
            if not any(open_call.lineno <= f <= node.lineno
                       for f in fsync_lines):
                yield Violation(
                    "durability-unsynced-ack", fi.relpath, node.lineno,
                    f"{fi.qualname} acks (returns a value) after "
                    f"appending at line {open_call.lineno} with no "
                    f"fsync in between — the caller proceeds on a "
                    f"record still in the page cache",
                    chain=(fi.site(node.lineno),))
