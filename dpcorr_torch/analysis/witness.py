"""``dpcorr_torch lint --witness DIR`` — diff runtime lock order vs static.

:mod:`dpcorr_torch.utils.syncwatch` records the acquisition-order graph a
live process actually walked and dumps one ``torch-witness-<pid>.json``
per process (a name the JAX package's ``witness-*.json`` gate does not
match, so both packages may share one witness directory and each gate
reads only its own artifacts). This module replays those artifacts against the static lock
model (:meth:`ProjectModel.lock_model`) and gates on three conditions:

- **observed-but-unpredicted edge** — the process acquired lock B
  while holding lock A, but the static call-graph analysis never
  predicted that ordering. Either the model has a blind spot (fix the
  model) or the code grew a lock nesting nobody reviewed (fix the
  code). Both deserve a red build. An edge whose endpoint cannot be
  matched to any statically known lock site counts as unpredicted —
  an unknown lock is the model's biggest possible blind spot.
- **runtime inversion** — syncwatch saw A→B and B→A live in one run.
  That is a deadlock that happened not to interleave.
- **observed cycle** — the union of observed edges across all witness
  files contains a directed cycle, even if no single run inverted.

Witness sites are ``relpath:lineno`` of the lock *creation* frame;
the static model records the same site for the enclosing assignment.
Multi-line constructor calls can put those a line or two apart, so
matching tolerates a small same-file line delta.

Stdlib and the analysis package only: the gate imports no torch, so it
runs beside the processes it judges without a card.
"""

from __future__ import annotations

import glob
import json
import os
import sys

from dpcorr_torch.analysis.core import Module, iter_py_files
from dpcorr_torch.utils.syncwatch import ARTIFACT_PREFIX

#: a runtime creation site within this many lines of a static lock
#: site (same file) is the same lock.
_LINE_SLACK = 2


def _build_lock_model(paths, root: str) -> dict:
    from dpcorr_torch.analysis.callgraph import ProjectModel

    modules = []
    for relpath in iter_py_files(paths, root):
        full = os.path.join(root, relpath)
        with open(full, encoding="utf-8") as f:
            source = f.read()
        try:
            modules.append(Module(full, relpath, source))
        except SyntaxError:
            continue
    return ProjectModel(modules, root).lock_model()


def _site_index(lock_model: dict) -> dict:
    """``relpath -> [(lineno, lock_id)]`` over every static lock site."""
    index: dict = {}
    for lid, info in lock_model["locks"].items():
        for site in info["sites"]:
            path, _, line = site.rpartition(":")
            index.setdefault(path, []).append((int(line), lid))
    for rows in index.values():
        rows.sort()
    return index


def _resolve_site(site: str, index: dict) -> str | None:
    """Static lock id for a runtime creation site, or None."""
    path, _, line_s = site.rpartition(":")
    rows = index.get(path)
    if not rows:
        return None
    line = int(line_s)
    best = None
    for lineno, lid in rows:
        delta = abs(lineno - line)
        if delta <= _LINE_SLACK and (best is None or delta < best[0]):
            best = (delta, lid)
    return best[1] if best else None


def _find_cycle(edges: set) -> list | None:
    """One directed cycle in ``edges`` (as a node list), or None."""
    adj: dict = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    visiting: dict = {}  # node -> position on the current DFS path
    done: set = set()

    def dfs(node, path):
        visiting[node] = len(path)
        path.append(node)
        for nxt in adj.get(node, ()):
            if nxt in visiting:
                return path[visiting[nxt]:] + [nxt]
            if nxt not in done:
                found = dfs(nxt, path)
                if found:
                    return found
        path.pop()
        del visiting[node]
        done.add(node)
        return None

    for start in sorted(adj):
        if start not in done:
            found = dfs(start, [])
            if found:
                return found
    return None


def run_witness_check(paths, root: str, witness_dir: str,
                      as_json: bool = False) -> int:
    """Gate described in the module docstring. Returns the process
    exit code: 0 clean, 1 witness contradicts the model, 2 usage
    (missing directory / no artifacts — a smoke that produced no
    witness is a broken smoke, not a clean one)."""
    if not os.path.isdir(witness_dir):
        print(f"dpcorr_torch lint: witness dir not found: {witness_dir}",
              file=sys.stderr)
        return 2
    files = sorted(glob.glob(os.path.join(witness_dir,
                                          f"{ARTIFACT_PREFIX}*.json")))
    if not files:
        print(f"dpcorr_torch lint: no {ARTIFACT_PREFIX}*.json artifacts in "
              f"{witness_dir} (was DPCORR_SYNCWATCH=1 exported?)",
              file=sys.stderr)
        return 2

    lock_model = _build_lock_model(paths, root)
    index = _site_index(lock_model)
    static_edges = {tuple(e) for e in lock_model["edges"]}

    observed: dict = {}      # (a_id, b_id) -> first witness file
    unpredicted: list = []
    unknown_sites: set = set()
    inversions: list = []
    for path in files:
        with open(path, encoding="utf-8") as fh:
            art = json.load(fh)
        for inv in art.get("inversions", []):
            inversions.append({**inv, "witness": os.path.basename(path)})
        for a_site, b_site in art.get("edges", []):
            a = _resolve_site(a_site, index)
            b = _resolve_site(b_site, index)
            for site, lid in ((a_site, a), (b_site, b)):
                if lid is None:
                    unknown_sites.add(site)
            a = a or f"?{a_site}"
            b = b or f"?{b_site}"
            if a == b:
                continue  # two sites of one lock: reentrancy, not order
            if (a, b) not in observed:
                observed[(a, b)] = os.path.basename(path)
                if (a, b) not in static_edges:
                    unpredicted.append(
                        {"edge": [a, b],
                         "sites": [a_site, b_site],
                         "witness": os.path.basename(path)})
    cycle = _find_cycle(set(observed))

    ok = not unpredicted and not inversions and cycle is None
    report = {
        "witness_files": [os.path.basename(p) for p in files],
        "observed_edges": sorted([a, b] for (a, b) in observed),
        "static_edges": sorted(map(list, static_edges)),
        "unpredicted_edges": unpredicted,
        "unknown_sites": sorted(unknown_sites),
        "inversions": inversions,
        "observed_cycle": cycle,
        "ok": ok,
    }
    if as_json:
        print(json.dumps(report, indent=2))
    else:
        print(f"witness: {len(files)} artifact(s), "
              f"{len(observed)} observed edge(s), "
              f"{len(static_edges)} statically predicted")
        for u in unpredicted:
            a, b = u["edge"]
            print(f"observed-but-unpredicted lock order: {a} -> {b}")
            print(f"    creation sites {u['sites'][0]} -> "
                  f"{u['sites'][1]} ({u['witness']})")
        for inv in inversions:
            print(f"runtime lock-order inversion: {inv['held']} -> "
                  f"{inv['acquiring']} on thread {inv['thread']} "
                  f"({inv['witness']})")
        if cycle:
            print("observed lock-order cycle: " + " -> ".join(cycle))
        print("witness: " + ("clean — runtime order within the static "
                             "model" if ok else "FAILED"))
    return 0 if ok else 1
