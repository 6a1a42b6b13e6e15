"""Interprocedural model: repo-wide call graph + lock-acquisition facts.

The per-module checkers (rules/) reason about one function at a time;
the ``--deep`` pass (``python -m dpcorr_torch lint --deep``) reasons
about the *composition*: which locks can be held when a call chain
reaches an ``fsync``, whether two threads can acquire the same pair of
locks in opposite orders, whether a charge in one function dominates an
enqueue three calls away. This module builds the shared substrate, all
stdlib ``ast`` (the linter imports no torch):

- **Lock identities.** Every ``threading.Lock()``/``RLock()`` created
  in the linted tree becomes a lock id named after its home
  (``dpcorr_torch.serve.ledger.PrivacyLedger._lock``,
  ``dpcorr_torch.chaos._lock``), carrying its creation site(s) so the
  runtime witness (utils/syncwatch.py) can map an observed lock back
  to the static model. ``threading.Condition(self._lock)`` aliases the
  wrapped lock — ``with self._cond`` acquires ``_lock``.
- **Call graph.** Calls resolve through lightweight type facts:
  ``self.x = Cls(...)`` and annotated parameters/attributes type the
  receiver; plain names resolve through imports and module scope;
  a name-unique method is matched as a last resort (never for generic
  names like ``append``). Unresolved calls stay unresolved — the
  analysis under-approximates rather than guesses.
- **Held-lock tracking.** Each function is scanned once, tracking the
  lexically-held lock set through ``with`` blocks (closures and
  lambdas escape the guard, as in rules/locks.py), recording every
  call site, lock acquisition and *effect* (fsync/subprocess/socket/
  ``.result()``/``join()``/``os.replace``/sweep/quarantine) together
  with the locks held at that point.
- **Closures.** :meth:`ProjectModel.transitive_acquires` and
  :meth:`~ProjectModel.transitive_effects` propagate those facts
  through the call graph (depth-capped, memoized), producing the
  file:line chains the findings report. The static lock-order graph
  (:meth:`~ProjectModel.lock_order_edges`) is every (held → acquired)
  pair, lexical or call-mediated; :meth:`~ProjectModel.lock_cycles`
  reports its cycles.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, Sequence

from dpcorr_torch.analysis.core import Module, attr_chain, imported_names

#: interprocedural chains are followed (and reported) this deep at most.
MAX_DEPTH = 6

#: effect kinds that block the calling thread (the ``blocking-under-lock``
#: rule keys on these; ``replace``/``sweep``/``quarantine`` are tracked
#: for the durability rule and are not blocking).
BLOCKING_KINDS = frozenset({
    "fsync", "subprocess", "socket", "result", "join", "sleep", "wait",
})

#: method names too generic for the unique-name fallback resolver — a
#: stray ``lst.append`` must never link to ``IngestWAL.append``.
_GENERIC_METHOD_NAMES = frozenset({
    "acquire", "add", "append", "apply", "charge", "clear", "close",
    "copy", "dump", "dumps", "flush", "get", "items", "join", "keys",
    "add_done_callback", "cancel", "done", "load", "loads", "main",
    "merge", "open", "point", "pop", "put", "read", "record", "recv",
    "refund", "release", "render", "reset", "result", "run", "send",
    "set_exception", "set_result", "start", "stop", "submit",
    "update", "values", "wait", "write",
})

_SOCKET_METHODS = frozenset({
    "accept", "connect", "create_connection", "makefile", "recv",
    "recvfrom", "recv_into", "sendall",
})
_SUBPROCESS_FNS = frozenset({
    "Popen", "call", "check_call", "check_output", "run",
})


@dataclasses.dataclass
class CallSite:
    """One call expression inside a function body."""
    lineno: int
    text: str                     # dotted call text ("self.wal.append")
    target: str | None            # resolved FuncKey, or None
    held: tuple[str, ...]         # lock ids lexically held at the call


@dataclasses.dataclass
class Acquire:
    """One ``with <lock>`` acquisition site."""
    lock_id: str
    lineno: int
    held: tuple[str, ...]         # lock ids already held when acquiring


@dataclasses.dataclass
class Effect:
    """One direct side effect (fsync, subprocess, os.replace, ...)."""
    kind: str
    lineno: int
    text: str
    held: tuple[str, ...]


@dataclasses.dataclass
class LockInfo:
    lock_id: str
    kind: str                     # "lock" | "rlock" | "condition"
    sites: list[str]              # "relpath:lineno" creation sites


class ClassInfo:
    def __init__(self, key: str, relpath: str, name: str,
                 node: ast.ClassDef):
        self.key = key
        self.relpath = relpath
        self.name = name
        self.node = node
        self.methods: dict[str, str] = {}      # method name -> FuncKey
        self.attr_types: dict[str, str] = {}   # attr -> ClassKey/pseudo
        self.lock_attrs: dict[str, str] = {}   # attr -> lock id
        self.base_names: list[str] = [
            b.id for b in node.bases if isinstance(b, ast.Name)]


class FunctionInfo:
    def __init__(self, key: str, relpath: str, qualname: str,
                 node: ast.AST, module: Module, cls_key: str | None):
        self.key = key
        self.relpath = relpath
        self.qualname = qualname
        self.name = node.name
        self.lineno = node.lineno
        self.node = node
        self.module = module
        self.cls_key = cls_key
        self.calls: list[CallSite] = []
        self.refs: set[str] = set()            # referenced FuncKeys
        self.acquires: list[Acquire] = []
        self.effects: list[Effect] = []

    def site(self, lineno: int | None = None) -> str:
        return f"{self.relpath}:{lineno or self.lineno} ({self.qualname})"


class ProjectModel:
    """All linted modules, resolved into one interprocedural model."""

    def __init__(self, modules: Sequence[Module], root: str):
        self.root = root
        self.modules = list(modules)
        self.by_relpath: dict[str, Module] = {
            m.relpath: m for m in self.modules}
        self.classes: dict[str, ClassInfo] = {}
        self.functions: dict[str, FunctionInfo] = {}
        self.module_classes: dict[str, dict[str, str]] = {}
        self.module_functions: dict[str, dict[str, str]] = {}
        self.module_locks: dict[str, dict[str, str]] = {}
        self.locks: dict[str, LockInfo] = {}
        self.lock_sites: dict[str, str] = {}   # "relpath:line" -> id
        self.method_index: dict[str, list[str]] = {}
        self._imports = {m.relpath: imported_names(m.tree)
                         for m in self.modules}
        self._dot_to_relpath = {
            self._dot(m.relpath): m.relpath for m in self.modules}
        self._acq_memo: dict[str, dict] = {}
        self._eff_memo: dict[str, dict] = {}
        self._edges: dict[tuple[str, str], tuple[str, ...]] | None = None
        for m in self.modules:
            self._collect(m)
        for m in self.modules:
            self._collect_locks_and_types(m)
        for fi in self.functions.values():
            self._scan_function(fi)

    # ------------------------------------------------------ indexing ----
    @staticmethod
    def _dot(relpath: str) -> str:
        return relpath[:-3].replace("/", ".") if relpath.endswith(".py") \
            else relpath.replace("/", ".")

    def _collect(self, module: Module) -> None:
        relpath = module.relpath
        self.module_classes[relpath] = {}
        self.module_functions[relpath] = {}
        self.module_locks[relpath] = {}

        def walk(body, cls_info, ctx_cls, prefix, parent_fn):
            for node in body:
                if isinstance(node, ast.ClassDef):
                    key = f"{relpath}::{prefix}{node.name}"
                    ci = ClassInfo(key, relpath, node.name, node)
                    self.classes[key] = ci
                    if not prefix:
                        self.module_classes[relpath][node.name] = key
                    walk(node.body, ci, key, f"{prefix}{node.name}.",
                         None)
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    qual = f"{prefix}{node.name}"
                    key = f"{relpath}::{qual}"
                    this_cls = cls_info.key if cls_info else ctx_cls
                    fi = FunctionInfo(key, relpath, qual, node, module,
                                      this_cls)
                    self.functions[key] = fi
                    if cls_info is not None:
                        cls_info.methods[node.name] = key
                        self.method_index.setdefault(
                            node.name, []).append(key)
                    elif not prefix:
                        self.module_functions[relpath][node.name] = key
                    if parent_fn is not None:
                        parent_fn.refs.add(key)
                    walk(node.body, None, this_cls, f"{qual}.", fi)

        walk(module.tree.body, None, None, "", None)

    # --------------------------------------------- locks & attr types ----
    def _factory(self, relpath: str, call: ast.Call) -> str | None:
        """"lock"/"rlock"/"condition"/"event"/"thread" for threading
        factory calls, else None."""
        dotted = self._dotted(relpath, attr_chain(call.func))
        return {
            "threading.Lock": "lock", "threading.RLock": "rlock",
            "threading.Condition": "condition",
            "threading.Event": "event", "threading.Thread": "thread",
        }.get(dotted)

    def _dotted(self, relpath: str, chain: tuple[str, ...]) -> str:
        if not chain:
            return ""
        imports = self._imports[relpath]
        if chain[0] in imports:
            return ".".join((imports[chain[0]],) + chain[1:])
        return ".".join(chain)

    def _register_lock(self, lock_id: str, kind: str, relpath: str,
                       lineno: int) -> None:
        site = f"{relpath}:{lineno}"
        info = self.locks.setdefault(lock_id, LockInfo(lock_id, kind, []))
        if site not in info.sites:
            info.sites.append(site)
        self.lock_sites[site] = lock_id

    def _collect_locks_and_types(self, module: Module) -> None:
        relpath = module.relpath
        moddot = self._dot(relpath)
        # module-level locks (chaos._lock, obs.trace._global_lock, ...)
        for node in module.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call):
                kind = self._factory(relpath, node.value)
                name = node.targets[0].id
                if kind in ("lock", "rlock"):
                    lid = f"{moddot}.{name}"
                    self._register_lock(lid, kind, relpath,
                                        node.value.lineno)
                    self.module_locks[relpath][name] = lid
                elif kind == "condition":
                    args = node.value.args
                    if args and isinstance(args[0], ast.Name) and \
                            args[0].id in self.module_locks[relpath]:
                        self.module_locks[relpath][name] = \
                            self.module_locks[relpath][args[0].id]
                    else:
                        lid = f"{moddot}.{name}"
                        self._register_lock(lid, "condition", relpath,
                                            node.value.lineno)
                        self.module_locks[relpath][name] = lid
        for ci in self.classes.values():
            if ci.relpath == relpath:
                self._collect_class(module, ci, moddot)

    def _collect_class(self, module: Module, ci: ClassInfo,
                       moddot: str) -> None:
        relpath = module.relpath
        assigns: list[tuple[str, ast.Call]] = []
        for node in ast.walk(ci.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t = node.targets[0]
                attr = None
                if isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == "self":
                    attr = t.attr
                elif isinstance(t, ast.Name) and node in ci.node.body:
                    attr = t.id        # class-level shared attribute
                if attr is None:
                    continue
                if isinstance(node.value, ast.Call):
                    assigns.append((attr, node.value))
                elif isinstance(node.value, ast.Name):
                    # self.x = param — typed by the param's annotation
                    ck = self._param_type(ci, node, node.value.id)
                    if ck:
                        ci.attr_types.setdefault(attr, ck)
                elif isinstance(node.value, ast.BoolOp):
                    # self.x = param or Cls() — either operand types it
                    for operand in node.value.values:
                        if isinstance(operand, ast.Call):
                            assigns.append((attr, operand))
                        elif isinstance(operand, ast.Name):
                            ck = self._param_type(ci, node, operand.id)
                            if ck:
                                ci.attr_types.setdefault(attr, ck)
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Attribute) and \
                    isinstance(node.target.value, ast.Name) and \
                    node.target.value.id == "self":
                ck = self._resolve_annotation(relpath, node.annotation)
                if ck:
                    ci.attr_types.setdefault(node.target.attr, ck)
                if isinstance(node.value, ast.Call):
                    assigns.append((node.target.attr, node.value))
        # pass 1: plain locks; pass 2: conditions may alias them
        for attr, call in assigns:
            kind = self._factory(relpath, call)
            if kind in ("lock", "rlock"):
                lid = f"{moddot}.{ci.name}.{attr}"
                self._register_lock(lid, kind, relpath, call.lineno)
                ci.lock_attrs[attr] = lid
        for attr, call in assigns:
            kind = self._factory(relpath, call)
            if kind == "condition":
                arg = call.args[0] if call.args else None
                wrapped = None
                if isinstance(arg, ast.Attribute) and \
                        isinstance(arg.value, ast.Name) and \
                        arg.value.id == "self":
                    wrapped = ci.lock_attrs.get(arg.attr)
                if wrapped:
                    ci.lock_attrs[attr] = wrapped
                else:
                    lid = f"{moddot}.{ci.name}.{attr}"
                    self._register_lock(lid, "condition", relpath,
                                        call.lineno)
                    ci.lock_attrs[attr] = lid
            elif kind in ("event", "thread"):
                ci.attr_types.setdefault(attr, f"threading.{kind}")
            elif kind is None:
                ck = self._class_of_call(relpath, call)
                if ck:
                    ci.attr_types.setdefault(attr, ck)
        # pass 3: factory-method returns — `self.x = r.counter(...)`
        # with `def counter(...) -> Counter` types the attribute; local
        # intermediates (`r = registry()`) are typed in source order so
        # the chain resolves
        for mkey in ci.methods.values():
            fn = self.functions.get(mkey)
            if fn is None:
                continue
            local: dict[str, str] = {}
            args = fn.node.args
            for a in (args.posonlyargs + args.args + args.kwonlyargs):
                if a.annotation is not None:
                    ck = self._resolve_annotation(relpath, a.annotation)
                    if ck:
                        local[a.arg] = ck
            for node in ast.walk(fn.node):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.value, ast.Call)):
                    continue
                t = node.targets[0]
                ck = self._class_of_call(relpath, node.value,
                                         ctx_cls=ci.key,
                                         local_types=local)
                if not ck:
                    continue
                if isinstance(t, ast.Name):
                    local[t.id] = ck
                elif isinstance(t, ast.Attribute) and \
                        isinstance(t.value, ast.Name) and \
                        t.value.id == "self" and \
                        t.attr not in ci.lock_attrs:
                    ci.attr_types.setdefault(t.attr, ck)

    def _param_type(self, ci: ClassInfo, assign: ast.AST,
                    pname: str) -> str | None:
        """Type of ``self.x = pname`` from the enclosing function's
        annotated parameter list."""
        for name, key in ci.methods.items():
            fi = self.functions.get(key)
            if fi is None or not any(
                    n is assign for n in ast.walk(fi.node)):
                continue
            args = fi.node.args
            for a in (args.posonlyargs + args.args + args.kwonlyargs):
                if a.arg == pname and a.annotation is not None:
                    return self._resolve_annotation(ci.relpath,
                                                    a.annotation)
        return None

    def _resolve_annotation(self, relpath: str,
                            ann: ast.AST) -> str | None:
        """``Cls`` / ``mod.Cls`` / ``Optional[Cls]`` / ``Cls | None`` /
        ``"Cls"`` → ClassKey (or a ``threading.*`` pseudo-key)."""
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
        if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
            return self._resolve_annotation(relpath, ann.left) or \
                self._resolve_annotation(relpath, ann.right)
        if isinstance(ann, ast.Subscript):  # Optional[X] / list[X]: try X
            chain = attr_chain(ann.value)
            if chain and chain[-1] in ("Optional", "Union"):
                inner = ann.slice
                if isinstance(inner, ast.Tuple):
                    for el in inner.elts:
                        ck = self._resolve_annotation(relpath, el)
                        if ck:
                            return ck
                    return None
                return self._resolve_annotation(relpath, inner)
            return None
        chain = attr_chain(ann)
        if not chain:
            return None
        return self._resolve_class_chain(relpath, chain)

    def _resolve_class_chain(self, relpath: str,
                             chain: tuple[str, ...]) -> str | None:
        if len(chain) == 1 and \
                chain[0] in self.module_classes.get(relpath, {}):
            return self.module_classes[relpath][chain[0]]
        dotted = self._dotted(relpath, chain)
        if dotted in ("threading.Event", "threading.Thread"):
            return "threading." + chain[-1].lower()
        mod, _, cls = dotted.rpartition(".")
        target = self._dot_to_relpath.get(mod)
        if target:
            return self.module_classes.get(target, {}).get(cls)
        return None

    def _class_of_call(self, relpath: str, call: ast.Call,
                       ctx_cls: str | None = None,
                       local_types: dict[str, str] | None = None,
                       ) -> str | None:
        kind = self._factory(relpath, call)
        if kind in ("event", "thread"):
            return f"threading.{kind}"
        chain = attr_chain(call.func)
        if not chain:
            return None
        ck = self._resolve_class_chain(relpath, chain)
        if ck:
            return ck
        # factory-method fallback: a call that resolves to a function
        # whose return annotation names a known class types the result
        # (the metrics registry builds every instrument this way, and
        # instrument mutators all take _Metric._lock — without this
        # the lock model is blind to every `held -> metric` edge, which
        # is exactly what the syncwatch witness caught)
        key = self.resolve_call(relpath, ctx_cls, local_types or {},
                                chain)
        if key:
            fn = self.functions.get(key)
            if fn is not None and fn.name != "__init__" and \
                    getattr(fn.node, "returns", None) is not None:
                return self._resolve_annotation(fn.relpath,
                                                fn.node.returns)
        return None

    # ------------------------------------------------ call resolution ----
    def _mro(self, ci: ClassInfo) -> list[ClassInfo]:
        out: list[ClassInfo] = []
        queue = [ci]
        local = self.module_classes.get(ci.relpath, {})
        while queue:
            c = queue.pop(0)
            if c in out:
                continue
            out.append(c)
            for b in c.base_names:
                if b in local and self.classes[local[b]] not in out:
                    queue.append(self.classes[local[b]])
        return out

    def _method(self, ci: ClassInfo, name: str) -> str | None:
        for c in self._mro(ci):
            if name in c.methods:
                return c.methods[name]
        return None

    def _attr_type(self, ci: ClassInfo, attr: str) -> str | None:
        for c in self._mro(ci):
            if attr in c.attr_types:
                return c.attr_types[attr]
        return None

    def _effective_lock_attrs(self, ci: ClassInfo) -> dict[str, str]:
        out: dict[str, str] = {}
        for c in reversed(self._mro(ci)):
            out.update(c.lock_attrs)
        return out

    def resolve_call(self, relpath: str, ctx_cls: str | None,
                     local_types: dict[str, str],
                     chain: tuple[str, ...]) -> str | None:
        """Resolve a called name chain to a FuncKey, or None."""
        if not chain:
            return None
        ci = self.classes.get(ctx_cls) if ctx_cls else None
        if chain[0] == "self" and ci is not None:
            if len(chain) == 2:
                return self._method(ci, chain[1])
            if len(chain) == 3:
                ck = self._attr_type(ci, chain[1])
                if ck in self.classes:
                    return self._method(self.classes[ck], chain[2])
            return None
        if len(chain) == 1:
            name = chain[0]
            if name in self.module_functions.get(relpath, {}):
                return self.module_functions[relpath][name]
            ck = self._resolve_class_chain(relpath, chain)
            if ck in self.classes:
                return self._method(self.classes[ck], "__init__")
            dotted = self._imports[relpath].get(name)
            if dotted:
                return self._resolve_dotted_callable(dotted)
            return None
        head = chain[0]
        if head in local_types and len(chain) == 2:
            ck = local_types[head]
            if ck in self.classes:
                return self._method(self.classes[ck], chain[1])
            return None
        if head in self._imports[relpath]:
            return self._resolve_dotted_callable(
                self._dotted(relpath, chain))
        if head in self.module_classes.get(relpath, {}) \
                and len(chain) == 2:
            return self._method(
                self.classes[self.module_classes[relpath][head]],
                chain[1])
        # unique-name fallback (never for generic method names)
        name = chain[-1]
        if name not in _GENERIC_METHOD_NAMES:
            cands = self.method_index.get(name, [])
            if len(cands) == 1:
                return cands[0]
        return None

    def _resolve_dotted_callable(self, dotted: str) -> str | None:
        mod, _, name = dotted.rpartition(".")
        target = self._dot_to_relpath.get(mod)
        if target:
            if name in self.module_functions.get(target, {}):
                return self.module_functions[target][name]
            ck = self.module_classes.get(target, {}).get(name)
            if ck:
                return self._method(self.classes[ck], "__init__")
        # from m import Cls; Cls.method / Cls(...) resolved one up
        mod2, _, cls = mod.rpartition(".")
        target = self._dot_to_relpath.get(mod2)
        if target:
            ck = self.module_classes.get(target, {}).get(cls)
            if ck:
                return self._method(self.classes[ck], name)
        return None

    # ------------------------------------------------- function scan ----
    def _scan_function(self, fi: FunctionInfo) -> None:
        relpath = fi.relpath
        ci = self.classes.get(fi.cls_key) if fi.cls_key else None
        lock_attrs = self._effective_lock_attrs(ci) if ci else {}
        mod_locks = self.module_locks.get(relpath, {})
        local_types: dict[str, str] = {}
        args = fi.node.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            if a.annotation is not None:
                ck = self._resolve_annotation(relpath, a.annotation)
                if ck:
                    local_types[a.arg] = ck
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call):
                ck = self._class_of_call(relpath, node.value,
                                         ctx_cls=fi.cls_key,
                                         local_types=local_types)
                if ck:
                    local_types[node.targets[0].id] = ck

        def resolve_lock(expr) -> str | None:
            if isinstance(expr, ast.Attribute) and \
                    isinstance(expr.value, ast.Name) and \
                    expr.value.id == "self":
                return lock_attrs.get(expr.attr)
            if isinstance(expr, ast.Name):
                return mod_locks.get(expr.id)
            return None

        def effect_kind(chain: tuple[str, ...], call: ast.Call,
                        resolved: str | None) -> str | None:
            if not chain:
                return None
            last = chain[-1]
            if last == "fsync":
                return "fsync"
            if "sweep_stale_tmp" in last:
                return "sweep"
            if "quarantine" in last:
                return "quarantine"
            if last == "replace" and len(chain) >= 2:
                return "replace"
            if resolved is not None:
                return None          # a project call: effects come
            dotted = self._dotted(relpath, chain)  # transitively
            if dotted == "time.sleep":
                return "sleep"
            if dotted.startswith("subprocess.") and \
                    last in _SUBPROCESS_FNS:
                return "subprocess"
            if last in _SOCKET_METHODS:
                return "socket"
            if last == "result" and len(chain) >= 2:
                return "result"
            rcv_type = None
            if len(chain) == 2 and chain[0] in local_types:
                rcv_type = local_types[chain[0]]
            elif len(chain) == 2 and chain[0] == "self":
                rcv_type = None
            elif chain[0] == "self" and len(chain) == 3 and ci:
                rcv_type = self._attr_type(ci, chain[1])
            if last == "join" and len(chain) >= 2:
                if rcv_type == "threading.thread" or any(
                        "thread" in p.lower() or "worker" in p.lower()
                        for p in chain[:-1]):
                    return "join"
            if last == "wait" and rcv_type == "threading.event":
                return "wait"
            return None

        def visit_expr(node, held: tuple[str, ...]) -> None:
            if not isinstance(node, ast.AST):
                return
            if isinstance(node, ast.Lambda):
                visit_expr(node.body, ())      # runs later, unguarded
                return
            if isinstance(node, ast.Call):
                chain = attr_chain(node.func)
                target = self.resolve_call(relpath, fi.cls_key,
                                           local_types, chain)
                text = ".".join(chain) if chain else "<call>"
                fi.calls.append(CallSite(node.lineno, text, target,
                                         held))
                kind = effect_kind(chain, node, target)
                if kind:
                    fi.effects.append(Effect(kind, node.lineno, text,
                                             held))
            elif isinstance(node, (ast.Attribute, ast.Name)) and \
                    isinstance(getattr(node, "ctx", None), ast.Load):
                chain = attr_chain(node)
                if chain and chain[-1] not in _GENERIC_METHOD_NAMES:
                    t = self.resolve_call(relpath, fi.cls_key,
                                          local_types, chain)
                    if t:
                        fi.refs.add(t)   # e.g. Thread(target=self._run)
            for child in ast.iter_child_nodes(node):
                visit_expr(child, held)

        def walk_stmts(stmts, held: tuple[str, ...]) -> None:
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    continue          # separate FunctionInfo (+ ref)
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    now = list(held)
                    for it in stmt.items:
                        visit_expr(it.context_expr, tuple(now))
                        lid = resolve_lock(it.context_expr)
                        if lid:
                            fi.acquires.append(Acquire(
                                lid, it.context_expr.lineno,
                                tuple(now)))
                            if lid not in now:
                                now.append(lid)
                    walk_stmts(stmt.body, tuple(now))
                    continue
                for field, value in ast.iter_fields(stmt):
                    if field in ("body", "orelse", "finalbody") and \
                            isinstance(value, list):
                        walk_stmts(value, held)
                    elif field == "handlers":
                        for h in value:
                            walk_stmts(h.body, held)
                    elif isinstance(value, list):
                        for v in value:
                            visit_expr(v, held)
                    else:
                        visit_expr(value, held)

        walk_stmts(fi.node.body, ())

    # ----------------------------------------------------- closures ----
    def transitive_acquires(self, key: str,
                            _stack: frozenset[str] = frozenset(),
                            ) -> dict[str, tuple[str, ...]]:
        """lock id → hop chain for every lock ``key`` (or anything it
        calls, depth-capped) may acquire."""
        if key in self._acq_memo:
            return self._acq_memo[key]
        if key in _stack or len(_stack) >= MAX_DEPTH:
            return {}
        fi = self.functions.get(key)
        if fi is None:
            return {}
        out: dict[str, tuple[str, ...]] = {}
        for acq in fi.acquires:
            out.setdefault(acq.lock_id, (fi.site(acq.lineno),))
        for cs in fi.calls:
            if cs.target is None:
                continue
            sub = self.transitive_acquires(cs.target,
                                           _stack | {key})
            for lid, chain in sub.items():
                out.setdefault(
                    lid, (fi.site(cs.lineno),) + chain)
        if not _stack:
            self._acq_memo[key] = out
        return out

    def transitive_effects(self, key: str,
                           _stack: frozenset[str] = frozenset(),
                           ) -> dict[str, tuple[str, ...]]:
        """effect kind → hop chain for every effect reachable from
        ``key`` through the call graph."""
        if key in self._eff_memo:
            return self._eff_memo[key]
        if key in _stack or len(_stack) >= MAX_DEPTH:
            return {}
        fi = self.functions.get(key)
        if fi is None:
            return {}
        out: dict[str, tuple[str, ...]] = {}
        for eff in fi.effects:
            out.setdefault(eff.kind,
                           (fi.site(eff.lineno) + f" {eff.text}",))
        for cs in fi.calls:
            if cs.target is None:
                continue
            sub = self.transitive_effects(cs.target, _stack | {key})
            for kind, chain in sub.items():
                out.setdefault(kind, (fi.site(cs.lineno),) + chain)
        if not _stack:
            self._eff_memo[key] = out
        return out

    def reachable(self, roots: Iterable[str]) -> set[str]:
        """Every FuncKey reachable from ``roots`` via calls or
        function references (``Thread(target=...)`` counts)."""
        seen: set[str] = set()
        queue = [r for r in roots if r in self.functions]
        while queue:
            key = queue.pop()
            if key in seen:
                continue
            seen.add(key)
            fi = self.functions[key]
            for cs in fi.calls:
                if cs.target and cs.target not in seen:
                    queue.append(cs.target)
            for ref in fi.refs:
                if ref not in seen:
                    queue.append(ref)
        return seen

    # ----------------------------------------------- lock-order graph ----
    def lock_order_edges(self) -> dict[tuple[str, str], tuple[str, ...]]:
        """(held, acquired) → representative file:line chain. The edge
        set is the static prediction the runtime witness diffs against;
        a cycle in it is a potential deadlock."""
        if self._edges is not None:
            return self._edges
        edges: dict[tuple[str, str], tuple[str, ...]] = {}
        for fi in self.functions.values():
            for acq in fi.acquires:
                for a in acq.held:
                    edges.setdefault((a, acq.lock_id),
                                     (fi.site(acq.lineno),))
            for cs in fi.calls:
                if not cs.held or cs.target is None:
                    continue
                sub = self.transitive_acquires(cs.target)
                for b, chain in sub.items():
                    for a in cs.held:
                        edges.setdefault(
                            (a, b), (fi.site(cs.lineno),) + chain)
        self._edges = edges
        return edges

    def lock_cycles(self) -> list[list[tuple[str, str, tuple[str, ...]]]]:
        """Cycles in the lock-order graph, each as a list of
        (held, acquired, chain) edges. Reentrant self-edges on RLocks
        and Conditions are legal and skipped; a self-edge on a plain
        Lock is a guaranteed self-deadlock and is reported as a
        1-cycle."""
        edges = self.lock_order_edges()
        cycles: list[list[tuple[str, str, tuple[str, ...]]]] = []
        adj: dict[str, list[str]] = {}
        for (a, b), chain in sorted(edges.items()):
            if a == b:
                kind = self.locks.get(a, LockInfo(a, "lock", [])).kind
                if kind == "lock":
                    cycles.append([(a, b, chain)])
                continue
            adj.setdefault(a, []).append(b)
        # DFS cycle enumeration (first cycle per SCC is enough for a
        # finding; the graph is tiny)
        seen_cycles: set[tuple[str, ...]] = set()
        for start in sorted(adj):
            stack = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in adj.get(node, []):
                    if nxt == start and len(path) > 1:
                        key = tuple(sorted(path))
                        if key in seen_cycles:
                            continue
                        seen_cycles.add(key)
                        cyc = []
                        loop = path + [start]
                        for a, b in zip(loop, loop[1:]):
                            cyc.append((a, b, edges[(a, b)]))
                        cycles.append(cyc)
                    elif nxt not in path and len(path) < MAX_DEPTH:
                        stack.append((nxt, path + [nxt]))
        return cycles

    # --------------------------------------------- witness interface ----
    def lock_model(self) -> dict:
        """The static model the runtime witness diff consumes
        (analysis/witness.py): lock ids with creation sites, plus the
        predicted lock-order edge set."""
        return {
            "locks": {lid: {"kind": info.kind,
                            "sites": sorted(info.sites)}
                      for lid, info in sorted(self.locks.items())},
            "edges": sorted([a, b] for (a, b)
                            in self.lock_order_edges()),
        }
