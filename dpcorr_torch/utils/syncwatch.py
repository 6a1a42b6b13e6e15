"""Runtime lock-witness sanitizer (``DPCORR_SYNCWATCH=1``).

Counterpart of ``dpcorr.utils.syncwatch``. The static lock model
(``python -m dpcorr_torch lint --deep``, analysis/callgraph.py) predicts
which lock-order edges the port can traverse. This module is the
empirical other half: an opt-in wrapper around ``threading.Lock`` /
``threading.RLock`` that records the acquisition-order graph a live
process *actually* walks, detects order inversions and held-across-
fsync windows as they happen, and dumps a witness artifact on exit —
including chaos kills (``dpcorr_torch.chaos.on_crash``; ``os._exit``
skips atexit). ``python -m dpcorr_torch lint --witness DIR``
(analysis/witness.py) then diffs the observed graph against the static
prediction: an observed edge the model did not predict, an inversion or
an observed cycle fails the gate.

Scope: only locks *created from dpcorr_torch source files* are wrapped
(the factory checks its caller's frame), so stdlib, torch and
third-party locks — and the JAX package's — pass through untouched. A
lock's identity is its creation site ``relpath:lineno`` (relative to
the repository root, ``dpcorr_torch/...``): every instance born at one
site shares an id, which is exactly the static model's granularity.
Stdlib only: safe to enable in the torch-free lint process.

Both packages in one process (the test suite imports both): each
watcher wraps only its own package's locks. :func:`enable` chains to
the factories installed when it runs instead of the ones found at
import, and the caller frame is found past any ``syncwatch.py`` frame,
so a watcher enabled after this one still sees the true creator. The
JAX watcher judges its caller at a fixed depth, so when this one is
enabled after it, locks the JAX package creates later pass through
unwatched by either. Artifacts are named ``torch-witness-<pid>.json``,
which the JAX gate's ``witness-*.json`` does not match: under one
``DPCORR_SYNCWATCH_DIR`` no artifact overwrites another, and each
gate reads only its own package's.

Cost when disabled: zero (nothing is patched). Cost when enabled: one
dict lookup + list append per acquisition — fine for smokes, not meant
for timed runs.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading

#: where witness artifacts land unless DPCORR_SYNCWATCH_DIR says else.
DEFAULT_DIR = ".dpcorr_torch-syncwatch"
#: artifact file names are ``<ARTIFACT_PREFIX><pid>.json``.
ARTIFACT_PREFIX = "torch-witness-"

_real_lock = threading.Lock
_real_rlock = threading.RLock
_real_fsync = os.fsync

# package root ("<...>/dpcorr_torch") — creator frames under it get wrapped
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_DIR = os.path.dirname(_PKG_DIR)

_enabled = False
_outer: tuple = ()            # (Lock, RLock, fsync) that enable() replaced
_mine: tuple = ()             # ... and what it put in their place
_meta = _real_lock()          # guards everything below (a REAL lock:
_edges: dict = {}             # the sanitizer must not watch itself)
_locks: dict = {}             # site -> kind
_inversions: list = []
_fsync_under_lock: dict = {}
_threads_seen: set = set()
_tls = threading.local()


def _held() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _creation_site() -> str | None:
    """``relpath:lineno`` of the frame creating the lock, when that
    frame lives in a dpcorr_torch source file; None otherwise. Frames of
    a ``syncwatch.py`` (another package's watcher chained around this
    one) are stepped over."""
    try:
        f = sys._getframe(2)
    except ValueError:
        return None
    while f is not None and \
            os.path.basename(f.f_code.co_filename) == "syncwatch.py":
        f = f.f_back
    if f is None:
        return None
    # a relative sys.path entry (`sys.path.insert(0, '.')`) leaves
    # co_filename relative or un-normalized ("<cwd>/./pkg/mod.py");
    # anchor and normalize it the way import resolved it
    fn = os.path.abspath(f.f_code.co_filename)
    if not fn.startswith(_PKG_DIR + os.sep):
        return None
    rel = os.path.relpath(fn, _REPO_DIR).replace(os.sep, "/")
    return f"{rel}:{f.f_lineno}"


class _WatchedLock:
    """Wraps one real lock; records order edges on acquisition. API
    surface matches what ``with``, ``threading.Condition`` and direct
    acquire/release callers use."""

    __slots__ = ("_real", "site", "kind")

    def __init__(self, real, site: str, kind: str):
        self._real = real
        self.site = site
        self.kind = kind

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._real.acquire(blocking, timeout)
        if got:
            self._record_acquire()
        return got

    def _record_acquire(self) -> None:
        stack = _held()
        reentrant = self.site in stack
        if not reentrant and stack:
            acquiring = self.site
            with _meta:
                _threads_seen.add(threading.current_thread().name)
                for held_site in set(stack):
                    if held_site == acquiring:
                        continue
                    edge = (held_site, acquiring)
                    if edge not in _edges:
                        _edges[edge] = threading.current_thread().name
                        if (acquiring, held_site) in _edges:
                            inv = {"held": held_site,
                                   "acquiring": acquiring,
                                   "thread":
                                       threading.current_thread().name}
                            _inversions.append(inv)
                            print(f"dpcorr_torch syncwatch: lock-order "
                                  f"inversion: {held_site} -> "
                                  f"{acquiring} (reverse edge already "
                                  f"observed)", file=sys.stderr)
        elif stack:
            with _meta:
                _threads_seen.add(threading.current_thread().name)
        stack.append(self.site)

    def release(self) -> None:
        stack = _held()
        # remove the most recent entry for this site (reentrant locks
        # push once per level, so counts stay balanced)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == self.site:
                del stack[i]
                break
        self._real.release()

    def locked(self) -> bool:
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def _at_fork_reinit(self) -> None:  # pragma: no cover - fork only
        self._real._at_fork_reinit()
        _tls.stack = []


def _make_factory(real_factory, kind: str):
    def factory():
        real = real_factory()
        site = _creation_site()
        if site is None:
            return real
        with _meta:
            _locks.setdefault(site, kind)
        return _WatchedLock(real, site, kind)
    return factory


def _watched_fsync(fd):
    stack = _held()
    if stack:
        with _meta:
            for site in set(stack):
                _fsync_under_lock[site] = \
                    _fsync_under_lock.get(site, 0) + 1
    return _outer[2](fd)


def snapshot() -> dict:
    """The witness artifact as a dict (also what gets dumped): the JAX
    package's fields, plus the process's ``argv`` (which process a
    dump came from, since a killed child's pid is nobody's to know)."""
    with _meta:
        return {
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "locks": {site: {"kind": kind}
                      for site, kind in sorted(_locks.items())},
            "edges": sorted([a, b] for (a, b) in _edges),
            "edge_threads": {f"{a} -> {b}": t
                             for (a, b), t in sorted(_edges.items())},
            "inversions": list(_inversions),
            "fsync_under_lock": dict(sorted(
                _fsync_under_lock.items())),
            "threads": sorted(_threads_seen),
        }


def dump(directory: str | None = None, end: str = "exit") -> str:
    """Write the witness artifact for this process; returns the path.
    ``end`` is recorded as how the process ended (``exit``, or
    ``chaos:<point>`` from the crash hook). Registered both with atexit
    and ``chaos.on_crash`` so a planned kill (``os._exit``) still leaves
    its witness behind."""
    directory = directory or os.environ.get("DPCORR_SYNCWATCH_DIR",
                                            DEFAULT_DIR)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{ARTIFACT_PREFIX}{os.getpid()}.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump({**snapshot(), "end": end}, fh, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def _crash_dump(point: str) -> None:
    dump(end=f"chaos:{point}")


def enable() -> None:
    """Patch the lock factories and ``os.fsync``, chaining to whatever
    is installed now. Idempotent; called from ``dpcorr_torch/__init__``
    when ``DPCORR_SYNCWATCH=1`` so the patch lands before any port module
    creates a lock."""
    global _enabled, _outer, _mine
    if _enabled:
        return
    _enabled = True
    _outer = (threading.Lock, threading.RLock, os.fsync)
    _mine = (_make_factory(_outer[0], "lock"),
             _make_factory(_outer[1], "rlock"), _watched_fsync)
    threading.Lock, threading.RLock, os.fsync = _mine
    atexit.register(dump)
    from dpcorr_torch import chaos
    chaos.on_crash(_crash_dump)


def disable() -> None:
    """Undo :func:`enable` (tests): the factories it replaced come back,
    unless a watcher enabled later sits on top of them. Locks already
    created stay wrapped; recording state is reset."""
    global _enabled
    if not _enabled:
        return
    _enabled = False
    for (owner, name), mine, outer in zip(
            ((threading, "Lock"), (threading, "RLock"), (os, "fsync")),
            _mine, _outer):
        if getattr(owner, name) is mine:
            setattr(owner, name, outer)
    atexit.unregister(dump)
    from dpcorr_torch import chaos
    chaos.remove_crash_hook(_crash_dump)
    with _meta:
        _edges.clear()
        _locks.clear()
        _inversions.clear()
        _fsync_under_lock.clear()
        _threads_seen.clear()
