"""The executor: build, dispatch and fetch for one placement.

Counterpart of ``dpcorr/plan/executor.py``. One :class:`Executor` owns
what every dispatch site used to hand-roll:

- **build** — :meth:`Executor.prepare` builds a :class:`Prepared` unit
  through ``utils.compile.aot_compile`` (with a warm run when example
  arguments are given), de-duplicated per key by a
  :class:`~dpcorr_torch.utils.compile.SingleFlight`, optionally cached;
  :meth:`Executor.lazy_unit` wraps a callable without building or
  timing anything.
- **dispatch** — operands are placed on the placement's device(s)
  before the call (:meth:`Executor.preshard`); the call itself stays
  asynchronous. Under a mesh the unit runs once per contiguous shard,
  each on its device, and the shards' outputs are concatenated on the
  first device in shard order.
- **fetch** — :meth:`Executor.fetch` is the one counted host read of a
  plan (``obs.transfer`` fetches).

A unit has no fallback: eager torch has no strict compiled signature
to reject a shape, and a unit that fails raises.
"""

from __future__ import annotations

import threading

import torch

from dpcorr_torch.plan.placement import Placement, resolve_placement
from dpcorr_torch.utils import compile as compile_mod
from dpcorr_torch.utils.profiling import HOST_READ, stage


class Prepared:
    """One plan unit: call it with the dispatch arguments. ``built`` is
    False for a lazy unit (nothing was built or timed ahead)."""

    __slots__ = ("key", "fn", "signature", "built")

    def __init__(self, key, fn, signature=None, built: bool = True):
        self.key = key
        self.fn = fn
        self.signature = dict(signature or {})
        self.built = built

    def __call__(self, *args):
        return self.fn(*args)


def _cat(parts, dev: torch.device):
    """Per-shard outputs (tensors, or tuples of them) joined along the
    leading axis on ``dev``, in shard order."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(dev) for p in parts])
    return tuple(_cat([p[j] for p in parts], dev)
                 for j in range(len(first)))


def _to_host(out):
    if isinstance(out, torch.Tensor):
        return out.cpu()
    return type(out)(_to_host(v) for v in out)


class Executor:
    """Build/dispatch/fetch for one placement.

    ``placement`` is a name (``"local"``/``"mesh"``/``"multihost"``) or a
    :class:`~dpcorr_torch.plan.placement.Placement`; ``devices`` and
    ``device`` feed its resolution. ``observer`` is the
    :class:`~dpcorr_torch.utils.compile.CompileObserver` every build
    reports through (serving passes its per-server registry; default: a
    process-registry observer made at the first build); ``counters`` the
    ``obs.transfer`` bundle placements and fetches count into."""

    def __init__(self, placement="local", *, devices=None, device=None,
                 observer=None, counters=None):
        self.placement: Placement = resolve_placement(
            placement, devices=devices, device=device)
        self.observer = observer
        self.flight = compile_mod.SingleFlight()
        self._counters = counters
        self._units: dict = {}  # guarded by: _lock
        self._lock = threading.Lock()

    def counters(self):
        if self._counters is None:
            from dpcorr_torch.obs import transfer as transfer_mod

            self._counters = transfer_mod.default_counters()
        return self._counters

    def _observer(self):
        if self.observer is None:
            self.observer = compile_mod.CompileObserver()
        return self.observer

    # --------------------------------------------------------- build ----
    def prepare(self, key, build, example_args=None, *, signature=None,
                cache: bool = True) -> Prepared:
        """The :class:`Prepared` unit for ``key``: from this executor's
        unit cache, or built by ``build()`` through
        ``utils.compile.aot_compile`` (warmed on ``example_args`` when
        given) under one single flight per key. ``cache=False`` leaves
        the unit's lifetime to the caller (the serving cache's LRU)."""
        if cache:
            with self._lock:
                unit = self._units.get(key)
            if unit is not None:
                return unit

        def _build():
            fn = compile_mod.aot_compile(
                build, example_args, signature=signature,
                observer=self._observer())
            unit = Prepared(key, fn, signature)
            if cache:
                with self._lock:
                    self._units[key] = unit
            return unit

        unit, _leader = self.flight.do(("plan.prepare", key), _build)
        return unit

    def lazy_unit(self, fn, *, key=None, signature=None) -> Prepared:
        """A :class:`Prepared` that was never built ahead: dispatching
        it is the plain call. Nothing is timed or counted."""
        return Prepared(key, fn, signature, built=False)

    def evict(self, key) -> None:
        """Drop a cached unit and tell the observer, so the next build
        of its signature is attributed to eviction, not novelty."""
        with self._lock:
            unit = self._units.pop(key, None)
        if unit is not None:
            self._observer().note_evicted(
                compile_mod.signature_key(unit.signature))

    # ------------------------------------------------------ dispatch ----
    def preshard(self, arrays) -> tuple:
        """Batch-axis operands onto the placement's device(s)."""
        return self.placement.preshard(arrays, self.counters())

    def dispatch(self, prepared, args):
        """Preshard ``args`` and launch; returns device tensors (the call
        stays asynchronous — pair it with one :meth:`fetch`). Under a
        mesh every leading axis must split evenly over the devices
        (pad first: ``placement.pad``)."""
        args = tuple(args)
        if self.placement.name != "mesh":
            return prepared(*self.preshard(args))
        n_dev = self.placement.device_count
        for a in args:
            if int(a.shape[0]) % n_dev:
                raise ValueError(
                    f"a batch of {int(a.shape[0])} does not split evenly "
                    f"over the {n_dev}-device mesh; pad it to "
                    f"{self.placement.pad(int(a.shape[0]))} first")
        shards = self.preshard(args)
        parts = [prepared(*(s[i] for s in shards)) for i in range(n_dev)]
        return _cat(parts, self.placement.replicated_sharding())

    # --------------------------------------------------------- fetch ----
    def fetch(self, out):
        """The one counted host read of a plan: ``out`` (a tensor, or a
        tuple or list of them) copied to the host, which waits for
        the work that makes it. Counts one fetch however many tensors
        ``out`` holds. The copy runs inside a ``host_read`` range
        (``utils.profiling``)."""
        with stage(HOST_READ):
            host = _to_host(out)
        self.counters().fetches.inc()
        return host
