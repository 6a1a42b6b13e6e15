"""Build-ahead layer: single-flight unit builds, their telemetry, and
the device lists operands are placed on.

Counterpart of ``dpcorr/utils/compile.py``. The JAX package compiles
XLA programs ahead of time so the cost leaves the request path. Eager
torch compiles nothing, so here "ahead of time" means two things:

- the unit is **built**: the engine closure, plus the ``nvcc`` library
  load when the fused kernel (``ops/fused_ni.py``) is on it;
- when the caller passes **example arguments** at the exact dispatch
  shapes, the unit is run once on them and the device synchronized.
  That takes the first-launch costs (lazy CUDA module loading, the
  caching allocator's first segments) off the request path. The warm
  run is timed into ``dpcorr_compile_seconds``; it is no fetch
  (``obs.transfer``) and consumes no key and no ε, because the example
  arguments are made for it and its outputs are dropped. A warm run
  that fails raises: nothing degrades quietly.

The pieces:

- :class:`SingleFlight` — per-key deduplication of concurrent builds
  (the serving kernel cache, the plan executor and the stream's chunk
  functions share it).
- :class:`CompileObserver` — the JAX package's series:
  ``dpcorr_compile_seconds`` (same buckets), ``dpcorr_compile_inflight``,
  ``dpcorr_compile_total{result}`` and
  ``dpcorr_compile_recompile_total{cause}``, plus ``kernel.compile``
  spans.
- :func:`aot_compile` — build (and warm) one unit through an observer.
- :func:`host_sharding` / :func:`mesh_shardings` — the device-list
  counterparts of JAX's shardings: a ``torch.device``, and a (shard
  list, replicated device) pair over ``parallel.mesh.rep_devices``.

``save_exported`` / ``load_exported`` have no counterpart: there is no
serialized eager program. The port's persistent artefact is the
``_build/`` library cache of ``ops/_build.py``, named by a digest of
the source.
"""

from __future__ import annotations

import threading
import time

from dpcorr_torch.obs import trace as obs_trace
from dpcorr_torch.obs.metrics import Registry, default_registry

#: Build-time buckets (seconds), the JAX package's.
COMPILE_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0, 60.0, 120.0, 300.0)

#: Why a build happened (``dpcorr_compile_recompile_total{cause}``), the
#: JAX package's vocabulary: ``new-signature`` — the first build of a
#: signature; ``cache-evict`` — a rebuild after its entry was dropped.
#: ``jit-fallback`` (a failed ahead-of-time compile) cannot happen here:
#: a failed build or warm run raises. A lazy unit
#: (``plan.Executor.lazy_unit``) is no build and records no cause.
RECOMPILE_CAUSES = ("new-signature", "cache-evict", "jit-fallback")


def signature_key(signature) -> tuple:
    """Hashable identity of a build signature dict (sorted items)."""
    return tuple(sorted((str(k), str(v))
                        for k, v in (signature or {}).items()))


class _Flight:
    """One inflight build: the leader publishes ``value``/``error`` then
    sets ``done``; followers wait on it."""

    __slots__ = ("done", "value", "error")

    def __init__(self):
        self.done = threading.Event()
        self.value = None
        self.error = None


class SingleFlight:
    """Per-key build deduplication (Go's ``singleflight`` shape).

    ``do(key, build)`` returns ``(value, leader)``: exactly one caller
    per concurrently-missed key runs ``build`` (leader=True); the rest
    block until it finishes and share the result. A build that raises
    propagates the exception to the leader *and* every waiter, and the
    key is cleared so the next call retries fresh. The leader publishes
    its result *before* the flight is removed, so a caller can install
    the value into its own cache inside ``build`` without a window where
    a third thread re-builds.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._inflight: dict[object, _Flight] = {}  # guarded by: _lock

    def inflight_count(self) -> int:
        with self._lock:
            return len(self._inflight)

    def do(self, key, build):
        with self._lock:
            fl = self._inflight.get(key)
            leader = fl is None
            if leader:
                fl = _Flight()
                self._inflight[key] = fl
        if not leader:
            fl.done.wait()
            if fl.error is not None:
                raise fl.error
            return fl.value, False
        try:
            fl.value = build()
        except BaseException as e:
            fl.error = e
            raise
        finally:
            # publish-then-clear: value/error are set before the flight
            # leaves the map and the event releases the waiters
            with self._lock:
                self._inflight.pop(key, None)
            fl.done.set()
        return fl.value, True


class CompileObserver:
    """The telemetry one consumer's builds report through: a histogram
    of build seconds, an inflight gauge, a per-result counter, a
    per-cause counter, and ``kernel.compile`` spans. Serving passes its
    per-server registry (so /metrics and /stats see the series); the
    grid and the stream use the process default unless given one."""

    def __init__(self, registry: Registry | None = None,
                 tracer: obs_trace.Tracer | None = None):
        self.registry = registry if registry is not None \
            else default_registry()
        self._tracer = tracer
        self.seconds = self.registry.histogram(
            "dpcorr_compile_seconds",
            "Wall seconds per kernel build (build plus warm run)",
            buckets=COMPILE_BUCKETS)
        self.inflight = self.registry.gauge(
            "dpcorr_compile_inflight",
            "Kernel builds currently running")
        self.results = self.registry.counter(
            "dpcorr_compile_total",
            "Kernel builds by outcome",
            labelnames=("result",))
        self.recompiles = self.registry.counter(
            "dpcorr_compile_recompile_total",
            "Kernel builds by cause",
            labelnames=("cause",))
        self._cause_lock = threading.Lock()
        self._seen: set = set()     # guarded by: _cause_lock
        self._evicted: set = set()  # guarded by: _cause_lock

    def note_evicted(self, key) -> None:
        """A consumer's cache dropped this signature's entry: its next
        build is a rebuild caused by eviction, not novelty."""
        with self._cause_lock:
            self._evicted.add(key)

    def classify(self, key, ok: bool = True) -> str:
        """Attribute one build to a :data:`RECOMPILE_CAUSES` cause and
        count it."""
        with self._cause_lock:
            if not ok:
                cause = "jit-fallback"
            elif key in self._evicted or key in self._seen:
                cause = "cache-evict"
            else:
                cause = "new-signature"
            self._seen.add(key)
            self._evicted.discard(key)
        self.recompiles.inc(cause=cause)
        return cause

    def tracer(self) -> obs_trace.Tracer:
        # resolved per call: the process tracer can be configured after
        # a long-lived observer is built
        return self._tracer if self._tracer is not None \
            else obs_trace.tracer()


def _synchronize(args) -> None:
    """Wait for the card(s) the example arguments live on."""
    import torch

    for dev in {a.device for a in args if isinstance(a, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def aot_compile(build, example_args=None, *, signature=None,
                observer: CompileObserver | None = None):
    """Build one unit ahead of its first dispatch and return it.

    ``build()`` returns the callable. With ``example_args`` (the full
    argument tuple at the exact dispatch shapes, on the dispatch
    device) the callable is run once on them, its outputs dropped, and
    the device synchronized. Build and warm run are timed together into
    ``observer`` under a ``kernel.compile`` span labelled with
    ``signature``. A build or warm run that raises propagates."""
    obs = observer if observer is not None else CompileObserver()
    attrs = dict(signature or {})
    obs.inflight.inc()
    t0 = time.perf_counter()
    try:
        with obs.tracer().span("kernel.compile", **attrs) as sp:
            fn = build()
            if example_args is not None:
                fn(*example_args)
                _synchronize(example_args)
            cause = obs.classify(signature_key(signature))
            sp.set(aot=True, warm=example_args is not None, cause=cause)
    finally:
        dt = time.perf_counter() - t0
        obs.inflight.dec()
    obs.seconds.observe(dt)
    obs.results.inc(result="aot")
    return fn


# ------------------------------------------------------- placements ----
def host_sharding(device=None) -> "torch.device":
    """The one device every operand and result of a local plan is placed
    on: ``device``, or the card when none is named (raises without one,
    as every entry point does)."""
    from dpcorr_torch.utils.device import resolve_device

    return resolve_device(device)


def mesh_shardings(devices) -> "tuple[list[torch.device], torch.device]":
    """``(sharded, replicated)`` for a device list
    (``parallel.mesh.rep_devices``): batch axes split into contiguous
    shards, one per entry, and whole operands on the first entry."""
    devices = list(devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return devices, devices[0]
