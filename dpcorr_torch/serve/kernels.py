"""Kernel cache + batched execution for the serving layer.

Counterpart of ``dpcorr/serve/kernels.py``. The cache is keyed on the
**kernel signature** ``(KernelKey, padded batch width, shards)``, and
the batch axis is padded to the next power of two, so a bucket that
flushes at 13 requests and one that flushes at 16 share one entry.

An entry is a plan unit (``dpcorr_torch.plan``) over the
:func:`~dpcorr_torch.models.estimators.registry.serving_entry` closure
of its bucket wrapped in a batch engine
(:func:`~dpcorr_torch.models.estimators.registry.batch_engine`). Builds
and dispatches go through one local-placement ``plan.Executor``:

- misses are **single-flight** (``utils.compile.SingleFlight``):
  concurrent misses for one signature wait on one build, counted as
  ``kernel_compile_dedup``; hits and builds are counted as
  ``kernel_hits`` / ``kernel_compiles``;
- with ``aot`` on (the default) an entry is built through
  ``Executor.prepare``: timed into the server registry's
  ``dpcorr_compile_seconds`` with its cause in
  ``dpcorr_compile_recompile_total{cause}`` and a ``kernel.compile``
  span. The warmup set (serve.warmup) passes example arguments, so a
  warm signature also runs once and pays its first launch before
  ``/readyz`` turns 200; a cold miss on the request path builds without
  that run, so a first flush never computes twice. With ``aot`` off an
  entry is a lazy unit: nothing is timed or counted;
- each flush is one plan: operands placed on the device
  (``plan.preshard``), one dispatch, one counted host read
  (``obs.transfer`` fetches);
- the live entries are bounded by ``max_kernels`` with LRU eviction, so
  a client sweeping sample sizes cannot grow the cache without limit;
- :meth:`KernelCache.manifest` lists the resident signatures, the warm
  set a server persists on shutdown (serve.warmup).

Two batch engines (the lane contract in estimators.registry):

- ``mode="exact"`` (default): the single call on each live lane in
  turn, every lane bit-equal to the direct single call on the same
  device. Padding lanes would replicate lane 0 and be thrown away, so
  this engine runs only the live lanes; the padded width still keys
  the cache.
- ``mode="vector"``: one call over the padded lane axis (padding lanes
  replicate lane 0 and are truncated before results leave this module).

When the cache holds more than one device, flushes whose padded width
splits evenly over them run through
``parallel.make_serve_batch_sharded``: the lane axis split into
contiguous shards, one per device, each engine's contract kept.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from dpcorr_torch import chaos
from dpcorr_torch import plan as plan_mod
from dpcorr_torch.models.estimators.registry import (
    ENGINES,
    batch_engine,
    serving_entry,
)
from dpcorr_torch.serve.request import KernelKey
from dpcorr_torch.serve.stats import ServeStats
from dpcorr_torch.utils import compile as compile_mod
from dpcorr_torch.utils.compile import SingleFlight  # noqa: F401
from dpcorr_torch.utils.device import resolve_device


def pad_batch(b: int) -> int:
    """Next power of two ≥ b: the batch-width bucket."""
    return 1 << (b - 1).bit_length() if b > 1 else 1


def _pad_rows(a: torch.Tensor, b_pad: int) -> torch.Tensor:
    """Pad the leading axis to ``b_pad`` lanes replicating row 0."""
    if a.shape[0] == b_pad:
        return a
    return torch.cat([a, a[:1].expand(b_pad - a.shape[0], *a.shape[1:])])


class KernelCache:
    """(KernelKey, b_pad, shards) → batched plan unit on ``device`` (the
    card unless the caller names another; raises without one).

    ``devices`` is the list the lane axis may shard over (default: every
    card, or one CPU entry; ``parallel.rep_devices``). ``aot=False``
    builds lazy units (no build telemetry, no warm runs), for A/B runs.
    ``_compile_hook`` (test seam) is invoked by the *leader* build of
    each signature, so a thread-race test can count actual builds.
    """

    def __init__(self, stats: ServeStats | None = None,
                 shard: str = "auto", mode: str = "exact",
                 max_kernels: int = 128, aot: bool = True, tracer=None,
                 device=None, devices=None):
        if shard not in ("auto", "off"):
            raise ValueError(f"shard must be 'auto' or 'off', got {shard!r}")
        if mode not in ENGINES:
            raise ValueError(f"mode must be 'exact' or 'vector', got {mode!r}")
        if max_kernels < 1:
            raise ValueError(f"max_kernels must be >= 1, got {max_kernels}")
        self.stats = stats or ServeStats()
        self.shard = shard
        self.mode = mode
        self.max_kernels = max_kernels
        self.aot = bool(aot)
        self.device = resolve_device(device)
        if devices is None:
            from dpcorr_torch.parallel.mesh import rep_devices

            devices = rep_devices(device=self.device)
        self.devices = list(devices)
        # the cache's build/dispatch/fetch engine: one local-placement
        # plan executor whose observer reports into the server's registry
        self._plan = plan_mod.Executor(
            "local", device=self.device,
            observer=compile_mod.CompileObserver(
                registry=self.stats.registry, tracer=tracer))
        self._cobs = self._plan.observer
        self._flight = self._plan.flight
        self._compile_hook: Callable | None = None  # test seam
        self._lock = threading.Lock()
        self._fns: OrderedDict[tuple, Callable] = OrderedDict()  # guarded by: _lock
        # per-thread build wait of the most recent get(): zero on a hit,
        # the blocked time on a miss. Thread-local so the warmup thread's
        # gets never clobber the flush thread's cost attribution.
        self._tls = threading.local()

    def last_compile_wait_s(self) -> float:
        """Build wait of the calling thread's most recent ``get``."""
        return getattr(self._tls, "compile_wait_s", 0.0)

    def _n_shards(self, b_pad: int) -> int:
        """How many devices this launch uses (1 = unsharded): all of
        them when the padded axis splits evenly with at least one lane
        per device, else one."""
        if self.shard == "off":
            return 1
        n_dev = len(self.devices)
        return n_dev if n_dev > 1 and b_pad % n_dev == 0 else 1

    def get(self, kkey: KernelKey, b_pad: int,
            example_args=None) -> tuple[Callable, int]:
        """The batched unit for this signature + its shard count.

        Misses are single-flight: one build per concurrently-missed
        signature, followers share the leader's result (and count into
        ``kernel_compile_dedup`` instead of compiles/hits).
        ``example_args`` (host ``(keys, xs, ys)`` at the dispatch shape,
        serve.warmup's) give a miss its warm run when ``aot`` is on; a
        hit ignores them."""
        shards = self._n_shards(b_pad)
        cache_key = (kkey, b_pad, shards)
        self._tls.compile_wait_s = 0.0
        with self._lock:
            fn = self._fns.get(cache_key)
            if fn is not None:
                self._fns.move_to_end(cache_key)  # LRU freshness
                self.stats.kernel(hit=True)
                return fn, shards

        def build():
            # leader path: build, then install under the cache lock
            # BEFORE the flight completes, so no third thread can miss
            # in between and rebuild
            fn = self._build(kkey, b_pad, shards, example_args)
            with self._lock:
                self._fns[cache_key] = fn
                self._fns.move_to_end(cache_key)
                while len(self._fns) > self.max_kernels:
                    evk, _ = self._fns.popitem(last=False)  # evict LRU
                    # a later build of this signature is a rebuild
                    # caused by eviction, not a new signature
                    self._cobs.note_evicted(compile_mod.signature_key(
                        self._signature(*evk)))
                self.stats.kernel(hit=False)
                self.stats.set_kernel_cache_size(len(self._fns))
            return fn

        t_miss = time.perf_counter()
        fn, leader = self._flight.do(cache_key, build)
        self._tls.compile_wait_s = time.perf_counter() - t_miss
        if not leader:
            self.stats.kernel_dedup()
        return fn, shards

    def _signature(self, kkey: KernelKey, b_pad: int, shards: int) -> dict:
        return {"family": kkey.family, "n": kkey.n,
                "eps1": kkey.eps1, "eps2": kkey.eps2,
                "b_pad": b_pad, "shards": shards, "mode": self.mode}

    def _build(self, kkey: KernelKey, b_pad: int, shards: int,
               example_args=None) -> plan_mod.Prepared:
        if self._compile_hook is not None:
            self._compile_hook((kkey, b_pad, shards))

        def engine():
            single = serving_entry(kkey.family, kkey.eps1, kkey.eps2,
                                   alpha=kkey.alpha,
                                   normalise=kkey.normalise,
                                   device=self.device)
            if shards > 1:
                from dpcorr_torch.parallel.backend import (
                    make_serve_batch_sharded,
                )

                return make_serve_batch_sharded(
                    single, self.devices[:shards], engine=self.mode)
            return batch_engine(single, self.mode)

        sig = self._signature(kkey, b_pad, shards)
        if not self.aot:
            return self._plan.lazy_unit(engine(), signature=sig)
        if example_args is not None:
            example_args = self._plan.preshard(example_args)
        # the LRU owns unit lifetime, so the executor's own unit cache is
        # off; the single flight in `get` already dedups concurrent builds
        return self._plan.prepare((kkey, b_pad, shards), engine,
                                  example_args, signature=sig, cache=False)

    # ------------------------------------------------------- warm set ----
    def manifest(self) -> list[dict]:
        """The resident kernel signatures, JSON-shaped — what the server
        persists on shutdown and replays as the next boot's warmup set
        (serve.warmup)."""
        with self._lock:
            sigs = list(self._fns.keys())
        return [{"family": k.family, "n": k.n, "eps1": k.eps1,
                 "eps2": k.eps2, "alpha": k.alpha,
                 "normalise": k.normalise, "b_pad": b_pad}
                for (k, b_pad, _shards) in sigs]

    # ------------------------------------------------------ execution ----
    def run_batch(self, kkey: KernelKey, keys, xs: np.ndarray,
                  ys: np.ndarray) -> tuple[np.ndarray, ...]:
        """Execute one flushed launch: pad the batch axis (vector engine),
        place the operands, run the cached unit, read the results back
        once, truncate. ``keys``: (b, words) int64 keys; ``xs``/``ys``:
        (b, n) float32. Returns (rho_hat, ci_low, ci_high) as (b,) numpy
        arrays."""
        # fault sites (chaos.FAULT_POINTS): a planned SimulatedFault here
        # stands in for a launch error / device OOM, a planned sleep for
        # a kernel blowing its latency budget — both land before the
        # launch so no lane ever half-executes
        chaos.fault("serve.kernel_slow")
        chaos.fault("serve.kernel")
        b = xs.shape[0]
        b_pad = pad_batch(b)
        fn, _shards = self.get(kkey, b_pad)
        keys = torch.as_tensor(keys, dtype=torch.int64)
        xs = torch.from_numpy(np.ascontiguousarray(xs, dtype=np.float32))
        ys = torch.from_numpy(np.ascontiguousarray(ys, dtype=np.float32))
        if self.mode == "vector":
            keys, xs, ys = (_pad_rows(a, b_pad) for a in (keys, xs, ys))
        # one plan per flush: operands placed on the device, one
        # dispatch, one counted host read
        out = self._plan.dispatch(fn, (keys, xs, ys))
        host = self._plan.fetch(torch.stack(out)).numpy()
        return tuple(host[j, :b] for j in range(3))
