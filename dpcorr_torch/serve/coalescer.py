"""Micro-batching coalescer: concurrent requests → batched launches.

Counterpart of ``dpcorr/serve/coalescer.py``. The serving analogue of
continuous batching (Orca/vLLM applied to DP query answering): client
threads ``submit()`` single requests;
a dedicated flush thread holds them briefly in per-:class:`BucketKey`
queues and launches each bucket as one batched kernel, trading a
bounded admission latency (``max_delay_s``) for device-side batching.

Flush policy per bucket (first condition wins):

- **size**: the bucket reached ``max_batch`` live requests → flush now.
- **age**: the bucket's OLDEST request has waited ``max_delay_s`` →
  flush whatever is there. A bucket that never fills still answers
  within one delay window.

Within a flushed bucket, requests are grouped by exact n (the batch
geometry follows from n — request.kernel_key) and each group is one
launch of the kernel cache (serve.kernels).

Degradation paths (both recorded in stats, never silent):

- a flush of ONE request runs the cached callable at width 1 — a
  bucket that can't fill costs no batching overhead;
- a batched launch that fails (lowering, OOM, device error) falls back
  to per-request direct execution, so one poisoned lane degrades its
  batch to unbatched service instead of failing every rider; under
  **brownout** (sustained pressure — serve.overload) every flush takes
  this unbatched path up front, keeping launches small and predictable.

Overload discipline — every shed request is an *admitted*
(charged) request dropped **before** its kernel launched, so the
coalescer refunds its charge (``ledger.refund`` with the shed reason)
and the drop provably consumes zero ε:

- **deadline expiry**: a request whose ``deadline_s`` passed while
  queued resolves to :class:`~dpcorr_torch.serve.overload.DeadlineExpiredError`
  at flush time, before any dispatch.
- **priority eviction**: ``submit`` at capacity no longer blindly
  refuses the newcomer — it sheds the pending request with the lowest
  ``(priority, remaining-deadline)`` rank when the newcomer outranks
  it, so a queue full of idle low-priority work cannot starve urgent
  queries. The victim's future gets :class:`ServerOverloadedError`
  with a ``retry_after_s`` estimate.
- **client abandonment**: a future the client managed to ``cancel()``
  (estimate-timeout path, serve.server) is dropped at flush claim time.
- **shutdown**: ``close()`` refuse-drains the queue — every pending
  request resolves to :class:`ServerClosedError` with its charge
  refunded; an answer computed after the front end stopped would spend
  ε on a response nobody reads.

The refusal constructors live in per-reason ``_refuse_*`` helpers next
to their refunds on purpose: each shed path pairs its refusal with its
refund in one place.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import TYPE_CHECKING

import numpy as np

import torch

from dpcorr_torch import chaos
from dpcorr_torch.obs import recorder as obs_recorder
from dpcorr_torch.obs import trace as obs_trace
if TYPE_CHECKING:  # annotation only: the client imports this module
    from dpcorr_torch.serve.kernels import KernelCache
from dpcorr_torch.serve.overload import (
    BrownoutController,
    CircuitBreaker,
    DeadlineExpiredError,
)
from dpcorr_torch.serve.request import (
    EstimateRequest,
    EstimateResponse,
    bucket_key,
    kernel_key,
)
from dpcorr_torch.serve.stats import ServeStats

#: ceiling on the Retry-After estimate — a hint, not a promise.
_MAX_RETRY_AFTER_S = 5.0


class ServerOverloadedError(Exception):
    """Admission refused (queue at capacity) or an admitted request
    evicted by a higher-(priority, urgency) arrival. ``retry_after_s``
    estimates when capacity should free up — surfaced as the HTTP
    ``Retry-After`` header and honored by the retrying client."""

    def __init__(self, msg: str, retry_after_s: float | None = None):
        self.retry_after_s = retry_after_s
        super().__init__(msg)


class ServerClosedError(ServerOverloadedError):
    """The coalescer is shut down; pending work was refuse-drained."""


@dataclasses.dataclass
class _Pending:
    req: EstimateRequest
    key: torch.Tensor  # (words,) int64 key of this request's noise stream
    seed: int
    future: Future
    t_enq: float
    #: the request's root span (serve.request), opened on the client
    #: thread at admission and ended here when the future resolves —
    #: how one trace ID links admission to flush across threads. The
    #: disabled tracer's null span when tracing is off.
    span: object = obs_trace._NULL_SPAN
    #: shedding rank (request.priority) — higher survives eviction
    priority: int = 0
    #: absolute perf_counter deadline, or None for no deadline
    t_deadline: float | None = None
    #: what admission charged, so a pre-launch drop can refund exactly
    charges: dict | None = None
    #: the charge's durable idempotency id (fleet retries): a refund
    #: must forget it so a genuinely new attempt can charge again
    charge_id: str | None = None
    #: the request's CostRecord (obs.cost), opened at admission and
    #: filled in here: queue wait at the claim boundary, compile wait
    #: and an even share of kernel time at launch, shed events + ε
    #: refunds on every refusal path. None when the server runs
    #: without cost attribution.
    cost: object = None

    def rank(self, now: float) -> tuple:
        """Eviction order: cancelled futures are free victims, then
        lowest priority, then least remaining deadline slack."""
        slack = (self.t_deadline - now if self.t_deadline is not None
                 else float("inf"))
        return (not self.future.cancelled(), self.priority, slack)


class Coalescer:
    def __init__(self, cache: KernelCache, stats: ServeStats,
                 max_batch: int = 64, max_delay_s: float = 0.005,
                 max_queue: int = 4096,
                 tracer: obs_trace.Tracer | None = None,
                 ledger=None, breaker: CircuitBreaker | None = None,
                 brownout: BrownoutController | None = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.cache = cache
        self.stats = stats
        self.tracer = tracer if tracer is not None else obs_trace.tracer()
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.max_queue = max_queue
        #: refund sink for shed requests (None → charges are the
        #: caller's problem)
        self.ledger = ledger
        self.breaker = breaker
        self.brownout = brownout
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._buckets: dict[tuple, list[_Pending]] = {}  # guarded by: _cond
        self._depth = 0  # guarded by: _cond
        self._closed = False  # guarded by: _cond
        self._thread = threading.Thread(target=self._flush_loop,
                                        name="dpcorr-serve-flush",
                                        daemon=True)
        self._thread.start()

    # -- admission -------------------------------------------------------
    def submit(self, req: EstimateRequest, key, seed: int,
               span=None, charges: dict | None = None,
               cost=None, charge_id: str | None = None) -> Future:
        """Enqueue one admitted request; resolves to EstimateResponse.
        ``span`` is the request's root span (or None/null when
        untraced); it rides the queue so the flush thread can parent
        its spans under the same trace ID. ``charges`` is what
        admission charged the ledger — carried so any pre-launch shed
        can refund it (``charge_id`` rides along so the refund forgets
        the durable retry id — without that, the NEXT attempt of the
        shed request would dedup against a charge that was just
        reversed and execute unpaid). ``cost`` is the request's
        CostRecord, filled in on the flush thread."""
        fut: Future = Future()
        now = time.perf_counter()
        t_deadline = (now + req.deadline_s if req.deadline_s is not None
                      else None)
        p = _Pending(req, key, seed, fut, now,
                     span if span is not None else obs_trace._NULL_SPAN,
                     priority=req.priority, t_deadline=t_deadline,
                     charges=charges, cost=cost, charge_id=charge_id)
        victim = None
        retry_after = None
        with self._cond:
            if self._closed:
                raise ServerClosedError("coalescer is closed")
            if self._depth >= self.max_queue:
                victim = self._pick_victim_locked(p, now)
                if victim is None:
                    self.stats.refused_overload()
                    raise ServerOverloadedError(
                        f"{self._depth} requests pending >= max_queue="
                        f"{self.max_queue}",
                        retry_after_s=self._retry_after_locked())
                retry_after = self._retry_after_locked()
            self._buckets.setdefault(bucket_key(req), []).append(p)
            self._depth += 1
            self.stats.set_queue_depth(self._depth)
            self._observe_pressure_locked()
            self._cond.notify()
        if victim is not None:
            self._refuse_evicted(victim, retry_after)
        return fut

    def _pick_victim_locked(self, incoming: _Pending,
                            now: float) -> _Pending | None:
        """At capacity: the lowest-ranked pending request, removed from
        its bucket — but only when the newcomer STRICTLY outranks it
        (equal-rank arrivals are refused, preserving FIFO fairness
        within a priority class)."""
        best = best_rank = best_loc = None
        for bkey, q in self._buckets.items():
            for i, p in enumerate(q):
                rank = p.rank(now)
                if best_rank is None or rank < best_rank:
                    best, best_rank, best_loc = p, rank, (bkey, i)
        if best is None or not best_rank < incoming.rank(now):
            return None
        bkey, i = best_loc
        q = self._buckets[bkey]
        q.pop(i)
        if not q:
            del self._buckets[bkey]
        self._depth -= 1
        return best

    def _retry_after_locked(self) -> float:
        """Back-of-envelope drain estimate: flushes left in the queue
        times the observed (EWMA) flush duration."""
        per_flush = max(self.stats.flush_ewma(), self.max_delay_s)
        flushes = self._depth / max(self.max_batch, 1) + 1.0
        return min(flushes * per_flush, _MAX_RETRY_AFTER_S)

    def retry_after_s(self) -> float:
        with self._cond:
            return self._retry_after_locked()

    def _observe_pressure_locked(self) -> None:
        if self.brownout is not None:
            self.brownout.observe(self._depth / max(self.max_queue, 1),
                                  self.stats.flush_ewma())

    def observe_pressure(self) -> None:
        """Feed the brownout controller the CURRENT queue pressure —
        called from the admission gate so the hysteresis clock keeps
        moving even when every arrival is refused before enqueue
        (otherwise brownout could latch active after the queue drains,
        refusing low-priority work forever)."""
        with self._cond:
            self._observe_pressure_locked()

    # -- shed refusals (refund + resolve, one helper per reason) ---------
    def _refund(self, p: _Pending, reason: str) -> None:
        """Reverse the shed request's admission charge — valid exactly
        because every caller drops ``p`` BEFORE any kernel launched
        (ledger.refund contract)."""
        if self.ledger is not None and p.charges:
            self.ledger.refund(p.charges, trace_id=p.span.trace_id,
                               charge_id=p.charge_id, reason=reason)
        if p.cost is not None:
            p.cost.event(reason)
            if p.charges:
                p.cost.refund(p.charges, reason)

    def _refuse_evicted(self, p: _Pending,
                        retry_after: float | None) -> None:
        self._refund(p, "queue_evict")
        self.stats.shed("queue_evict")
        if p.future.set_running_or_notify_cancel():
            p.future.set_exception(ServerOverloadedError(
                "evicted from the pending queue by a higher-priority "
                "arrival", retry_after_s=retry_after))
        p.span.set(refused="queue_evict")
        p.span.end()

    def _refuse_expired(self, p: _Pending, now: float) -> None:
        self._refund(p, "expired")
        self.stats.shed("expired")
        late_ms = (now - p.t_deadline) * 1e3
        p.future.set_exception(DeadlineExpiredError(
            f"deadline_s={p.req.deadline_s} expired {late_ms:.1f} ms "
            "before the kernel launched (charge refunded)",
            retry_after_s=self.retry_after_s()))
        p.span.set(refused="expired")
        p.span.end()

    def _refuse_closed(self, p: _Pending) -> None:
        self._refund(p, "closed")
        self.stats.shed("closed")
        if p.future.set_running_or_notify_cancel():
            p.future.set_exception(ServerClosedError(
                "server shut down before this request launched "
                "(charge refunded)"))
        p.span.set(refused="closed")
        p.span.end()

    def _drop_cancelled(self, p: _Pending) -> None:
        """The client's ``cancel()`` won the claim race: it already
        sees CancelledError; the request never launched, so the charge
        reverses like any other shed."""
        self._refund(p, "cancelled")
        self.stats.shed("cancelled")
        p.span.set(refused="cancelled")
        p.span.end()

    # -- flush thread ----------------------------------------------------
    def _take_ready_locked(self, now: float) -> list[list[_Pending]]:
        """Pop every bucket that is full or whose head has aged out."""
        ready = []
        for bkey in list(self._buckets):
            q = self._buckets[bkey]
            if (len(q) >= self.max_batch
                    or now - q[0].t_enq >= self.max_delay_s):
                ready.append(q[: self.max_batch])
                rest = q[self.max_batch:]
                if rest:
                    self._buckets[bkey] = rest
                else:
                    del self._buckets[bkey]
        return ready

    def _next_deadline_locked(self) -> float | None:
        heads = [q[0].t_enq for q in self._buckets.values()]
        return min(heads) + self.max_delay_s if heads else None

    def _flush_loop(self) -> None:
        while True:
            with self._cond:
                while True:
                    if self._closed:
                        # close() refuse-drains the queue itself; the
                        # flush thread just stops picking up work
                        return
                    now = time.perf_counter()
                    ready = self._take_ready_locked(now)
                    if ready:
                        break
                    deadline = self._next_deadline_locked()
                    self._cond.wait(timeout=None if deadline is None
                                    else max(deadline - now, 1e-4))
                n_taken = sum(len(g) for g in ready)
                self._depth -= n_taken
                self.stats.set_queue_depth(self._depth)
            for group in ready:
                try:
                    self._flush(group)
                except Exception as e:
                    # a bug in the flush path must not kill the flush
                    # thread (every later request would hang): fail the
                    # group's unresolved futures, dump the flight
                    # recorder, keep serving. SimulatedCrash is a
                    # BaseException on purpose — chaos kills still kill.
                    logging.getLogger("dpcorr.serve").exception(
                        "unhandled error flushing group of %d",
                        len(group))
                    obs_recorder.trigger(
                        "coalescer_unhandled",
                        error=type(e).__name__, detail=str(e),
                        group_size=len(group))
                    for p in group:
                        if p.future.done():
                            continue  # resolved before the error
                        self.stats.failed()
                        if p.cost is not None:
                            p.cost.event(
                                f"flush_error:{type(e).__name__}")
                        p.future.set_running_or_notify_cancel()
                        try:
                            p.future.set_exception(e)
                        except InvalidStateError:
                            pass
                        p.span.set(error=type(e).__name__)
                        p.span.end()

    # -- execution -------------------------------------------------------
    def _claim_live(self, group: list[_Pending]) -> list[_Pending]:
        """The pre-launch boundary: claim each pending future (after
        which a client ``cancel()`` can no longer race a resolution),
        dropping the already-cancelled and the deadline-expired — both
        refunded, neither reaches a kernel."""
        now = time.perf_counter()
        live = []
        for p in group:
            if not p.future.set_running_or_notify_cancel():
                self._drop_cancelled(p)
                continue
            if p.t_deadline is not None and now >= p.t_deadline:
                self._refuse_expired(p, now)
                continue
            if p.cost is not None:
                # claim boundary = end of queue wait: everything after
                # this point is compile/kernel/fetch work
                p.cost.set_queue_wait(now - p.t_enq)
            live.append(p)
        return live

    def _flush(self, group: list[_Pending]) -> None:
        """Run one flushed bucket: launch every exact-n subgroup,
        resolving futures with responses.

        Span model: every rider gets its own
        ``serve.flush`` span parented under its request's trace, so one
        trace ID follows the request from admission into the launch
        that served it; the physical launch itself is one
        ``serve.kernel`` span (dispatch through fetch barrier) under
        the first rider's flush span, carrying the batch size (dispatch
        through the launch's one device read)."""
        # crash points bracketing the launch: pre_flush models a crash
        # after charge but before any kernel ran (budget wasted, nothing
        # leaked — server module docstring), post_flush one after the
        # answers landed but before the client read them
        chaos.point("coalescer.pre_flush")
        chaos.fault("serve.flush_stall")
        t0 = time.perf_counter()
        group = self._claim_live(group)
        if not group:
            chaos.point("coalescer.post_flush")
            return
        by_kernel: dict[tuple, list[_Pending]] = {}
        for p in group:
            by_kernel.setdefault(kernel_key(p.req), []).append(p)
        browned = self.brownout is not None and self.brownout.active()

        launches = []
        for kkey, ps in by_kernel.items():
            # flush spans ride the launch list; each ends when its
            # future resolves
            # dpcorr-lint: ignore[span-no-finally] — flush spans ride the launch list; each ends when its future resolves
            fspans = [self.tracer.start_span(
                "serve.flush", parent=p.span.context,
                family=kkey.family, n=kkey.n, batch_size=len(ps))
                for p in ps]
            if browned and len(ps) > 1:
                # brownout: skip the batched machinery up front —
                # small, predictable unbatched launches under pressure
                launches.append((kkey, ps, None, fspans, None, None, 0.0))
                continue
            # the kernel span covers dispatch → fetch; it ends at the
            # fetch barrier below
            # dpcorr-lint: ignore[span-no-finally] — kernel span spans dispatch→fetch; ends at the fetch barrier below
            ksp = self.tracer.start_span(
                "serve.kernel", parent=fspans[0],
                family=kkey.family, n=kkey.n, batch_size=len(ps))
            t_disp = time.perf_counter()
            try:
                raw = self._dispatch(kkey, ps)
            except Exception:
                # batched dispatch failed — degrade this subgroup
                raw = None
                ksp.set(error="dispatch")
            compile_s = self.cache.last_compile_wait_s()
            launches.append((kkey, ps, raw, fspans, ksp, t_disp,
                             compile_s))

        for kkey, ps, raw, fspans, ksp, t_disp, compile_s in launches:
            batched = len(ps) > 1 and raw is not None
            if raw is not None:
                try:
                    raw = tuple(np.asarray(a) for a in raw)  # fetch barrier
                except Exception:
                    raw, batched = None, False
                    ksp.set(error="fetch")
            if ksp is not None:
                ksp.end()
            if raw is None:
                self._flush_unbatched(kkey, ps, fspans)
                continue
            if self.breaker is not None:
                self.breaker.record_success(bucket_key(ps[0].req))
            self.stats.flushed(len(ps), batched=batched)
            t_done = time.perf_counter()
            # kernel attribution: one histogram observation per launch
            # (dispatch → fetch barrier, compile wait excluded), divided
            # evenly across the riders so the sum of per-request shares
            # equals the histogram total (serve_load --cost gate)
            kernel_s = max(t_done - t_disp - compile_s, 0.0)
            self.stats.observe_kernel(kernel_s)
            share = kernel_s / len(ps)
            for j, p in enumerate(ps):
                lat = t_done - p.t_enq
                self.stats.observe_latency(lat,
                                           trace_id=p.span.trace_id)
                if p.cost is not None:
                    p.cost.add_kernel(share)
                    if compile_s > 0.0:
                        # every rider waited out the whole compile
                        p.cost.add_compile_wait(compile_s)
                p.future.set_result(EstimateResponse(
                    rho_hat=float(raw[0][j]), ci_low=float(raw[1][j]),
                    ci_high=float(raw[2][j]), batched=batched,
                    batch_size=len(ps), latency_s=lat, seed=p.seed,
                    cost=(p.cost.to_dict() if p.cost is not None
                          else None)))
                fspans[j].set(batched=batched)
                fspans[j].end()
                # the respond point: the request's root span closes with
                # its end-to-end latency
                p.span.set(latency_s=lat, batch_size=len(ps),
                           batched=batched)
                p.span.end()
        self.stats.observe_flush(time.perf_counter() - t0)
        with self._cond:
            self._observe_pressure_locked()
        chaos.point("coalescer.post_flush")

    def _dispatch(self, kkey, ps: list[_Pending]):
        """Launch one exact-n subgroup."""
        if len(ps) == 1:
            # graceful degradation: a bucket that never filled runs the
            # cached callable at width 1, no padding overhead
            return self._run_direct(kkey, ps[0])
        keys = torch.stack([p.key for p in ps])
        xs = np.stack([p.req.x for p in ps])
        ys = np.stack([p.req.y for p in ps])
        return self.cache.run_batch(kkey, keys, xs, ys)

    def _run_direct(self, kkey, p: _Pending):
        """The unbatched path: the cached batch callable at width 1 (one
        signature shared by every singleton flush of this bucket, and by
        the batch-failure fallback)."""
        return self.cache.run_batch(kkey, torch.stack([p.key]),
                                    np.stack([p.req.x]),
                                    np.stack([p.req.y]))

    def _flush_unbatched(self, kkey, ps: list[_Pending],
                         fspans=None) -> None:
        """Batch-path failure fallback (and the brownout fast path):
        serve each rider individually; only requests that fail on
        their own fail. Per-request outcomes feed the circuit breaker
        — this is where consecutive kernel failures accumulate into a
        bucket trip (serve.overload)."""
        bkey = bucket_key(ps[0].req)
        for idx, p in enumerate(ps):
            sp = fspans[idx] if fspans else obs_trace._NULL_SPAN
            sp.set(degraded=True)
            try:
                t_disp = time.perf_counter()
                raw = self._run_direct(kkey, p)
                raw = tuple(np.asarray(a) for a in raw)  # fetch barrier
                t_done = time.perf_counter()
                compile_s = self.cache.last_compile_wait_s()
                kernel_s = max(t_done - t_disp - compile_s, 0.0)
                self.stats.observe_kernel(kernel_s)
                self.stats.flushed(1, batched=False)
                lat = t_done - p.t_enq
                self.stats.observe_latency(lat,
                                           trace_id=p.span.trace_id)
                if p.cost is not None:
                    p.cost.event("degraded_unbatched")
                    p.cost.add_kernel(kernel_s)
                    if compile_s > 0.0:
                        p.cost.add_compile_wait(compile_s)
                p.future.set_result(EstimateResponse(
                    rho_hat=float(raw[0][0]), ci_low=float(raw[1][0]),
                    ci_high=float(raw[2][0]), batched=False,
                    batch_size=1, latency_s=lat, seed=p.seed,
                    cost=(p.cost.to_dict() if p.cost is not None
                          else None)))
                sp.end()
                p.span.set(latency_s=lat, batch_size=1, batched=False)
                p.span.end()
                if self.breaker is not None:
                    self.breaker.record_success(bkey)
            except Exception as e:
                self.stats.failed()
                if p.cost is not None:
                    p.cost.event(f"kernel_error:{type(e).__name__}")
                p.future.set_exception(e)
                sp.set(error=type(e).__name__)
                sp.end()
                p.span.set(error=type(e).__name__)
                p.span.end()
                if self.breaker is not None:
                    self.breaker.record_failure(bkey)

    # -- lifecycle -------------------------------------------------------
    def close(self, timeout: float = 30.0) -> None:
        """Stop admitting, refuse-drain pending requests, join the
        flush thread; raises if the thread fails to stop.

        Draining means REFUSING, not executing: each pending request
        resolves to :class:`ServerClosedError` with its charge
        refunded. Executing them would spend ε computing answers for
        clients the shutdown is about to disconnect — the retrying
        client re-runs them against a live replica instead."""
        with self._cond:
            self._closed = True
            drained = [p for q in self._buckets.values() for p in q]
            self._buckets.clear()
            self._depth = 0
            self.stats.set_queue_depth(0)
            self._cond.notify()
        for p in drained:
            self._refuse_closed(p)
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise RuntimeError(
                f"coalescer flush thread did not stop within {timeout}s")
