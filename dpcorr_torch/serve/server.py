"""The online DP-correlation server: admission → ledger → coalescer.

Counterpart of ``dpcorr/serve/server.py``. :class:`DpcorrServer` is the
in-process composition root the tests drive directly;
:func:`serve_http` wraps it in a stdlib threaded HTTP front end
for ``python -m dpcorr_torch serve``:

- ``POST /estimate`` — one request (JSON body; arrays as lists) →
  estimate, or 403 (budget refused) / 429 (overloaded or shed, with
  ``Retry-After``) / 503 (circuit breaker open, with ``Retry-After``)
  / 504 (deadline expired before launch, charge refunded) / 400
  (invalid).
- ``GET /stats`` — live counters + ledger snapshot (serve.stats shape).
- ``GET /metrics`` — the same counters as Prometheus text.
- ``GET /healthz`` — liveness.
- ``GET /readyz`` — readiness: 503 until the warmup signature set is
  resident (serve.warmup) and 503 again while any circuit breaker is
  open, 200 otherwise.

Admission order is the privacy invariant: the ledger is charged (and
durably persisted) BEFORE the request is enqueued, so no query ever
computes without its spend on disk; a crash after charge and before
answer wastes budget rather than leaking it (ledger module docstring).
The one exception is a request the enqueue itself refuses (queue
backpressure / closed coalescer): no kernel ran and nothing was
released, so the charge is reversed before the refusal propagates —
overload sheds load, it must not drain budgets.

Request noise streams extend the key-tree (utils.rng) with two disjoint
named subtrees under the server's master key, the JAX package's keys bit
for bit. Two admissions NEVER share a noise stream unless they are the
same query — a repeated stream over different data lets a client
difference the Laplace noise away, voiding the ledger's composition
accounting:

- **pinned** (``req.seed`` set): ``stream(master, "serve/pinned") →
  fold_in(seed) → fold_in(sha256(request content))`` — see
  :func:`pinned_request_key`. Replaying the same seed with the SAME
  request is exactly reproducible; the same seed over different data
  lands on an independent stream.
- **assigned** (``req.seed is None``): ``stream(master, "serve/boot")
  → fold_in(boot nonce) → fold_in(admission counter)``. The nonce is
  drawn fresh from the OS CSPRNG at every server construction, so
  counter reuse across restarts cannot repeat a stream, and assigned
  streams can never collide with the pinned subtree.

A request key is ten ``fold_in``s of the master key's two or four 32-bit
words (threefry2x32, or an rbg-family impl under ``DPCORR_PRNG``). They
are derived at admission on the host, in Python ints
(``rng.fold_in_words``, bit-equal to the tensor ``fold_in``; a host
Philox under unsafe_rbg): on the card each tensor op would be a launch,
about 1,600 of them per key. The flushed keys go to the device with the
data; the estimator and its noise run there.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import logging
import secrets
import threading
from collections import OrderedDict
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as _FuturesTimeout

import numpy as np
import torch

from dpcorr_torch import chaos
from dpcorr_torch.obs import recorder as obs_recorder
from dpcorr_torch.obs import trace as obs_trace
from dpcorr_torch.obs.audit import AuditTrail
from dpcorr_torch.obs.cost import CostRegistry
from dpcorr_torch.obs.metrics import CONTENT_TYPE as _PROM_CONTENT_TYPE
from dpcorr_torch.serve import warmup as warmup_mod
from dpcorr_torch.serve.budget_dir import (
    BudgetDirectory,
    CompositeLedger,
    RenewalPolicy,
    party_view,
)
from dpcorr_torch.serve.coalescer import Coalescer, ServerOverloadedError
from dpcorr_torch.serve.fleet.lease import ShardNotOwnedError
from dpcorr_torch.serve.kernels import KernelCache
from dpcorr_torch.serve.ledger import BudgetExceededError, PrivacyLedger
from dpcorr_torch.serve.overload import (
    BrownoutController,
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExpiredError,
    _bucket_label,
)
from dpcorr_torch.serve.request import (
    EstimateRequest,
    EstimateResponse,
    bucket_key,
)
from dpcorr_torch.serve.stats import ServeStats
from dpcorr_torch.utils import rng
from dpcorr_torch.utils.device import resolve_device

log = logging.getLogger("dpcorr.serve")


def request_digest(req: EstimateRequest) -> bytes:
    """SHA-256 over the request's kernel inputs — everything the noise
    touches is digested (family, ε, α, normalise, the data vectors);
    party names are not, as they only route budget accounting. Feeds
    both the pinned-key derivation words and the default idempotency
    key, so "same content" means the same thing in both places."""
    h = hashlib.sha256()
    h.update(req.family.encode())
    h.update(np.asarray([req.eps1, req.eps2, req.alpha],
                        dtype=np.float64).tobytes())
    h.update(b"\x01" if req.normalise else b"\x00")
    h.update(req.x.tobytes())
    h.update(req.y.tobytes())
    return h.digest()


def request_digest_words(req: EstimateRequest) -> tuple[int, ...]:
    """The request digest as eight 31-bit ``fold_in`` words — a 248-bit
    content binding, far past birthday range for any realistic query
    volume."""
    d = request_digest(req)
    return tuple(int.from_bytes(d[4 * i:4 * i + 4], "big") & 0x7FFFFFFF
                 for i in range(8))


def _key_tensor(words) -> torch.Tensor:
    return torch.tensor(words, dtype=torch.int64)


def _master_words(master) -> tuple[int, ...]:
    # every word, two or four: a four-word key is folded as its impl
    return tuple(int(v) for v in
                 rng.key_data(torch.as_tensor(master)).tolist())


def pinned_request_key(master, req: EstimateRequest,
                       seed: int) -> torch.Tensor:
    """Noise key for a client-pinned seed: the seed folded into the
    dedicated pinned subtree, then bound to the request content, so a
    seed replayed over different data yields an independent stream (the
    anti-differencing guarantee) while an identical request stays
    exactly reproducible. ``master`` is a port key; returns the
    (words,) int64 key on the CPU, bit-equal to
    ``dpcorr.serve.server.pinned_request_key``."""
    # dpcorr-lint: ignore[rng-raw-api] — rng.stream on host words: no launch, bit-equal to the JAX key
    w = rng.fold_in_words(_master_words(master),
                          rng.stream_index("serve/pinned"))
    # dpcorr-lint: ignore[rng-raw-api] — rng.design_key on host words, as above
    w = rng.fold_in_words(w, seed)
    for d in request_digest_words(req):
        # dpcorr-lint: ignore[rng-raw-api] — rng.design_key on host words, as above
        w = rng.fold_in_words(w, d)
    return _key_tensor(w)


def boot_request_key(master, nonce: int, counter: int) -> torch.Tensor:
    """Noise key of a server-assigned stream: ``stream(master,
    "serve/boot") → fold_in(nonce) → fold_in(counter)``, on the CPU."""
    # dpcorr-lint: ignore[rng-raw-api] — rng.stream on host words, as above
    w = rng.fold_in_words(_master_words(master),
                          rng.stream_index("serve/boot"))
    # dpcorr-lint: ignore[rng-raw-api] — rng.design_key twice on host words, as above
    return _key_tensor(rng.fold_in_words(rng.fold_in_words(w, nonce),
                                         counter))


class DpcorrServer:
    """In-process serving stack on ``device`` (the card unless the caller
    names another; raises without one). Thread-safe; close() drains."""

    def __init__(self, budget: float = 100.0,
                 ledger_path: str | None = None,
                 per_party_budget=None,
                 seed: int = rng.MASTER_SEED,
                 max_batch: int = 64, max_delay_s: float = 0.005,
                 max_queue: int = 4096, shard: str = "auto",
                 batch_mode: str = "exact", max_kernels: int = 128,
                 tracer: obs_trace.Tracer | None = None,
                 audit: AuditTrail | str | None = None,
                 warmup: str | list | None = None,
                 warmup_manifest: str | None = None,
                 warmup_autostart: bool = True,
                 aot: bool = True,
                 max_idempotency_cache: int = 1024,
                 breaker_threshold: int = 5,
                 breaker_reset_s: float = 30.0,
                 shed_queue_frac: float = 0.75,
                 flush_slo_s: float | None = None,
                 brownout_enter_s: float = 0.5,
                 brownout_exit_s: float = 2.0,
                 brownout_min_priority: int = 0,
                 user_dir: str | None = None,
                 user_budget: float = 1.0,
                 user_shards: int = 8,
                 user_max_resident: int | None = None,
                 user_compact_every: int | None = 256,
                 user_renew_period_s: float = 86400.0,
                 user_burst_cap: float = 0.0,
                 user_fsync: bool = True,
                 global_budget: float | None = None,
                 instance: str | None = None,
                 lease_dir: str | None = None,
                 lease_ttl_s: float = 3.0,
                 lease_target: int | None = None,
                 advertise_url: str | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.seed = seed
        #: instance identity: labels /stats and /metrics
        self.instance = instance
        # obs wiring: one tracer spans the request lifecycle (admit →
        # charge → enqueue → flush → respond; default is the process
        # tracer, disabled unless configured), one per-server metrics
        # registry backs BOTH /stats and /metrics, and the ledger's audit
        # trail stamps budget events with trace IDs
        self.tracer = tracer if tracer is not None else obs_trace.tracer()
        self.audit = AuditTrail(audit) if isinstance(audit, str) else audit
        self.stats = ServeStats(instance=instance)
        # per-request cost attribution: a CostRecord per admission,
        # filled in across the queue/compile/kernel path and returned in
        # response metadata; the bounded registry keeps the recent
        # window for /stats aggregation and flight-recorder dumps
        self.costs = CostRegistry()
        self._recorder = None  # set by attach_recorder
        self._crash_hook = None  # set by attach_recorder
        self.ledger = PrivacyLedger(budget, path=ledger_path,
                                    per_party=per_party_budget,
                                    audit=self.audit,
                                    registry=self.stats.registry)
        # per-user budget directory: with user_dir (or a global cap) the
        # ledger becomes a CompositeLedger — per-user + per-party +
        # global admission as one atomic charge with one refund path.
        # Drop-in: the coalescer's shed-refund and the overload refund
        # below reverse every leg through the same refund() call.
        # fleet mode: with lease_dir the budget directory is SHARED across
        # replicas and this server only opens a shard journal while it
        # holds that shard's lease — the keeper heartbeats renewals from
        # its own thread and picks up free and orphaned shards
        self.leases = None
        self._lease_keeper = None
        if lease_dir is not None and user_dir is None:
            raise ValueError("--lease-dir requires --user-dir: leases "
                             "grant budget-directory shards")
        if user_dir is not None or global_budget is not None:
            directory = None
            if user_dir is not None:
                if lease_dir is not None:
                    from dpcorr_torch.serve.fleet.lease import LeaseManager

                    self.leases = LeaseManager(
                        lease_dir,
                        owner=instance if instance is not None
                        else f"serve-pid-{secrets.token_hex(4)}",
                        url=advertise_url, ttl_s=lease_ttl_s)
                directory = BudgetDirectory(
                    user_dir, shards=user_shards,
                    user_budget=user_budget,
                    renewal=RenewalPolicy(period_s=user_renew_period_s,
                                          burst_cap=user_burst_cap),
                    max_resident=user_max_resident,
                    compact_every=user_compact_every,
                    fsync=user_fsync, audit=self.audit,
                    lease=self.leases)
                if self.leases is not None:
                    from dpcorr_torch.serve.fleet.lease import LeaseKeeper

                    self._lease_keeper = LeaseKeeper(self.leases,
                                                     target=lease_target)
                    self._lease_keeper.start()
            self.ledger = CompositeLedger(self.ledger, directory,
                                          global_budget=global_budget)
        self.cache = KernelCache(stats=self.stats, shard=shard,
                                 mode=batch_mode, max_kernels=max_kernels,
                                 aot=aot, tracer=self.tracer,
                                 device=self.device)
        # overload resilience: the breaker fail-fasts a poisoned kernel
        # bucket BEFORE ε is charged; brownout degrades execution
        # (unbatched launches, low-priority rejection) under sustained
        # pressure — both observed by the coalescer, which also holds
        # the ledger so every pre-launch shed is refunded
        self.brownout_min_priority = int(brownout_min_priority)
        self.breaker = CircuitBreaker(fail_threshold=breaker_threshold,
                                      reset_after_s=breaker_reset_s,
                                      stats=self.stats)
        self.brownout = BrownoutController(queue_frac=shed_queue_frac,
                                           flush_slo_s=flush_slo_s,
                                           enter_after_s=brownout_enter_s,
                                           exit_after_s=brownout_exit_s,
                                           stats=self.stats)
        self.coalescer = Coalescer(self.cache, self.stats,
                                   max_batch=max_batch,
                                   max_delay_s=max_delay_s,
                                   max_queue=max_queue,
                                   tracer=self.tracer,
                                   ledger=self.ledger,
                                   breaker=self.breaker,
                                   brownout=self.brownout)
        self._master = rng.master_key(self.seed)
        self._req_counter = itertools.count()
        # fresh per construction: makes counter-assigned streams unique
        # across restarts even though the counter itself restarts at 0
        # (module docstring — the ledger persists, the counter must not
        # need to)
        self._boot_nonce = secrets.randbits(31)
        # -- idempotency ------------------------------------------------
        # a retried request (client timeout, dropped response) must not
        # charge ε or draw noise twice: completed responses are cached
        # under the request's idempotency key and replayed verbatim;
        # duplicates of a still-running request attach to its future.
        # Failures are never cached — a retry after a refusal genuinely
        # re-runs.
        self._idem_cap = max(int(max_idempotency_cache), 0)
        self._idem_lock = threading.Lock()
        self._idem_done: OrderedDict[str, EstimateResponse] = \
            OrderedDict()  # guarded by: _idem_lock
        self._idem_inflight: dict[str, Future] = {}  # guarded by: _idem_lock
        # -- warmup / readiness (serve.warmup) --------------------------
        # signature sources: explicit spec (CLI --warmup) + the previous
        # boot's manifest, merged and deduplicated. An empty set means
        # the server is ready immediately.
        self._warmup_manifest = warmup_manifest
        sigs: list[dict] = []
        if warmup:
            sigs += (warmup_mod.parse_warmup_spec(warmup, max_batch)
                     if isinstance(warmup, str) else list(warmup))
        if warmup_manifest:
            sigs += warmup_mod.load_manifest(warmup_manifest)
        self._warm_set = warmup_mod.signatures_to_keys(sigs)
        self._warm_lock = threading.Lock()
        self._warm_done = 0  # guarded by: _warm_lock
        self._warm_errors = 0  # guarded by: _warm_lock
        self._warm_state = "ready" if not self._warm_set else "pending"  # guarded by: _warm_lock
        self._warm_thread = None  # guarded by: _warm_lock
        self._ready = threading.Event()
        if not self._warm_set:
            self._ready.set()
        elif warmup_autostart:
            self.start_warmup()

    # -- warmup / readiness ----------------------------------------------
    def start_warmup(self) -> None:
        """Kick the background warmup thread (idempotent). Split from
        construction (``warmup_autostart=False``) so tests can observe
        the not-ready → warming → ready lifecycle."""
        with self._warm_lock:
            if self._warm_thread is not None or not self._warm_set:
                return
            self._warm_state = "warming"
            t = threading.Thread(target=self._warm_loop,
                                 name="dpcorr-serve-warmup", daemon=True)
            self._warm_thread = t
        t.start()

    def _warm_loop(self) -> None:
        with self.tracer.span("serve.warmup", signatures=len(self._warm_set)):
            for kkey, b_pad in self._warm_set:
                try:
                    self.cache.get(kkey, b_pad, example_args=(
                        warmup_mod.example_args(kkey, b_pad, self.cache.mode)
                        if self.cache.aot else None))
                except Exception as e:
                    # a single bad signature (typo'd family in a spec,
                    # stale manifest entry) must not hold readiness
                    # hostage — log it, count it, keep warming
                    log.warning("warmup signature %s b_pad=%d failed: %s",
                                kkey, b_pad, e)
                    with self._warm_lock:
                        self._warm_errors += 1
                else:
                    # ``warmed`` counts signatures actually resident —
                    # warmed + warm_errors == total once the loop ends
                    with self._warm_lock:
                        self._warm_done += 1
        with self._warm_lock:
            self._warm_state = "ready"
        self._ready.set()

    def readiness(self) -> dict:
        """The ``GET /readyz`` body: ready only once the warmup set is
        resident (or there was none) AND no circuit breaker is open —
        a replica with a tripped bucket reports 503 so a balancer
        drains it while the breaker cools down and probes."""
        breakers_open = self.breaker.any_open()
        with self._warm_lock:
            return {"ready": self._ready.is_set() and not breakers_open,
                    "state": self._warm_state,
                    "warmed": self._warm_done,
                    "warm_errors": self._warm_errors,
                    "total": len(self._warm_set),
                    "breakers_open": breakers_open}

    def wait_ready(self, timeout: float | None = None) -> bool:
        """Block until the warmup set is resident (True) or ``timeout``
        elapses (False) — the load generator's wait-for-ready hook."""
        return self._ready.wait(timeout)

    def _request_key(self, req: EstimateRequest, seed: int) -> torch.Tensor:
        if req.seed is not None:
            return pinned_request_key(self._master, req, seed)
        return boot_request_key(self._master, self._boot_nonce, seed)

    # -- idempotency -----------------------------------------------------
    def _idem_key(self, req: EstimateRequest) -> str | None:
        """The request's retry identity. Explicit key wins; pinned-seed
        requests default to their content digest (the same bytes the
        noise stream is bound to, so "same key" implies "same answer")
        plus the charged party names — the digest itself excludes them
        (they only route budget), but two submissions billing different
        parties are different ledger operations and must not dedupe;
        assigned-stream requests have no stable identity to key on —
        every submission is a fresh draw by design."""
        if req.idempotency_key is not None:
            return req.idempotency_key
        if req.seed is not None:
            h = hashlib.sha256(request_digest(req))
            for party in (req.party_x, req.party_y):
                raw = party.encode()
                h.update(len(raw).to_bytes(4, "big"))
                h.update(raw)
            if req.user is not None:
                # same reasoning as the party names: the user routes a
                # budget leg (serve.budget_dir), so two users submitting
                # identical content are different ledger operations.
                # Folded only when set, so pre-user keys stay identical.
                raw = req.user.encode()
                h.update(b"user")
                h.update(len(raw).to_bytes(4, "big"))
                h.update(raw)
            return f"pinned:{req.seed}:{h.hexdigest()}"
        return None

    def _idem_complete(self, idem: str, fut: Future) -> None:
        """Done-callback for the original submission: publish success
        into the completed cache (bounded, LRU eviction) and resolve
        the shared placeholder every duplicate is holding."""
        err = fut.exception()
        with self._idem_lock:
            placeholder = self._idem_inflight.pop(idem, None)
            if err is None:
                # done-callback: fut is already settled, result() cannot
                # block under the lock
                # dpcorr-lint: ignore[blocking-under-lock] — done-callback: fut is already settled, result() cannot block
                self._idem_done[idem] = fut.result()
                self._idem_done.move_to_end(idem)
                while len(self._idem_done) > self._idem_cap:
                    self._idem_done.popitem(last=False)
        if placeholder is not None:
            # resolve outside the lock: waiter callbacks run inline.
            # The placeholder may have been cancelled by an
            # estimate() timeout — the response is still cached above,
            # so a retry under the same key replays it.
            try:
                if err is None:
                    placeholder.set_result(fut.result())
                else:
                    placeholder.set_exception(err)
            except InvalidStateError:
                pass

    # -- API -------------------------------------------------------------
    def submit(self, req: EstimateRequest) -> Future:
        """Admit one request: charge the ledger (may raise
        BudgetExceededError), then enqueue (may raise
        ServerOverloadedError). Returns a Future[EstimateResponse].

        Idempotency runs first: a key that already completed returns
        the ORIGINAL response object (byte-identical on the wire) with
        no charge, no noise draw and no kernel execution; a key still
        in flight returns the original's future. The reservation is
        taken BEFORE the charge so a concurrent duplicate can never
        race past the cache into a second spend."""
        idem = self._idem_key(req)
        if idem is not None and self._idem_cap > 0:
            with self._idem_lock:
                done = self._idem_done.get(idem)
                if done is not None:
                    self._idem_done.move_to_end(idem)
                    self.stats.idempotent_hit("completed")
                    fut: Future = Future()
                    fut.set_result(done)
                    return fut
                running = self._idem_inflight.get(idem)
                if running is not None:
                    self.stats.idempotent_hit("inflight")
                    return running
                placeholder: Future = Future()
                self._idem_inflight[idem] = placeholder
            try:
                inner = self._admit(req, idem=idem)
            except BaseException as e:
                # refused admissions are not cached (a retry genuinely
                # re-runs), but duplicates already attached must fail too
                with self._idem_lock:
                    self._idem_inflight.pop(idem, None)
                placeholder.set_exception(e)
                raise
            inner.add_done_callback(
                lambda f, k=idem: self._idem_complete(k, f))
            return placeholder
        return self._admit(req)

    def _admit(self, req: EstimateRequest,
               idem: str | None = None) -> Future:
        """Charge + enqueue.

        The root ``serve.request`` span opens here and closes on the
        flush thread when the response lands; its trace ID stamps the
        ledger's audit events, so one ID joins the latency chain and
        the budget decision.

        ``idem`` (the request's retry identity, when it has one)
        doubles as the charge's durable charge_id, as in the JAX
        package, so a ledger file shared by the two packages dedups
        the same retries."""
        charge_id = None if idem is None else f"req:{idem}"
        seed = req.seed if req.seed is not None else next(self._req_counter)
        key = self._request_key(req, seed)
        # the request's root span closes on the flush thread when the
        # response lands
        # dpcorr-lint: ignore[span-no-finally] — request root span; closes on the flush thread when the response lands
        root = self.tracer.start_span("serve.request", family=req.family,
                                      n=req.n, seed=seed)
        # the cost record opens with the root span and shares its trace
        # ID — refused requests keep theirs in the registry too, so the
        # "refused ⇒ zero ε net of refunds" invariant is checkable
        cost = self.costs.new(root.trace_id)
        try:
            with self.tracer.span("serve.admit", parent=root):
                # inner spans parent implicitly under serve.admit (the
                # thread's current span) — all on root's trace ID
                try:
                    # fail-fast gates run BEFORE the charge: a request
                    # the breaker or the brownout floor refuses never
                    # touches the ledger, so it trivially consumes zero ε
                    self._overload_gate(req)
                except CircuitOpenError:
                    self.stats.refused("breaker")
                    root.set(refused="breaker")
                    cost.event("refused_breaker")
                    raise
                except ServerOverloadedError:
                    self.stats.refused("brownout")
                    self.stats.shed("admission")
                    root.set(refused="brownout")
                    cost.event("refused_brownout")
                    raise
                try:
                    with self.tracer.span("serve.ledger.charge"):
                        charges = self.ledger.charge_request(
                            req, trace_id=root.trace_id,
                            charge_id=charge_id)
                    # cost attribution is party ε (what crossed into a
                    # kernel) — the directory's derived user/global
                    # legs are bookkeeping views of the same spend
                    cost.charge(party_view(charges))
                except ShardNotOwnedError as e:
                    # fleet routing miss: another replica holds the
                    # user's budget shard. Charge-free by construction
                    # (the lease gate runs before any leg applies) — the
                    # front end forwards to the owner named in e
                    self.stats.refused("not_owner")
                    root.set(refused="not_owner", shard=e.shard)
                    cost.event("refused_not_owner")
                    raise
                except BudgetExceededError as e:
                    self.stats.refused_budget()
                    root.set(refused="budget", refused_level=e.level)
                    # the event names WHICH budget level refused, as in
                    # the JAX package's cost records
                    cost.event(f"refused_budget_{e.level}")
                    raise
                try:
                    with self.tracer.span("serve.enqueue"):
                        fut = self.coalescer.submit(req, key, seed,
                                                    span=root,
                                                    charges=charges,
                                                    cost=cost,
                                                    charge_id=charge_id)
                except Exception:
                    # the enqueue refused (backpressure / closed): no
                    # kernel ran and nothing was released, so reversing
                    # the charge is safe — shed load must not consume ε
                    # (ledger.refund); the charge_id is forgotten with
                    # it so the client's next attempt charges cleanly
                    self.ledger.refund(charges, trace_id=root.trace_id,
                                       charge_id=charge_id,
                                       reason="overload")
                    cost.event("refused_overload")
                    cost.refund(party_view(charges), "overload")
                    root.set(refused="overload")
                    raise
        except Exception:
            root.end()  # refused requests never reach the flush thread
            raise
        self.stats.admitted()
        return fut

    def _overload_gate(self, req: EstimateRequest) -> None:
        """Pre-charge admission gates: the request's bucket breaker
        (raises :class:`CircuitOpenError` while open) and the brownout
        priority floor (raises :class:`ServerOverloadedError` for work
        below ``brownout_min_priority`` while browned out)."""
        self.breaker.allow(bucket_key(req))
        # keep the brownout hysteresis fed from the gate itself: with
        # every arrival refused pre-enqueue, nothing else would observe
        # the (now calm) queue and brownout would never exit
        self.coalescer.observe_pressure()
        if self.brownout.active() \
                and req.priority < self.brownout_min_priority:
            raise ServerOverloadedError(
                f"brownout: priority {req.priority} below the floor "
                f"{self.brownout_min_priority} under sustained pressure",
                retry_after_s=self.coalescer.retry_after_s())

    def estimate(self, req: EstimateRequest,
                 timeout: float | None = 60.0) -> EstimateResponse:
        """Blocking convenience wrapper around :meth:`submit`.

        A timeout does not leak the in-flight request silently: the
        pending future is cancelled — if the
        cancel wins (the flush thread had not claimed it) the request
        is withdrawn and the coalescer refunds its charge at claim
        time; if it loses, the request was already launching and
        completes unobserved (``detached`` — its spend stands, its
        response still lands in the idempotency cache). Either way the
        outcome is counted in the ``abandoned`` stat."""
        fut = self.submit(req)
        try:
            return fut.result(timeout=timeout)
        except _FuturesTimeout:
            self.stats.abandoned("cancelled" if fut.cancel()
                                 else "detached")
            raise

    def stats_snapshot(self) -> dict:
        snap = self.stats.snapshot(
            ledger_snapshot=self.ledger.snapshot(),
            cost_aggregate=self.costs.aggregate(),
            budget_dir=(self.ledger.directory_snapshot()
                        if isinstance(self.ledger, CompositeLedger)
                        else None))
        snap["breaker"] = self.breaker.snapshot()
        if self.leases is not None:
            # fleet mode: which budget shards this replica owns, at
            # which epochs
            snap["leases"] = self.leases.snapshot()
        return snap

    # -- flight recorder -------------------------------------------------
    def attach_recorder(self, rec) -> None:
        """Wire a :class:`~dpcorr_torch.obs.recorder.FlightRecorder` into
        every capture point of this server: span + audit observers,
        the metrics registry and cost registry for dump snapshots,
        breaker-trip / brownout-transition / chaos-crash dump triggers,
        and the ``dpcorr`` logging ring. Installs the recorder as the
        process-wide trigger target (the CLI's SIGUSR2 path)."""
        self._recorder = rec
        self.tracer.add_observer(rec.record_span)
        if self.audit is not None:
            self.audit.add_observer(rec.record_audit)
        rec.watch_registry(self.stats.registry)
        rec.watch_costs(self.costs)
        # dump triggers: all three callbacks fire OUTSIDE their
        # component's lock (overload.py / chaos.py contracts), so the
        # recorder may take its ring lock and do file I/O safely
        self.breaker.on_open = lambda bkey, consecutive: \
            obs_recorder.trigger(
                "breaker_open", family=bkey.family,
                bucket=_bucket_label(bkey), consecutive=consecutive)
        self.brownout.on_change = lambda active: obs_recorder.trigger(
            "brownout_enter" if active else "brownout_exit")
        self._crash_hook = lambda point: rec.dump("chaos", point=point)
        chaos.on_crash(self._crash_hook)
        rec.attach_logging("dpcorr")
        obs_recorder.install(rec)

    def close(self) -> None:
        if self._crash_hook is not None:
            chaos.remove_crash_hook(self._crash_hook)
            self._crash_hook = None
        if self._lease_keeper is not None:
            self._lease_keeper.stop()
        self.coalescer.close()
        if self.leases is not None:
            # graceful handback AFTER the drain: successors take over
            # immediately instead of waiting out the TTL
            self.leases.release_all()
        if isinstance(self.ledger, CompositeLedger):
            self.ledger.close()
        if self._warmup_manifest:
            # persist the working set AFTER the drain: every kernel the
            # final flushes built is in the manifest the next boot
            # replays
            try:
                warmup_mod.save_manifest(self._warmup_manifest,
                                         self.cache.manifest())
            except OSError as e:
                log.warning("could not persist warmup manifest %s: %s",
                            self._warmup_manifest, e)


class InProcessClient:
    """The client surface the tests program against — the same calls a
    network client would make, minus the wire."""

    def __init__(self, server: DpcorrServer):
        self._server = server

    def submit(self, req: EstimateRequest) -> Future:
        return self._server.submit(req)

    def estimate(self, req: EstimateRequest,
                 timeout: float | None = 60.0) -> EstimateResponse:
        return self._server.estimate(req, timeout=timeout)

    def stats(self) -> dict:
        return self._server.stats_snapshot()

    def readiness(self) -> dict:
        return self._server.readiness()

    def wait_ready(self, timeout: float | None = None) -> bool:
        """Wait-for-ready hook: what ``GET /readyz`` polling would do,
        minus the wire."""
        return self._server.wait_ready(timeout)


# ---------------------------------------------------------------- HTTP ----
def _request_from_json(body: dict) -> EstimateRequest:
    try:
        return EstimateRequest(
            family=body["family"],
            x=np.asarray(body["x"], dtype=np.float32),
            y=np.asarray(body["y"], dtype=np.float32),
            eps1=float(body["eps1"]), eps2=float(body["eps2"]),
            party_x=str(body.get("party_x", "party-x")),
            party_y=str(body.get("party_y", "party-y")),
            alpha=float(body.get("alpha", 0.05)),
            normalise=bool(body.get("normalise", True)),
            seed=(int(body["seed"]) if body.get("seed") is not None
                  else None),
            idempotency_key=(str(body["idempotency_key"])
                             if body.get("idempotency_key") is not None
                             else None),
            priority=int(body.get("priority", 0)),
            deadline_s=(float(body["deadline_s"])
                        if body.get("deadline_s") is not None
                        else None),
            user=(str(body["user"]) if body.get("user") is not None
                  else None))
    except KeyError as e:
        raise ValueError(f"missing required field {e.args[0]!r}") from e


def _response_json(resp: EstimateResponse) -> dict:
    return {"rho_hat": resp.rho_hat, "ci_low": resp.ci_low,
            "ci_high": resp.ci_high, "batched": resp.batched,
            "batch_size": resp.batch_size,
            "latency_s": round(resp.latency_s, 6), "seed": resp.seed,
            "cost": resp.cost}


def make_http_server(server: DpcorrServer, host: str = "127.0.0.1",
                     port: int = 8321, sock=None):
    """Build (not start) the threaded HTTP front end; the caller owns
    ``serve_forever`` / ``shutdown`` so tests can run it on a thread.
    ``sock`` adopts a pre-bound listening socket: the CLI binds before
    the server build so the port — and the instance name derived from
    it — is known up front."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict,
                  headers: tuple = ()) -> None:
            blob = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            for name, value in headers:
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(blob)

        @staticmethod
        def _retry_after(e) -> tuple:
            """``Retry-After`` header (whole seconds, ceil'd so a
            client never retries early) when the refusal carries an
            estimate."""
            ra = getattr(e, "retry_after_s", None)
            if ra is None:
                return ()
            secs = max(1, int(ra) + (1 if ra % 1 else 0))
            return (("Retry-After", str(secs)),)

        def _send_text(self, code: int, text: str,
                       content_type: str) -> None:
            blob = text.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):  # noqa: N802 (stdlib handler casing)
            if self.path == "/stats":
                self._send(200, server.stats_snapshot())
            elif self.path == "/metrics":
                # Prometheus text exposition off the same registry that
                # backs /stats — single source of truth (obs.metrics)
                self._send_text(200, server.stats.render_prometheus(),
                                _PROM_CONTENT_TYPE)
            elif self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/readyz":
                # readiness ≠ liveness: 503 while the warmup set is
                # still being built, so a load balancer holds traffic
                r = server.readiness()
                self._send(200 if r["ready"] else 503, r)
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path == "/obs/trigger":
                # a burn-rate page (obs.slo.http_trigger_hook) or the
                # sentinel arms THIS instance's flight recorder: the
                # dump happens here, next to the rings
                self._send(*obs_recorder.http_trigger(self))
                return
            if self.path != "/estimate":
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = _request_from_json(json.loads(self.rfile.read(length)))
            except (ValueError, json.JSONDecodeError) as e:
                self._send(400, {"error": str(e)})
                return
            try:
                resp = server.estimate(req)
            except BudgetExceededError as e:
                # enough detail for the client to reconstruct the typed
                # refusal (serve.client.HttpEstimateClient) — a budget
                # refusal is terminal, retrying it is never right
                self._send(403, {"error": str(e), "refused": "budget",
                                 "party": e.party, "spent": e.spent,
                                 "charge": e.charge, "budget": e.budget,
                                 "level": e.level})
            except ShardNotOwnedError as e:
                # fleet routing miss: 421 Misdirected Request naming the
                # owner so the front end forwards instead of failing —
                # charge-free on this replica
                self._send(421, {"error": str(e),
                                 "refused": "not_owner",
                                 "shard": e.shard, "owner": e.owner,
                                 "owner_url": e.owner_url},
                           headers=self._retry_after(e))
            except DeadlineExpiredError as e:
                self._send(504, {"error": str(e), "refused": "expired"},
                           headers=self._retry_after(e))
            except CircuitOpenError as e:
                self._send(503, {"error": str(e), "refused": "breaker"},
                           headers=self._retry_after(e))
            except ServerOverloadedError as e:
                self._send(429, {"error": str(e), "refused": "overload"},
                           headers=self._retry_after(e))
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
            else:
                self._send(200, _response_json(resp))

        def log_message(self, *args):  # quiet by default
            pass

    if sock is None:
        return ThreadingHTTPServer((host, port), Handler)
    httpd = ThreadingHTTPServer((host, port), Handler,
                                bind_and_activate=False)
    httpd.socket.close()
    httpd.socket = sock
    httpd.server_address = sock.getsockname()[:2]
    httpd.server_activate()
    return httpd


def serve_http(server: DpcorrServer, host: str = "127.0.0.1",
               port: int = 8321) -> None:
    """Run the HTTP front end until interrupted (the CLI entry)."""
    httpd = make_http_server(server, host=host, port=port)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        server.close()
