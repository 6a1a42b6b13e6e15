"""The port's overload resilience (``dpcorr_torch.serve``), case by case
after the JAX package's ``tests/test_overload.py``: deadlines,
prioritized shedding, circuit breaker, brownout and the retrying client,
on the CPU.

The unifying invariant under test: a request that is REFUSED or SHED —
at admission, in the queue, or at shutdown — consumes zero ε. Either it
was never charged (breaker / brownout-floor refusals run before the
ledger) or its charge was reversed before any kernel launched (deadline
expiry, priority eviction, close-drain), and the audit trail replays to
the same balances the ledger holds. The retrying client layers on top:
one idempotency key across attempts makes retries charge-once and
byte-identical.
"""

import threading
import time

import numpy as np
import pytest

import torch

from dpcorr_torch import chaos
from dpcorr_torch.models.estimators.registry import serving_entry
from dpcorr_torch.obs import audit as obs_audit
from dpcorr_torch.serve import (
    BrownoutController,
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExpiredError,
    EstimateRequest,
    InProcessClient,
    RetriableTransportError,
    RetryingClient,
    RetryPolicy,
    ServerOverloadedError,
    pinned_request_key,
)
from dpcorr_torch.serve import DpcorrServer as _DpcorrServer
from dpcorr_torch.serve.request import bucket_key
from dpcorr_torch.utils import rng


def _mk_req(n=96, family="ni_sign", seed=None, i=0, **kw):
    rs = np.random.RandomState(100 + i)
    return EstimateRequest(family, rs.randn(n).astype(np.float32),
                           rs.randn(n).astype(np.float32),
                           1.0, 0.5, seed=seed, **kw)


def DpcorrServer(**kw):  # noqa: N802 — the server, on the CPU
    return _DpcorrServer(device="cpu", **kw)


@pytest.fixture(autouse=True)
def _clean_faults():
    chaos.clear_faults()
    yield
    chaos.clear_faults()


class _Clock:
    """Scripted monotonic clock for the state-machine units."""

    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _assert_replay_matches(events, ledger):
    """The acceptance identity: a jax-free fold over the audit trail
    reproduces the ledger's per-party balances exactly."""
    spent = obs_audit.replay(events)
    parties = ledger.snapshot()["parties"]
    assert set(spent) == set(parties)
    for p, s in spent.items():
        assert s == parties[p]["spent"]


# ------------------------------------------------------- breaker unit ----

def test_breaker_trips_after_consecutive_failures():
    clk = _Clock()
    cb = CircuitBreaker(fail_threshold=3, reset_after_s=10.0, clock=clk)
    bkey = bucket_key(_mk_req())
    for _ in range(2):
        cb.record_failure(bkey)
    assert cb.state(bkey) == "closed"
    cb.allow(bkey)  # still admitting below the threshold
    cb.record_failure(bkey)
    assert cb.state(bkey) == "open"
    assert cb.any_open()
    with pytest.raises(CircuitOpenError) as ei:
        cb.allow(bkey)
    assert 0.0 < ei.value.retry_after_s <= 10.0


def test_breaker_success_resets_consecutive_count():
    cb = CircuitBreaker(fail_threshold=3, clock=_Clock())
    bkey = bucket_key(_mk_req())
    for _ in range(2):
        cb.record_failure(bkey)
    cb.record_success(bkey)  # non-consecutive failures never trip
    for _ in range(2):
        cb.record_failure(bkey)
    assert cb.state(bkey) == "closed"


def test_breaker_half_open_single_probe_then_close():
    clk = _Clock()
    cb = CircuitBreaker(fail_threshold=1, reset_after_s=5.0, clock=clk)
    bkey = bucket_key(_mk_req())
    cb.record_failure(bkey)
    assert cb.state(bkey) == "open"
    clk.t = 6.0
    cb.allow(bkey)  # cooldown elapsed: this caller is the probe
    assert cb.state(bkey) == "half_open"
    with pytest.raises(CircuitOpenError):
        cb.allow(bkey)  # one probe at a time
    cb.record_success(bkey)
    assert cb.state(bkey) == "closed"
    assert not cb.any_open()
    cb.allow(bkey)  # back to normal admission


def test_breaker_failed_probe_reopens():
    clk = _Clock()
    cb = CircuitBreaker(fail_threshold=1, reset_after_s=5.0, clock=clk)
    bkey = bucket_key(_mk_req())
    cb.record_failure(bkey)
    clk.t = 6.0
    cb.allow(bkey)
    cb.record_failure(bkey)  # the probe failed
    assert cb.state(bkey) == "open"
    with pytest.raises(CircuitOpenError):
        cb.allow(bkey)  # a fresh cooldown started at t=6
    clk.t = 12.0
    cb.allow(bkey)
    assert cb.state(bkey) == "half_open"


def test_breaker_stale_probe_cannot_deadlock_recovery():
    clk = _Clock()
    cb = CircuitBreaker(fail_threshold=1, reset_after_s=5.0, clock=clk)
    bkey = bucket_key(_mk_req())
    cb.record_failure(bkey)
    clk.t = 6.0
    cb.allow(bkey)  # probe admitted ... and its client vanishes
    clk.t = 12.0  # one more cooldown later a new probe is allowed
    cb.allow(bkey)
    assert cb.state(bkey) == "half_open"


def test_breaker_isolates_buckets():
    cb = CircuitBreaker(fail_threshold=1, clock=_Clock())
    sick, healthy = bucket_key(_mk_req(n=96)), bucket_key(_mk_req(n=200))
    cb.record_failure(sick)
    with pytest.raises(CircuitOpenError):
        cb.allow(sick)
    cb.allow(healthy)  # other buckets unaffected
    snap = cb.snapshot()
    assert snap["open"] == 1 and snap["half_open"] == 0
    assert list(snap["tripped_buckets"].values()) == ["open"]


def test_breaker_validation():
    with pytest.raises(ValueError, match="fail_threshold"):
        CircuitBreaker(fail_threshold=0)
    with pytest.raises(ValueError, match="reset_after_s"):
        CircuitBreaker(reset_after_s=0.0)


# ------------------------------------------------------ brownout unit ----

def test_brownout_enters_after_sustained_pressure_only():
    clk = _Clock()
    bo = BrownoutController(queue_frac=0.75, enter_after_s=1.0,
                            exit_after_s=2.0, clock=clk)
    bo.observe(0.9, 0.0)
    assert not bo.active()  # a burst is not sustained pressure
    clk.t = 0.5
    bo.observe(0.9, 0.0)
    assert not bo.active()
    clk.t = 1.1
    bo.observe(0.9, 0.0)
    assert bo.active()


def test_brownout_hysteresis_on_exit():
    clk = _Clock()
    bo = BrownoutController(queue_frac=0.75, enter_after_s=0.0,
                            exit_after_s=2.0, clock=clk)
    bo.observe(0.9, 0.0)
    assert bo.active()
    clk.t = 1.0
    bo.observe(0.1, 0.0)  # calm, but not for long enough
    assert bo.active()
    clk.t = 2.0
    bo.observe(0.9, 0.0)  # pressure returns: the calm window resets
    clk.t = 3.5
    bo.observe(0.1, 0.0)
    assert bo.active()
    clk.t = 6.0
    bo.observe(0.1, 0.0)  # 2.5 s of sustained calm
    assert not bo.active()


def test_brownout_flush_slo_is_a_pressure_signal():
    clk = _Clock()
    bo = BrownoutController(queue_frac=1.0, flush_slo_s=0.1,
                            enter_after_s=0.0, clock=clk)
    bo.observe(0.0, 0.05)
    assert not bo.active()
    bo.observe(0.0, 0.5)  # queue empty but flushes are slow
    assert bo.active()


def test_brownout_validation():
    with pytest.raises(ValueError, match="queue_frac"):
        BrownoutController(queue_frac=1.5)


# ------------------------------------------------- retry policy unit ----

def test_retry_policy_delay_shape():
    import random

    pol = RetryPolicy(base_delay_s=0.1, max_delay_s=1.0, multiplier=2.0,
                      jitter=0.5)
    r = random.Random(0)
    for attempt, base in ((1, 0.1), (2, 0.2), (3, 0.4), (7, 1.0)):
        for _ in range(20):
            d = pol.delay_for(attempt, None, r)
            assert 0.5 * base <= d <= 1.5 * base
    # Retry-After floors the jittered backoff — never retry early
    assert pol.delay_for(1, 3.0, r) >= 3.0


def test_retry_policy_validation():
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError, match="jitter"):
        RetryPolicy(jitter=1.5)


# -------------------------------------------------- deadline expiry ----

def test_deadline_expiry_refunds_and_audits():
    """A request whose deadline passes while queued resolves to
    DeadlineExpiredError BEFORE any kernel launches; its ε charge is
    reversed and the audit trail carries the refund with its reason —
    a jax-free replay lands on the ledger's own balances."""
    trail = obs_audit.AuditTrail()
    srv = DpcorrServer(budget=1e6, max_delay_s=0.25, shard="off",
                       audit=trail)
    try:
        fut = srv.submit(_mk_req(seed=7, deadline_s=0.01))
        with pytest.raises(DeadlineExpiredError):
            fut.result(timeout=30)
        assert srv.ledger.spent("party-x") == 0.0
        assert srv.ledger.spent("party-y") == 0.0
        snap = srv.stats.snapshot()
        assert snap["shed"]["expired"] == 1
        refunds = [e for e in trail.events() if e["kind"] == "refund"]
        assert len(refunds) == 1
        assert refunds[0]["reason"] == "expired"
        _assert_replay_matches(trail.events(), srv.ledger)
    finally:
        srv.close()


def test_deadline_zero_consumption_is_exact():
    """Exact-binary ε (2.0 + 1.0 per request after the normalise
    release factor) so the refund check is == not ≈."""
    srv = DpcorrServer(budget=1e6, max_delay_s=0.25, shard="off")
    try:
        ok = srv.submit(_mk_req(seed=1, i=0))  # same flush window
        with pytest.raises(DeadlineExpiredError):
            srv.submit(_mk_req(seed=2, i=1,
                               deadline_s=1e-9)).result(timeout=30)
        ok.result(timeout=60)  # the live rider still gets served
        assert srv.ledger.spent("party-x") == 2.0
        assert srv.ledger.spent("party-y") == 1.0
    finally:
        srv.close()


def test_request_deadline_validation():
    with pytest.raises(ValueError, match="deadline_s"):
        _mk_req(deadline_s=0.0)
    with pytest.raises(ValueError, match="priority"):
        _mk_req(priority=True)


# ------------------------------------------------ priority eviction ----

def test_priority_eviction_sheds_lowest_rank():
    srv = DpcorrServer(budget=1e6, max_delay_s=30.0, max_queue=2,
                       shard="off")
    try:
        low = srv.submit(_mk_req(seed=1, i=0, priority=-1))
        mid = srv.submit(_mk_req(seed=2, i=1, priority=0))
        urgent = srv.submit(_mk_req(seed=3, i=2, priority=5))
        with pytest.raises(ServerOverloadedError) as ei:
            low.result(timeout=5)
        assert ei.value.retry_after_s is not None
        assert not mid.done() and not urgent.done()
        snap = srv.stats.snapshot()
        assert snap["shed"]["queue_evict"] == 1
        # the victim's charge came back: two admitted requests remain
        # (2.0 ε each on party-x under the normalise release factor)
        assert srv.ledger.spent("party-x") == 4.0
    finally:
        srv.close()


def test_equal_rank_arrival_is_refused_not_evicting():
    """FIFO fairness within a priority class: a newcomer only evicts
    when it STRICTLY outranks the victim."""
    srv = DpcorrServer(budget=1e6, max_delay_s=30.0, max_queue=2,
                       shard="off")
    try:
        futs = [srv.submit(_mk_req(seed=i, i=i)) for i in range(2)]
        with pytest.raises(ServerOverloadedError) as ei:
            srv.submit(_mk_req(seed=9, i=9))
        assert ei.value.retry_after_s is not None
        assert not any(f.done() for f in futs)
        assert srv.stats.requests_refused_overload == 1
        assert srv.ledger.spent("party-x") == 4.0  # refusal refunded
    finally:
        srv.close()


def test_deadline_slack_breaks_priority_ties():
    srv = DpcorrServer(budget=1e6, max_delay_s=30.0, max_queue=2,
                       shard="off")
    try:
        tight = srv.submit(_mk_req(seed=1, i=0, deadline_s=60.0))
        loose = srv.submit(_mk_req(seed=2, i=1, deadline_s=600.0))
        srv.submit(_mk_req(seed=3, i=2, priority=1))
        # within a priority class the LEAST-slack rider is shed first:
        # it is the one most likely to expire unanswered anyway, and
        # evicting it now lets its client retry soonest
        with pytest.raises(ServerOverloadedError):
            tight.result(timeout=5)
        assert not loose.done()
    finally:
        srv.close()


# ------------------------------------------------- estimate timeout ----

def test_estimate_timeout_cancels_and_refunds():
    from concurrent.futures import TimeoutError as FuturesTimeout

    srv = DpcorrServer(budget=1e6, max_delay_s=30.0, shard="off")
    try:
        with pytest.raises((TimeoutError, FuturesTimeout)):
            srv.estimate(_mk_req(seed=1), timeout=0.05)
        assert srv.stats.snapshot()["abandoned"]["cancelled"] == 1
    finally:
        srv.close()
    # the cancelled pending is dropped at drain/claim time and refunded
    assert srv.ledger.spent("party-x") == 0.0


# ------------------------------------------------------- breaker e2e ----

def _fault(spec):
    chaos.install_fault(chaos.fault_from_spec(spec))


def test_breaker_trips_and_recovers_bit_identical():
    """Consecutive injected kernel failures trip the request's bucket
    breaker: admission then fail-fasts with ZERO charge and /readyz
    degrades. After the cooldown the half-open probe heals the bucket
    and the post-recovery answer is bit-identical to the direct
    single-request reference — recovery changed availability, not
    results."""
    req = _mk_req(seed=42)
    srv = DpcorrServer(budget=1e6, max_delay_s=0.001, shard="off",
                       breaker_threshold=2, breaker_reset_s=0.3)
    try:
        # times=4: each failing request traverses the fault point twice
        # (batched-path attempt + unbatched fallback) — 2 whole-request
        # failures, then the plan is spent and the probe can heal
        _fault("point=serve.kernel,mode=fail,times=4")
        for i in range(2):
            with pytest.raises(chaos.SimulatedFault):
                # distinct data per attempt: failures must be
                # consecutive in the BUCKET, not retries of one request
                srv.estimate(_mk_req(seed=i, i=i), timeout=30)
        spent_after_failures = srv.ledger.spent("party-x")
        r = srv.readiness()
        assert r["ready"] is False and r["breakers_open"] is True
        with pytest.raises(CircuitOpenError) as ei:
            srv.estimate(req, timeout=30)
        assert ei.value.retry_after_s > 0.0
        # fail-fast means fail-FREE: the refused request never charged
        assert srv.ledger.spent("party-x") == spent_after_failures
        snap = srv.stats_snapshot()
        assert snap["refused"]["breaker"] == 1
        assert snap["breaker"]["open"] == 1
        time.sleep(0.35)  # cooldown: next admission is the probe
        resp = srv.estimate(req, timeout=60)
        assert srv.readiness()["ready"] is True
        assert not srv.breaker.any_open()
        # bit-identity against the direct single-request call
        single = serving_entry(req.family, req.eps1, req.eps2,
                               alpha=req.alpha, normalise=req.normalise,
                               device="cpu")
        key = pinned_request_key(rng.master_key(srv.seed), req, req.seed)
        ref = single(key, torch.from_numpy(req.x), torch.from_numpy(req.y))
        assert resp.rho_hat == float(ref[0])
        assert resp.ci_low == float(ref[1])
        assert resp.ci_high == float(ref[2])
    finally:
        srv.close()


def test_breaker_failures_do_not_leak_charges():
    """A request that EXECUTES and fails keeps its charge (the kernel
    ran; ε was exposed) — but every breaker-refused request after the
    trip is charge-free. The audit replay stays in lockstep with the
    ledger through the whole storm."""
    trail = obs_audit.AuditTrail()
    srv = DpcorrServer(budget=1e6, max_delay_s=0.001, shard="off",
                       breaker_threshold=2, breaker_reset_s=30.0,
                       audit=trail)
    try:
        _fault("point=serve.kernel,mode=fail")
        for i in range(2):
            with pytest.raises(chaos.SimulatedFault):
                srv.estimate(_mk_req(seed=i, i=i), timeout=30)
        for i in range(5):
            with pytest.raises(CircuitOpenError):
                srv.estimate(_mk_req(seed=10 + i, i=10 + i), timeout=30)
        assert srv.ledger.spent("party-x") == 4.0  # executed failures only
        _assert_replay_matches(trail.events(), srv.ledger)
    finally:
        srv.close()


# --------------------------------------------------- brownout e2e ----

def test_brownout_forces_unbatched_flushes():
    """With the pressure threshold at zero the server is permanently
    browned out: multi-request flushes take the unbatched path."""
    srv = DpcorrServer(budget=1e6, max_delay_s=0.05, shard="off",
                       shed_queue_frac=0.0, brownout_enter_s=0.0)
    try:
        futs = [srv.submit(_mk_req(seed=i)) for i in range(4)]
        out = [f.result(timeout=60) for f in futs]
        assert all(not r.batched for r in out)
        assert srv.stats.snapshot()["brownout_active"] is True
    finally:
        srv.close()


def test_brownout_floor_rejects_low_priority_uncharged():
    srv = DpcorrServer(budget=1e6, max_delay_s=30.0, max_queue=64,
                       shard="off", shed_queue_frac=0.0,
                       brownout_enter_s=0.0, brownout_min_priority=0)
    try:
        held = srv.submit(_mk_req(seed=1, i=0))  # arms the pressure signal
        spent = srv.ledger.spent("party-x")
        with pytest.raises(ServerOverloadedError) as ei:
            srv.submit(_mk_req(seed=2, i=1, priority=-1))
        assert ei.value.retry_after_s is not None
        assert srv.ledger.spent("party-x") == spent  # never charged
        snap = srv.stats.snapshot()
        assert snap["refused"]["brownout"] == 1
        assert snap["shed"]["admission"] == 1
        srv.submit(_mk_req(seed=3, i=2, priority=0))  # at the floor: admitted
        assert not held.done()
    finally:
        srv.close()


def test_brownout_gate_observes_pressure_so_it_cannot_latch():
    """The admission gate itself feeds the brownout controller: after
    the queue drains, a lone low-priority arrival must see brownout
    exit (via its own pressure observation) instead of being refused
    by a state nothing else would ever update."""
    srv = DpcorrServer(budget=1e6, max_delay_s=0.02, max_queue=2,
                       shard="off", shed_queue_frac=0.5,
                       brownout_enter_s=0.0, brownout_exit_s=0.2,
                       brownout_min_priority=0)
    try:
        futs = [srv.submit(_mk_req(seed=i, i=i)) for i in range(2)]
        assert srv.brownout.active()
        for f in futs:
            f.result(timeout=60)
        time.sleep(0.3)  # the calm window elapses with NO traffic at all
        r = srv.estimate(_mk_req(seed=9, i=9, priority=-1), timeout=30)
        assert np.isfinite(r.rho_hat)
    finally:
        srv.close()


# --------------------------------------------------- retrying client ----

class _Flaky:
    """Client wrapper that injects failures around a real client."""

    def __init__(self, inner, plan):
        self.inner = inner
        self.plan = list(plan)  # per-attempt: None=pass through, exc=raise
        self.lock = threading.Lock()

    def estimate(self, req, timeout=None):
        with self.lock:
            step = self.plan.pop(0) if self.plan else None
        if step is not None:
            if getattr(step, "_after_execute", False):
                # the server DID answer; the response was lost on the
                # wire — the nastiest retry case
                self.inner.estimate(req, timeout=timeout)
            raise step
        return self.inner.estimate(req, timeout=timeout)


def test_retrying_client_recovers_and_counts():
    srv = DpcorrServer(budget=1e6, max_delay_s=0.001, shard="off")
    try:
        flaky = _Flaky(InProcessClient(srv), [
            ServerOverloadedError("shed", retry_after_s=0.01),
            ServerOverloadedError("shed", retry_after_s=0.01),
        ])
        rc = RetryingClient(flaky, RetryPolicy(base_delay_s=0.001),
                            seed=0)
        resp = rc.estimate(_mk_req(seed=5), timeout=30)
        assert np.isfinite(resp.rho_hat)  # a real response landed
        st = rc.stats()
        assert st["attempts"] == 3 and st["successes"] == 1
        assert st["retryable"] == 2 and st["recovered"] == 1
        assert st["retryable:ServerOverloadedError"] == 2
    finally:
        srv.close()


def test_retrying_client_charges_once_for_lost_response():
    """Attempt 1 executes server-side but the response is lost in
    transit; the retry replays the idempotency cache — ONE charge, ONE
    noise draw, byte-identical bytes."""
    srv = DpcorrServer(budget=1e6, max_delay_s=0.001, shard="off")
    try:
        lost = RetriableTransportError("connection reset mid-response")
        lost._after_execute = True
        rc = RetryingClient(_Flaky(InProcessClient(srv), [lost]),
                            RetryPolicy(base_delay_s=0.001), seed=0)
        req = _mk_req(seed=77)
        resp = rc.estimate(req, timeout=30)
        direct = srv.estimate(req, timeout=30)  # third replay, same bytes
        assert resp == direct
        snap = srv.stats.snapshot()
        assert snap["requests_total"] == 1
        assert snap["idempotent_hits_completed"] == 2
        assert srv.ledger.spent("party-x") == 2.0  # exactly one charge
    finally:
        srv.close()


def test_retrying_client_generates_identity_for_assigned_streams():
    """An assigned-stream request (no seed, no key) has no natural
    retry identity — the client mints one so its retries are
    charge-once too, and distinct logical requests stay distinct."""
    srv = DpcorrServer(budget=1e6, max_delay_s=0.001, shard="off")
    try:
        lost = RetriableTransportError("reset")
        lost._after_execute = True
        rc = RetryingClient(_Flaky(InProcessClient(srv), [lost]),
                            RetryPolicy(base_delay_s=0.001), seed=0)
        rc.estimate(_mk_req(seed=None), timeout=30)
        assert srv.ledger.spent("party-x") == 2.0  # one charge, one draw
        assert srv.stats.snapshot()["idempotent_hits_completed"] == 1
        # a SECOND logical request gets a fresh identity → fresh draw
        rc.estimate(_mk_req(seed=None), timeout=30)
        assert srv.ledger.spent("party-x") == 4.0
    finally:
        srv.close()


def test_retrying_client_budget_refusal_is_terminal():
    srv = DpcorrServer(budget=0.75, max_delay_s=0.001, shard="off")
    try:
        rc = RetryingClient(InProcessClient(srv),
                            RetryPolicy(base_delay_s=0.001), seed=0)
        from dpcorr_torch.serve import BudgetExceededError
        with pytest.raises(BudgetExceededError):
            rc.estimate(_mk_req(seed=1), timeout=30)
        st = rc.stats()
        assert st == {"attempts": 1, "terminal": 1}  # no retry happened
    finally:
        srv.close()


def test_retrying_client_gives_up_at_deadline_budget():
    sleeps = []
    rc = RetryingClient(
        _Flaky(None, [ServerOverloadedError("full", retry_after_s=10.0)]
               * 10),
        RetryPolicy(max_attempts=10, base_delay_s=0.01, deadline_s=5.0),
        clock=time.monotonic, sleep=sleeps.append, seed=0)
    with pytest.raises(ServerOverloadedError):
        rc.estimate(_mk_req(seed=1), timeout=1)
    st = rc.stats()
    # Retry-After=10 s > the 5 s budget: give up before the first sleep
    assert st["gave_up"] == 1 and st["attempts"] == 1
    assert sleeps == []


def test_retrying_client_honors_retry_after_floor():
    sleeps = []
    clk = _Clock()
    rc = RetryingClient(
        _Flaky(None, [ServerOverloadedError("full", retry_after_s=0.5)]
               * 3),
        RetryPolicy(max_attempts=3, base_delay_s=0.001, deadline_s=60.0),
        clock=clk, sleep=sleeps.append, seed=0)
    with pytest.raises(ServerOverloadedError):
        rc.estimate(_mk_req(seed=1), timeout=1)
    assert len(sleeps) == 2 and all(s >= 0.5 for s in sleeps)


# --------------------------------------------------------- HTTP e2e ----

def test_http_refusal_codes_round_trip():
    """The front end's typed refusal codes (504/503/Retry-After)
    reconstruct the in-process exceptions through HttpEstimateClient —
    so RetryingClient composes identically over the wire."""
    from dpcorr_torch.serve import HttpEstimateClient, make_http_server

    srv = DpcorrServer(budget=1e6, max_delay_s=0.2, shard="off",
                       breaker_threshold=1, breaker_reset_s=30.0)
    httpd = make_http_server(srv, port=0)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    client = HttpEstimateClient(f"http://127.0.0.1:{port}",
                                timeout_s=30.0)
    try:
        # 504: deadline expired while queued (charge refunded server-side)
        with pytest.raises(DeadlineExpiredError):
            client.estimate(_mk_req(seed=1, i=0, deadline_s=1e-9))
        assert srv.ledger.spent("party-x") == 0.0
        # 500 (executed fault) → generic retriable transport error;
        # times=2 covers both traversals (batched attempt + fallback)
        # so the request fails outright instead of degrading
        _fault("point=serve.kernel,mode=fail,times=2")
        with pytest.raises(RetriableTransportError):
            client.estimate(_mk_req(seed=2, i=1))
        # ... which tripped the threshold-1 breaker → 503 with Retry-After
        with pytest.raises(CircuitOpenError) as ei:
            client.estimate(_mk_req(seed=3, i=1))
        assert ei.value.retry_after_s >= 1.0  # ceil'd whole seconds
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()


# ------------------------------------------------------- chaos plans ----

def test_fault_specs_parse_as_in_jax():
    from dpcorr import chaos as jchaos

    for spec in ("point=serve.kernel,mode=fail,times=3",
                 "point=serve.kernel_slow,mode=sleep,delay_ms=40,after=2",
                 "point=serve.flush_stall,mode=sleep,delay_s=0.5"):
        assert chaos.fault_from_spec(spec).to_dict() == \
            jchaos.fault_from_spec(spec).to_dict()
    for bad, match in (("mode=fail", "names no point"),
                       ("point=serve.nope", "unknown fault point"),
                       ("point=serve.kernel,mode=sleep", "delay_s > 0")):
        with pytest.raises(ValueError, match=match):
            chaos.fault_from_spec(bad)


def test_faults_from_env_and_firing_window(monkeypatch):
    monkeypatch.setenv("DPCORR_FAULTS",
                       "point=serve.kernel,times=2,after=1;"
                       "point=serve.flush_stall,mode=sleep,delay_ms=1")
    plans = chaos.faults_from_env()
    assert [p.point for p in plans] == ["serve.kernel", "serve.flush_stall"]
    chaos.install_faults(plans)
    fired = []
    for _ in range(5):
        try:
            chaos.fault("serve.kernel")
            fired.append(False)
        except chaos.SimulatedFault:
            fired.append(True)
    assert fired == [False, True, True, False, False]
    chaos.fault("serve.flush_stall")  # sleeps 1 ms, raises nothing
    with pytest.raises(ValueError, match="unregistered fault point"):
        chaos.fault("serve.nope")


def test_crash_point_before_persist_leaves_the_ledger_file(tmp_path):
    """A kill between the in-memory spend and the file write leaves the
    previous durable state: a restart sees the spend before the kill."""
    from dpcorr_torch.serve import PrivacyLedger

    path = str(tmp_path / "ledger.json")
    led = PrivacyLedger(budget=5.0, path=path)
    led.charge({"a": 1.0})
    hooks = []
    chaos.on_crash(hooks.append)
    chaos.install(chaos.ChaosPlan("ledger.pre_persist", mode="raise"))
    try:
        with pytest.raises(chaos.SimulatedCrash):
            led.charge({"a": 2.0})
    finally:
        chaos.clear()
        chaos.remove_crash_hook(hooks.append)
    assert hooks == ["ledger.pre_persist"]
    assert PrivacyLedger(budget=5.0, path=path).spent("a") == 1.0
    with pytest.raises(ValueError, match="unknown chaos point"):
        chaos.ChaosPlan("gate.nope")
    # the fleet's point arms like every other, its module being ported
    chaos.install(chaos.ChaosPlan("fleet.pre_lease_commit"))
    assert chaos.active().point == "fleet.pre_lease_commit"
    chaos.clear()
    assert chaos.active() is None
