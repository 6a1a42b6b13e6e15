"""Retrying clients: jittered backoff over the idempotent serve API.

Counterpart of ``dpcorr/serve/client.py``. Every request has a retry
identity (idempotency keys, serve.server); this module is the client
half that makes retries *safe by construction*:

- :class:`RetryingClient` wraps any estimate client (the in-process
  one or :class:`HttpEstimateClient`) and retries **refusals that can
  heal** — overload sheds, open circuit breakers, deadline expiries,
  timeouts, transport drops — with jittered exponential backoff that
  honors the server's ``Retry-After`` estimate and an overall deadline
  budget. Budget refusals are terminal and never retried: ε exhaustion
  does not heal by waiting.
- Every attempt of one logical request reuses ONE idempotency key
  (requests without an identity get a generated ``rc:`` key up front),
  so a retry whose predecessor actually executed replays the cached
  response — byte-identical, charge-once, noise-drawn-once — instead
  of re-running (``idempotent_hits`` with a single ledger charge).

Retry arithmetic is stdlib, and the HTTP client speaks plain ``urllib``
against either package's serve front end.
"""

from __future__ import annotations

import dataclasses
import json
import random
import secrets
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import TimeoutError as _FuturesTimeout

from dpcorr_torch.serve.coalescer import ServerOverloadedError
from dpcorr_torch.serve.fleet.lease import ShardNotOwnedError
from dpcorr_torch.serve.ledger import BudgetExceededError
from dpcorr_torch.serve.overload import CircuitOpenError, DeadlineExpiredError
from dpcorr_torch.serve.request import EstimateRequest, EstimateResponse


class RetriableTransportError(Exception):
    """The wire failed (connection refused/reset, 5xx without a typed
    refusal) — nothing is known about server state, but the request's
    idempotency key makes blind retry safe."""


#: refusals that can heal with time — what the client retries.
#: ShardNotOwnedError heals too: leases move (TTL expiry, on-demand
#: takeover), and the refusal was charge-free by construction.
RETRIABLE = (ServerOverloadedError, CircuitOpenError,
             DeadlineExpiredError, RetriableTransportError,
             ShardNotOwnedError, _FuturesTimeout, TimeoutError)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff shape: ``base_delay_s * multiplier**k`` capped at
    ``max_delay_s``, multiplied by a uniform jitter in
    ``[1 - jitter, 1 + jitter]``, floored by the server's
    ``Retry-After`` when one was sent. ``deadline_s`` bounds the whole
    logical request (attempts + sleeps); ``max_attempts`` bounds the
    count."""

    max_attempts: int = 6
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5
    deadline_s: float | None = 30.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], "
                             f"got {self.jitter}")

    def delay_for(self, attempt: int, retry_after_s: float | None,
                  rng: random.Random) -> float:
        """Sleep before attempt ``attempt + 1`` (attempt is 1-based)."""
        d = min(self.base_delay_s * self.multiplier ** (attempt - 1),
                self.max_delay_s)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        if retry_after_s is not None:
            d = max(d, retry_after_s)
        return max(d, 0.0)


class RetryingClient:
    """Retry wrapper around an estimate client.

    ``client`` needs one method: ``estimate(req, timeout=...)``.
    ``clock``/``sleep``/``seed`` are injectable so tests can script
    time; ``seed`` pins the jitter stream (default: OS entropy).
    """

    def __init__(self, client, policy: RetryPolicy | None = None,
                 clock=time.monotonic, sleep=time.sleep,
                 seed: int | None = None):
        self.client = client
        self.policy = policy if policy is not None else RetryPolicy()
        self.clock = clock
        self.sleep = sleep
        self._rng = random.Random(seed if seed is not None
                                  else secrets.randbits(64))
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}  # guarded by: _lock

    def _count(self, what: str, k: int = 1) -> None:
        with self._lock:
            self._counts[what] = self._counts.get(what, 0) + k

    def stats(self) -> dict:
        with self._lock:
            return dict(self._counts)

    @staticmethod
    def _with_identity(req: EstimateRequest) -> EstimateRequest:
        """Pin ONE retry identity for every attempt of this logical
        request. Pinned-seed requests already have a content-derived
        key (serve.server); assigned-stream requests get a generated
        one so their retries are charge-once too — without it every
        retry would be a fresh draw and a fresh spend."""
        if req.idempotency_key is not None or req.seed is not None:
            return req
        return dataclasses.replace(
            req, idempotency_key=f"rc:{secrets.token_hex(16)}")

    def estimate(self, req: EstimateRequest,
                 timeout: float | None = 60.0) -> EstimateResponse:
        req = self._with_identity(req)
        t0 = self.clock()
        budget = self.policy.deadline_s
        last: Exception | None = None
        for attempt in range(1, self.policy.max_attempts + 1):
            self._count("attempts")
            try:
                resp = self.client.estimate(req, timeout=timeout)
            except RETRIABLE as e:
                last = e
                self._count("retryable")
                self._count(f"retryable:{type(e).__name__}")
            except BudgetExceededError:
                # terminal: waiting cannot un-spend ε
                self._count("terminal")
                raise
            else:
                self._count("successes")
                if attempt > 1:
                    self._count("recovered")
                    if isinstance(resp.cost, dict):
                        # client-side cost annotation: the server only
                        # sees attempts, the retry count is ours to
                        # stamp (the dict rides the frozen dataclass)
                        resp.cost["retries"] = \
                            resp.cost.get("retries", 0) + attempt - 1
                return resp
            if attempt == self.policy.max_attempts:
                break
            delay = self.policy.delay_for(
                attempt, getattr(last, "retry_after_s", None), self._rng)
            if budget is not None and \
                    self.clock() - t0 + delay > budget:
                break
            self._count("retries")
            self.sleep(delay)
        self._count("gave_up")
        raise last

    def submit(self, req: EstimateRequest):
        """Pass-through (no retry) — callers managing futures
        themselves own their retry loop."""
        return self.client.submit(req)


def request_to_json(req: EstimateRequest) -> dict:
    """The ``POST /estimate`` body for one request."""
    body = {"family": req.family,
            "x": [float(v) for v in req.x],
            "y": [float(v) for v in req.y],
            "eps1": req.eps1, "eps2": req.eps2,
            "party_x": req.party_x, "party_y": req.party_y,
            "alpha": req.alpha, "normalise": req.normalise,
            "seed": req.seed, "idempotency_key": req.idempotency_key,
            "priority": req.priority, "deadline_s": req.deadline_s,
            "user": req.user}
    return body


def _retry_after_from(headers) -> float | None:
    raw = headers.get("Retry-After") if headers is not None else None
    if raw is None:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


class HttpEstimateClient:
    """Estimate client over the serve HTTP front end, mapping the
    typed refusal codes back onto the same exceptions the in-process
    client raises — so :class:`RetryingClient` composes with either."""

    def __init__(self, base_url: str, timeout_s: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def estimate(self, req: EstimateRequest,
                 timeout: float | None = None) -> EstimateResponse:
        blob = json.dumps(request_to_json(req)).encode()
        http_req = urllib.request.Request(
            f"{self.base_url}/estimate", data=blob,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(
                    http_req, timeout=timeout if timeout is not None
                    else self.timeout_s) as r:
                body = json.load(r)
        except urllib.error.HTTPError as e:
            raise self._refusal(e) from e
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            raise RetriableTransportError(
                f"POST {self.base_url}/estimate failed: {e}") from e
        return EstimateResponse(
            rho_hat=body["rho_hat"], ci_low=body["ci_low"],
            ci_high=body["ci_high"], batched=body["batched"],
            batch_size=body["batch_size"], latency_s=body["latency_s"],
            seed=body["seed"], cost=body.get("cost"))

    @staticmethod
    def _refusal(e: urllib.error.HTTPError) -> Exception:
        try:
            body = json.load(e)
        except (json.JSONDecodeError, UnicodeDecodeError):
            body = {}
        msg = body.get("error", f"HTTP {e.code}")
        ra = _retry_after_from(e.headers)
        if e.code == 403 and body.get("refused") == "budget":
            return BudgetExceededError(
                body.get("party", "?"), float(body.get("spent", 0.0)),
                float(body.get("charge", 0.0)),
                float(body.get("budget", 0.0)))
        if e.code == 421:
            # fleet routing miss: this replica does not own the user's
            # budget shard (the front end normally forwards before a
            # client ever sees this; a direct client just retries)
            return ShardNotOwnedError(
                int(body.get("shard", -1)), owner=body.get("owner"),
                owner_url=body.get("owner_url"), retry_after_s=ra)
        if e.code == 504:
            return DeadlineExpiredError(msg, retry_after_s=ra)
        if e.code == 503:
            return CircuitOpenError(msg, retry_after_s=ra)
        if e.code == 429:
            return ServerOverloadedError(msg, retry_after_s=ra)
        if e.code >= 500:
            return RetriableTransportError(msg)
        return ValueError(msg)
