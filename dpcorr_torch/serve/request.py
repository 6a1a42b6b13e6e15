"""Request/response types and bucket signatures for the serving layer.

Counterpart of ``dpcorr/serve/request.py``, with the same bucket and
kernel keys, so the two packages bucket a request alike.

Two levels of grouping, both explicit:

- :func:`bucket_key` — the **coalescing** bucket ``(family, padded-n,
  ε-pair, α, normalise)``. Requests landing in the same bucket are held
  together by the coalescer and flushed as one unit; n is quantized to
  the next power of two so near-miss sample sizes share a flush queue
  (and its timer) instead of each opening a singleton bucket.
- :func:`kernel_key` — the **kernel** signature: the bucket key plus
  the *exact* n. The batch geometry (common.batch_geometry) follows from
  n, so a flushed bucket launches one batch per distinct n it contains;
  at steady state traffic per client is fixed-n and a flush is a single
  launch. The kernel cache (serve.kernels) is keyed here, so the number
  of live entries is bounded by live (family, n, ε) combinations, not
  by request count.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from dpcorr_torch.models.estimators.families import FAMILIES

#: Smallest padded-n bucket — below this every n shares one bucket.
MIN_N_BUCKET = 64


def pad_n(n: int, floor: int = MIN_N_BUCKET) -> int:
    """Next power of two ≥ max(n, floor): the coalescing n-bucket."""
    v = max(int(n), floor)
    return 1 << (v - 1).bit_length()


class BucketKey(NamedTuple):
    """Coalescing bucket: which requests may share a flush."""

    family: str
    n_pad: int
    eps1: float
    eps2: float
    alpha: float
    normalise: bool


class KernelKey(NamedTuple):
    """Kernel signature: which requests share one batched launch."""

    family: str
    n: int
    eps1: float
    eps2: float
    alpha: float
    normalise: bool


@dataclasses.dataclass(frozen=True)
class EstimateRequest:
    """One online DP-correlation query.

    ``party_x`` / ``party_y`` name the data owners whose privacy budget
    the query spends (ε₁ against x's owner, ε₂ against y's — doubled
    for sign families with ``normalise``, see serve.ledger). ``seed``
    pins the request's noise stream for reproducible replays of this
    exact request — the stream is bound to the request content
    (server.pinned_request_key), so reusing a seed over different data
    draws independent noise rather than enabling differencing. ``None``
    lets the server assign a stream from its per-boot subtree.
    """

    family: str
    x: np.ndarray
    y: np.ndarray
    eps1: float
    eps2: float
    party_x: str = "party-x"
    party_y: str = "party-y"
    alpha: float = 0.05
    normalise: bool = True
    seed: int | None = None
    #: client retry token: two submissions with the same key are the
    #: same logical request — the second returns the first's response
    #: without a second ledger charge or noise draw (server idempotency
    #: cache). Pinned-seed requests get a content-derived default key,
    #: so a dropped-response retry is always safe without client
    #: bookkeeping.
    idempotency_key: str | None = None
    #: shedding rank under overload: when the queue is at capacity the
    #: coalescer evicts the pending request with the LOWEST (priority,
    #: remaining-deadline) in favor of a strictly better newcomer, and
    #: brownout mode refuses work below the server's priority floor.
    #: Routing metadata like the party names — deliberately NOT part of
    #: the request digest (same content at different priority is the
    #: same query, same noise stream, same idempotency identity).
    priority: int = 0
    #: seconds this request is worth waiting for, measured from
    #: admission. A request still queued when it expires is dropped
    #: BEFORE its kernel launches and its charge refunded
    #: (DeadlineExpiredError / HTTP 504) — late answers to departed
    #: clients must not consume ε. ``None`` = no deadline.
    deadline_s: float | None = None
    #: requesting principal for per-user budget accounting
    #: (serve.budget_dir): when the server runs a budget directory the
    #: request's total party ε is also charged against ``user/<user>``.
    #: Routing metadata like priority — deliberately NOT part of the
    #: request digest (the same query from the same user retried is the
    #: same noise stream), but folded into the idempotency identity so
    #: two *different* users submitting identical content each get
    #: their own charge. ``None`` = no user leg.
    user: str | None = None

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown estimator family {self.family!r}; "
                             f"expected one of {FAMILIES}")
        if self.idempotency_key is not None \
                and not isinstance(self.idempotency_key, str):
            raise ValueError("idempotency_key must be a string or None, "
                             f"got {type(self.idempotency_key).__name__}")
        x = np.asarray(self.x, dtype=np.float32)
        y = np.asarray(self.y, dtype=np.float32)
        if x.ndim != 1 or y.ndim != 1 or x.shape != y.shape:
            raise ValueError(f"x and y must be equal-length 1-D vectors, "
                             f"got {x.shape} and {y.shape}")
        if x.shape[0] < 2:
            raise ValueError(f"need at least two observations, "
                             f"got n={x.shape[0]}")
        if not (self.eps1 > 0.0 and self.eps2 > 0.0):
            raise ValueError(f"eps must be positive, got "
                             f"({self.eps1}, {self.eps2})")
        if not isinstance(self.priority, int) \
                or isinstance(self.priority, bool):
            raise ValueError("priority must be an int, got "
                             f"{type(self.priority).__name__}")
        if self.deadline_s is not None and not self.deadline_s > 0.0:
            raise ValueError("deadline_s must be positive or None, "
                             f"got {self.deadline_s}")
        if self.user is not None and not isinstance(self.user, str):
            raise ValueError("user must be a string or None, got "
                             f"{type(self.user).__name__}")
        object.__setattr__(self, "x", x)
        object.__setattr__(self, "y", y)

    @property
    def n(self) -> int:
        return int(self.x.shape[0])


def bucket_key(req: EstimateRequest) -> BucketKey:
    return BucketKey(req.family, pad_n(req.n), float(req.eps1),
                     float(req.eps2), float(req.alpha), bool(req.normalise))


def kernel_key(req: EstimateRequest) -> KernelKey:
    return KernelKey(req.family, req.n, float(req.eps1), float(req.eps2),
                     float(req.alpha), bool(req.normalise))


@dataclasses.dataclass(frozen=True)
class EstimateResponse:
    """The answer plus serving metadata (how the request was executed)."""

    rho_hat: float
    ci_low: float
    ci_high: float
    #: True when the request ran inside a coalesced batch; False on
    #: the unbatched degradation path (bucket never filled / batch-path
    #: failure fallback).
    batched: bool
    #: number of live requests in the flushed launch (1 when unbatched)
    batch_size: int
    #: admission-to-completion wall seconds
    latency_s: float
    #: seed the noise stream was derived from — replayable only when
    #: the request pinned it (server-assigned streams also fold in a
    #: per-boot nonce, deliberately not reproducible across restarts)
    seed: int
    #: per-request cost attribution (obs.cost.CostRecord.to_dict():
    #: queue/compile/kernel seconds, retries, shed events, ε charged
    #: and refunded per party)
    cost: dict | None = None
