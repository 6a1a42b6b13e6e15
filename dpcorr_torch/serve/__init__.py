"""Online serving: micro-batched DP-correlation queries on the card with a
per-party privacy-budget ledger.

Counterpart of ``dpcorr/serve/``. The pieces, bottom up — each module's
docstring carries its own contract:

- :mod:`request`   — request/response types; coalescing bucket and
  kernel-signature keys.
- :mod:`ledger`    — per-party ε accounting under basic composition:
  refusal before execution, write-ahead persistence in the JAX
  package's file format.
- :mod:`kernels`   — kernel cache keyed on (signature, padded batch
  width, shards), with the ``exact`` and ``vector`` batch engines.
- :mod:`stats`     — live counters: queue depth, flush sizes,
  batch-fill ratio, latency percentiles, ε spend.
- :mod:`coalescer` — the micro-batcher: per-bucket queues, size/age
  flush policy, backpressure, unbatched degradation; deadline drops,
  priority eviction and refuse-draining shutdown (every shed refunds).
- :mod:`overload`  — circuit breaker and brownout.
- :mod:`budget_dir` — the per-user budget directory (sharded WAL +
  snapshot journals) and the CompositeLedger over it.
- :mod:`client`    — retrying clients and the HTTP client speaking the
  front end's refusal codes.
- :mod:`warmup`    — warm signature sets behind ``/readyz``.
- :mod:`server`    — composition root + in-process client + stdlib
  HTTP front end (``python -m dpcorr_torch serve``).
- :mod:`fleet`     — N replicas over one leased budget directory: shard
  leases, the front-end router and the replica supervisor
  (``python -m dpcorr_torch fleet``).
"""

import importlib

# Lazy re-exports (PEP 562), as in the JAX package: importing a leaf
# (request, ledger, client) does not load the estimators.
_EXPORTS = {
    # client
    "HttpEstimateClient": "client",
    "RetriableTransportError": "client",
    "RetryingClient": "client",
    "RetryPolicy": "client",
    "request_to_json": "client",
    # coalescer
    "Coalescer": "coalescer",
    "ServerClosedError": "coalescer",
    "ServerOverloadedError": "coalescer",
    # kernels
    "KernelCache": "kernels",
    "pad_batch": "kernels",
    # overload
    "BrownoutController": "overload",
    "CircuitBreaker": "overload",
    "CircuitOpenError": "overload",
    "DeadlineExpiredError": "overload",
    # ledger
    "BudgetExceededError": "ledger",
    "PrivacyLedger": "ledger",
    "request_charges": "ledger",
    # request
    "BucketKey": "request",
    "EstimateRequest": "request",
    "EstimateResponse": "request",
    "KernelKey": "request",
    "bucket_key": "request",
    "kernel_key": "request",
    "pad_n": "request",
    # server
    "DpcorrServer": "server",
    "InProcessClient": "server",
    "make_http_server": "server",
    "pinned_request_key": "server",
    "serve_http": "server",
    # stats
    "ServeStats": "stats",
    "percentiles": "stats",
    # warmup
    "load_manifest": "warmup",
    "parse_warmup_spec": "warmup",
    "save_manifest": "warmup",
    "signatures_to_keys": "warmup",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(
        importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value  # cache: resolve each name once
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
