"""Horizontally scaled serve: front-end router, leased budget shards,
process supervision.

Counterpart of ``dpcorr/serve/fleet/``. It turns the single-process serve
node into N replicas behind one HTTP front end, without giving up a
single exactness invariant:

- :mod:`~dpcorr_torch.serve.fleet.lease` — durable fsynced lease files
  grant each :class:`~dpcorr_torch.serve.budget_dir.BudgetDirectory`
  shard to exactly one replica at a time (epoch-numbered, TTL +
  heartbeat), so any replica can admit any user without double-spend.
- :mod:`~dpcorr_torch.serve.fleet.frontend` — health-checked routing
  with per-replica circuit state, Retry-After passthrough, and
  consistent-hash shard affinity keyed on the request's user.
- :mod:`~dpcorr_torch.serve.fleet.supervisor` — boots, monitors and
  restarts replicas with identical argv, so a killed replica's shards
  are re-leased and its WAL-recovered balances stay exact.

Nothing here computes on a device: the front end and the supervisor are
deployment-plane code; the replicas compute on their ``--device``.
Lease files and lease-mode directories are the JAX package's formats, so
a fleet may mix replicas of the two packages.
"""

from dpcorr_torch.serve.fleet.frontend import (
    FleetFrontend,
    make_frontend_http_server,
)
from dpcorr_torch.serve.fleet.lease import (
    LeaseKeeper,
    LeaseManager,
    ShardNotOwnedError,
    lease_table,
)
from dpcorr_torch.serve.fleet.supervisor import (
    ReplicaDiedError,
    ReplicaSpec,
    Supervisor,
)

__all__ = [
    "FleetFrontend",
    "LeaseKeeper",
    "LeaseManager",
    "ReplicaDiedError",
    "ReplicaSpec",
    "ShardNotOwnedError",
    "Supervisor",
    "lease_table",
    "make_frontend_http_server",
]
