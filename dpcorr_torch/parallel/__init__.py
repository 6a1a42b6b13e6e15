"""Replications over several devices and the grid over several worker
processes (counterpart of ``dpcorr.parallel``, which replaces the
reference's ``mclapply`` layer, vert-cor.R:534-554):

- replications → contiguous shards over :func:`rep_devices`
  (:mod:`dpcorr_torch.parallel.backend`), summaries as f32 partial sums
  per shard added in shard order;
- design grid → whole (n, ε) buckets per worker process into a shared
  ``design_*.npz`` cache, merged through the grid's resume
  (:mod:`dpcorr_torch.parallel.multihost`), optionally as a
  ``torch.distributed`` gloo group whose one collective is a barrier.
"""

from dpcorr_torch.parallel.backend import (  # noqa: F401
    make_serve_batch_sharded,
    run_detail_flat_sharded,
    run_detail_sharded,
    run_summary_sharded,
)
from dpcorr_torch.parallel.mesh import (  # noqa: F401
    local_device_count,
    rep_devices,
    rep_mesh,
)
from dpcorr_torch.parallel.multihost import (  # noqa: F401
    grid_slice,
    run_grid_host,
    run_grid_multihost,
)
