"""Plan/executor layer: build → dispatch → fetch, once.

Counterpart of ``dpcorr/plan/``. The rep pipeline
(``sim.RepBlockPipeline``), the grid's bucketed phases
(``dpcorr_torch.grid``), the serving kernel cache
(``dpcorr_torch.serve.kernels``), the federation's ``finish_batch``
(``models.estimators.split_reference``) and the stream's releases
(``stream.service``) dispatch through it, with the placement pluggable:

- ``local`` — one device, bit-equal to the direct calls;
- ``mesh`` — the batch axis split over ``parallel.mesh.rep_devices``;
- ``multihost`` — a named seam that raises, pointing at
  ``parallel.multihost``'s gloo group.

Builds go through ``utils.compile`` and each plan's one host read is
counted into ``obs.transfer``.
"""

from dpcorr_torch.plan.executor import Executor, Prepared
from dpcorr_torch.plan.placement import (
    LocalPlacement,
    MeshPlacement,
    MultihostPlacement,
    Placement,
    preshard,
    resolve_placement,
)

__all__ = [
    "Executor",
    "LocalPlacement",
    "MeshPlacement",
    "MultihostPlacement",
    "Placement",
    "Prepared",
    "preshard",
    "resolve_placement",
]
