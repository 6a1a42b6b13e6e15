"""Always-on windowed DP correlation: the stream service.

Counterpart of ``dpcorr/stream/``, with the same modules and exports:

- :mod:`sketch` — mergeable per-window sketch states over per-chunk
  sufficient statistics; ``merge`` is a disjoint dict union, so shard
  sketches tree-reduce and the shard split can never change a release
  byte (on the card too: each chunk is computed alone at a fixed shape).
- :mod:`windows` — tumbling/sliding event-time windows with a bounded
  late-data admission.
- :mod:`wal` — the ingest WAL and the released-window journal, in the
  JAX package's line format.
- :mod:`service` — the window manager + per-window DP release: one
  atomic :class:`~dpcorr_torch.serve.budget_dir.CompositeLedger` charge
  per window (refuse-before-release, idempotent
  ``stream:<stream>:<window>`` charge ids), pinned per-window noise
  streams, crash-exact resume.
- :mod:`http` — the ingest/subscribe HTTP front end.

The window releases run on the card unless the caller passes
``device="cpu"``.
"""

from dpcorr_torch.stream.sketch import (  # noqa: F401
    ChunkGrid,
    ReleaseParams,
    SketchState,
    grid_for,
    release_window,
    window_key,
)
from dpcorr_torch.stream.service import (  # noqa: F401
    StreamOverloadedError,
    StreamService,
)
from dpcorr_torch.stream.windows import WindowManager, WindowSpec  # noqa: F401

__all__ = [
    "ChunkGrid", "ReleaseParams", "SketchState", "StreamOverloadedError",
    "StreamService", "WindowManager", "WindowSpec", "grid_for",
    "release_window", "window_key",
]
