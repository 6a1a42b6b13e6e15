"""Host↔device transfer accounting for the port's dispatch sites.

Counterpart of ``dpcorr/obs/transfer.py``, with its six series. The JAX
package counts what XLA does with donated and pre-sharded buffers; eager
torch has neither, so each counter is defined here by what the port
does:

- ``dpcorr_transfer_fetches_total`` — a counted device-to-host read at
  a reduction boundary (``plan.Executor.fetch``): one per plan, so one
  per ``sim.RepBlockPipeline.run``, one per grid bucket that ran, one
  per serving flush and one per stream pass. A rising fetches:plans
  ratio is an accidental host sync.
- ``dpcorr_transfer_device_put_total`` / ``_bytes_total`` — an explicit
  host-to-card copy made through ``plan.placement`` (``preshard``, or
  ``put`` / ``put_ints`` where a loop copies one tensor at a time; those
  tally copies and add them once, at the stream pass's fetch). A tensor
  already on its device is not counted.
- ``dpcorr_transfer_reshard_mismatch_total`` — a tensor that was
  already on a device other than the placement's (another card) and
  had to be moved.
- ``dpcorr_transfer_donated_blocks_total`` — a block written into the
  pipeline's preallocated output and accumulator buffers, the port's
  counterpart of donation (``sim.RepBlockPipeline``).
- ``dpcorr_transfer_donation_unused_total`` — a block that could not be
  written in place. No path of the port allocates per block, so it
  stays 0; it is kept so the series match the JAX package's.

``donation_watch`` has no counterpart: eager torch makes no donation
offer a runtime could decline, so there is no warning to watch.

The counters live in the process default registry
(``obs.metrics.default_registry``) unless a caller gives its own (tests
do, so concurrent pipelines never mix counts).
"""

from __future__ import annotations

from typing import Mapping

from dpcorr_torch.obs.metrics import Registry, default_registry


class TransferCounters:
    """The transfer-counter bundle for one registry (usually the process
    default)."""

    def __init__(self, registry: Registry | None = None):
        self.registry = registry if registry is not None \
            else default_registry()
        self.donated_blocks = self.registry.counter(
            "dpcorr_transfer_donated_blocks_total",
            "Blocks written into preallocated pipeline buffers")
        self.donation_unused = self.registry.counter(
            "dpcorr_transfer_donation_unused_total",
            "Blocks that could not be written in place")
        self.fetches = self.registry.counter(
            "dpcorr_transfer_fetches_total",
            "Host fetches at a reduction boundary")
        self.device_puts = self.registry.counter(
            "dpcorr_transfer_device_put_total",
            "Explicit host-to-device placements (pre-sharding)")
        self.device_put_bytes = self.registry.counter(
            "dpcorr_transfer_device_put_bytes_total",
            "Bytes moved by explicit host-to-device placements")
        self.reshard_mismatch = self.registry.counter(
            "dpcorr_transfer_reshard_mismatch_total",
            "Tensors already on another device that had to be moved")

    def snapshot(self) -> dict[str, int]:
        """Flat dict of the six counts."""
        return {
            "donated_blocks": int(self.donated_blocks.value()),
            "donation_unused": int(self.donation_unused.value()),
            "fetches": int(self.fetches.value()),
            "device_put": int(self.device_puts.value()),
            "device_put_bytes": int(self.device_put_bytes.value()),
            "reshard_mismatch": int(self.reshard_mismatch.value()),
        }


_default: TransferCounters | None = None


def default_counters() -> TransferCounters:
    """The process-wide bundle over the default registry."""
    global _default
    if _default is None:
        _default = TransferCounters()
    return _default


def diff(after: Mapping[str, int], before: Mapping[str, int],
         ) -> dict[str, int]:
    """Per-run delta between two :meth:`TransferCounters.snapshot` calls
    (the counters are process-cumulative)."""
    return {k: int(after[k]) - int(before.get(k, 0)) for k in after}
