"""Per-device memory watermarks and per-device transfer attribution.

Counterpart of ``dpcorr/obs/devicemon.py``, with the same
``dpcorr_device_*`` gauge names. It samples what the CUDA caching
allocator reports and maps it onto the JAX package's keys:

- ``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` →
  ``bytes_in_use``, ``allocated_bytes.all.peak`` → ``peak_bytes_in_use``;
  the device's total memory → ``bytes_limit``. A field the allocator does
  not report (nothing allocated yet) is absent, never a zero;
- no live-buffer sampling: torch has no counterpart of
  ``jax.live_arrays``, so ``live_buffers`` and ``live_buffer_bytes`` are
  never set;
- the process-wide transfer counters (``obs.transfer``) attributed to
  one device, as in the JAX package.

Devices are labelled ``cuda:<i>``. A host with no CUDA device
contributes no series: every probe returns ``{}``. Importing this module
imports no torch.
"""

from __future__ import annotations

import threading

from dpcorr_torch.obs.metrics import Registry, default_registry

#: the keys published (the JAX package's), the gauge names and help
_MEM_KEYS = (
    ("bytes_in_use", "dpcorr_device_mem_bytes_in_use",
     "Device allocator bytes currently in use"),
    ("peak_bytes_in_use", "dpcorr_device_mem_peak_bytes",
     "Device allocator high-water mark (backend-reported)"),
    ("bytes_limit", "dpcorr_device_mem_limit_bytes",
     "Device allocator capacity"),
)

#: ``torch.cuda.memory_stats`` key of each allocator-reported field
_TORCH_KEYS = (("bytes_in_use", "allocated_bytes.all.current"),
               ("peak_bytes_in_use", "allocated_bytes.all.peak"))


def device_label(index: int) -> str:
    """The label of card ``index``: ``cuda:<index>``."""
    return f"cuda:{int(index)}"


def probe() -> dict[str, dict]:
    """One sample of every visible card: ``{device_label: stats}``.
    ``{}`` on a host with no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        return {}
    out: dict[str, dict] = {}
    for i in range(torch.cuda.device_count()):
        reported = torch.cuda.memory_stats(i)
        stats = {key: int(reported[tkey]) for key, tkey in _TORCH_KEYS
                 if tkey in reported}
        stats["bytes_limit"] = int(
            torch.cuda.get_device_properties(i).total_memory)
        out[device_label(i)] = stats
    return out


class DeviceMonitor:
    """Samples card memory and splits the transfer counters per device,
    publishing ``dpcorr_device_*`` gauges into ``registry`` and keeping
    its own high-water marks across samples (the allocator's peak resets
    with ``reset_peak_memory_stats``; the monitor's watermark survives)."""

    def __init__(self, registry: Registry | None = None,
                 transfer_counters=None):
        self.registry = registry if registry is not None \
            else default_registry()
        r = self.registry
        self._mem_gauges = {
            key: r.gauge(gname, ghelp, labelnames=("device",))
            for key, gname, ghelp in _MEM_KEYS}
        self._transfer = r.gauge(
            "dpcorr_device_transfer",
            "Process transfer counters (obs.transfer) attributed to "
            "the dispatch placement device",
            labelnames=("device", "counter"))
        self._counters = transfer_counters
        self._lock = threading.Lock()
        self._watermarks: dict[str, dict] = {}  # guarded by: _lock

    def sample(self, transfer_device: str | None = None) -> dict:
        """One sample: probe the cards, publish gauges, fold watermarks.
        ``transfer_device`` names the card the process's transfer
        counters belong to; default is the first probed card."""
        snap = probe()
        with self._lock:
            for label, stats in snap.items():
                for key, _, _ in _MEM_KEYS:
                    if key in stats:
                        self._mem_gauges[key].set(stats[key],
                                                  device=label)
                wm = self._watermarks.setdefault(label, {})
                for key in ("bytes_in_use", "peak_bytes_in_use"):
                    if key in stats:
                        wm[key] = max(wm.get(key, 0), stats[key])
                if "bytes_limit" in stats:
                    wm["bytes_limit"] = stats["bytes_limit"]
        if self._counters is not None and snap:
            label = transfer_device if transfer_device is not None \
                else sorted(snap)[0]
            for counter, value in self._counters.snapshot().items():
                self._transfer.set(value, device=label, counter=counter)
        return snap

    def watermarks(self) -> dict[str, dict]:
        """Per-card high-water marks over this monitor's lifetime."""
        with self._lock:
            return {label: dict(wm)
                    for label, wm in sorted(self._watermarks.items())}


def watermarks_detail(transfer_counters=None) -> dict[str, dict]:
    """One-shot probe for artifact stamping: a private registry, one
    sample, the watermark dict; empty on a host with no card."""
    mon = DeviceMonitor(registry=Registry(),
                        transfer_counters=transfer_counters)
    mon.sample()
    return mon.watermarks()
