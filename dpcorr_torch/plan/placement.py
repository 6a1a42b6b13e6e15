"""Pluggable placement: where a plan's units run and how operands land.

Counterpart of ``dpcorr/plan/placement.py``. A :class:`Placement`
answers what every dispatch site used to answer privately: which
device(s) operands and results are placed on, how the batch axis pads
(a mesh needs a multiple of its device count), and which devices units
run over. JAX answers with shardings; here a "sharding" is a
``torch.device`` (whole tensors there) or a device list (the leading
axis split into contiguous shards, one per entry), as
``utils.compile.host_sharding`` and ``mesh_shardings`` make them.
"""

from __future__ import annotations

import torch

from dpcorr_torch.obs import transfer as transfer_mod


def canonical_device(device) -> torch.device:
    """``device`` as the indexed device a tensor on it reports (``cuda``
    becomes ``cuda:0``), so :func:`put` can compare it directly. A loop
    that copies tensor after tensor resolves it once."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class CopyTally:
    """Copies made by :func:`put` and :func:`put_ints`, tallied in plain
    ints and added to the transfer counters by :meth:`flush`, so a loop
    that copies tensor after tensor takes no counter lock per copy."""

    __slots__ = ("puts", "nbytes", "mismatch")

    def __init__(self):
        self.puts = self.nbytes = self.mismatch = 0

    def flush(self, counters) -> None:
        """Add the tally to ``counters`` (``obs.transfer``) and clear it."""
        if self.puts:
            counters.device_puts.inc(self.puts)
            counters.device_put_bytes.inc(self.nbytes)
        if self.mismatch:
            counters.reshard_mismatch.inc(self.mismatch)
        self.puts = self.nbytes = self.mismatch = 0


def put(a, dev: torch.device, tally: CopyTally,
        non_blocking: bool = False) -> torch.Tensor:
    """One operand onto ``dev`` (a :func:`canonical_device`), tallied
    when it is copied; a tensor already there is returned as it is. The
    per-tensor step of :func:`preshard`, called directly where a loop
    copies one chunk at a time (the stream's sketch)."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
    src = t.device
    if src == dev:
        return t
    if src.type != "cpu":
        tally.mismatch += 1
    if non_blocking and src.type == "cpu" and dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    else:
        t = t.to(dev)
    tally.puts += 1
    tally.nbytes += t.nbytes
    return t


def put_ints(values, dev: torch.device, tally: CopyTally) -> torch.Tensor:
    """A short list of host ints (a key's two or four words) as an int64
    tensor made on ``dev`` in one call, tallied as one copy when ``dev``
    is not the host."""
    t = torch.tensor(values, dtype=torch.int64, device=dev)
    if dev.type != "cpu":
        tally.puts += 1
        tally.nbytes += 8 * len(values)
    return t


def preshard(arrays, sharding, counters=None,
             non_blocking: bool = False) -> tuple:
    """Place ``arrays`` on ``sharding`` before dispatch: a device puts
    each whole tensor there; a device list splits each leading axis into
    contiguous shards (``tensor_split``), one per entry, and returns a
    list of pieces per array. A tensor already where it belongs is not
    copied. Each copy is counted into the transfer counters
    (``obs.transfer``: ``device_put`` and its bytes, and
    ``reshard_mismatch`` when the tensor sat on another device). Numpy
    arrays and numbers are taken as CPU tensors.

    ``non_blocking`` copies host tensors to the card from pinned memory
    without waiting for the work queued there (the grid's short host
    lists, enqueued bucket after bucket); otherwise the copy is the
    plain pageable one, which waits for the card."""
    tally = CopyTally()
    if isinstance(sharding, (list, tuple)):
        devs = [canonical_device(d) for d in sharding]
        out = []
        for a in arrays:
            t = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
            out.append([put(p, d, tally, non_blocking) for p, d in
                        zip(t.tensor_split(len(devs)), devs, strict=True)])
        placed = tuple(out)
    else:
        dev = canonical_device(sharding)
        placed = tuple(put(a, dev, tally, non_blocking) for a in arrays)
    tally.flush(counters if counters is not None
                else transfer_mod.default_counters())
    return placed


class Placement:
    """Interface: one answer to "where does this plan run"."""

    name = "?"

    def data_sharding(self):
        """Where batch-axis operands and per-element results go."""
        raise NotImplementedError

    def replicated_sharding(self):
        """Where whole operands (scalars, small vectors) go."""
        raise NotImplementedError

    @property
    def devices(self) -> list[torch.device]:
        raise NotImplementedError

    @property
    def device_count(self) -> int:
        return 1

    def mesh_shape(self):
        """``{axis: size}`` for mesh placements, None otherwise."""
        return None

    def pad(self, n: int) -> int:
        """Smallest dispatchable batch size >= n for this placement."""
        return int(n)

    def preshard(self, arrays, counters=None) -> tuple:
        return preshard(arrays, self.data_sharding(), counters)


class LocalPlacement(Placement):
    """Everything on one device: ``device``, or the card when none is
    named (resolved at first use, so naming the placement needs no
    card). No padding, no mesh."""

    name = "local"

    def __init__(self, device=None):
        self._device = device

    def data_sharding(self) -> torch.device:
        from dpcorr_torch.utils.compile import host_sharding

        return host_sharding(self._device)

    def replicated_sharding(self) -> torch.device:
        return self.data_sharding()

    @property
    def devices(self) -> list[torch.device]:
        return [self.data_sharding()]


class MeshPlacement(Placement):
    """The batch axis split over a device list, contiguous shards in
    device order (``parallel.mesh.rep_devices``): ``devices`` given, or
    the first ``n_devices`` cards (default all), or with ``device="cpu"``
    ``n_devices`` CPU entries whose shards run one after another. On one
    H100 it is one device."""

    name = "mesh"

    def __init__(self, devices=None, n_devices: int | None = None,
                 device=None):
        if devices is None:
            from dpcorr_torch.parallel.mesh import rep_devices

            devices = rep_devices(n_devices, device=device)
        elif n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices={n_devices} but {len(devices)} "
                             f"devices given")
        self._devices = [torch.device(d) for d in devices]
        if not self._devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def devices(self) -> list[torch.device]:
        return list(self._devices)

    @property
    def device_count(self) -> int:
        return len(self._devices)

    def mesh_shape(self) -> dict:
        return {"rep": self.device_count}

    def data_sharding(self) -> list[torch.device]:
        from dpcorr_torch.utils.compile import mesh_shardings

        return mesh_shardings(self._devices)[0]

    def replicated_sharding(self) -> torch.device:
        from dpcorr_torch.utils.compile import mesh_shardings

        return mesh_shardings(self._devices)[1]

    def pad(self, n: int) -> int:
        d = self.device_count
        return -(-int(n) // d) * d


class MultihostPlacement(Placement):
    """The multihost seam. Resolvable by name so plans can state the
    intent, but every execution surface raises with the recipe."""

    name = "multihost"

    @property
    def device_count(self) -> int:
        return 0  # unknown until the distributed group is up

    def _unavailable(self):
        raise NotImplementedError(
            "multihost placement is a seam, not an implementation: join "
            "the gloo group first (dpcorr_torch.parallel.multihost."
            "init_distributed, as `grid --n-hosts N --distributed` does), "
            "then build a MeshPlacement over each process's devices")

    def data_sharding(self):
        self._unavailable()

    def replicated_sharding(self):
        self._unavailable()

    @property
    def devices(self):
        self._unavailable()

    def pad(self, n: int) -> int:
        self._unavailable()


def resolve_placement(spec, *, devices=None, device=None) -> Placement:
    """``spec`` is a Placement (returned as is) or one of the names
    ``"local"`` / ``"mesh"`` / ``"multihost"`` (None means local).
    ``devices`` feeds a mesh placement (default: every card, or one CPU
    entry with ``device="cpu"``); ``device`` pins a local one."""
    if isinstance(spec, Placement):
        return spec
    if spec is None or spec == "local":
        return LocalPlacement(device)
    if spec == "mesh":
        return MeshPlacement(devices, device=device)
    if spec == "multihost":
        return MultihostPlacement()
    raise ValueError(
        f"unknown placement {spec!r}: expected 'local', 'mesh', or "
        "'multihost' (or a Placement instance)")
