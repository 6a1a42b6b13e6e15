"""The stream service: window manager + per-window DP release.

Counterpart of ``dpcorr/stream/service.py``, on ``device`` (the card
unless the caller names another; raises without one). Its workdir — the
ingest WAL, the release journal, ``ledger.json``, ``audit.jsonl`` and
the optional ``budget_dir/`` — is in the JAX package's formats, so a
workdir written by either package is resumed by the other: a journaled
window is served from the journal, never recomputed, and a per-window
charge id is never charged twice. HTTP handler threads call
:meth:`StreamService.ingest`; a release runs under the service lock on
the handler's thread, on the service's device and its default stream.

One :class:`StreamService` owns the whole always-on pipeline for one
logical stream: ingest (WAL before ack, bounded pending rows, late-data
refusal), event-time windowing (:mod:`dpcorr_torch.stream.windows`), and the
per-window release sequence whose ordering IS the crash-safety
argument:

1. ``chaos.point("stream.pre_release")`` — the window is closable,
   nothing charged yet. A kill here loses only in-memory state; the
   WAL replays it and the release runs at recovery.
2. **Charge** — one atomic
   :class:`~dpcorr_torch.serve.budget_dir.CompositeLedger` charge for the
   whole window (every family, both parties, plus the optional
   per-user and global legs), under the idempotent charge id
   ``stream:<stream_id>:<window_id>``. Refuse-before-release: a budget
   refusal marks the window refused and draws **no** noise. A kill
   after the charge persists re-runs the same charge at recovery and
   dedups — exactly-once ε.
3. **Release** — :func:`dpcorr_torch.stream.sketch.release_window` under the
   pinned per-window key (``stream/<window_id>`` subtree of the
   service master key). A pure function of (admitted rows, window id,
   params), so a replayed window is byte-identical. An in-process
   release failure refunds the charge and arms the flight recorder
   (``stream_release_failed``); a simulated *crash*
   (:class:`~dpcorr_torch.chaos.SimulatedCrash`, a BaseException) sails
   through the refund handler like a real kill would.
4. **Journal** — fsynced append to the released-window journal, then
   ``chaos.point("stream.post_journal")``. A journaled window is done:
   recovery serves it from the journal and closes it without
   recomputing.

Renewal epoch == release epoch: when a per-user budget directory is
attached, its :class:`~dpcorr_torch.serve.budget_dir.RenewalPolicy`
period is the window hop and its clock is the *event time of the window being
released* — so each release epoch charges exactly one renewal window,
never straddling two.
"""

from __future__ import annotations

import os
import threading
import time

from dpcorr_torch import chaos
from dpcorr_torch.obs import recorder as obs_recorder
from dpcorr_torch.obs.audit import AuditTrail
from dpcorr_torch.obs.cost import CostRegistry
from dpcorr_torch.obs.metrics import Registry
from dpcorr_torch.serve.budget_dir import (
    BudgetDirectory,
    CompositeLedger,
    RenewalPolicy,
)
from dpcorr_torch.serve.ledger import (
    BudgetExceededError,
    PrivacyLedger,
    release_factor,
)
from dpcorr_torch.stream import sketch
from dpcorr_torch.stream.wal import IngestWAL, ReleaseJournal
from dpcorr_torch.stream.windows import (
    LateRecordError,
    Window,
    WindowManager,
    WindowSpec,
    as_rows,
)
from dpcorr_torch.utils import compile as compile_mod
from dpcorr_torch.utils.device import resolve_device
from dpcorr_torch.utils.rng import master_key

__all__ = ["Releaser", "StreamOverloadedError", "StreamService",
           "window_charges"]


class StreamOverloadedError(Exception):
    """The bounded ingest queue (pending un-released rows) is full.
    The HTTP layer maps this to 429 + ``Retry-After``."""

    def __init__(self, retry_after_s: float):
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"stream ingest queue full; retry after "
            f"{self.retry_after_s:.3g}s")


def window_charges(families, eps1: float, eps2: float, normalise: bool,
                   party_x: str, party_y: str) -> dict[str, float]:
    """The per-party ε one window release spends — the same
    :func:`~dpcorr_torch.serve.ledger.release_factor` math as the serving
    admission path, summed over the released families, so a stream
    window and the equivalent one-shot requests can never drift on
    cost."""
    charges: dict[str, float] = {}
    for family in families:
        factor = release_factor(family, normalise)
        for party, eps in ((party_x, eps1 * factor),
                           (party_y, eps2 * factor)):
            charges[party] = charges.get(party, 0.0) + float(eps)
    return charges


class Releaser:
    """The execution layer the service's admission path hands a
    charged window to: one :func:`sketch.release_window` per family
    under the window's pinned key, on ``device``. Kept separate from the
    service so the charge→release→refund shape is the admission
    function's whole body."""

    def __init__(self, seed: int, families, eps1: float, eps2: float,
                 normalise: bool, placement=None, device=None):
        self.device = resolve_device(device)
        self.master = master_key(seed)
        self.families = tuple(families)
        self.eps1 = float(eps1)
        self.eps2 = float(eps2)
        self.normalise = bool(normalise)
        # a dpcorr_torch.plan placement (or None = monolithic): finalize
        # routes through sketch.placement_shards, so a MeshPlacement
        # splits each pass's chunk set over its devices and tree-merges
        # the shard sketches, byte-equal to the monolith (no arithmetic
        # in the merge)
        self.placement = placement

    def release(self, window: Window) -> dict:
        rows = window.rows
        wkey = sketch.window_key(self.master, window.id)
        out = {}
        for family in self.families:
            params = sketch.ReleaseParams(
                family, self.eps1, self.eps2, normalise=self.normalise)
            out[family] = sketch.release_window(
                rows, params, wkey, placement=self.placement,
                device=self.device)
        return {"start": window.start, "end": window.end,
                "rows": int(len(window)), "releases": out}


class StreamService:
    """One always-on windowed DP correlation stream. Thread-safe: the
    HTTP front end calls :meth:`ingest` from handler threads; all
    mutation is serialized under one lock."""

    def __init__(self, workdir: str, spec: WindowSpec, families,
                 eps1: float, eps2: float, *, normalise: bool = True,
                 budget: float = 10.0, seed: int = 0,
                 party_x: str = "party/x", party_y: str = "party/y",
                 stream_id: str = "stream",
                 user: str | None = None,
                 user_budget: float | None = None,
                 global_budget: float | None = None,
                 max_pending_rows: int = 1 << 20,
                 fsync: bool = True,
                 registry: Registry | None = None,
                 placement=None,
                 clock=time.time,
                 device=None):
        self.device = resolve_device(device)
        self.workdir = str(workdir)
        self.clock = clock
        os.makedirs(self.workdir, exist_ok=True)
        self.spec = spec
        self.families = tuple(families)
        if not self.families:
            raise ValueError("need at least one family to release")
        self.eps1 = float(eps1)
        self.eps2 = float(eps2)
        self.normalise = bool(normalise)
        self.party_x = party_x
        self.party_y = party_y
        self.stream_id = str(stream_id)
        self.max_pending_rows = int(max_pending_rows)
        self.per_window_charges = window_charges(
            self.families, self.eps1, self.eps2, self.normalise,
            party_x, party_y)

        self.registry = registry if registry is not None else Registry()
        self.audit = AuditTrail(os.path.join(self.workdir,
                                             "audit.jsonl"))
        self.costs = CostRegistry()
        self._epoch_ts = 0.0  # guarded by: _lock — release epoch
        base = PrivacyLedger(
            budget, path=os.path.join(self.workdir, "ledger.json"),
            audit=self.audit, registry=self.registry)
        directory = None
        if user is not None:
            directory = BudgetDirectory(
                os.path.join(self.workdir, "budget_dir"),
                user_budget=(user_budget if user_budget is not None
                             else budget),
                renewal=RenewalPolicy(period_s=spec.hop_s),
                clock=lambda: self._epoch_ts,
                fsync=fsync, audit=self.audit)
        self.ledger = CompositeLedger(base, directory, user=user,
                                      global_budget=global_budget)
        if isinstance(placement, str):
            from dpcorr_torch.plan import resolve_placement

            placement = resolve_placement(placement, device=self.device)
        self.releaser = Releaser(seed, self.families, self.eps1,
                                 self.eps2, self.normalise,
                                 placement=placement, device=self.device)
        # process-wide: the service made last owns the stream's build
        # series (stream.sketch)
        self._cobs = compile_mod.CompileObserver(registry=self.registry)
        sketch.set_compile_observer(self._cobs)

        self._batches = self.registry.counter(
            "dpcorr_stream_batches_total",
            "Ingest batches by outcome", labelnames=("kind",))
        self._rows = self.registry.counter(
            "dpcorr_stream_rows_total", "Rows admitted into windows")
        self._windows = self.registry.counter(
            "dpcorr_stream_windows_total",
            "Windows finalized by outcome", labelnames=("outcome",))
        self._open_g = self.registry.gauge(
            "dpcorr_stream_open_windows", "Currently open windows")
        self._pending_g = self.registry.gauge(
            "dpcorr_stream_pending_rows",
            "Rows buffered in open windows")
        self._wm_g = self.registry.gauge(
            "dpcorr_stream_watermark_ts",
            "Event-time watermark (seconds)")
        self._wm_lag_g = self.registry.gauge(
            "dpcorr_stream_watermark_lag_seconds",
            "Ingest-clock seconds the watermark trails now "
            "(the thresholdable form of freshness)")
        self._release_h = self.registry.histogram(
            "dpcorr_stream_release_seconds",
            "Wall seconds per window release (all families)")

        self._lock = threading.Lock()
        self.manager = WindowManager(spec)   # guarded by: _lock
        self._seen: set[str] = set()         # guarded by: _lock
        self._refused: list[str] = []        # guarded by: _lock
        self.wal = IngestWAL(os.path.join(self.workdir, "wal.jsonl"),
                             fsync=fsync)
        self.journal = ReleaseJournal(
            os.path.join(self.workdir, "releases.jsonl"), fsync=fsync)
        self._recover_locked()

    # ------------------------------------------------------ recovery ----
    def _recover_locked(self) -> None:
        """Rebuild in-memory state from the durable stores: journaled
        windows are closed (never recomputed), the WAL re-admits every
        acked batch in append order (so watermark history — hence the
        admit/refuse sequence — replays exactly), then any window the
        watermark already passed is released. Idempotent charge ids
        make the re-release spend nothing it already spent.
        Runs from the constructor, before any other thread can hold
        the lock (the ``_locked`` suffix marks the same caller-owns-
        the-lock contract the release helpers follow)."""
        for entry in self.journal.entries():
            self.manager.close(str(entry["window_id"]))
        for rec in self.wal.replay():
            self._seen.add(str(rec["batch_id"]))
            try:
                self.manager.admit(float(rec["ts"]), rec["rows"])
            except LateRecordError:
                # admissible when logged; only refusable now because
                # every window it fed is already journaled
                continue
        self._close_ready_locked()
        self._publish_gauges_locked()

    # -------------------------------------------------------- ingest ----
    def ingest(self, batch_id: str, ts: float, rows) -> dict:
        """Admit one batch (``rows``: list of [x, y] pairs; empty list
        = watermark heartbeat). The ack — which includes any windows
        this batch's watermark advance released — is returned only
        after the batch is durably in the WAL. ``batch_id`` is the
        client's idempotency key: a re-send of an acked batch dedups
        (the crash-recovery contract is "re-send everything unacked,
        re-sending acked is free")."""
        batch_id = str(batch_id)
        rows = [(float(x), float(y)) for x, y in rows]
        arr = as_rows(rows)
        with self._lock:
            if batch_id in self._seen:
                self._batches.inc(kind="deduped")
                return {"ok": True, "deduped": True, "seq": None,
                        "released": [], "refused": []}
            pending = sum(len(w) for w in self.manager.windows.values())
            if rows and pending + len(rows) > self.max_pending_rows:
                self._batches.inc(kind="overload")
                raise StreamOverloadedError(
                    retry_after_s=max(0.05, self.spec.hop_s / 10.0))
            try:
                self.manager.admit(ts, arr)
            except LateRecordError:
                self._batches.inc(kind="late")
                raise
            # WAL-before-ack: the batch is durable before the ack forms
            # dpcorr-lint: ignore[blocking-under-lock] — WAL-before-ack: the batch is durable before the ack forms
            seq = self.wal.append(batch_id, float(ts), rows)
            chaos.point("stream.mid_window")
            self._seen.add(batch_id)
            self._batches.inc(kind="accepted")
            if rows:
                self._rows.inc(len(rows))
            # release charge+journal must serialize with admission
            # dpcorr-lint: ignore[blocking-under-lock] — release charge+journal must serialize with admission
            released, refused = self._close_ready_locked()
            self._publish_gauges_locked()
            return {"ok": True, "deduped": False, "seq": seq,
                    "released": released, "refused": refused}

    # ------------------------------------------------------- release ----
    def _close_ready_locked(self):
        """Release every window the watermark has passed, oldest
        first. Caller holds the lock (or is the constructor)."""
        released, refused = [], []
        for window in self.manager.closable():
            entry = self._release_window_locked(window)
            if entry is None:
                refused.append(window.id)
            else:
                released.append(window.id)
        return released, refused

    def _release_window_locked(self, window: Window) -> dict | None:
        """Charge → release → journal for one closable window; the
        chaos points bracket the durability boundaries (module
        docstring). Returns the journal entry, or None on a budget
        refusal (refuse-before-release: no noise drawn, no ε spent)."""
        chaos.point("stream.pre_release")
        prior = self.journal.get(window.id)
        if prior is not None:
            # crashed after the journal append, before close: done
            self.manager.close(window.id)
            return prior
        charge_id = f"stream:{self.stream_id}:{window.id}"
        cost = self.costs.new(trace_id=charge_id)
        self._epoch_ts = window.start  # renewal epoch == release epoch
        try:
            self.ledger.charge(self.per_window_charges,
                               trace_id=charge_id, charge_id=charge_id)
        except BudgetExceededError:
            self._windows.inc(outcome="refused")
            self._refused.append(window.id)
            self.manager.close(window.id)
            cost.event("stream_window_refused")
            return None
        cost.charge(self.per_window_charges)
        t0 = time.monotonic()
        try:
            result = self.releaser.release(window)
        except Exception:
            self.ledger.refund(self.per_window_charges,
                               trace_id=charge_id, charge_id=charge_id,
                               reason="release_failed")
            cost.refund(self.per_window_charges,
                        reason="release_failed")
            obs_recorder.trigger("stream_release_failed",
                                 window=window.id,
                                 stream=self.stream_id)
            raise
        entry = dict(result)
        entry["charge_id"] = charge_id
        entry["eps_window"] = sum(self.per_window_charges.values())
        entry = self.journal.append(window.id, entry)
        chaos.point("stream.post_journal")
        self.manager.close(window.id)
        dt = time.monotonic() - t0
        self._release_h.observe(dt)
        self._windows.inc(outcome="released")
        cost.add_kernel(dt)
        cost.event("stream_window_released")
        return entry

    # --------------------------------------------------------- views ----
    def _publish_gauges_locked(self) -> None:
        self._open_g.set(float(len(self.manager.windows)))
        self._pending_g.set(float(
            sum(len(w) for w in self.manager.windows.values())))
        wm = self.manager.watermark
        if wm != float("-inf"):
            self._wm_g.set(wm)
            self._wm_lag_g.set(max(0.0, float(self.clock()) - wm))

    def releases(self, since: int = 0) -> list[dict]:
        """Journal entries with ``release_seq > since`` — the subscribe
        feed (clients poll with their highest seen seq)."""
        return [e for e in self.journal.entries()
                if int(e.get("release_seq", 0)) > int(since)]

    def stats(self) -> dict:
        with self._lock:
            wm = self.manager.watermark
            out = {
                "stream_id": self.stream_id,
                "families": list(self.families),
                "window": {"size_s": self.spec.size_s,
                           "slide_s": self.spec.slide_s,
                           "late_s": self.spec.late_s},
                "eps_per_window": dict(self.per_window_charges),
                "open_windows": len(self.manager.windows),
                "pending_rows": sum(
                    len(w) for w in self.manager.windows.values()),
                "watermark": None if wm == float("-inf") else wm,
                "watermark_lag_s": (
                    None if wm == float("-inf")
                    else max(0.0, float(self.clock()) - wm)),
                "released": len(self.journal.entries()),
                "refused": list(self._refused),
                "late_refused": self.manager.late_refused,
                "seen_batches": len(self._seen),
                "ledger": self.ledger.snapshot(),
                "cost": self.costs.aggregate(),
            }
            bd = self.ledger.directory_snapshot()
            if bd is not None:
                out["budget_dir"] = bd
            return out

    def render_metrics(self) -> str:
        return self.registry.render()

    def close(self) -> None:
        self.wal.close()
        self.journal.close()
        self.ledger.close()
        self.audit.close()
