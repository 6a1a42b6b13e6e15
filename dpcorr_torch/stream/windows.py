"""Event-time windowing with bounded late-data admission.

Counterpart of ``dpcorr/stream/windows.py``: the same spans, window ids,
watermark and refusals. One difference in representation: a window holds
its admitted rows as one ``(b, 2)`` float32 array per batch instead of a
list of Python pairs. The JAX service casts the rows to float32 once, at
release; casting each batch once at admission rounds the same doubles
once and gives the same bits, and at 10⁶ rows per window it saves the
list of tuples.

Tumbling (``slide_s=None``) and sliding windows keyed by **event
time** — the producer's timestamp, not arrival time — with the
standard watermark discipline (Akidau et al., "The Dataflow Model",
VLDB 2015): the watermark trails the maximum event time seen by the
lateness bound ``late_s``. A record older than the watermark is
refused (``too_late``), a record between watermark and max-seen is
*late but admissible* and still lands in its (still-open) windows, and
a window closes exactly when the watermark passes its end — so every
admitted row is in the window state before any release can run.

Window identity is a pure function of the spec and the epoch
(``<start_ms>-<end_ms>``): two processes — or one process before and
after a kill — derive the same id for the same span, which is what
lets the per-window noise subtree and the idempotent per-window
charge id be stable across recovery.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

__all__ = ["LateRecordError", "Window", "WindowManager", "WindowSpec",
           "as_rows"]


class LateRecordError(ValueError):
    """The record's event time is older than the watermark: admitting
    it could touch an already-released window, so it is refused at the
    door (counted, never silently dropped)."""

    def __init__(self, ts: float, watermark: float):
        self.ts = ts
        self.watermark = watermark
        super().__init__(
            f"event time {ts:.3f} is older than the watermark "
            f"{watermark:.3f} (lateness bound exhausted)")


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """``size_s`` window length; ``slide_s`` hop (None = tumbling);
    ``late_s`` bounded lateness (0 = in-order streams only)."""

    size_s: float
    slide_s: float | None = None
    late_s: float = 0.0

    def __post_init__(self):
        if self.size_s <= 0.0:
            raise ValueError(f"size_s must be positive, got "
                             f"{self.size_s}")
        if self.slide_s is not None:
            if self.slide_s <= 0.0 or self.slide_s > self.size_s:
                raise ValueError(
                    f"slide_s must be in (0, size_s], got "
                    f"{self.slide_s}")
        if self.late_s < 0.0:
            raise ValueError(f"late_s must be >= 0, got {self.late_s}")

    @property
    def hop_s(self) -> float:
        return self.slide_s if self.slide_s is not None else self.size_s

    def spans_for(self, ts: float) -> list[tuple[float, float]]:
        """Every (start, end) span containing event time ``ts``
        (half-open [start, end)); one for tumbling, size/slide for
        sliding. Starts are multiples of the hop, so the span set is a
        pure function of the spec — every process agrees."""
        if ts < 0.0:
            raise ValueError(f"event time must be >= 0, got {ts}")
        hop = self.hop_s
        start = int(ts // hop) * hop
        spans = []
        while start > ts - self.size_s and start >= 0.0:
            spans.append((start, start + self.size_s))
            start -= hop
        spans.sort()
        return spans

    @staticmethod
    def window_id(span: tuple[float, float]) -> str:
        return f"{int(round(span[0] * 1000))}-{int(round(span[1] * 1000))}"


class Window:
    """One open window's accumulating state."""

    __slots__ = ("id", "start", "end", "batches", "n")

    def __init__(self, span: tuple[float, float]):
        self.start, self.end = span
        self.id = WindowSpec.window_id(span)
        self.batches: list[np.ndarray] = []
        self.n = 0

    def add(self, rows: np.ndarray) -> None:
        self.batches.append(rows)
        self.n += len(rows)

    @property
    def rows(self) -> np.ndarray:
        """Every admitted row, in admission order, as one (n, 2) f32
        array."""
        if not self.batches:
            return np.zeros((0, 2), np.float32)
        return np.concatenate(self.batches, axis=0)

    def __len__(self) -> int:
        return self.n


def as_rows(rows) -> np.ndarray:
    """A batch's ``[[x, y], ...]`` as a (b, 2) f32 array (the one cast)."""
    arr = np.asarray(rows, dtype=np.float64)
    if arr.size == 0:
        return np.zeros((0, 2), np.float32)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"rows must be [[x, y], ...], got shape "
                         f"{arr.shape}")
    return arr.astype(np.float32)


class WindowManager:
    """Open-window table + watermark. Single-threaded by design — the
    service serializes ingest under its own lock; this class holds the
    pure windowing logic so it is testable with a scripted sequence."""

    def __init__(self, spec: WindowSpec):
        self.spec = spec
        self.windows: dict[str, Window] = {}
        self.max_event_ts = float("-inf")
        self.closed: set[str] = set()
        self.late_refused = 0
        self.reclosed_skips = 0

    @property
    def watermark(self) -> float:
        return self.max_event_ts - self.spec.late_s

    def admit(self, ts: float, rows: Iterable[tuple[float, float]]
              ) -> list[str]:
        """Admit one batch at event time ``ts``; returns the window ids
        it landed in. Raises :class:`LateRecordError` past the
        lateness bound; an empty ``rows`` only advances the watermark
        (the heartbeat/flush form)."""
        ts = float(ts)
        rows = rows if isinstance(rows, np.ndarray) \
            and rows.dtype == np.float32 else as_rows(rows)
        if len(rows) and self.max_event_ts != float("-inf") \
                and ts < self.watermark:
            self.late_refused += 1
            raise LateRecordError(ts, self.watermark)
        hit = []
        if len(rows):
            for span in self.spec.spans_for(ts):
                wid = WindowSpec.window_id(span)
                if wid in self.closed:
                    # recovery replay: the batch already contributed to
                    # this (journaled) window's release — skip the span,
                    # never reopen it, but still land the rows in any
                    # sibling span that is still open. Genuine late data
                    # can't reach here: closure implies watermark >= end
                    # > ts, which the watermark check above refuses.
                    self.reclosed_skips += 1
                    continue
                w = self.windows.get(wid)
                if w is None:
                    w = self.windows[wid] = Window(span)
                w.add(rows)
                hit.append(wid)
        self.max_event_ts = max(self.max_event_ts, ts)
        return hit

    def closable(self) -> list[Window]:
        """Windows the watermark has passed, oldest first — ready for
        release (no admissible record can reach them anymore)."""
        ready = [w for w in self.windows.values()
                 if w.end <= self.watermark]
        ready.sort(key=lambda w: (w.start, w.end))
        return ready

    def close(self, window_id: str) -> None:
        """Drop a released (or refused) window's state and remember the
        id so recovery re-admission can never resurrect it."""
        self.windows.pop(window_id, None)
        self.closed.add(window_id)

    def pending(self) -> list[Window]:
        return sorted(self.windows.values(),
                      key=lambda w: (w.start, w.end))
