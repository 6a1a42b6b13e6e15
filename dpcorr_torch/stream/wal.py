"""Stream durability: ingest WAL + released-window journal.

Counterpart of ``dpcorr/stream/wal.py``, with its line format
(``json.dumps(sort_keys=True)``, one fsynced line per record): a WAL or
journal written by either package is replayed by the other. It imports
no torch.

Same discipline as the repo's other durable stores (``SessionJournal``,
``BudgetDirectory``): every mutation is an **fsynced append** of one
JSON line *before* the caller acknowledges anything, snapshots are
written tmp + fsync + rename, and recovery tolerates exactly one torn
tail line (a crash mid-append) by ignoring it — any other parse
failure quarantines the file to a ``.corrupt`` sidecar and raises,
because silently skipping a mid-file line could drop acknowledged
data.

- :class:`IngestWAL`: one line per admitted batch
  (``{"seq", "batch_id", "ts", "rows"}``). ``batch_id`` is the
  client's idempotency key — recovery rebuilds the seen-set so a
  client re-sending an acked batch after a crash dedups instead of
  double-counting.
- :class:`ReleaseJournal`: one line per released window, appended
  *after* the ledger charge and *before* the release is acknowledged
  to subscribers. A journaled window is done: recovery serves it from
  the journal and never recomputes (the charge it rode is idempotent
  under the window's charge id, so even the recompute path could not
  double-spend).
"""

from __future__ import annotations

import json
import os
from typing import Iterator

from dpcorr_torch.obs.budget_replay import quarantine_corrupt, sweep_stale_tmp

__all__ = ["IngestWAL", "ReleaseJournal", "StreamCorruptError"]


class StreamCorruptError(ValueError):
    """A stream durability file failed to parse mid-file. The bad file
    has been quarantined to a ``.corrupt`` sidecar."""


def _append_line(fh, record: dict, fsync: bool) -> None:
    fh.write(json.dumps(record, sort_keys=True) + "\n")
    fh.flush()
    if fsync:
        os.fsync(fh.fileno())


def _read_lines(path: str) -> list[dict]:
    """All complete records; a torn final line (no trailing newline —
    the only state a kill mid-append can leave) is dropped."""
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    lines = text.split("\n")
    torn = lines.pop() if lines and lines[-1] != "" else None
    records = []
    for i, line in enumerate(line for line in lines if line):
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError as e:
            quarantine = quarantine_corrupt(path)
            raise StreamCorruptError(
                f"{path!r} line {i + 1} is corrupt ({e}); the file was "
                f"moved to {quarantine!r} — restore from a replica or "
                f"accept the data loss explicitly by removing the "
                f"sidecar") from e
    if torn:
        try:
            records.append(json.loads(torn))
        except json.JSONDecodeError:
            pass  # crash mid-append: the batch was never acked
    return records


class IngestWAL:
    """Append-ack ingest log. ``append`` returns the assigned sequence
    number only after the line is durably on disk — the service acks
    nothing it could forget."""

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        sweep_stale_tmp(path)
        self._seq = 0
        self._fh = None

    def replay(self) -> Iterator[dict]:
        """Recovery scan, in append order; leaves ``seq`` continuing
        after the highest replayed entry."""
        for rec in _read_lines(self.path):
            self._seq = max(self._seq, int(rec.get("seq", 0)))
            yield rec

    def append(self, batch_id: str, ts: float, rows: list) -> int:
        if self._fh is None:
            self._fh = open(self.path, "a", encoding="utf-8")
        self._seq += 1
        _append_line(self._fh, {"seq": self._seq, "batch_id": batch_id,
                                "ts": ts, "rows": rows}, self.fsync)
        return self._seq

    def compact(self, keep) -> None:
        """Rewrite the WAL keeping only entries ``keep(rec)`` selects
        (rows whose every window is already journaled can go):
        tmp + fsync + rename, so a kill mid-compaction leaves the full
        old WAL."""
        records = [r for r in _read_lines(self.path) if keep(r)]
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            for rec in records:
                fh.write(json.dumps(rec, sort_keys=True) + "\n")
            fh.flush()
            if self.fsync:
                os.fsync(fh.fileno())
        os.replace(tmp, self.path)
        self.close()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class ReleaseJournal:
    """Append-only record of released windows, keyed by window id.
    Idempotent: re-appending an already-journaled window is a no-op
    (recovery re-runs the release sequence; the journal, like the
    ledger, must absorb the repeat)."""

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        sweep_stale_tmp(path)
        self._fh = None
        self._entries: dict[str, dict] = {}
        for rec in _read_lines(path):
            self._entries[str(rec["window_id"])] = rec

    def __contains__(self, window_id: str) -> bool:
        return window_id in self._entries

    def get(self, window_id: str) -> dict | None:
        return self._entries.get(window_id)

    def entries(self) -> list[dict]:
        """Journal order (= release order): the subscribe feed."""
        return sorted(self._entries.values(),
                      key=lambda r: int(r.get("release_seq", 0)))

    def append(self, window_id: str, record: dict) -> dict:
        if window_id in self._entries:
            return self._entries[window_id]
        rec = dict(record)
        rec["window_id"] = window_id
        rec["release_seq"] = len(self._entries) + 1
        if self._fh is None:
            self._fh = open(self.path, "a", encoding="utf-8")
        _append_line(self._fh, rec, self.fsync)
        self._entries[window_id] = rec
        return rec

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
