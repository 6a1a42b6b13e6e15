"""Bench-trajectory regression engine (``obs trajectory``).

Counterpart of ``dpcorr/obs/trajectory.py``, the same report on the same
artifacts: it normalizes the repo-root ``BENCH_r0*.json`` wrappers (a
command transcript plus a ``parsed`` payload), the ``MULTICHIP_r0*.json``
status stamps and the direct artifacts under ``benchmarks/results/`` into
``Point`` records, groups them into per-``(device_kind, metric)``
series, walks each series in round order, and names the first artifact
whose value fell below ``floor ×`` the best value seen before it.
Device kinds keep the JAX package's classification
(:func:`derive_device_kind`), so a card's series (``cuda-h100``) never
folds into a TPU or CPU series. :func:`gate_attribution` is the hook a
regression gate calls; the port has no bench yet to call it.

Standard library only; malformed artifacts become skip notes in the
report, never crashes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

DEFAULT_FLOOR = 0.85

_ROUND_RE = re.compile(r"r(\d+)")

# Artifact filename globs we consider, relative to each root.
_PATTERNS = ("BENCH_", "MULTICHIP_")


@dataclasses.dataclass
class Point:
    """One normalized benchmark observation."""

    path: str
    round: Optional[int]
    metric: str
    value: float
    unit: str = ""
    device_kind: str = "unknown"
    captured_utc: str = ""
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "path": self.path,
            "round": self.round,
            "metric": self.metric,
            "value": self.value,
            "unit": self.unit,
            "device_kind": self.device_kind,
            "captured_utc": self.captured_utc,
        }


@dataclasses.dataclass
class Status:
    """A non-numeric artifact (e.g. MULTICHIP probe stamps)."""

    path: str
    round: Optional[int]
    ok: Optional[bool]
    skipped: Optional[bool]
    note: str = ""

    def as_dict(self) -> Dict[str, Any]:
        return {
            "path": self.path,
            "round": self.round,
            "ok": self.ok,
            "skipped": self.skipped,
            "note": self.note,
        }


@dataclasses.dataclass
class Regression:
    """First point in a series that fell below floor × best-so-far."""

    series: Tuple[str, str]  # (device_kind, metric)
    path: str
    value: float
    best_value: float
    best_path: str
    ratio: float
    floor: float

    def as_dict(self) -> Dict[str, Any]:
        return {
            "device_kind": self.series[0],
            "metric": self.series[1],
            "path": self.path,
            "value": self.value,
            "best_value": self.best_value,
            "best_path": self.best_path,
            "ratio": self.ratio,
            "floor": self.floor,
        }


def _round_of(name: str) -> Optional[int]:
    m = _ROUND_RE.search(os.path.basename(name))
    return int(m.group(1)) if m else None


def derive_device_kind(detail: Dict[str, Any], top: Dict[str, Any]) -> str:
    """Resolve device_kind with fallbacks for artifacts that predate the field.

    Old artifacts only carry a device *string* like ``"TFRT_CPU_0"`` or
    ``"TPU v5 lite0"`` — derive the kind from it so old and new rounds
    land in the same series.

    A multi-device measurement (``detail.device_count`` > 1, stamped by
    bench and mesh-scaling runs) gets a ``x<count>`` suffix —
    ``cpux4`` — so an N-way sharded series is never folded into (or
    regression-walked against) the 1-device series of the same chip.
    Absent or 1 keeps the bare kind: every historical series label is
    unchanged.
    """
    kind = ""
    for src in (detail, top):
        dk = src.get("device_kind")
        if isinstance(dk, str) and dk:
            kind = dk
            break
    if not kind:
        dev = detail.get("device") or top.get("device") or ""
        if isinstance(dev, str) and dev:
            low = dev.lower()
            if "tpu" in low:
                kind = "tpu"
            elif "gpu" in low or "cuda" in low or "rocm" in low:
                kind = "gpu"
            elif "cpu" in low:
                kind = "cpu"
    if not kind:
        return "unknown"
    nd = detail.get("device_count")
    if isinstance(nd, int) and not isinstance(nd, bool) and nd > 1:
        return f"{kind}x{nd}"
    return kind


def _point_from_payload(
    path: str, payload: Dict[str, Any], notes: List[str]
) -> Optional[Point]:
    """Normalize a metric-bearing dict (direct artifact or ``parsed``)."""
    metric = payload.get("metric")
    value = payload.get("value")
    if not isinstance(metric, str) or not metric:
        notes.append(f"{path}: no metric field — skipped")
        return None
    if not isinstance(value, (int, float)) or isinstance(value, bool):
        notes.append(f"{path}: non-numeric value {value!r} — skipped")
        return None
    if value <= 0:
        notes.append(f"{path}: non-positive value {value} — skipped")
        return None
    detail = payload.get("detail")
    detail = detail if isinstance(detail, dict) else {}
    return Point(
        path=path,
        round=_round_of(path),
        metric=metric,
        value=float(value),
        unit=str(payload.get("unit", "") or ""),
        device_kind=derive_device_kind(detail, payload),
        captured_utc=str(payload.get("captured_utc", "") or ""),
        detail=detail,
    )


def load_artifact(
    path: str, notes: List[str], statuses: List[Status]
) -> Optional[Point]:
    """Load one JSON artifact into a Point, Status, or skip note."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError) as exc:
        notes.append(f"{path}: unreadable ({exc.__class__.__name__}) — skipped")
        return None
    if not isinstance(data, dict):
        notes.append(f"{path}: not a JSON object — skipped")
        return None

    # MULTICHIP-style status stamp: no metric, just ok/skipped.
    if "metric" not in data and "parsed" not in data and (
        "ok" in data or "skipped" in data
    ):
        statuses.append(
            Status(
                path=path,
                round=_round_of(path),
                ok=data.get("ok"),
                skipped=data.get("skipped"),
                note=str(data.get("tail", "") or "")[-120:],
            )
        )
        return None

    # BENCH_r* wrapper: the payload lives under "parsed" (may be null
    # when the wrapped command failed — rc is the tell).
    if "parsed" in data:
        parsed = data.get("parsed")
        if not isinstance(parsed, dict):
            rc = data.get("rc")
            notes.append(f"{path}: parsed is null (rc={rc}) — skipped")
            return None
        return _point_from_payload(path, parsed, notes)

    # Direct artifact (benchmarks/results/*, last_known_good.json).
    return _point_from_payload(path, data, notes)


def discover(roots: Sequence[str]) -> List[str]:
    """Find candidate artifact files under the given roots.

    A root that is a file is taken verbatim; a directory contributes
    its ``*.json`` files (non-recursive — ``benchmarks/results`` holds
    trace *directories* we must not descend into) plus repo-root
    ``BENCH_*``/``MULTICHIP_*`` stamps.
    """
    out: List[str] = []
    for root in roots:
        if os.path.isfile(root):
            out.append(root)
            continue
        if not os.path.isdir(root):
            continue
        try:
            names = sorted(os.listdir(root))
        except OSError:
            continue
        for name in names:
            full = os.path.join(root, name)
            if not os.path.isfile(full):
                continue
            if not name.endswith(".json"):
                continue
            base = os.path.basename(os.path.normpath(root))
            if base == "results" or any(name.startswith(p) for p in _PATTERNS):
                # results/ dirs contribute every artifact; other roots
                # (the repo root) only their BENCH_/MULTICHIP_ stamps.
                out.append(full)
    # Dedup preserving order.
    seen = set()
    uniq = []
    for p in out:
        rp = os.path.normpath(p)
        if rp not in seen:
            seen.add(rp)
            uniq.append(rp)
    return uniq


def default_roots(repo_root: str = ".") -> List[str]:
    return [repo_root, os.path.join(repo_root, "benchmarks", "results")]


def _series_sort_key(pt: Point) -> Tuple[int, str, str]:
    # Round-less artifacts (e.g. last_known_good) sort by timestamp
    # after round-stamped ones of the same vintage; use a large round
    # sentinel so explicit rounds dominate ordering.
    rnd = pt.round if pt.round is not None else 1 << 30
    return (rnd, pt.captured_utc, os.path.basename(pt.path))


def build_series(
    points: Iterable[Point],
) -> Dict[Tuple[str, str], List[Point]]:
    """Group points into (device_kind, metric) series, round-ordered."""
    series: Dict[Tuple[str, str], List[Point]] = {}
    for pt in points:
        series.setdefault((pt.device_kind, pt.metric), []).append(pt)
    for key in series:
        series[key].sort(key=_series_sort_key)
    return series


def find_regressions(
    series: Dict[Tuple[str, str], List[Point]], floor: float = DEFAULT_FLOOR
) -> List[Regression]:
    """Walk each series; name the FIRST artifact below floor × best."""
    out: List[Regression] = []
    for key, pts in sorted(series.items()):
        best: Optional[Point] = None
        for pt in pts:
            if best is not None and best.value > 0:
                ratio = pt.value / best.value
                if ratio < floor:
                    out.append(
                        Regression(
                            series=key,
                            path=pt.path,
                            value=pt.value,
                            best_value=best.value,
                            best_path=best.path,
                            ratio=ratio,
                            floor=floor,
                        )
                    )
                    break
            if best is None or pt.value > best.value:
                best = pt
    return out


@dataclasses.dataclass
class Report:
    points: List[Point]
    statuses: List[Status]
    notes: List[str]
    series: Dict[Tuple[str, str], List[Point]]
    regressions: List[Regression]
    floor: float

    def as_dict(self) -> Dict[str, Any]:
        return {
            "floor": self.floor,
            "series": {
                f"{dk}/{metric}": [p.as_dict() for p in pts]
                for (dk, metric), pts in sorted(self.series.items())
            },
            "statuses": [s.as_dict() for s in self.statuses],
            "notes": list(self.notes),
            "regressions": [r.as_dict() for r in self.regressions],
        }


def build_report(
    roots: Sequence[str], floor: float = DEFAULT_FLOOR
) -> Report:
    notes: List[str] = []
    statuses: List[Status] = []
    points: List[Point] = []
    for path in discover(roots):
        pt = load_artifact(path, notes, statuses)
        if pt is not None:
            points.append(pt)
    series = build_series(points)
    return Report(
        points=points,
        statuses=statuses,
        notes=notes,
        series=series,
        regressions=find_regressions(series, floor),
        floor=floor,
    )


def gate_attribution(
    roots: Sequence[str],
    *,
    metric: str,
    device_kind: str,
    measured_value: float,
    measured_path: str = "<this run>",
    floor: float = DEFAULT_FLOOR,
) -> Optional[Dict[str, Any]]:
    """Attribution hook for a bench's regression gate.

    Appends the just-measured point to its historical series and
    returns the first offending artifact in the combined trajectory
    (which may be a committed artifact that bent the curve earlier, or
    this very run).  Returns None when the trajectory is clean or
    history is unusable — the gate must never fail because attribution
    couldn't run.
    """
    try:
        report = build_report(roots, floor)
        pts = list(report.series.get((device_kind, metric), []))
        pts.append(
            Point(
                path=measured_path,
                round=None,
                metric=metric,
                value=float(measured_value),
                device_kind=device_kind,
            )
        )
        regs = find_regressions({(device_kind, metric): pts}, floor)
        return regs[0].as_dict() if regs else None
    except Exception:  # noqa: BLE001 — attribution is best-effort
        return None


# ---------------------------------------------------------------------------
# Rendering


def _fmt_val(v: float) -> str:
    if v >= 1000:
        return f"{v:,.0f}"
    if v >= 10:
        return f"{v:.1f}"
    return f"{v:.3g}"


def render_console(report: Report) -> str:
    lines: List[str] = []
    lines.append(f"bench trajectory — floor {report.floor:.2f}")
    for (dk, metric), pts in sorted(report.series.items()):
        lines.append(f"\n[{dk}] {metric}")
        best = 0.0
        for pt in pts:
            best = max(best, pt.value)
            ratio = pt.value / best if best > 0 else 1.0
            flag = "  " if ratio >= report.floor else "<<"
            rnd = f"r{pt.round:02d}" if pt.round is not None else "  ?"
            lines.append(
                f"  {rnd}  {_fmt_val(pt.value):>12} {pt.unit:<18}"
                f" x{ratio:4.2f} {flag} {os.path.basename(pt.path)}"
            )
    if report.statuses:
        lines.append("\nstatus artifacts (no numeric series):")
        for st in report.statuses:
            state = (
                "skipped" if st.skipped else ("ok" if st.ok else "failed")
            )
            lines.append(f"  {state:<8} {os.path.basename(st.path)}")
    if report.notes:
        lines.append("\nskipped artifacts:")
        for note in report.notes:
            lines.append(f"  - {note}")
    if report.regressions:
        lines.append("\nREGRESSIONS:")
        for r in report.regressions:
            lines.append(
                f"  [{r.series[0]}] {r.series[1]}: {os.path.basename(r.path)}"
                f" fell to {_fmt_val(r.value)} = {r.ratio:.2f}x of best"
                f" {_fmt_val(r.best_value)} ({os.path.basename(r.best_path)})"
                f" < floor {r.floor:.2f}"
            )
    else:
        lines.append("\nno regressions below floor.")
    return "\n".join(lines) + "\n"


def render_json(report: Report) -> str:
    return json.dumps(report.as_dict(), indent=2, sort_keys=True) + "\n"


def render_markdown(report: Report) -> str:
    lines: List[str] = ["# Bench trajectory", ""]
    lines.append(f"Regression floor: **{report.floor:.2f}×** best-so-far.")
    for (dk, metric), pts in sorted(report.series.items()):
        lines.append(f"\n## `{dk}` / `{metric}`\n")
        lines.append("| round | value | unit | vs best | artifact |")
        lines.append("|---|---|---|---|---|")
        best = 0.0
        for pt in pts:
            best = max(best, pt.value)
            ratio = pt.value / best if best > 0 else 1.0
            rnd = f"r{pt.round:02d}" if pt.round is not None else "—"
            mark = " ⚠" if ratio < report.floor else ""
            lines.append(
                f"| {rnd} | {_fmt_val(pt.value)} | {pt.unit} |"
                f" {ratio:.2f}×{mark} | `{os.path.basename(pt.path)}` |"
            )
    if report.regressions:
        lines.append("\n## Regressions\n")
        for r in report.regressions:
            lines.append(
                f"- **`{os.path.basename(r.path)}`** ({r.series[0]}/"
                f"{r.series[1]}): {_fmt_val(r.value)} is {r.ratio:.2f}× of"
                f" best `{os.path.basename(r.best_path)}`"
                f" ({_fmt_val(r.best_value)}), below floor {r.floor:.2f}."
            )
    else:
        lines.append("\nNo regressions below floor.")
    if report.notes:
        lines.append("\n## Skipped artifacts\n")
        for note in report.notes:
            lines.append(f"- {note}")
    return "\n".join(lines) + "\n"
