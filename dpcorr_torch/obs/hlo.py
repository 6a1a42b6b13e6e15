"""Reader of the JAX package's compiled-signature dumps (``obs hlo show |
diff``).

Counterpart of the JAX-free half of ``dpcorr/obs/hlo.py``. The port
makes no HLO and records none (eager torch compiles no program); this
module reads the ``dpcorr_hlo_dump`` files the JAX package writes
(``HloStore.dump``) and explains what changed between two of them:
fingerprint flips, FLOP/byte/memory deltas, and op-count deltas (fusion,
copy and transpose counts are how layout and reshard boundaries show up
in optimized HLO). Standard library only.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List


def load_dump(path: str) -> Dict[str, Dict[str, Any]]:
    """Read a persisted signature dump; raises ValueError on bad shape."""
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    if not isinstance(data, dict) or data.get("kind") != "dpcorr_hlo_dump":
        raise ValueError(f"{path}: not a dpcorr_hlo_dump artifact")
    sigs = data.get("signatures")
    if not isinstance(sigs, dict):
        raise ValueError(f"{path}: missing signatures table")
    return sigs


def _sig_label(rec: Dict[str, Any]) -> str:
    sig = rec.get("signature") or {}
    if not sig:
        return "<unsigned>"
    return ",".join(f"{k}={sig[k]}" for k in sorted(sig))


def _deltas(a: Dict[str, Any], b: Dict[str, Any], cast) -> Dict[str, Any]:
    """``{field: {"old", "new"}}`` for each field whose values differ
    (a missing field reads as 0)."""
    out = {}
    for field in sorted(set(a) | set(b)):
        va, vb = cast(a.get(field, 0)), cast(b.get(field, 0))
        if va != vb:
            out[field] = {"old": va, "new": vb}
    return out


def diff_dumps(
    a: Dict[str, Dict[str, Any]], b: Dict[str, Dict[str, Any]]
) -> Dict[str, Any]:
    """Structural diff of two signature dumps (a = old, b = new)."""
    added = sorted(set(b) - set(a))
    removed = sorted(set(a) - set(b))
    changed: List[Dict[str, Any]] = []
    for key in sorted(set(a) & set(b)):
        ra, rb = a[key], b[key]
        entry: Dict[str, Any] = {
            "signature": rb.get("signature") or ra.get("signature") or {},
            "label": _sig_label(rb),
        }
        if ra.get("fingerprint") != rb.get("fingerprint"):
            entry["fingerprint"] = {
                "old": ra.get("fingerprint"),
                "new": rb.get("fingerprint"),
            }
        for part, cast in (("cost", float), ("memory", int), ("ops", int)):
            d = _deltas(ra.get(part) or {}, rb.get(part) or {}, cast)
            if d:
                entry[part] = d
        if len(entry) > 2:
            changed.append(entry)
    return {
        "added": [
            {"label": _sig_label(b[k]), "signature": b[k].get("signature", {})}
            for k in added
        ],
        "removed": [
            {"label": _sig_label(a[k]), "signature": a[k].get("signature", {})}
            for k in removed
        ],
        "changed": changed,
    }


def _fmt_num(v: float) -> str:
    for unit, scale in (("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(v) >= scale:
            return f"{v / scale:.2f}{unit}"
    return f"{v:g}"


def render_show(sigs: Dict[str, Dict[str, Any]]) -> str:
    """``obs hlo show``'s text: per signature its label, fingerprint,
    cost and compile cause."""
    lines: List[str] = []
    for key in sorted(sigs):
        rec = sigs[key]
        cost = rec.get("cost") or {}
        lines.append(f"{key}  {_sig_label(rec)}")
        lines.append(f"    fingerprint={rec.get('fingerprint') or '-'} "
                     f"flops={cost.get('flops', '-')} "
                     f"bytes={cost.get('bytes', '-')} "
                     f"cause={rec.get('cause') or '-'}")
    return "".join(f"{line}\n" for line in lines)


def render_diff(diff: Dict[str, Any]) -> str:
    lines: List[str] = []
    for rec in diff.get("added", []):
        lines.append(f"+ {rec['label']}")
    for rec in diff.get("removed", []):
        lines.append(f"- {rec['label']}")
    for rec in diff.get("changed", []):
        lines.append(f"~ {rec['label']}")
        fp = rec.get("fingerprint")
        if fp:
            lines.append(f"    hlo fingerprint {fp['old']} -> {fp['new']}")
        for field, dd in (rec.get("cost") or {}).items():
            lines.append(
                f"    {field}: {_fmt_num(dd['old'])} -> {_fmt_num(dd['new'])}"
            )
        for field, dd in (rec.get("memory") or {}).items():
            lines.append(
                f"    {field}: {_fmt_num(dd['old'])} -> {_fmt_num(dd['new'])}"
            )
        ops = rec.get("ops") or {}
        if ops:
            parts = [
                f"{op} {dd['old']}->{dd['new']}" for op, dd in sorted(ops.items())
            ]
            lines.append("    ops: " + ", ".join(parts))
    if not lines:
        lines.append("dumps are identical.")
    return "\n".join(lines) + "\n"
