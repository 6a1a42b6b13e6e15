"""Fleet telemetry plane: scrape N instances, merge their telemetry exactly.

Counterpart of ``dpcorr/obs/fleet.py``: the same parse, merge, fold and
replay arithmetic, so both packages give byte-equal output from the
same inputs, and a fleet of either package's instances (or a mix) is
scraped alike.

Every other observability surface sees exactly one process — a
registry renders its own counters, a tracer spools its own spans, an
audit trail replays its own ledger. This module folds many processes
into one view, pull-style (the collector scrapes; instances never push)
and without computing on any device:

- **kind-aware exposition parsing** — :func:`parse_families` reads the
  text format :meth:`~dpcorr_torch.obs.metrics.Registry.render` emits back
  into typed :class:`MetricFamily` objects (counter / gauge /
  histogram, with labels), strictly: a malformed line is a loud
  ``ValueError``, never a silently dropped series. The existing flat
  ``parse_exposition`` stays what it is — a value checker; merging
  needs kinds.
- **federated merge** — :func:`merge_families` unions per-instance
  families under an added ``instance`` label. Collisions are refused
  loudly: a duplicate instance name, a sample claiming a different
  instance identity than the target map, or two instances exposing one
  family under different kinds all raise instead of guessing.
- **exact aggregation** — :func:`aggregate_families` strips the
  ``instance`` label and folds: counters sum, cumulative histogram
  buckets (same ``le`` bounds by construction — every instance runs the
  same code) add bucket-wise, in sorted-instance order so the fold is
  deterministic and, for the integer counts that dominate, exact.
- **spool union** — :func:`fleet_chrome_trace` unions many span JSONL
  spools into ONE Chrome trace (one ``pid`` per instance, named via
  ``process_name`` metadata, so Perfetto shows the fleet side by side);
  :func:`fleet_replay` unions many audit spools into one fleet ε table
  that folds to the sum of per-instance ledgers —
  :func:`conservation` is the binary-exact gate the fleet's failover
  test on the card asserts on (``tests/test_torch_cuda.py``).
- **the collector** — :class:`FleetCollector` scrapes N ``/metrics`` +
  ``/stats`` endpoints into a :class:`FleetSnapshot`; a dead instance
  becomes an ``error`` entry, never an exception (half a fleet view
  beats none during the incident that killed the other half).
"""

from __future__ import annotations

import json
import math
import re
import urllib.error
import urllib.request
from typing import Iterable, Mapping

from dpcorr_torch.obs.metrics import _fmt_value

#: the reserved label the merge layer owns; instances must not set it
INSTANCE_LABEL = "instance"

#: instrument kinds the merge layer knows how to fold
_KINDS = ("counter", "gauge", "histogram", "untyped")

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _unescape(v: str) -> str:
    return re.sub(r"\\(.)",
                  lambda m: {"n": "\n"}.get(m.group(1), m.group(1)), v)


def _parse_value(raw: str) -> float:
    special = {"+Inf": math.inf, "-Inf": -math.inf, "NaN": math.nan}
    if raw in special:
        return special[raw]
    return float(raw)


class MetricFamily:
    """One exposition family: name, kind, help and its samples.

    ``samples`` is a list of ``(sample_name, labels, value)`` where
    ``labels`` is a tuple of ``(key, value)`` pairs sorted by key —
    a canonical form, so two families parsed from independently
    rendered expositions compare equal iff they carry the same data.
    For histograms the sample names are the exposition's own
    ``<name>_bucket`` / ``<name>_sum`` / ``<name>_count``.
    """

    __slots__ = ("name", "kind", "help", "samples")

    def __init__(self, name: str, kind: str, help: str = ""):
        if kind not in _KINDS:
            raise ValueError(f"{name}: unknown metric kind {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.samples: list[tuple[str, tuple, float]] = []

    def add(self, sample_name: str, labels: Mapping[str, str] | Iterable,
            value: float) -> None:
        if isinstance(labels, Mapping):
            canon = tuple(sorted((str(k), str(v))
                                 for k, v in labels.items()))
        else:
            canon = tuple(sorted((str(k), str(v)) for k, v in labels))
        self.samples.append((sample_name, canon, float(value)))

    def __eq__(self, other) -> bool:
        if not isinstance(other, MetricFamily):
            return NotImplemented
        return (self.name == other.name and self.kind == other.kind
                and sorted(self.samples) == sorted(other.samples))

    def __repr__(self) -> str:
        return (f"MetricFamily({self.name!r}, {self.kind!r}, "
                f"samples={len(self.samples)})")

    def to_dict(self) -> dict:
        return {"name": self.name, "kind": self.kind, "help": self.help,
                "samples": [{"sample": s, "labels": dict(ls), "value": v}
                            for s, ls, v in sorted(self.samples)]}


def _family_for_sample(families: dict, sample_name: str):
    """Resolve which family a sample line belongs to: exact name, or —
    for ``_bucket``/``_sum``/``_count`` — its declared histogram."""
    fam = families.get(sample_name)
    if fam is not None:
        return fam
    for suffix in _HIST_SUFFIXES:
        if sample_name.endswith(suffix):
            base = families.get(sample_name[:-len(suffix)])
            if base is not None and base.kind == "histogram":
                return base
    return None


def parse_families(text: str) -> dict[str, MetricFamily]:
    """Parse exposition text (what :meth:`Registry.render` emits) into
    ``{family_name: MetricFamily}``, kind-aware and strict: a sample
    line that does not parse raises ``ValueError`` naming it — the
    fleet gates want a corrupted scrape to fail loudly, not fold a
    truncated counter into the aggregate."""
    families: dict[str, MetricFamily] = {}
    helps: dict[str, str] = {}
    for i, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                name, kind = parts[2], (parts[3] if len(parts) > 3
                                        else "untyped")
                families[name] = MetricFamily(name, kind,
                                              helps.get(name, ""))
            elif len(parts) >= 3 and parts[1] == "HELP":
                helps[parts[2]] = parts[3] if len(parts) > 3 else ""
                if parts[2] in families:
                    families[parts[2]].help = helps[parts[2]]
            continue  # other comments (e.g. # EXEMPLAR) pass through
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"exposition line {i}: unparseable sample "
                             f"{line!r}")
        sample_name = m.group("name")
        raw_labels = m.group("labels")
        labels: dict[str, str] = {}
        if raw_labels:
            stripped = re.sub(r"[,\s]", "", _LABEL_RE.sub("", raw_labels))
            if stripped:
                raise ValueError(f"exposition line {i}: bad label set "
                                 f"{{{raw_labels}}}")
            labels = {lm.group(1): _unescape(lm.group(2))
                      for lm in _LABEL_RE.finditer(raw_labels)}
        try:
            value = _parse_value(m.group("value"))
        except ValueError as e:
            raise ValueError(f"exposition line {i}: bad value "
                             f"{m.group('value')!r}") from e
        fam = _family_for_sample(families, sample_name)
        if fam is None:
            # sample with no TYPE declaration: carry it as untyped so a
            # hand-built exposition still merges (kind defaults safely)
            fam = families.setdefault(
                sample_name, MetricFamily(sample_name, "untyped",
                                          helps.get(sample_name, "")))
        fam.add(sample_name, labels, value)
    return families


def render_families(families: Mapping[str, MetricFamily]) -> str:
    """Re-expose families as exposition text — the same shape
    :meth:`Registry.render` emits, so a merged fleet registry is itself
    scrapeable, and ``parse_families(render_families(x)) == x`` (the
    round-trip the determinism tests pin)."""
    lines = []
    for name in sorted(families):
        fam = families[name]
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for sample_name, labels, value in sorted(fam.samples):
            if labels:
                inner = ",".join(
                    f'{k}="{_escape(v)}"' for k, v in labels)
                suffix = "{" + inner + "}"
            else:
                suffix = ""
            lines.append(f"{sample_name}{suffix} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def merge_families(per_instance: Mapping[str, Mapping[str, MetricFamily]],
                   ) -> dict[str, MetricFamily]:
    """Union per-instance families into one federated set, each sample
    gaining an ``instance`` label. Refused loudly: a sample claiming a
    *different* instance identity than the target map (an instance
    impersonating another) and a cross-instance kind clash both raise
    ``ValueError``; a sample whose self-reported ``instance`` matches
    (the serve layer's instance_info gauge) passes the cross-check."""
    merged: dict[str, MetricFamily] = {}
    for inst in sorted(per_instance):
        for name, fam in per_instance[inst].items():
            out = merged.get(name)
            if out is None:
                out = merged[name] = MetricFamily(name, fam.kind, fam.help)
            elif out.kind != fam.kind:
                raise ValueError(
                    f"instance {inst!r}: family {name!r} is a {fam.kind}, "
                    f"already merged as a {out.kind}")
            for sample_name, labels, value in fam.samples:
                claimed = dict(labels).get(INSTANCE_LABEL)
                if claimed is None:
                    out.add(sample_name,
                            labels + ((INSTANCE_LABEL, inst),), value)
                elif claimed == inst:
                    # self-reported identity (the serve layer's
                    # instance_info gauge) agreeing with the target map
                    # is the cross-check working; keep it as-is
                    out.add(sample_name, labels, value)
                else:
                    raise ValueError(
                        f"instance {inst!r}: sample {sample_name} claims "
                        f"{INSTANCE_LABEL}={claimed!r} — refusing to "
                        f"merge a colliding instance identity")
    return merged


def merge_expositions(expositions: Iterable[tuple[str, str]],
                      ) -> dict[str, MetricFamily]:
    """Merge ``(instance_name, exposition_text)`` pairs; duplicate
    instance names are refused loudly (two processes claiming one
    identity is an operator error, not a mergeable state)."""
    per_instance: dict[str, dict[str, MetricFamily]] = {}
    for inst, text in expositions:
        if inst in per_instance:
            raise ValueError(f"duplicate instance name {inst!r}")
        per_instance[inst] = parse_families(text)
    return merge_families(per_instance)


def aggregate_families(merged: Mapping[str, MetricFamily],
                       ) -> dict[str, MetricFamily]:
    """Fold a federated family set across instances: drop the
    ``instance`` label and sum samples that land on the same residual
    label set — counters and cumulative histogram buckets add exactly
    (every instance runs the same code, so bucket bounds agree by
    construction); gauges fold additively too, which is the right
    semantics for the level gauges the serve layer publishes (queue
    depth, cache size — fleet capacity is the sum of replica
    capacities). The fold iterates instances in sorted order, so the
    result is deterministic, byte for byte, across re-merges."""
    out: dict[str, MetricFamily] = {}
    for name in sorted(merged):
        fam = merged[name]
        agg = MetricFamily(name, fam.kind, fam.help)
        folded: dict[tuple[str, tuple], float] = {}
        order: list[tuple[str, tuple]] = []
        for sample_name, labels, value in sorted(
                fam.samples, key=lambda s: (s[0], s[1])):
            residual = tuple((k, v) for k, v in labels
                             if k != INSTANCE_LABEL)
            key = (sample_name, residual)
            if key not in folded:
                folded[key] = 0.0
                order.append(key)
            folded[key] += value
        for sample_name, residual in order:
            agg.samples.append((sample_name, residual,
                                folded[(sample_name, residual)]))
        out[name] = agg
    return out


def families_to_flat(families: Mapping[str, MetricFamily],
                     ) -> dict[str, float]:
    """``{"name{labels}": value}`` — the flat shape
    ``parse_exposition`` speaks, for gates that compare single series."""
    flat: dict[str, float] = {}
    for fam in families.values():
        for sample_name, labels, value in fam.samples:
            if labels:
                inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
                flat[f"{sample_name}{{{inner}}}"] = value
            else:
                flat[sample_name] = value
    return flat


# ------------------------------------------------------- span union ----
def _load_spans(spool) -> list[dict]:
    if isinstance(spool, str):
        from dpcorr_torch.obs.trace import read_spans

        return read_spans(spool)
    return list(spool)


def fleet_chrome_trace(spools: Mapping[str, object]) -> dict:
    """Union many span spools (``{instance: jsonl_path_or_span_list}``)
    into ONE Chrome trace document: one ``pid`` per instance (sorted,
    so pids are stable), named via ``process_name`` metadata, one
    ``tid`` per originating thread within each instance — Perfetto then
    shows the whole fleet's request flow on one timeline, which is the
    entire point of a fleet postmortem."""
    events: list[dict] = []
    meta: list[dict] = []
    for pid, inst in enumerate(sorted(spools), start=1):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": inst}})
        tids: dict[str, int] = {}
        for sp in _load_spans(spools[inst]):
            tid = tids.setdefault(sp.get("thread", "main"), len(tids) + 1)
            events.append({
                "name": sp["name"], "ph": "X", "pid": pid, "tid": tid,
                "ts": sp.get("ts", 0.0) * 1e6,
                "dur": sp["dur_s"] * 1e6,
                "args": {**sp.get("attrs", {}),
                         "instance": inst,
                         "trace_id": sp.get("trace_id"),
                         "span_id": sp.get("span_id"),
                         "parent_id": sp.get("parent_id")},
            })
        meta.extend({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": t, "args": {"name": thread}}
                    for thread, t in tids.items())
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_fleet_chrome_trace(spools: Mapping[str, object],
                             out_path: str) -> str:
    with open(out_path, "w") as f:
        json.dump(fleet_chrome_trace(spools), f)
    return out_path


# ------------------------------------------------------ audit union ----
def _load_audit(spool) -> list[dict]:
    if isinstance(spool, str):
        from dpcorr_torch.obs.audit import read_events

        return read_events(spool)
    return list(spool)


def fleet_replay(spools: Mapping[str, object]) -> dict:
    """Replay many audit spools (``{instance: jsonl_path_or_events}``)
    with the ledger's own arithmetic, per instance, then fold the
    per-party spends across instances in sorted-instance order. The
    fold is the definition of the fleet ε table: charge_id idempotency
    stays *per instance* (each instance owns its own ledger, so ids
    only ever dedup within one), and the fleet total for a party is
    exactly the sum of what each instance's ledger says it spent —
    which is what :func:`conservation` checks, binary-exact."""
    from dpcorr_torch.obs.audit import replay

    per_instance = {inst: replay(_load_audit(spools[inst]))
                    for inst in sorted(spools)}
    fleet: dict[str, float] = {}
    for inst in sorted(per_instance):
        for party, eps in sorted(per_instance[inst].items()):
            fleet[party] = fleet.get(party, 0.0) + eps
    return {"per_instance": per_instance, "fleet": fleet}


def ledger_parties(stats_snapshot: Mapping) -> dict[str, float]:
    """Per-party spend out of one instance's ``/stats`` snapshot —
    the ledger side of the conservation equation."""
    parties = (stats_snapshot.get("ledger") or {}).get("parties", {})
    return {p: float(rec["spent"]) if isinstance(rec, Mapping)
            else float(rec)
            for p, rec in parties.items()}


def conservation(audit_spools: Mapping[str, object],
                 ledgers: Mapping[str, Mapping[str, float]]) -> dict:
    """The fleet ε-conservation gate: per instance, the audit replay
    must equal that instance's ledger spends *exactly* (``==`` on the
    floats — the ledger's dyadic charges make this well-defined), and
    the fleet fold of the replays must equal the fold of the ledgers,
    summed in the same sorted-instance order so both sides perform the
    identical float additions. Returns a verdict document a gate can
    embed in its JSON record."""
    replayed = fleet_replay(audit_spools)
    per_ok: dict[str, bool] = {}
    mismatches: list[dict] = []
    for inst in sorted(audit_spools):
        want = dict(ledgers.get(inst, {}))
        got = replayed["per_instance"].get(inst, {})
        ok = got == want
        per_ok[inst] = ok
        if not ok:
            mismatches.append({"instance": inst, "replay": got,
                               "ledger": want})
    ledger_fleet: dict[str, float] = {}
    for inst in sorted(ledgers):
        for party, eps in sorted(ledgers[inst].items()):
            ledger_fleet[party] = ledger_fleet.get(party, 0.0) + float(eps)
    fleet_ok = replayed["fleet"] == ledger_fleet
    return {"ok": all(per_ok.values()) and fleet_ok,
            "per_instance_ok": per_ok, "fleet_ok": fleet_ok,
            "fleet": replayed["fleet"], "ledger_fleet": ledger_fleet,
            "mismatches": mismatches}


# -------------------------------------------------------- collector ----
def parse_targets(spec) -> dict[str, str]:
    """Target specs: ``"name=url,name=url"`` (CLI), a ``{name: url}``
    mapping, or an iterable of ``name=url`` strings / ``(name, url)``
    pairs / bare urls (which get positional ``instance-N`` names).
    Duplicate names refuse loudly."""
    if isinstance(spec, str):
        items = [s for s in spec.split(",") if s.strip()]
    elif isinstance(spec, Mapping):
        items = list(spec.items())
    else:
        items = list(spec)
    out: dict[str, str] = {}
    for i, item in enumerate(items):
        if isinstance(item, (tuple, list)):
            name, url = item
        elif "=" in item and not item.startswith(("http://", "https://")):
            name, _, url = item.partition("=")
        else:
            name, url = f"instance-{i}", item
        name = name.strip()
        if name in out:
            raise ValueError(f"duplicate instance name {name!r} in "
                             f"fleet targets")
        out[name] = url.strip()
    if not out:
        raise ValueError("no fleet targets given")
    return out


class FleetSnapshot:
    """One scrape of the whole fleet. ``instances`` maps instance name
    to ``{"url", "error", "stats", "exposition"}`` — a dead instance
    carries its error string and ``None`` payloads, and every derived
    view (merge, aggregate) is computed over the live subset."""

    def __init__(self, instances: dict[str, dict]):
        self.instances = instances

    def live(self) -> dict[str, dict]:
        return {n: rec for n, rec in self.instances.items()
                if rec.get("error") is None}

    def errors(self) -> dict[str, str]:
        return {n: rec["error"] for n, rec in self.instances.items()
                if rec.get("error") is not None}

    def families(self) -> dict[str, dict[str, MetricFamily]]:
        return {n: parse_families(rec["exposition"])
                for n, rec in sorted(self.live().items())}

    def merged(self) -> dict[str, MetricFamily]:
        return merge_families(self.families())

    def aggregate(self) -> dict[str, MetricFamily]:
        return aggregate_families(self.merged())

    def exposition(self) -> str:
        """The federated registry re-exposed — itself scrapeable."""
        return render_families(self.merged())

    def stats(self) -> dict[str, dict]:
        return {n: rec["stats"] for n, rec in sorted(self.live().items())}

    def to_doc(self) -> dict:
        """The ``obs fleet snapshot`` artifact: per-instance
        stats + errors, the merged exposition, and the aggregate as a
        flat series map (gates read single series out of it)."""
        return {
            "version": 1,
            "instances": {
                n: {"url": rec["url"], "error": rec.get("error"),
                    "stats": rec.get("stats")}
                for n, rec in sorted(self.instances.items())},
            "merged_exposition": self.exposition(),
            "aggregate": families_to_flat(self.aggregate()),
        }


class FleetCollector:
    """Pull-based collector over N serve instances. Construction
    validates the target map (duplicate names refuse loudly); each
    :meth:`scrape` is one poll of every instance's ``/metrics`` +
    ``/stats``."""

    def __init__(self, targets):
        self.targets = parse_targets(targets)

    def scrape(self, timeout_s: float = 5.0) -> FleetSnapshot:
        instances: dict[str, dict] = {}
        for name in sorted(self.targets):
            base = self.targets[name].rstrip("/")
            rec: dict = {"url": base, "error": None, "stats": None,
                         "exposition": None}
            try:
                with urllib.request.urlopen(f"{base}/stats",
                                            timeout=timeout_s) as resp:
                    rec["stats"] = json.loads(resp.read().decode("utf-8"))
                with urllib.request.urlopen(f"{base}/metrics",
                                            timeout=timeout_s) as resp:
                    rec["exposition"] = resp.read().decode("utf-8")
            except (urllib.error.URLError, ValueError, OSError) as e:
                rec["error"] = f"{type(e).__name__}: {e}"
                rec["stats"] = rec["exposition"] = None
            instances[name] = rec
        return FleetSnapshot(instances)
