"""ε-provenance: the federation's budget story as one checkable DAG
(counterpart of ``dpcorr/obs/provenance.py``: on the same files both
packages build the same document, divergences included).

The paper's premise is that the parties' data cannot meet — so after a
k-party matrix run, the only trustworthy account of where each unit of
privacy budget went is one *reconstructed from every party's
independent records* and checked for exact agreement. This module
builds that account: it merges per-party pair-link
transcripts, durable audit trails, and session journals into a DAG of

    column-release **artifacts** → **charge** events (party ledger,
    charge_id, plan share) → link **rounds** → finished **cells**

and structurally proves the two federation invariants the wire gate
(:func:`dpcorr_torch.protocol.scan.scan_federation`) only passes/fails:
every artifact charged **exactly once** at its plan venue, and reused
**byte-identically** everywhere else — total spend at the
``2·f·ε·(k−1)`` optimum, float-for-float against
``FederationPlan.optimal_eps()``. Any divergence becomes a *named,
typed* entry attributing the offending party and artifact — hostile
inputs (a missing party view, a tampered charge amount, a re-noised
artifact, a truncated transcript) produce divergences, never crashes.

It imports no torch and computes nothing on a device: postmortems run
on hosts with no card. Exports JSON (``to_doc``) and Graphviz DOT
(``to_dot``); ``python -m dpcorr_torch obs provenance`` wraps both and
exits 1 on any divergence.
"""

from __future__ import annotations

import glob as globmod
import hashlib
import json
import math
import os
from dataclasses import dataclass, field

from dpcorr_torch.obs.audit import read_events, replay
from dpcorr_torch.protocol.matrix import FederationPlan
from dpcorr_torch.protocol.messages import canonical_encode, read_transcript

#: Divergence kinds, append-only — consumers (CI gates, the console)
#: match on these strings.
DIVERGENCE_KINDS = (
    "missing-party-view",     # a plan party contributed no/partial records
    "truncated-transcript",   # a link transcript ends before its plan rounds
    "re-noised-artifact",     # one column released as >1 byte encodings
    "double-charged-artifact",  # one artifact charged in >1 rounds
    "tampered-charge",        # a charge amount disagrees with the plan share
    "eps-total-mismatch",     # reconstructed total != optimal_eps()
)


def _divergence(out: list, kind: str, party, detail: str,
                **attrs) -> None:
    assert kind in DIVERGENCE_KINDS, kind
    d = {"kind": kind, "party": party, "detail": detail}
    d.update({k: v for k, v in attrs.items() if v is not None})
    out.append(d)


@dataclass
class Provenance:
    """The explorable result: ``nodes`` maps node id → attrs (every
    node carries ``kind`` ∈ plan|artifact|charge|round|cell),
    ``edges`` is ``[src, dst, relation]`` triples, ``divergences`` the
    typed findings. ``ok`` iff no divergence survived."""

    fed: str
    nodes: dict = field(default_factory=dict)
    edges: list = field(default_factory=list)
    divergences: list = field(default_factory=list)
    total_eps: float = 0.0
    expected_eps: float = 0.0
    parties: dict = field(default_factory=dict)  # party -> spend summary

    @property
    def ok(self) -> bool:
        return not self.divergences

    # ------------------------------------------------------- exports ----
    def to_doc(self) -> dict:
        return {"provenance": 1, "fed": self.fed, "ok": self.ok,
                "eps": {"total": self.total_eps,
                        "optimal": self.expected_eps,
                        "parties": self.parties},
                "counts": {"nodes": len(self.nodes),
                           "edges": len(self.edges),
                           "divergences": len(self.divergences)},
                "nodes": {k: self.nodes[k] for k in sorted(self.nodes)},
                "edges": sorted(self.edges),
                "divergences": self.divergences}

    def to_dot(self) -> str:
        """Graphviz DOT: artifacts as boxes, charges as diamonds,
        rounds as ellipses, cells as plain nodes; divergent nodes red."""
        shapes = {"plan": "folder", "artifact": "box",
                  "charge": "diamond", "round": "ellipse",
                  "cell": "plaintext"}
        flagged = set()
        for d in self.divergences:
            for key in ("node", "artifact_node"):
                if d.get(key):
                    flagged.add(d[key])
        lines = [f'digraph "{self.fed}" {{', "  rankdir=LR;"]
        for nid in sorted(self.nodes):
            attrs = self.nodes[nid]
            label = attrs.get("label_text") or nid
            shape = shapes.get(attrs.get("kind"), "box")
            colour = ', color=red, fontcolor=red' \
                if nid in flagged else ""
            lines.append(f'  "{nid}" [shape={shape}, '
                         f'label="{label}"{colour}];')
        for src, dst, rel in sorted(self.edges):
            lines.append(f'  "{src}" -> "{dst}" [label="{rel}"];')
        lines.append("}")
        return "\n".join(lines) + "\n"

    # --------------------------------------------------------- query ----
    def cell_story(self, i: int, j: int) -> dict:
        """The postmortem query: everything that fed one cell — its
        round, the artifacts that round embedded, and the charges that
        paid for them."""
        cid = f"cell:{i},{j}"
        rounds = [src for src, dst, rel in self.edges
                  if dst == cid and rel == "finishes"]
        arts, charges = [], []
        for rid in rounds:
            arts.extend(src for src, dst, rel in self.edges
                        if dst == rid and rel == "released_in")
        for aid in arts:
            charges.extend(dst for src, dst, rel in self.edges
                           if src == aid and rel == "charged_by")
        charges.extend(src for src, dst, rel in self.edges
                       if dst == cid and rel == "covers")
        return {"cell": self.nodes.get(cid),
                "rounds": {r: self.nodes.get(r) for r in rounds},
                "artifacts": {a: self.nodes.get(a) for a in arts},
                "charges": {c: self.nodes.get(c)
                            for c in sorted(set(charges))},
                "divergences": [d for d in self.divergences
                                if d.get("cell") == [i, j]]}


# ================================================= building the DAG ====

def _walk_party(party: str, sources, div: list) -> dict:
    """One party's evidence: releases (label → sha/bytes per session),
    charges seen on its gated sends, rounds, results. A transcript
    that cannot be read to the end is a *truncated-transcript*
    divergence, and whatever prefix was readable still counts as
    evidence — a hostile party must not be able to suppress its own
    records by corrupting their tail."""
    ev = {"releases": [], "sends": [], "rounds": {}, "results": [],
          "sessions": set()}
    for src in sources:
        try:
            entries = (read_transcript(src) if isinstance(src, str)
                       else list(src))
        except (OSError, ValueError) as e:
            _divergence(div, "truncated-transcript", party,
                        f"unreadable transcript: {e}",
                        path=src if isinstance(src, str) else None)
            continue
        for e in entries:
            w = e.get("wire", {})
            sess = w.get("session", "?")
            ev["sessions"].add(sess)
            payload = w.get("payload", {})
            mtype = w.get("msg_type")
            if mtype == "release" and isinstance(
                    payload.get("artifacts"), dict):
                r = payload.get("round")
                ev["rounds"].setdefault(
                    (sess, r), {"cells": payload.get("cells", []),
                                "ts": e.get("ts"), "result": False})
                for lab, group in payload["artifacts"].items():
                    enc = (canonical_encode(group)
                           if isinstance(group, dict)
                           else repr(group).encode())
                    ev["releases"].append({
                        "label": lab, "session": sess, "round": r,
                        "sha256": hashlib.sha256(enc).hexdigest(),
                        "bytes": len(enc)})
                if e.get("dir") == "send" and e.get("eps", 0) > 0:
                    ev["sends"].append({
                        "session": sess, "round": r, "side": "x",
                        "eps": float(e["eps"]),
                        "charge_id": e.get("charge_id"),
                        "labels": list(payload.get("charged", ())),
                        "trace_id": e.get("trace_id")})
            elif mtype == "result":
                r = payload.get("round")
                rd = ev["rounds"].setdefault(
                    (sess, r), {"cells": payload.get("cells", []),
                                "ts": e.get("ts"), "result": False})
                rd["result"] = True
                rd["cells"] = [list(c[:2])
                               for c in payload.get("cells", [])] \
                    or rd["cells"]
                ev["results"].append({"session": sess, "round": r,
                                      "cells": payload.get("cells",
                                                           [])})
                if e.get("dir") == "send" and e.get("eps", 0) > 0:
                    ev["sends"].append({
                        "session": sess, "round": r, "side": "y",
                        "eps": float(e["eps"]),
                        "charge_id": e.get("charge_id"),
                        "labels": list(payload.get("charged", ())),
                        "trace_id": e.get("trace_id")})
    return ev


def build_provenance(plan: FederationPlan, transcripts: dict,
                     audits: dict | None = None,
                     journals: dict | None = None) -> Provenance:
    """Merge every party's records into the provenance DAG.

    ``transcripts`` maps party name → list of its pair-link transcript
    paths (or pre-read entry lists); ``audits`` maps party name →
    audit-trail JSONL path (or event list) — optional, but exactly-once
    charging can only be *proved* against the durable trails;
    ``journals`` maps party name → list of its session-journal paths
    (adds resume lineage to the round nodes). Never raises on hostile
    input: every disagreement lands in ``divergences``."""
    audits = audits or {}
    journals = journals or {}
    div: list = []
    prov = Provenance(fed=plan.fed)
    nodes, edges = prov.nodes, prov.edges

    nodes["plan"] = {"kind": "plan", "fed": plan.fed,
                     "family": plan.family, "n": plan.n,
                     "eps": plan.eps, "k": plan.k,
                     "optimal_eps": plan.optimal_eps(),
                     "naive_eps": plan.naive_eps(),
                     "trace_id": plan.trace_id(),
                     "label_text": f"plan {plan.fed}"}

    # -- plan skeleton: artifacts, cells ------------------------------
    venues = plan.artifact_venues()
    label_owner = {lab: pname for pname, cols in plan.parties
                   for lab in cols}
    for (side, lab), venue in sorted(venues.items()):
        aid = f"artifact:{side}:{lab}"
        nodes[aid] = {"kind": "artifact", "side": side, "label": lab,
                      "owner": label_owner.get(lab),
                      "venue": list(venue),
                      "label_text": f"{side}:{lab}"}
        edges.append(["plan", aid, "schedules"])
    for i, j in plan.cells():
        cid = f"cell:{i},{j}"
        nodes[cid] = {"kind": "cell", "i": i, "j": j,
                      "venue": list(plan.cell_venue(i, j)),
                      "label_text": f"({i},{j})"}

    # -- party views --------------------------------------------------
    expected_sessions = {}
    for p, q in plan.links():
        sess = plan.link_session(p, q)
        expected_sessions.setdefault(p, set()).add(sess)
        expected_sessions.setdefault(q, set()).add(sess)
    evidence = {}
    for pname, _cols in plan.parties:
        sources = transcripts.get(pname)
        needs_wire = bool(expected_sessions.get(pname))
        if not sources:
            if needs_wire:
                _divergence(div, "missing-party-view", pname,
                            f"party {pname!r} shares "
                            f"{len(expected_sessions[pname])} link(s) "
                            "but contributed no transcripts — its view "
                            "of the federation cannot be cross-checked")
            evidence[pname] = _walk_party(pname, [], div)
            continue
        evidence[pname] = _walk_party(pname, sources, div)
        missing = expected_sessions.get(pname, set()) \
            - evidence[pname]["sessions"]
        for sess in sorted(missing):
            _divergence(div, "missing-party-view", pname,
                        f"party {pname!r} has no transcript for its "
                        f"link session {sess!r}", session=sess)

    # -- rounds + truncation + cells ----------------------------------
    for p, q in plan.links():
        sess = plan.link_session(p, q)
        plan_rounds = plan.link_rounds(p, q)
        seen: dict = {}
        for pname in (p, q):
            for (s, r), rd in evidence[pname]["rounds"].items():
                if s == sess and r is not None:
                    got = seen.setdefault(r, dict(rd))
                    got["result"] = got["result"] or rd["result"]
        for r, cells in enumerate(plan_rounds):
            rid = f"round:{sess}:{r}"
            rd = seen.get(r)
            nodes[rid] = {"kind": "round", "session": sess,
                          "link": f"{p}-{q}", "round": r,
                          "cells": [list(c) for c in cells],
                          "observed": rd is not None,
                          "finished": bool(rd and rd["result"]),
                          "ts": (rd or {}).get("ts"),
                          "label_text": f"{sess} r{r}"}
            for lab in plan.round_x_labels(p, q, r):
                edges.append([f"artifact:x:{lab}", rid, "released_in"])
            for _i, j in cells:
                edges.append([f"artifact:y:{plan.label(j)}", rid,
                              "released_in"])
            for i, j in cells:
                edges.append([rid, f"cell:{i},{j}", "finishes"])
        observed = {r for r in seen if r is not None}
        if any(evidence[pname]["sessions"] & {sess}
               for pname in (p, q)):
            want = set(range(len(plan_rounds)))
            gone = sorted(want - observed)
            half = sorted(r for r in observed & want
                          if not seen[r]["result"])
            if gone or half:
                culprit = [pname for pname in (p, q)
                           if sess in evidence[pname]["sessions"]]
                _divergence(
                    div, "truncated-transcript",
                    ",".join(culprit), f"link {sess!r} shows "
                    f"{len(observed)} of {len(plan_rounds)} plan "
                    f"rounds (missing {gone}, unfinished {half}) — "
                    "the transcript ends before the plan does",
                    session=sess, missing_rounds=gone,
                    unfinished_rounds=half)

    # -- journals: resume lineage on the round nodes ------------------
    for pname, paths in journals.items():
        for src in paths:
            try:
                with open(src, encoding="utf-8") as fh:
                    st = json.load(fh)
            except (OSError, ValueError):
                continue  # a journal is optional corroboration
            sess = st.get("session")
            for attrs in nodes.values():
                if attrs.get("kind") == "round" \
                        and attrs.get("session") == sess:
                    attrs.setdefault("journals", {})[pname] = {
                        "status": st.get("status"),
                        "trace_id": st.get("trace_id")}

    # -- byte-identity across every party's view ----------------------
    by_label: dict = {}
    for pname, ev in evidence.items():
        for rel in ev["releases"]:
            by_label.setdefault(rel["label"], {}).setdefault(
                rel["sha256"], set()).add((pname, rel["session"]))
    for lab, variants in sorted(by_label.items()):
        for side in ("x", "y"):
            aid = f"artifact:{side}:{lab}"
            if aid in nodes:
                one = sorted(variants)[0] if len(variants) == 1 \
                    else None
                nodes[aid]["sha256"] = one
                nodes[aid]["seen_by"] = sorted(
                    {p for ss in variants.values() for p, _ in ss})
        if len(variants) > 1:
            counts = sorted(variants.items(), key=lambda kv:
                            (len(kv[1]), sorted(kv[1])))
            minority_sha, minority = counts[0]
            suspects = sorted({p for p, _s in minority})
            owner = label_owner.get(lab)
            _divergence(
                div, "re-noised-artifact",
                ",".join(suspects) or owner,
                f"column {lab!r} (owner {owner!r}) appears as "
                f"{len(variants)} distinct byte encodings; minority "
                f"variant {minority_sha[:12]} seen only by "
                f"{suspects} — re-noised releases of one column are "
                "subtractable", artifact=lab,
                artifact_node=f"artifact:x:{lab}",
                variants={sha: sorted(f"{p}:{s}" for p, s in ss)
                          for sha, ss in variants.items()})

    # -- charges: wire + audit, exactly-once, plan amounts ------------
    # expected (labels, ε) per gated message, straight from the plan's
    # own arithmetic so the comparison is float-for-float exact
    expected_send: dict = {}
    for p, q in plan.links():
        sess = plan.link_session(p, q)
        for r in range(len(plan.link_rounds(p, q))):
            rc = plan.round_charges(p, q, r)
            expected_send[(sess, r, "x")] = (
                p, tuple(rc["release"]["labels"]),
                float(sum(rc["release"]["charges"].values())))
            expected_send[(sess, r, "y")] = (
                q, tuple(rc["result"]["labels"]),
                float(sum(rc["result"]["charges"].values())))
    audit_events = {}
    for pname, src in audits.items():
        try:
            audit_events[pname] = (read_events(src)
                                   if isinstance(src, str) else
                                   list(src))
        except (OSError, ValueError) as e:
            _divergence(div, "missing-party-view", pname,
                        f"audit trail unreadable: {e}")
    charge_total: dict = {}
    charged_venues: dict = {}
    for pname, ev in evidence.items():
        by_id = {}
        for a in audit_events.get(pname, []):
            cid = (a.get("detail") or {}).get("charge_id") \
                if isinstance(a.get("detail"), dict) \
                else a.get("charge_id")
            if a.get("kind") == "charge" and cid:
                by_id[cid] = a
        for send in ev["sends"]:
            if not send["labels"]:
                continue  # reuse round: empty charge map, nothing due
            cid = send["charge_id"] or \
                f"{send['session']}:r{send['round']}:{send['side']}"
            nid = f"charge:{cid}"
            _payer, want_labels, expected = expected_send.get(
                (send["session"], send["round"], send["side"]),
                (pname, (), 0.0))
            nodes[nid] = {"kind": "charge", "party": pname,
                          "charge_id": cid, "eps": send["eps"],
                          "expected_eps": expected,
                          "session": send["session"],
                          "round": send["round"],
                          "trace_id": send["trace_id"],
                          "source": "transcript",
                          "label_text":
                              f"{pname} ε={send['eps']:g}"}
            for lab in send["labels"]:
                aid = f"artifact:{send['side']}:{lab}"
                edges.append([aid, nid, "charged_by"])
                charged_venues.setdefault(
                    (send["side"], lab), []).append(
                    (pname, send["session"], send["round"]))
            rid = f"round:{send['session']}:{send['round']}"
            if rid in nodes:
                edges.append([nid, rid, "funds"])
            if send["eps"] != expected \
                    or tuple(send["labels"]) != want_labels:
                _divergence(
                    div, "tampered-charge", pname,
                    f"gated send {cid!r} charged ε={send['eps']!r} "
                    f"for labels {send['labels']} but the plan "
                    f"assigns ε={expected!r} for "
                    f"labels {list(want_labels)}",
                    charge_id=cid, node=nid,
                    labels=send["labels"])
            audit_ev = by_id.get(cid)
            if audit_ev is not None:
                trail_eps = float(sum(
                    (audit_ev.get("charges") or {}).values()))
                nodes[nid]["audit_eps"] = trail_eps
                nodes[nid]["source"] = "transcript+audit"
                if trail_eps != send["eps"]:
                    _divergence(
                        div, "tampered-charge", pname,
                        f"charge {cid!r}: transcript says "
                        f"ε={send['eps']!r}, the durable audit trail "
                        f"says ε={trail_eps!r} — the records disagree",
                        charge_id=cid, node=nid,
                        labels=send["labels"])
            charge_total.setdefault(pname, []).append(
                (cid, send["eps"]))
        # local cells: the plan-derived local charge (audit-backed when
        # a trail is present)
        lc = plan.local_charges(pname)
        if lc["charges"]:
            cid = lc["charge_id"]
            nid = f"charge:{cid}"
            expected = float(sum(lc["charges"].values()))
            got = expected
            source = "plan"
            audit_ev = by_id.get(cid)
            if audit_ev is not None:
                got = float(sum(
                    (audit_ev.get("charges") or {}).values()))
                source = "audit"
            elif pname in audit_events:
                _divergence(
                    div, "tampered-charge", pname,
                    f"local charge {cid!r} (ε={expected:g}) is absent "
                    f"from {pname!r}'s audit trail — local cells were "
                    "computed without the recorded spend",
                    charge_id=cid, node=nid)
            nodes[nid] = {"kind": "charge", "party": pname,
                          "charge_id": cid, "eps": got,
                          "expected_eps": expected, "source": source,
                          "label_text": f"{pname} local ε={got:g}"}
            if got != expected:
                _divergence(
                    div, "tampered-charge", pname,
                    f"local charge {cid!r}: audit trail says "
                    f"ε={got!r}, the plan assigns ε={expected!r}",
                    charge_id=cid, node=nid)
            for side, lab in lc["artifacts"]:
                edges.append([f"artifact:{side}:{lab}", nid,
                              "charged_by"])
            for i, j in plan.local_cells(pname):
                edges.append([nid, f"cell:{i},{j}", "covers"])
            charge_total.setdefault(pname, []).append((cid, got))

    for (side, lab), sites in sorted(charged_venues.items()):
        uniq = sorted({(s, r) for _p, s, r in sites})
        if len(uniq) > 1:
            _divergence(
                div, "double-charged-artifact",
                ",".join(sorted({p for p, _s, _r in sites})),
                f"({side}, {lab!r}) charged in {len(uniq)} rounds "
                f"{uniq} — the plan charges each artifact exactly "
                "once", artifact=lab,
                artifact_node=f"artifact:{side}:{lab}")

    # -- totals: float-for-float at the optimum -----------------------
    per_party = {}
    for pname, pairs in sorted(charge_total.items()):
        per_party[pname] = math.fsum(e for _cid, e in sorted(pairs))
    # audit replay is the stronger per-party source when present: it
    # folds refunds and duplicate charge_ids the transcript can't see
    for pname, events in audit_events.items():
        spent = replay(events).get(pname)
        if spent is not None:
            per_party[pname] = spent
    prov.parties = {
        p: {"spent": per_party.get(p, 0.0),
            "share": plan.party_eps().get(p, 0.0)}
        for p, _c in plan.parties}
    prov.total_eps = math.fsum(per_party.get(p, 0.0)
                               for p, _c in plan.parties)
    # the expected total is the plan's *own* charge arithmetic folded
    # the same way as the observed spend (fsum of per-party shares in
    # party order) — optimal_eps()'s single multiply can differ in the
    # last ulp for arbitrary ε, and that is not a divergence
    prov.expected_eps = math.fsum(plan.party_eps().get(p, 0.0)
                                  for p, _c in plan.parties)
    if prov.total_eps != prov.expected_eps:
        worst = sorted(
            ((p, v["spent"] - v["share"])
             for p, v in prov.parties.items()),
            key=lambda kv: -abs(kv[1]))
        _divergence(
            div, "eps-total-mismatch",
            worst[0][0] if worst and worst[0][1] else None,
            f"reconstructed federation spend {prov.total_eps!r} != "
            f"optimal_eps() {prov.expected_eps!r} "
            f"(per-party deltas: "
            f"{ {p: round(d, 12) for p, d in worst if d} })")
    prov.divergences = div
    return prov


# ===================================================== CLI plumbing ====

def discover_federation(plan_path: str,
                        transcript_dir: str | None = None,
                        transcript_specs=None,
                        audit_specs=None,
                        journal_dir: str | None = None):
    """Resolve the CLI's file arguments into :func:`build_provenance`
    inputs. Transcripts are grouped by the party name embedded in the
    ``{session}.{party}.jsonl`` convention every federation driver
    writes; explicit ``NAME=PATH`` specs override."""
    with open(plan_path, encoding="utf-8") as fh:
        doc = json.load(fh)
    plan = FederationPlan.from_public(doc.get("plan", doc))
    transcripts: dict = {}
    paths = []
    if transcript_dir:
        for path in sorted(globmod.glob(
                os.path.join(transcript_dir, "*.jsonl"))):
            base = os.path.basename(path)
            if not base.startswith(("audit.", "trace.")):
                paths.append(path)
    for spec in transcript_specs or []:
        name, sep, path = spec.partition("=")
        if sep:
            transcripts.setdefault(name, []).append(path)
        else:
            paths.append(spec)
    known = {p for p, _c in plan.parties}
    for path in paths:
        parts = os.path.basename(path).split(".")
        pname = parts[-2] if len(parts) >= 3 else None
        if pname in known:
            transcripts.setdefault(pname, []).append(path)
    audits: dict = {}
    for spec in audit_specs or []:
        pname, sep, path = spec.partition("=")
        if not sep:
            raise ValueError(f"--audit {spec!r}: expected NAME=PATH")
        audits[pname] = path
    journals: dict = {}
    if journal_dir:
        for path in sorted(globmod.glob(
                os.path.join(journal_dir, "journal.*.json"))):
            parts = os.path.basename(path).split(".")
            if len(parts) >= 3 and parts[1] in known:
                journals.setdefault(parts[1], []).append(path)
    return plan, transcripts, audits, journals
