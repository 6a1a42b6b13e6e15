"""Offline transcript auditor: schema, no-raw-columns, ε balance.

Counterpart of ``dpcorr/protocol/scan.py``: it reads either package's
transcripts and audit trails.

A party's transcript (protocol.messages.Transcript) records the full
wire dict of every frame it sent or received, so the privacy claims of
a finished session are *checkable from the log alone*:

- :func:`scan_transcript` — the structural audit. Every wire object
  must parse as a versioned message from the closed vocabulary; array
  envelopes may appear **only** inside ``release`` payloads and must
  match the family's wire schema (kind, shape, dtype) derived from the
  session's own ``hello`` spec; value-level checks (sign releases take
  values only in {−1, 0, +1}) plus — when the caller supplies the raw
  columns — the no-raw-columns proof: no released array may reproduce a
  raw column (or its sign/clip image) beyond the exact-match rate DP
  noise permits.
- :func:`ledger_balance` — the accounting audit. Every gated send in
  the transcript (``eps > 0``) must match exactly one durable ``charge``
  event in the party's audit trail (same trace, same total ε) and vice
  versa, and replaying the trail must land on the same per-party totals
  — a release that crossed the wire without a durable charge, or a
  charge with no corresponding message, both surface as violations.

Deliberately torch-free (stdlib + numpy): the auditor must run where the
estimators can't, and must not share code paths with the thing it
audits. The wire schema is therefore *re-derived* here from the public
batch-geometry rule — tests/test_torch_protocol.py pins it equal to
``split_reference.release_schema`` so the two can never drift silently.
"""

from __future__ import annotations

import hashlib
import math

from dpcorr_torch.obs.audit import replay
from dpcorr_torch.obs.budget_replay import RESERVED_PREFIXES
from dpcorr_torch.protocol.messages import (
    MSG_TYPES,
    PROTOCOL_VERSION,
    canonical_encode,
    decode_array,
    iter_arrays,
    read_transcript,
)

#: exact-match fraction a continuous-noise release may share with a raw
#: column: Laplace noise makes exact float equality measure-zero, so
#: anything above ~1% of entries means the "release" is raw data.
RAW_MATCH_MAX = 0.01

_SIGN_VALUES = (-1.0, -0.0, 0.0, 1.0)


def wire_schema(family: str, n: int, eps1: float, eps2: float) -> dict:
    """Pure-Python mirror of ``split_reference.release_schema`` (the
    batch-geometry rule ⌈8/(ε₁ε₂)⌉ capped at n; see module docstring
    for why this is re-derived rather than imported)."""
    kinds = {
        "ni_sign": ("batch_means", "noisy_sign_batch_means"),
        "ni_subg": ("batch_means", "noisy_clipped_batch_means"),
        "int_sign": ("flipped_signs", "rr_flipped_signs"),
        "int_subg": ("ldp_values", "ldp_clipped_values"),
    }
    if family not in kinds:
        raise ValueError(f"unknown family {family!r}")
    name, kind = kinds[family]
    if family in ("ni_sign", "ni_subg"):
        m = min(math.ceil(8.0 / (eps1 * eps2)), n)
        shape = (n // m,)
    else:
        shape = (n,)
    return {name: {"kind": kind, "shape": shape, "dtype": "float32"}}


def _violation(out: list, entry_idx: int, rule: str, detail: str) -> None:
    out.append({"entry": entry_idx, "rule": rule, "detail": detail})


def _spec_from_hello(entries: list[dict]) -> dict | None:
    for e in entries:
        w = e.get("wire", {})
        if w.get("msg_type") == "hello":
            return w.get("payload", {}).get("spec")
    return None


def _fed_from_hello(entries: list[dict]) -> dict | None:
    """The federation plan a pair-link transcript opened under (the
    link hello carries the full public plan, like the two-party hello
    carries the public spec)."""
    for e in entries:
        w = e.get("wire", {})
        if w.get("msg_type") == "hello":
            fed = w.get("payload", {}).get("fed")
            if isinstance(fed, dict):
                return fed
    return None


def _check_raw(viol: list, idx: int, rel, raws: dict) -> None:
    """The no-raw-columns proof against supplied raw columns. Shapes
    that cannot hold a column pass trivially; same-shape arrays must
    differ from the raw column (and its sign image) in all but a
    noise-consistent fraction of entries."""
    import numpy as np

    for col_name, raw in raws.items():
        raw = np.asarray(raw, dtype=np.float32)
        if rel.shape != raw.shape:
            continue
        frac = float(np.mean(rel == raw))
        if frac > RAW_MATCH_MAX:
            _violation(viol, idx, "raw-column-on-wire",
                       f"release matches raw {col_name} on "
                       f"{frac:.1%} of entries")
        # a sign image is raw data too: randomized response must have
        # flipped SOMETHING, and batch noise never reproduces it exactly
        if bool(np.array_equal(rel, np.sign(raw))):
            _violation(viol, idx, "raw-column-on-wire",
                       f"release equals sign({col_name}) exactly — "
                       "no randomization applied")


def _check_group(viol: list, idx: int, group, schema: dict, raws: dict,
                 where: str = "") -> None:
    """One release payload group (the whole payload of a two-party
    ``release``, or one labelled artifact of a federation round)
    against the family wire schema — keys, envelope, kind, shape,
    dtype, sign-value range, raw-column proof."""
    import numpy as np

    tag = f"{where}: " if where else ""
    if not isinstance(group, dict) or set(group) != set(schema):
        _violation(viol, idx, "schema-keys",
                   f"{tag}payload keys "
                   f"{sorted(group) if isinstance(group, dict) else group!r}"
                   f" != {sorted(schema)}")
        return
    for name, want in schema.items():
        env = group[name]
        if not (isinstance(env, dict) and env.get("__array__") == 1):
            _violation(viol, idx, "schema-envelope",
                       f"{tag}{name!r} is not an array envelope")
            continue
        if env.get("kind") != want["kind"]:
            _violation(viol, idx, "schema-kind",
                       f"{tag}{name!r} kind {env.get('kind')!r} != "
                       f"{want['kind']!r}")
        rel = decode_array(env)
        if tuple(rel.shape) != want["shape"] \
                or str(rel.dtype) != want["dtype"]:
            _violation(viol, idx, "schema-shape",
                       f"{tag}{name!r} is {rel.dtype}{rel.shape}, schema "
                       f"says {want['dtype']}{want['shape']}")
            continue
        if name == "flipped_signs":
            bad = ~np.isin(rel, np.asarray(_SIGN_VALUES, np.float32))
            if bool(bad.any()):
                _violation(viol, idx, "sign-values",
                           f"{tag}{int(bad.sum())} values outside "
                           "{-1, 0, +1}")
        _check_raw(viol, idx, rel, raws)


def scan_transcript(transcript, spec: dict | None = None,
                    raw_x=None, raw_y=None) -> dict:
    """Audit one party's transcript. ``transcript`` is a path or the
    entry list from :func:`~dpcorr_torch.protocol.messages.read_transcript`;
    ``spec`` overrides the hello-embedded public spec (they are
    cross-checked when both exist). Federation pair-link transcripts
    (hello carries the public *plan*) validate each round's labelled
    artifact groups against the same family schema and flag
    ``"federation": True`` in the report. Returns ``{"ok",
    "violations", "messages", "releases", "gated_eps"}`` — never
    raises on content violations, only on an unreadable transcript."""
    entries = (read_transcript(transcript) if isinstance(transcript, str)
               else list(transcript))
    viol: list[dict] = []
    hello_spec = _spec_from_hello(entries)
    fed = _fed_from_hello(entries)
    if spec is not None and hello_spec is not None and spec != hello_spec:
        _violation(viol, -1, "spec-mismatch",
                   "supplied spec differs from the transcript's hello")
    eff = spec or hello_spec
    if eff is None and fed is not None:
        # a federation pair-link: every column shares the plan's one ε
        eff = {"family": fed["family"], "n": fed["n"],
               "eps1": fed["eps"], "eps2": fed["eps"]}
    schema = (wire_schema(eff["family"], int(eff["n"]),
                          float(eff["eps1"]), float(eff["eps2"]))
              if eff else None)
    raws = {}
    if raw_x is not None:
        raws["x"] = raw_x
    if raw_y is not None:
        raws["y"] = raw_y

    releases = 0
    gated_eps = 0.0
    seen_charge_ids: set = set()
    for idx, entry in enumerate(entries):
        w = entry["wire"]
        if w.get("version") != PROTOCOL_VERSION:
            _violation(viol, idx, "bad-version",
                       f"version {w.get('version')!r}")
            continue
        mtype = w.get("msg_type")
        if mtype not in MSG_TYPES:
            _violation(viol, idx, "unknown-type", f"msg_type {mtype!r}")
            continue
        payload = w.get("payload", {})
        arrays = list(iter_arrays(payload))
        if mtype != "release":
            if arrays:
                _violation(viol, idx, "array-outside-release",
                           f"{len(arrays)} array(s) in a {mtype} message")
            continue
        releases += 1
        if entry.get("dir") == "send":
            # a crash-resumed session may log the same gated send twice
            # (original + journal-replayed line); its charge_id is the
            # collapse key — ε was spent once, count it once
            cid = entry.get("charge_id")
            if cid is None or cid not in seen_charge_ids:
                gated_eps += float(entry.get("eps", 0.0))
                if cid is not None:
                    seen_charge_ids.add(cid)
        if schema is None:
            _violation(viol, idx, "no-spec",
                       "release before any hello spec; cannot validate")
            continue
        if fed is not None:
            # federation round envelope: arrays may appear only inside
            # the labelled artifact groups; each group is one column's
            # release and must satisfy the family schema exactly like a
            # two-party payload
            arts = payload.get("artifacts")
            if not isinstance(arts, dict):
                _violation(viol, idx, "fed-release-shape",
                           "round release carries no artifacts map")
                continue
            outside = list(iter_arrays(
                {k: v for k, v in payload.items() if k != "artifacts"}))
            if outside:
                _violation(viol, idx, "array-outside-artifacts",
                           f"{len(outside)} array(s) outside the "
                           "artifacts map")
            for lab in sorted(arts):
                _check_group(viol, idx, arts[lab], schema, raws,
                             where=f"artifact {lab!r}")
            continue
        _check_group(viol, idx, payload, schema, raws)

    out = {"ok": not viol, "violations": viol,
           "messages": len(entries), "releases": releases,
           "gated_eps": gated_eps}
    if fed is not None:
        out["federation"] = True
    return out


def ledger_balance(transcript, audit_events: list[dict]) -> dict:
    """Match every gated send in the transcript to exactly one durable
    ``charge`` event and vice versa (same trace ID, same total ε), and
    compare per-party replay totals. Refunded charges are excluded from
    the expected set — their release never counted. Returns ``{"ok",
    "unmatched_sends", "unmatched_charges", "spent"}``.

    Crash-resumed sessions balance through the ``charge_id`` lens, the
    audit walked chronologically exactly like the ledger walked it:
    only the first charge under a given id spends (later ones are the
    resumed session's idempotent re-runs — including a ``dedup`` event
    standing in for an original line lost between ledger persist and
    audit append); a refund forgets the id so a genuinely new charge
    may reuse it; transcript send lines sharing a charge_id (an
    original plus its journal-replayed duplicate) collapse to one.

    Reserved directory legs (``user/``, ``global/`` — serve.budget_dir)
    are bookkeeping principals, not wire spend: the transcript's ``eps``
    is party-leg-only by construction, so matching sums only the party
    legs of each event, and events consisting *only* of reserved legs
    (the directory's own per-user trail lines) are accounted by the
    replay but never expected to match a send."""
    entries = (read_transcript(transcript) if isinstance(transcript, str)
               else list(transcript))
    sends = []
    seen_cids: set = set()
    for e in entries:
        if e.get("dir") != "send" or float(e.get("eps", 0.0)) <= 0.0:
            continue
        cid = e.get("charge_id")
        if cid is not None:
            if cid in seen_cids:
                continue
            seen_cids.add(cid)
        sends.append(e)

    # chronological effective-charge set, mirroring the ledger's own
    # idempotency arithmetic (obs.audit._dedup_walk)
    applied: dict = {}     # charge_id -> its first (spending) event
    anon: list = []        # charges without an id (legacy / serve path)
    refunded_tids = set()  # refunds without an id match by trace_id
    for ev in audit_events:
        kind, cid = ev["kind"], ev.get("charge_id")
        if kind == "charge":
            if cid is not None:
                applied.setdefault(cid, ev)
            else:
                anon.append(ev)
        elif kind == "refund":
            if cid is not None:
                applied.pop(cid, None)
            else:
                refunded_tids.add(ev.get("trace_id"))
    def _party_eps(ev: dict) -> float:
        return sum(float(e) for p, e in ev["charges"].items()
                   if not p.startswith(RESERVED_PREFIXES))

    charges = [ev for ev in list(applied.values()) +
               [ev for ev in anon
                if ev.get("trace_id") not in refunded_tids]
               if _party_eps(ev) > 0.0]

    unmatched_sends = []
    pool = list(charges)
    for e in sends:
        eps = float(e.get("eps", 0.0))
        tid = e.get("trace_id")
        cid = e.get("charge_id")
        hit = None
        for ev in pool:
            if cid is not None:
                if ev.get("charge_id") == cid \
                        and abs(_party_eps(ev) - eps) < 1e-9:
                    hit = ev
                    break
            elif ev.get("trace_id") == tid \
                    and abs(_party_eps(ev) - eps) < 1e-9:
                hit = ev
                break
        if hit is None:
            unmatched_sends.append({"seq": e.get("seq"), "eps": eps,
                                    "trace_id": tid, "charge_id": cid})
        else:
            pool.remove(hit)
    unmatched_charges = [{"seq": ev.get("seq"),
                          "eps": _party_eps(ev),
                          "trace_id": ev.get("trace_id"),
                          "charge_id": ev.get("charge_id")}
                         for ev in pool]
    return {
        "ok": not unmatched_sends and not unmatched_charges,
        "unmatched_sends": unmatched_sends,
        "unmatched_charges": unmatched_charges,
        "spent": replay(audit_events),
    }


def scan_federation(transcripts) -> dict:
    """The cross-pair correlation-leak gate over a whole federation's
    pair-link transcripts (every party, every link).

    The federation's budget optimum rests on *reusing* a column's DP
    release across every pair that needs it: re-noising per pair would
    hand a curious observer k−1 independently-noised images of the same
    column (averaging them cancels the noise — a correlation leak the
    per-release ε accounting never sees). The wire-checkable form of
    that contract is **byte identity**: a given column label's release
    envelope must be the *identical bytes* in every transcript it
    appears in. Divergence names the offending pair sessions. The gate
    also refuses double-charging — an artifact whose label appears in
    more than one distinct round's ``charged`` list was paid for twice,
    which is an ε leak even when the bytes agree.

    ``transcripts`` is a list of paths or entry lists. Returns
    ``{"ok", "violations", "labels", "transcripts", "by_label",
    "charged"}`` — the last two are the gate's working evidence
    (per-label encoding variants with sha256 + sessions, and each
    side's charging venues), exported so a provenance view can be
    built without re-walking the transcripts; the ``federation scan``
    command exits 1 on any violation."""
    by_label: dict = {}     # label -> {canonical bytes -> [session...]}
    charged_x: dict = {}    # label -> set of (session, round) charging it
    charged_y: dict = {}
    n = 0
    for t in transcripts:
        entries = (read_transcript(t) if isinstance(t, str) else list(t))
        n += 1
        for e in entries:
            w = e.get("wire", {})
            sess = w.get("session", "?")
            payload = w.get("payload", {})
            mtype = w.get("msg_type")
            if mtype == "release" and isinstance(
                    payload.get("artifacts"), dict):
                for lab, group in payload["artifacts"].items():
                    enc = canonical_encode(group) \
                        if isinstance(group, dict) else repr(group).encode()
                    by_label.setdefault(lab, {}).setdefault(
                        enc, set()).add(sess)
                for lab in payload.get("charged", ()):
                    charged_x.setdefault(lab, set()).add(
                        (sess, payload.get("round")))
            elif mtype == "result":
                for lab in payload.get("charged", ()):
                    charged_y.setdefault(lab, set()).add(
                        (sess, payload.get("round")))
    viol: list[dict] = []
    for lab, variants in sorted(by_label.items()):
        if len(variants) > 1:
            sessions = sorted(s for ss in variants.values() for s in ss)
            _violation(
                viol, -1, "cross-pair-release-divergence",
                f"column {lab!r} released as {len(variants)} distinct "
                f"byte encodings across pair sessions {sessions} — "
                "re-noised releases of one column are subtractable")
    for side, charged in (("x", charged_x), ("y", charged_y)):
        for lab, venues in sorted(charged.items()):
            if len(venues) > 1:
                _violation(
                    viol, -1, "double-charged-artifact",
                    f"({side}, {lab!r}) charged in {len(venues)} rounds "
                    f"{sorted(venues)} — the plan charges each artifact "
                    "exactly once")
    label_detail = {
        lab: [{"sha256": hashlib.sha256(enc).hexdigest(),
               "bytes": len(enc), "sessions": sorted(sessions)}
              for enc, sessions in sorted(
                  variants.items(),
                  key=lambda kv: sorted(kv[1]))]
        for lab, variants in sorted(by_label.items())}
    charged = {side: {lab: sorted(([s, r] for s, r in venues),
                                  key=lambda v: (str(v[0]), str(v[1])))
                      for lab, venues in sorted(ch.items())}
               for side, ch in (("x", charged_x), ("y", charged_y))}
    return {"ok": not viol, "violations": viol,
            "labels": sorted(by_label), "transcripts": n,
            "by_label": label_detail, "charged": charged}


def federation_balance(transcripts, audit_events: list[dict],
                       expected_local_eps: float = 0.0) -> dict:
    """One party's whole-matrix accounting audit: every gated send
    across *all* of its pair-link transcripts matches exactly one
    durable charge (:func:`ledger_balance` over the concatenated
    entries), and the only charges allowed to stand unmatched by any
    send are the party's local-cell charges (their plan-derived
    ``charge_id`` ends in ``":local"`` — local cells spend real ε with
    no wire message to pair it with), whose total must equal
    ``expected_local_eps`` (``FederationPlan.local_charges``)."""
    entries: list = []
    for t in transcripts:
        entries.extend(read_transcript(t) if isinstance(t, str)
                       else list(t))
    bal = ledger_balance(entries, audit_events)
    local, rest = [], []
    for c in bal["unmatched_charges"]:
        cid = str(c.get("charge_id") or "")
        (local if cid.endswith(":local") else rest).append(c)
    local_eps = sum(float(c["eps"]) for c in local)
    ok = (not bal["unmatched_sends"] and not rest
          and abs(local_eps - float(expected_local_eps)) < 1e-9)
    return {"ok": ok, "unmatched_sends": bal["unmatched_sends"],
            "unmatched_charges": rest, "local_eps": local_eps,
            "expected_local_eps": float(expected_local_eps),
            "spent": bal["spent"]}
