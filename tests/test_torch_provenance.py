"""The port's ε-provenance DAG (``dpcorr_torch.obs.provenance``) and the
federation's observability surfaces against the JAX package's, case by
case as ``tests/test_provenance.py`` runs them.

The records come from the port's own federation on the CPU (n = 256-512,
``device="cpu"``); the same files then go through both packages'
builders, which are torch- and jax-free. On every input — the clean run
and each hostile copy — the port's document (JSON and DOT) equals the
JAX package's byte for byte, so divergences carry the same kinds, parties
and details; the clean total equals ``FederationPlan.optimal_eps()``
float for float.
"""

import argparse
import glob
import json
import math
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

import dpcorr.obs.provenance as jprov
from dpcorr.__main__ import cmd_obs_provenance as jax_cmd_obs_provenance
from dpcorr.obs import recorder as jrecorder
from dpcorr.obs.console import render_federation_frame as jax_fed_frame
from dpcorr.obs.endpoint import start_obs_server as jax_start_obs_server
from dpcorr.obs.fleet import FleetSnapshot as JaxFleetSnapshot
from dpcorr.obs.metrics import Registry as JaxRegistry
from dpcorr.obs.slo import (
    federation_eps_burn_objectives as jax_eps_burn_objectives,
)
from dpcorr.protocol.matrix import FederationPlan as JaxPlan
from dpcorr_torch.__main__ import cmd_obs_provenance
from dpcorr_torch.obs import recorder as obs_recorder
from dpcorr_torch.obs import trace as obs_trace
from dpcorr_torch.obs.audit import AuditTrail
from dpcorr_torch.obs.endpoint import start_obs_server
from dpcorr_torch.obs.fleet import FleetCollector, FleetSnapshot
from dpcorr_torch.obs.metrics import Registry
from dpcorr_torch.obs.provenance import (
    DIVERGENCE_KINDS,
    build_provenance,
    discover_federation,
)
from dpcorr_torch.protocol.federation import (
    _drive_parties,
    make_federation_parties,
    run_federation_inproc,
)
from dpcorr_torch.protocol.matrix import FederationPlan
from dpcorr_torch.serve.ledger import PrivacyLedger

N = 512


def _plan(eps=1.0, parties=None, n=N, family="ni_sign"):
    return FederationPlan(
        family=family, n=n, eps=eps,
        parties=parties or [("p0", ["a", "b"]), ("p1", ["c"]),
                            ("p2", ["d"])])


def _jplan(plan):
    return JaxPlan.from_public(plan.to_public())


def _data(plan, rho=0.6):
    k = plan.k
    cov = np.full((k, k), rho)
    np.fill_diagonal(cov, 1.0)
    xy = np.random.default_rng(plan.seed).multivariate_normal(
        np.zeros(k), cov, size=plan.n)
    return {lab: np.asarray(xy[:, i], np.float32)
            for i, (_owner, lab) in enumerate(plan.columns())}


def _run_recorded(plan, outdir):
    """One clean port federation on the CPU with every record kind on
    disk; returns (transcripts, audits, journals) maps."""
    ledgers = {}
    for name, _cols in plan.parties:
        trail = AuditTrail(os.path.join(outdir, f"audit.{name}.jsonl"))
        ledgers[name] = PrivacyLedger(
            100.0, path=os.path.join(outdir, f"ledger.{name}.json"),
            audit=trail)
    run_federation_inproc(plan, _data(plan), ledgers=ledgers,
                          transcript_dir=outdir, journal_dir=outdir,
                          device="cpu")
    transcripts, journals = {}, {}
    for path in sorted(glob.glob(os.path.join(outdir, "*.jsonl"))):
        base = os.path.basename(path)
        if base.startswith("audit."):
            continue
        transcripts.setdefault(base.split(".")[-2], []).append(path)
    for path in sorted(glob.glob(os.path.join(outdir, "journal.*.json"))):
        journals.setdefault(
            os.path.basename(path).split(".")[1], []).append(path)
    audits = {name: os.path.join(outdir, f"audit.{name}.jsonl")
              for name, _cols in plan.parties}
    return transcripts, audits, journals


def _both(plan, transcripts, audits=None, journals=None):
    """The port's provenance, after holding its JSON document and its DOT
    rendering byte-equal to the JAX package's on the same files."""
    port = build_provenance(plan, transcripts, audits=audits,
                            journals=journals)
    ref = jprov.build_provenance(_jplan(plan), transcripts, audits=audits,
                                 journals=journals)
    assert json.dumps(port.to_doc(), sort_keys=True) == \
        json.dumps(ref.to_doc(), sort_keys=True)
    assert port.to_dot() == ref.to_dot()
    assert port.total_eps == ref.total_eps
    return port


@pytest.fixture(scope="module")
def clean_run(tmp_path_factory):
    """One recorded 3-party run shared by the read-only tests (the hostile
    tests mutate *copies* of its files)."""
    outdir = str(tmp_path_factory.mktemp("fedprov"))
    plan = _plan()
    return plan, outdir, _run_recorded(plan, outdir)


def _mutate_transcript(src, dstdir, fn):
    """Copy a transcript applying ``fn(entry_dict) -> entry_dict`` to
    every message line (meta lines pass through)."""
    os.makedirs(dstdir, exist_ok=True)
    dst = os.path.join(dstdir, os.path.basename(src))
    with open(src) as f, open(dst, "w") as out:
        for line in f:
            obj = json.loads(line)
            if "dir" in obj:
                obj = fn(obj)
            out.write(json.dumps(obj) + "\n")
    return dst


# ------------------------------------------------------ clean DAG ----

def test_clean_run_proves_optimum(clean_run):
    plan, _outdir, (transcripts, audits, journals) = clean_run
    prov = _both(plan, transcripts, audits, journals)
    assert prov.ok, prov.divergences
    assert prov.total_eps == plan.optimal_eps()
    assert prov.total_eps == _jplan(plan).optimal_eps()
    for name, share in plan.party_eps().items():
        assert prov.parties[name]["spent"] == share
    charged_by = {}
    for src, dst, rel in prov.edges:
        if rel == "charged_by":
            charged_by.setdefault(src, []).append(dst)
    for (side, lab), _venue in plan.artifact_venues().items():
        aid = f"artifact:{side}:{lab}"
        assert len(charged_by.get(aid, [])) == 1, (aid, charged_by)
    doc = prov.to_doc()
    assert doc["ok"] and doc["eps"]["total"] == plan.optimal_eps()
    assert prov.to_dot().startswith("digraph")
    i, j = plan.cells()[-1]
    story = prov.cell_story(i, j)
    assert story == jprov.build_provenance(
        _jplan(plan), transcripts, audits=audits,
        journals=journals).cell_story(i, j)
    assert story["cell"]["venue"] == list(plan.cell_venue(i, j))
    assert story["rounds"] and story["charges"]


def test_four_party_meta_total_eps_exact(tmp_path):
    plan = _plan(eps=1.0, n=256,
                 parties=[("p0", ["a", "b"]), ("p1", ["c"]),
                          ("p2", ["d"]), ("p3", ["e", "f"])])
    transcripts, audits, journals = _run_recorded(plan, str(tmp_path))
    prov = _both(plan, transcripts, audits, journals)
    assert prov.ok, prov.divergences
    assert prov.total_eps == plan.optimal_eps()
    assert sum(1 for _s, _d, rel in prov.edges
               if rel == "charged_by") == len(plan.artifact_venues())


def test_awkward_eps_reassociation_is_not_a_divergence(tmp_path):
    plan = _plan(eps=0.7, n=256)
    transcripts, audits, journals = _run_recorded(plan, str(tmp_path))
    prov = _both(plan, transcripts, audits, journals)
    assert prov.ok, prov.divergences
    assert prov.total_eps == math.fsum(
        plan.party_eps()[p] for p, _c in plan.parties)
    assert abs(prov.total_eps - plan.optimal_eps()) < 1e-12


# -------------------------------------------------- hostile inputs ----

def _kinds(prov):
    return {d["kind"] for d in prov.divergences}


def test_divergence_kinds_are_closed():
    assert DIVERGENCE_KINDS == jprov.DIVERGENCE_KINDS
    assert set(DIVERGENCE_KINDS) == {
        "missing-party-view", "truncated-transcript",
        "re-noised-artifact", "double-charged-artifact",
        "tampered-charge", "eps-total-mismatch"}


def test_missing_party_view_named(clean_run):
    plan, _outdir, (transcripts, audits, _journals) = clean_run
    partial = {k: v for k, v in transcripts.items() if k != "p2"}
    prov = _both(plan, partial, audits)
    assert not prov.ok
    assert _kinds(prov) == {"missing-party-view"}
    assert all(d["party"] == "p2" for d in prov.divergences)


def test_tampered_charge_amount_named(clean_run, tmp_path):
    plan, _outdir, (transcripts, audits, _journals) = clean_run

    def halve(entry):
        if entry.get("dir") == "send" and entry.get("eps", 0) > 0:
            entry["eps"] = entry["eps"] / 2
        return entry

    mutated = dict(transcripts)
    mutated["p0"] = [_mutate_transcript(p, str(tmp_path), halve)
                     for p in transcripts["p0"]]
    prov = _both(plan, mutated, audits)
    assert "tampered-charge" in _kinds(prov)
    bad = [d for d in prov.divergences if d["kind"] == "tampered-charge"]
    assert bad and all(d["party"] == "p0" for d in bad)
    assert all(d.get("charge_id") for d in bad)


def test_tampered_audit_trail_named(clean_run, tmp_path):
    plan, _outdir, (transcripts, audits, _journals) = clean_run
    forged = os.path.join(str(tmp_path), "audit.p1.jsonl")
    with open(audits["p1"]) as f, open(forged, "w") as out:
        for line in f:
            ev = json.loads(line)
            if ev.get("kind") == "charge" and ev.get("charges"):
                k = sorted(ev["charges"])[0]
                ev["charges"][k] += 0.25
            out.write(json.dumps(ev) + "\n")
    prov = _both(plan, transcripts, {**audits, "p1": forged})
    assert {"tampered-charge", "eps-total-mismatch"} <= _kinds(prov)
    assert all(d["party"] == "p1" for d in prov.divergences)
    assert prov.total_eps != plan.optimal_eps()


def test_renoised_artifact_names_minority_holder(clean_run, tmp_path):
    plan, _outdir, (transcripts, audits, _journals) = clean_run

    def perturb(entry):
        pay = entry.get("wire", {}).get("payload", {})
        arts = pay.get("artifacts")
        if isinstance(arts, dict) and arts:
            for group in arts.values():
                for leaf in group.values():
                    if isinstance(leaf, dict) and "b64" in leaf:
                        s = leaf["b64"]
                        leaf["b64"] = ("B" if s[0] != "B" else "C") + s[1:]
                        return entry
        return entry

    mutated = dict(transcripts)
    mutated["p1"] = [_mutate_transcript(transcripts["p1"][0],
                                        str(tmp_path), perturb)]
    prov = _both(plan, mutated, audits)
    bad = [d for d in prov.divergences
           if d["kind"] == "re-noised-artifact"]
    assert bad and bad[0]["party"] == "p1"
    assert len(bad[0]["variants"]) == 2


def test_truncated_transcript_is_typed_not_a_crash(clean_run, tmp_path):
    plan, _outdir, (transcripts, audits, _journals) = clean_run
    src = transcripts["p2"][0]
    with open(src) as f:
        raw = f.read()
    cut = os.path.join(str(tmp_path), os.path.basename(src))
    with open(cut, "w") as f:
        f.write(raw[: int(len(raw) * 0.4)])  # mid-line: unparseable tail
    mutated = dict(transcripts)
    mutated["p2"] = [cut if p == src else p for p in transcripts["p2"]]
    prov = _both(plan, mutated, audits)
    assert "truncated-transcript" in _kinds(prov)
    assert all("p2" in (d["party"] or "") for d in prov.divergences)


def test_double_charged_artifact(clean_run, tmp_path):
    plan, _outdir, (transcripts, _audits, _journals) = clean_run
    src = transcripts["p0"][0]
    dst = os.path.join(str(tmp_path), os.path.basename(src))
    with open(src) as f:
        lines = [json.loads(ln) for ln in f]
    dup = None
    for obj in lines:
        if obj.get("dir") == "send" and obj.get("eps", 0) > 0 \
                and obj.get("wire", {}).get("msg_type") == "release":
            dup = json.loads(json.dumps(obj))
            dup["wire"]["payload"]["round"] = 1
            if "charge_id" in dup:
                dup["charge_id"] = dup["charge_id"] + ":dup"
            break
    assert dup is not None
    with open(dst, "w") as f:
        for obj in lines + [dup]:
            f.write(json.dumps(obj) + "\n")
    mutated = dict(transcripts)
    mutated["p0"] = [dst if p == src else p for p in transcripts["p0"]]
    prov = _both(plan, mutated)
    assert "double-charged-artifact" in _kinds(prov)


# ---------------------------------------------- single shared trace ----

def test_inproc_federation_is_one_trace(tmp_path):
    spool = str(tmp_path / "spans.jsonl")
    obs_trace.configure(spool)
    try:
        plan = _plan(n=256)
        run_federation_inproc(plan, _data(plan), device="cpu")
    finally:
        obs_trace.configure(None)
    spans = obs_trace.read_spans(spool)
    assert {s["trace_id"] for s in spans} == {_jplan(plan).trace_id()}
    assert {"federation.matrix", "federation.link", "federation.round",
            "federation.cell"} <= {s["name"] for s in spans}


def test_plan_trace_id_is_deterministic_and_wire_width():
    plan = _plan()
    assert plan.trace_id() == _plan().trace_id() == _jplan(plan).trace_id()
    assert plan.trace_id() == plan.fed_hash()[:16]
    assert len(plan.trace_id()) == 16


# ---------------------------------------------- party obs endpoint ----

def _scrape_endpoint(start, registry_cls, recorder_mod, dump_path):
    """Scrape and trigger one package's mini endpoint the way
    ``tests/test_provenance.py`` does; every answer in order."""
    registry = registry_cls()
    registry.counter("dpcorr_federation_cells_completed_total", "cells",
                     labelnames=("venue",)).inc(7, venue="link")
    stats = {"kind": "federation_party", "party": "p0", "cells_done": 7}
    server, port = start(registry, stats_fn=lambda: stats)
    rec = recorder_mod.FlightRecorder(dump_path)
    recorder_mod.install(rec)
    base = f"http://127.0.0.1:{port}"
    out = []
    try:
        for route in ("/stats", "/metrics", "/healthz"):
            with urllib.request.urlopen(f"{base}{route}", timeout=5) as r:
                out.append((r.status, r.read().decode()))
        for body in ({"reason": "nonsense"},
                     {"reason": "federation_scan_violation",
                      "detail": {"party": "p0"}}):
            req = urllib.request.Request(
                f"{base}/obs/trigger", method="POST",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=5) as r:
                    doc = json.loads(r.read())
                    out.append((r.status, doc["armed"],
                                doc["dumped"] == dump_path))
            except urllib.error.HTTPError as e:
                out.append((e.code, json.loads(e.read())))
        out.append(rec.last_reason)
    finally:
        recorder_mod.install(None)
        server.shutdown()
    return out, registry.render()


def test_obs_endpoint_scrape_and_trigger(tmp_path):
    got, exposition = _scrape_endpoint(
        start_obs_server, Registry, obs_recorder, str(tmp_path / "p.json"))
    want, _ = _scrape_endpoint(jax_start_obs_server, JaxRegistry,
                               jrecorder, str(tmp_path / "p.json"))
    assert got == want
    assert got[0] == (200, json.dumps({"kind": "federation_party",
                                       "party": "p0", "cells_done": 7}))
    assert got[1] == (200, exposition)
    assert got[3][0] == 400 and got[4] == (200, True, True)
    assert got[5] == "federation_scan_violation"


def test_federation_trigger_reasons_registered():
    assert obs_recorder.TRIGGER_REASONS == jrecorder.TRIGGER_REASONS
    for reason in ("federation_unhandled", "federation_resume_refused",
                   "federation_scan_violation"):
        assert reason in obs_recorder.TRIGGER_REASONS


def test_fleet_collector_scrapes_party_binary_exact(tmp_path):
    plan = _plan(n=256)
    parties = make_federation_parties(plan, _data(plan),
                                      transcript_dir=str(tmp_path),
                                      device="cpu")
    p0 = parties["p0"]
    server, port = start_obs_server(p0.registry,
                                    stats_fn=p0.stats_snapshot)
    try:
        _drive_parties(parties)
        snap = FleetCollector({"p0": f"http://127.0.0.1:{port}"}).scrape()
        assert not snap.errors()
        rec = snap.instances["p0"]
        assert rec["exposition"] == p0.registry.render()
        stats = rec["stats"]
        assert stats["kind"] == "federation_party"
        assert stats["trace_id"] == _jplan(plan).trace_id()
        assert stats["cells_done"] == len(plan.local_cells("p0")) + sum(
            len(r) for p, q in plan.party_links("p0")
            for r in plan.link_rounds(p, q))
        assert stats["eps"]["spent"] == _jplan(plan).party_eps()["p0"]
        cells = snap.families()["p0"][
            "dpcorr_federation_cells_completed_total"]
        assert sum(v for _s, _l, v in cells.samples) == stats["cells_done"]
    finally:
        server.shutdown()


# ----------------------------------------------- console + SLO view ----

def test_console_federation_frame(clean_run):
    """The federation frame over one live party and one dead: string-equal
    to the JAX package's on the same snapshot, ``now`` pinned."""
    from dpcorr_torch.obs.console import render_federation_frame

    plan, _outdir, _records = clean_run
    frames = []
    for registry_cls, snapshot_cls, render in (
            (Registry, FleetSnapshot, render_federation_frame),
            (JaxRegistry, JaxFleetSnapshot, jax_fed_frame)):
        registry = registry_cls()
        registry.counter("dpcorr_federation_rounds_total", "rounds",
                         labelnames=("link", "role")).inc(
            3, link="p0-p1", role="release")
        registry.histogram("dpcorr_federation_round_latency_seconds",
                           "rt", buckets=(0.1, 1.0)).observe(0.05)
        registry.counter("dpcorr_federation_release_cache_total", "cache",
                         labelnames=("label", "outcome")).inc(
            2, label="a", outcome="hit")
        stats = {"kind": "federation_party", "instance": "p0",
                 "party": "p0", "fed": plan.fed,
                 "trace_id": plan.trace_id(), "cells_done": 5,
                 "cells_total": 6, "links": ["p0-p1", "p0-p2"],
                 "eps": {"spent": 6.0, "share": 6.0}}
        frames.append(render(snapshot_cls({
            "p0": {"url": "http://x", "error": None, "stats": stats,
                   "exposition": registry.render()},
            "p1": {"url": "http://y", "error": "URLError: down",
                   "stats": None, "exposition": None}}), now=0.0))
    assert frames[0] == frames[1]
    frame = frames[0]
    assert "p1" in frame and "DOWN" in frame
    assert "5/6" in frame and "6/6" in frame
    assert plan.fed in frame and plan.trace_id() in frame


def test_slo_federation_objectives_page_offending_party():
    from dpcorr_torch.obs.fleet import parse_families
    from dpcorr_torch.obs.slo import (
        BurnRateEngine,
        federation_eps_burn_objectives,
        federation_round_latency_objective,
    )

    plan = _plan()
    lat = federation_round_latency_objective()
    assert lat.histogram == "dpcorr_federation_round_latency_seconds"
    objectives = federation_eps_burn_objectives(plan, makespan_s=100.0)
    ref = jax_eps_burn_objectives(_jplan(plan), makespan_s=100.0)
    assert [(o.name, o.eps_per_s, o.eps_series) for o in objectives] == \
        [(o.name, o.eps_per_s, o.eps_series) for o in ref]
    shares = plan.party_eps()
    for o in objectives:
        assert o.eps_per_s == shares[o.name.rsplit("-", 1)[1]] / 100.0
    obj = next(o for o in objectives if o.name.endswith("p0"))
    engine = BurnRateEngine([obj], windows=(("page", 1.0, 1.0, 14.4),))

    def fams(spent):
        registry = Registry()
        registry.gauge("dpcorr_federation_ledger_spent_eps", "eps",
                       labelnames=("ledger",)).set(spent, ledger="p0")
        return parse_families(registry.render())

    engine.observe({"p0": fams(0.0)}, at=0.0)
    engine.observe({"p0": fams(6.0)}, at=1.0)
    fired = engine.evaluate(at=1.0)
    assert [(a.instance, a.severity) for a in fired] == [("p0", "page")]


# ------------------------------------------------------ CLI surface ----

def _provenance_cli(cmd, recorder_mod, args, dump, capsys):
    rec = recorder_mod.FlightRecorder(dump)
    recorder_mod.install(rec)
    try:
        with pytest.raises(SystemExit) as exc:
            cmd(args)
    finally:
        recorder_mod.install(None)
    return exc.value.code, rec.last_reason, capsys.readouterr().out


def test_cli_provenance_divergence_arms_recorder(clean_run, tmp_path,
                                                 capsys):
    """``obs provenance`` on divergent records exits 1, dumps the installed
    recorder with the federation reason and prints what the JAX command
    prints; ``--out`` writes the JAX command's document."""
    plan, _outdir, (transcripts, _audits, _journals) = clean_run
    plan_path = str(tmp_path / "plan.json")
    with open(plan_path, "w") as f:
        json.dump({"plan": plan.to_public()}, f)
    partial = tmp_path / "partial"
    partial.mkdir()
    for pname, paths in transcripts.items():
        if pname == "p2":
            continue
        for p in paths:
            with open(p) as f:
                (partial / os.path.basename(p)).write_text(f.read())
    runs = {}
    for pkg, cmd, mod in (("port", cmd_obs_provenance, obs_recorder),
                          ("jax", jax_cmd_obs_provenance, jrecorder)):
        args = argparse.Namespace(
            plan=plan_path, transcript_dir=str(partial), transcript=None,
            audit=None, journal_dir=None, out=str(tmp_path / f"{pkg}.json"),
            dot=str(tmp_path / f"{pkg}.dot"), cell=None, json=False)
        runs[pkg] = _provenance_cli(cmd, mod, args,
                                    str(tmp_path / f"dump.{pkg}.json"),
                                    capsys)
    assert runs["port"] == runs["jax"]
    code, reason, out = runs["port"]
    assert code == 1 and reason == "federation_scan_violation"
    assert "missing-party-view" in out and "p2" in out
    for ext in ("json", "dot"):
        with open(tmp_path / f"port.{ext}") as a, \
                open(tmp_path / f"jax.{ext}") as b:
            assert a.read() == b.read()
    with open(tmp_path / "port.json") as f:
        assert not json.load(f)["ok"]


@pytest.mark.parametrize("flag", ["json", "cell"])
def test_cli_provenance_clean_outputs_equal_jax(clean_run, tmp_path, capsys,
                                                flag):
    """On the clean records, ``--json`` and ``--cell I,J`` print what the
    JAX command prints, and the command exits normally."""
    plan, outdir, _records = clean_run
    plan_path = str(tmp_path / "plan.json")
    with open(plan_path, "w") as f:
        json.dump(plan.to_public(), f)
    i, j = plan.cells()[0]
    outs = []
    for cmd in (cmd_obs_provenance, jax_cmd_obs_provenance):
        cmd(argparse.Namespace(
            plan=plan_path, transcript_dir=outdir, transcript=None,
            audit=[f"{p}={outdir}/audit.{p}.jsonl" for p, _ in plan.parties],
            journal_dir=outdir, out=None, dot=None,
            cell=f"{i},{j}" if flag == "cell" else None,
            json=flag == "json"))
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    doc = json.loads(outs[0])
    if flag == "json":
        assert doc["ok"] and doc["eps"]["total"] == plan.optimal_eps()
    else:
        assert doc["cell"]["i"] == i and doc["charges"]


def test_discover_federation_groups_by_filename(clean_run, tmp_path):
    plan, outdir, _records = clean_run
    plan_path = str(tmp_path / "plan.json")
    with open(plan_path, "w") as f:
        json.dump({"plan": plan.to_public()}, f)
    kw = dict(transcript_dir=outdir,
              audit_specs=[f"p0={outdir}/audit.p0.jsonl"],
              journal_dir=outdir)
    got_plan, transcripts, audits, journals = discover_federation(
        plan_path, **kw)
    ref = jprov.discover_federation(plan_path, **kw)
    assert got_plan.to_public() == ref[0].to_public()
    assert (transcripts, audits, journals) == ref[1:]
    assert got_plan.fed == plan.fed
    assert set(transcripts) == {"p0", "p1", "p2"}
    assert all(len(v) == 2 for k, v in transcripts.items() if k != "p1")
    assert list(audits) == ["p0"]
    assert set(journals) == {"p0", "p1", "p2"}
    prov = _both(got_plan, transcripts, audits, journals)
    assert prov.ok and prov.total_eps == plan.optimal_eps()
