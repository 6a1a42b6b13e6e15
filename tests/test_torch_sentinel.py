"""The port's live invariant sentinel (``dpcorr_torch.obs.sentinel``)
against ``dpcorr.obs.sentinel``, case by case as
``tests/test_sentinel.py`` runs them, plus both packages over the port's
own services' files.

Every case runs a port sentinel and a JAX sentinel side by side over the
same files at the same poll times (:class:`Twin`): each poll's
violations (kind, source, artifact, detail, signature) and each
checkpoint file are equal. A checkpoint written by either package is
resumed by the other without alerting twice. The durable files come from
scripted lines with the services' shapes and from the port's stream
service, serve ledger and federation on the CPU (``device="cpu"``); the
sentinels themselves import neither torch nor jax.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import dpcorr.obs.sentinel as jsentinel
from dpcorr.obs.provenance import DIVERGENCE_KINDS as JAX_DIVERGENCE_KINDS
from dpcorr_torch.obs.provenance import DIVERGENCE_KINDS
from dpcorr_torch.obs.sentinel import (
    VIOLATION_KINDS,
    Sentinel,
    Violation,
    arm_offender_hook,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wline(path, obj):
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(obj) + "\n")


def _mk_stream_workdir(root, windows=2):
    """Script the durable files of a healthy stream run: per window one
    (charge, WAL batch, journal entry) triple with the service's shapes
    and id discipline."""
    wd = os.path.join(str(root), "wd")
    os.makedirs(wd, exist_ok=True)
    audit = os.path.join(wd, "audit.jsonl")
    wal = os.path.join(wd, "wal.jsonl")
    journal = os.path.join(wd, "releases.jsonl")
    for w in range(windows):
        wid = f"{w * 2000}-{(w + 1) * 2000}"
        cid = f"stream:s:{wid}"
        _wline(audit, {"seq": w, "ts": float(w), "kind": "charge",
                       "charge_id": cid,
                       "charges": {"party/x": 0.4, "party/y": 0.4},
                       "trace_id": cid})
        _wline(wal, {"seq": w + 1, "batch_id": f"b{w}",
                     "ts": w * 2.0, "rows": [[0.1, 0.2]]})
        _wline(journal, {"start": w * 2.0, "end": (w + 1) * 2.0,
                         "rows": 1, "releases": {"ni_sign": {"r": w}},
                         "charge_id": cid, "eps_window": 0.8,
                         "window_id": wid, "release_seq": w + 1})
    return wd


class Twin:
    """A port sentinel and a JAX sentinel over the same sources, each with
    its own checkpoint; :meth:`poll` polls both at one instant and holds
    their new violations and their checkpoint documents equal."""

    def __init__(self, tmp_path, name="ck.json", **kw):
        self.port = Sentinel(str(tmp_path / name), **kw)
        self.jax = jsentinel.Sentinel(str(tmp_path / f"jax.{name}"), **kw)

    def add(self, method, *args, **kw):
        getattr(self.port, method)(*args, **kw)
        getattr(self.jax, method)(*args, **kw)

    def poll(self, at=None):
        t = time.time() if at is None else at
        got, want = self.port.poll(at=t), self.jax.poll(at=t)
        assert [v.to_dict() for v in got] == [v.to_dict() for v in want]
        with open(self.port.checkpoint_path) as a, \
                open(self.jax.checkpoint_path) as b:
            assert json.load(a) == json.load(b)
        return got

    @property
    def rc(self):
        assert self.port.rc == self.jax.rc
        return self.port.rc

    @property
    def violations(self):
        return self.port.violations


def _twin(tmp_path, wd=None, name="ck.json", **kw):
    s = Twin(tmp_path, name=name, **kw)
    if wd is not None:
        s.add("add_stream", "s1", wd)
    return s


class TestTaxonomy:
    def test_kinds_extend_divergence_kinds(self):
        assert VIOLATION_KINDS == jsentinel.VIOLATION_KINDS
        assert DIVERGENCE_KINDS == JAX_DIVERGENCE_KINDS
        for k in DIVERGENCE_KINDS:
            assert k in VIOLATION_KINDS
        for k in ("conservation-drift", "double-release",
                  "wal-regression", "checkpoint-gap"):
            assert k in VIOLATION_KINDS

    def test_violation_signature_is_stable_and_kind_checked(self):
        v = Violation(kind="wal-regression", source="s", artifact="a",
                      detail="d", at=1.0)
        w = Violation(kind="wal-regression", source="s", artifact="a",
                      detail="d", at=99.0)
        assert v.signature == w.signature
        assert v.signature == jsentinel.Violation(
            kind="wal-regression", source="s", artifact="a", detail="d",
            at=5.0).signature
        assert v.to_dict() == jsentinel.Violation(
            kind="wal-regression", source="s", artifact="a", detail="d",
            at=1.0).to_dict()
        with pytest.raises(AssertionError):
            Violation(kind="nope", source="s", artifact="a",
                      detail="d", at=0.0)


class TestChaosClean:
    def test_healthy_run_is_silent(self, tmp_path):
        wd = _mk_stream_workdir(tmp_path, windows=3)
        s = _twin(tmp_path, wd)
        assert s.poll() == [] and s.poll() == [] and s.rc == 0

    def test_torn_tail_is_not_a_violation(self, tmp_path):
        wd = _mk_stream_workdir(tmp_path)
        with open(os.path.join(wd, "wal.jsonl"), "a") as f:
            f.write('{"seq": 3, "batch_id": "torn')
        s = _twin(tmp_path, wd)
        assert s.poll() == []
        with open(os.path.join(wd, "wal.jsonl"), "a") as f:
            f.write('3", "ts": 4.0, "rows": []}\n')
        assert s.poll() == []

    def test_dedup_replay_charge_is_not_a_violation(self, tmp_path):
        wd = _mk_stream_workdir(tmp_path)
        _wline(os.path.join(wd, "audit.jsonl"),
               {"seq": 2, "ts": 9.0, "kind": "charge",
                "charge_id": "stream:s:0-2000",
                "charges": {"party/x": 0.4, "party/y": 0.4},
                "trace_id": "t", "dedup": True})
        assert _twin(tmp_path, wd).poll() == []

    def test_refusal_event_is_not_a_violation(self, tmp_path):
        wd = _mk_stream_workdir(tmp_path)
        _wline(os.path.join(wd, "audit.jsonl"),
               {"seq": 2, "ts": 9.0, "kind": "refusal",
                "charges": {"party/x": 0.4}, "trace_id": "t",
                "party": "party/x", "spent": 99.0, "budget": 100.0})
        assert _twin(tmp_path, wd).poll() == []


class TestTamperDetection:
    def _clean(self, tmp_path, wd):
        s = _twin(tmp_path, wd)
        assert s.poll() == []
        return s

    def test_wal_byte_flip(self, tmp_path):
        wd = _mk_stream_workdir(tmp_path)
        s = self._clean(tmp_path, wd)
        with open(os.path.join(wd, "wal.jsonl"), "r+b") as f:
            f.seek(3)
            f.write(b"X")
        kinds = {(v.kind, v.artifact) for v in s.poll()}
        assert ("wal-regression", os.path.join(wd, "wal.jsonl")) in kinds

    def test_duplicate_charge_line(self, tmp_path):
        wd = _mk_stream_workdir(tmp_path)
        s = self._clean(tmp_path, wd)
        audit = os.path.join(wd, "audit.jsonl")
        with open(audit) as f:
            first = f.readline()
        with open(audit, "a") as f:
            f.write(first)
        kinds = {v.kind for v in s.poll()}
        assert {"double-charged-artifact", "wal-regression"} <= kinds
        assert all(v.artifact == audit for v in s.violations)

    def test_renoised_release_substitution(self, tmp_path):
        wd = _mk_stream_workdir(tmp_path)
        s = self._clean(tmp_path, wd)
        _wline(os.path.join(wd, "releases.jsonl"),
               {"start": 0.0, "end": 2.0, "rows": 1,
                "releases": {"ni_sign": {"r": 777}},
                "charge_id": "stream:s:0-2000", "eps_window": 0.8,
                "window_id": "0-2000", "release_seq": 3})
        kinds = {(v.kind, v.artifact) for v in s.poll()}
        assert ("re-noised-artifact",
                os.path.join(wd, "releases.jsonl")) in kinds

    def test_identical_double_release(self, tmp_path):
        wd = _mk_stream_workdir(tmp_path)
        s = self._clean(tmp_path, wd)
        journal = os.path.join(wd, "releases.jsonl")
        with open(journal) as f:
            first = f.readline()
        with open(journal, "a") as f:
            f.write(first)
        assert "double-release" in {v.kind for v in s.poll()}

    def test_release_seq_rewind(self, tmp_path):
        wd = _mk_stream_workdir(tmp_path)
        s = self._clean(tmp_path, wd)
        _wline(os.path.join(wd, "releases.jsonl"),
               {"start": 4.0, "end": 6.0, "rows": 0, "releases": {},
                "charge_id": "stream:s:4000-6000", "eps_window": 0.8,
                "window_id": "4000-6000", "release_seq": 1})
        kinds = {(v.kind, v.artifact) for v in s.poll()}
        assert ("wal-regression",
                os.path.join(wd, "releases.jsonl")) in kinds

    def test_audit_seq_gap(self, tmp_path):
        wd = _mk_stream_workdir(tmp_path)
        s = self._clean(tmp_path, wd)
        _wline(os.path.join(wd, "audit.jsonl"),
               {"seq": 9, "ts": 9.0, "kind": "charge",
                "charge_id": "c9", "charges": {"party/x": 0.1},
                "trace_id": "t"})
        assert "checkpoint-gap" in {v.kind for v in s.poll()}

    def test_complete_garbage_line_mid_file(self, tmp_path):
        wd = _mk_stream_workdir(tmp_path)
        s = self._clean(tmp_path, wd)
        with open(os.path.join(wd, "wal.jsonl"), "a") as f:
            f.write("not json at all\n")
        assert "checkpoint-gap" in {v.kind for v in s.poll()}

    def test_journal_charge_never_audited(self, tmp_path):
        wd = _mk_stream_workdir(tmp_path)
        s = self._clean(tmp_path, wd)
        _wline(os.path.join(wd, "releases.jsonl"),
               {"start": 4.0, "end": 6.0, "rows": 0, "releases": {},
                "charge_id": "stream:s:4000-6000", "eps_window": 0.8,
                "window_id": "4000-6000", "release_seq": 3})
        assert s.poll() == []
        assert "tampered-charge" in {v.kind for v in s.poll()}

    def test_journal_eps_disagrees_with_trail(self, tmp_path):
        wd = _mk_stream_workdir(tmp_path)
        wid, cid = "4000-6000", "stream:s:4000-6000"
        _wline(os.path.join(wd, "audit.jsonl"),
               {"seq": 2, "ts": 9.0, "kind": "charge",
                "charge_id": cid, "charges": {"party/x": 0.1},
                "trace_id": cid})
        _wline(os.path.join(wd, "releases.jsonl"),
               {"start": 4.0, "end": 6.0, "rows": 0, "releases": {},
                "charge_id": cid, "eps_window": 0.8,
                "window_id": wid, "release_seq": 3})
        s = _twin(tmp_path, wd)
        assert "eps-total-mismatch" in {v.kind for v in s.poll()}


class TestCheckpointRestart:
    def test_restart_never_realerts(self, tmp_path):
        wd = _mk_stream_workdir(tmp_path)
        s = _twin(tmp_path, wd)
        s.poll()
        with open(os.path.join(wd, "wal.jsonl"), "r+b") as f:
            f.seek(3)
            f.write(b"X")
        assert {v.kind for v in s.poll()} == {"wal-regression"}
        s2 = _twin(tmp_path, wd)
        assert s2.poll() == [] and s2.rc == 0

    def test_restart_resumes_offsets_and_still_detects(self, tmp_path):
        wd = _mk_stream_workdir(tmp_path)
        _twin(tmp_path, wd).poll()
        s2 = _twin(tmp_path, wd)
        audit = os.path.join(wd, "audit.jsonl")
        with open(audit) as f:
            first = f.readline()
        with open(audit, "a") as f:
            f.write(first)
        assert "double-charged-artifact" in {v.kind for v in s2.poll()}
        assert s2.rc == 1

    def test_checkpoint_is_fsynced_json(self, tmp_path):
        wd = _mk_stream_workdir(tmp_path)
        s = _twin(tmp_path, wd)
        s.poll()
        with open(s.port.checkpoint_path) as f:
            doc = json.load(f)
        assert doc["version"] == Sentinel.CHECKPOINT_VERSION \
            == jsentinel.Sentinel.CHECKPOINT_VERSION
        assert "s1/stream" in doc["watchers"]

    @pytest.mark.parametrize("first", ["jax", "port"])
    def test_checkpoint_resumed_across_packages(self, tmp_path, first):
        """A sentinel of one package raises a violation and checkpoints;
        the other package's sentinel started on that checkpoint stays
        silent about it, resumes mid-file, and still catches a fresh
        tamper — with the signature the first would have given."""
        wd = _mk_stream_workdir(tmp_path)
        ck = str(tmp_path / "ck.json")
        mods = {"jax": jsentinel.Sentinel, "port": Sentinel}
        second = "port" if first == "jax" else "jax"
        a = mods[first](ck)
        a.add_stream("s1", wd)
        assert a.poll() == []
        with open(os.path.join(wd, "wal.jsonl"), "r+b") as f:
            f.seek(3)
            f.write(b"X")
        raised = a.poll()
        assert [v.kind for v in raised] == ["wal-regression"]
        b = mods[second](ck)
        b.add_stream("s1", wd)
        assert b.poll() == [] and b.rc == 0
        audit = os.path.join(wd, "audit.jsonl")
        with open(audit) as f:
            first_line = f.readline()
        with open(audit, "a") as f:
            f.write(first_line)
        fresh = b.poll(at=5.0)
        assert "double-charged-artifact" in {v.kind for v in fresh}
        c = mods[first](str(tmp_path / "ck2.json"))
        c.add_stream("s1", wd)
        redo = c.poll(at=5.0)
        assert {v.signature for v in fresh} <= {v.signature for v in redo}


class TestConservation:
    def test_budget_dir_drift_fires_after_debounce(self, tmp_path):
        from dpcorr_torch.serve.budget_dir import BudgetDirectory

        wd = _mk_stream_workdir(tmp_path)
        bd = BudgetDirectory(os.path.join(wd, "budget_dir"),
                             user_budget=50.0)
        bd.charge("alice", 0.8, charge_id="c1")
        bd.close()
        _wline(os.path.join(wd, "audit.jsonl"),
               {"seq": 2, "ts": 9.0, "kind": "charge",
                "charge_id": "c1", "charges": {"user/alice": 0.8},
                "trace_id": "c1"})
        s = _twin(tmp_path, wd)
        assert s.poll() == [] and s.poll() == []
        _wline(os.path.join(wd, "audit.jsonl"),
               {"seq": 3, "ts": 9.0, "kind": "charge",
                "charge_id": "forged", "charges": {"user/alice": 3.0},
                "trace_id": "z"})
        assert s.poll() == []
        assert {v.kind for v in s.poll()} == {"conservation-drift"}
        assert any("alice" in v.artifact for v in s.violations)

    def test_scrape_drift_against_canned_metrics(self, tmp_path):
        exposition = ('# TYPE dpcorr_ledger_spent_eps gauge\n'
                      'dpcorr_ledger_spent_eps{party="party/x"} 0.8\n'
                      'dpcorr_ledger_spent_eps{party="party/y"} 0.8\n')
        httpd = _canned_server(exposition, {})
        try:
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            wd = _mk_stream_workdir(tmp_path)
            s = _twin(tmp_path)
            s.add("add_stream", "s1", wd, url=url)
            assert s.poll() == [] and s.poll() == []
            _wline(os.path.join(wd, "audit.jsonl"),
                   {"seq": 2, "ts": 9.0, "kind": "charge",
                    "charge_id": "forged",
                    "charges": {"party/x": 3.0}, "trace_id": "z"})
            assert s.poll() == []
            assert {v.kind for v in s.poll()} == {"conservation-drift"}
            assert any(v.artifact == "party/x" for v in s.violations)
        finally:
            httpd.shutdown()

    def test_down_instance_is_not_drift(self, tmp_path):
        wd = _mk_stream_workdir(tmp_path)
        s = _twin(tmp_path, scrape_timeout_s=0.2)
        s.add("add_stream", "s1", wd, url="http://127.0.0.1:1")
        assert s.poll() == [] and s.poll() == []


class TestTranscriptsAndJournals:
    def _rel(self, sess, rnd, label, group, charged):
        return {"wire": {"session": sess, "msg_type": "release",
                         "payload": {"round": rnd,
                                     "artifacts": {label: group},
                                     "charged": charged}}}

    def test_renoised_artifact_across_sessions(self, tmp_path):
        d = tmp_path / "tx"
        d.mkdir()
        _wline(str(d / "a.jsonl"),
               self._rel("s1", 0, "col0", {"noise": 1}, ["col0"]))
        s = _twin(tmp_path)
        s.add("add_transcripts", "fed", str(d))
        assert s.poll() == []
        _wline(str(d / "b.jsonl"),
               self._rel("s2", 0, "col0", {"noise": 2}, []))
        v = s.poll()
        assert [x.kind for x in v] == ["re-noised-artifact"]
        assert v[0].artifact == "col0"

    def test_double_charged_artifact_across_venues(self, tmp_path):
        d = tmp_path / "tx"
        d.mkdir()
        _wline(str(d / "a.jsonl"),
               self._rel("s1", 0, "col0", {"noise": 1}, ["col0"]))
        s = _twin(tmp_path)
        s.add("add_transcripts", "fed", str(d))
        assert s.poll() == []
        _wline(str(d / "a.jsonl"),
               self._rel("s1", 1, "col1", {"noise": 1}, ["col0"]))
        assert [x.kind for x in s.poll()] == ["double-charged-artifact"]

    def test_corrupt_session_journal(self, tmp_path):
        d = tmp_path / "j"
        d.mkdir()
        (d / "journal.alice.json").write_text('{"version": 1}')
        s = _twin(tmp_path)
        s.add("add_journals", "fed", str(d))
        assert s.poll() == []
        (d / "journal.alice.json").write_text('{"torn')
        assert {v.kind for v in s.poll()} == {"checkpoint-gap"}


class TestPagingAndArming:
    def test_violation_pages_burn_rate_engine(self, tmp_path):
        wd = _mk_stream_workdir(tmp_path)
        pages, jpages = [], []
        clock = [1000.0]
        s = Sentinel(str(tmp_path / "ck.json"), clock=lambda: clock[0],
                     on_page=pages.append)
        js = jsentinel.Sentinel(str(tmp_path / "jck.json"),
                                clock=lambda: clock[0],
                                on_page=jpages.append)
        for sen in (s, js):
            sen.add_stream("s1", wd)

        def rounds():
            for _ in range(3):
                s.poll()
                js.poll()
                clock[0] += 1.0

        rounds()
        assert pages == jpages == []
        with open(os.path.join(wd, "wal.jsonl"), "r+b") as f:
            f.seek(3)
            f.write(b"X")
        rounds()
        assert [a.severity for a in pages] == ["page"]
        assert pages[0].objective == "sentinel-violations"
        assert [a.to_dict() for a in pages] == [a.to_dict() for a in jpages]
        assert s.registry.render() == js.registry.render()
        got, want = s.stats(), js.stats()
        for doc in (got, want):
            doc.pop("checkpoint")
        assert got == want

    def test_arm_offender_hook_posts_trigger(self, tmp_path):
        seen = []
        httpd = _canned_server("", {}, posts=seen)
        try:
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            v = Violation(kind="wal-regression", source="s1",
                          artifact="a", detail="d", at=0.0)
            for hook in (arm_offender_hook({"s1": url}),
                         jsentinel.arm_offender_hook({"s1": url})):
                hook(v)
                hook(Violation(kind="wal-regression", source="unknown",
                               artifact="a", detail="d", at=0.0))
            assert len(seen) == 2 and seen[0] == seen[1]
            body = json.loads(seen[0])
            assert body["reason"] == "sentinel_violation"
            assert body["detail"]["kind"] == "wal-regression"
        finally:
            httpd.shutdown()

    def test_sentinel_violation_is_a_trigger_reason(self):
        from dpcorr_torch.obs.recorder import TRIGGER_REASONS

        assert "sentinel_violation" in TRIGGER_REASONS


class TestStreamSLOFactories:
    def test_watermark_lag_objective_pages_on_sustained_lag(self):
        from dpcorr_torch.obs.fleet import parse_families
        from dpcorr_torch.obs.metrics import Registry
        from dpcorr_torch.obs.slo import (
            BurnRateEngine,
            stream_watermark_lag_objective,
        )

        eng = BurnRateEngine([stream_watermark_lag_objective(max_lag_s=1.0)],
                             clock=lambda: 0.0)

        def fams(lag):
            r = Registry()
            r.gauge("dpcorr_stream_watermark_lag_seconds", "l").set(lag)
            return parse_families(r.render())

        eng.observe({"s1": fams(0.5)}, at=0.0)
        eng.observe({"s1": fams(0.5)}, at=60.0)
        assert eng.evaluate(at=60.0) == []
        eng.observe({"s1": fams(30.0)}, at=120.0)
        assert [a.severity for a in eng.evaluate(at=120.0)] == ["page"]

    def test_release_latency_objective_uses_exact_bucket(self):
        from dpcorr_torch.obs.slo import stream_release_latency_objective

        obj = stream_release_latency_objective(threshold_s=1.0)
        assert obj.histogram == "dpcorr_stream_release_seconds"
        assert obj.kind == "latency"
        with pytest.raises(ValueError):
            stream_release_latency_objective(target=0.0)

    def test_gauge_kind_requires_threshold(self):
        from dpcorr_torch.obs.slo import Objective

        with pytest.raises(ValueError, match="gauge"):
            Objective(name="g", kind="gauge", target=1.0)


# ------------------------------------------- the port's own services ----

BATCHES = [
    ("b1", 1.0, [[0.5, 0.4], [-0.2, 0.3], [1.0, -1.0], [0.1, 0.2]]),
    ("b2", 4.0, [[0.3, 0.3], [-0.4, -0.5], [0.8, 0.9], [-1.0, 0.7]]),
    ("b3", 12.0, [[0.2, -0.2], [0.6, 0.5], [-0.7, -0.6], [0.9, 0.1]]),
    ("hb", 50.0, []),
]


@pytest.fixture(scope="module")
def service_files(tmp_path_factory):
    """The port's services on the CPU, each leaving its durable files: a
    stream workdir (two windows, a resent batch, a late one), a serve
    audit trail over four requests, and a 3-party federation's
    transcripts and journals."""
    from dpcorr_torch.obs.audit import AuditTrail
    from dpcorr_torch.protocol.federation import run_federation_inproc
    from dpcorr_torch.protocol.matrix import FederationPlan
    from dpcorr_torch.serve import DpcorrServer, EstimateRequest
    from dpcorr_torch.serve.ledger import PrivacyLedger
    from dpcorr_torch.stream.service import StreamService
    from dpcorr_torch.stream.windows import LateRecordError, WindowSpec

    root = tmp_path_factory.mktemp("services")
    wd = str(root / "stream")
    sv = StreamService(wd, WindowSpec(size_s=10.0), ("ni_sign",), 0.8, 0.8,
                       normalise=False, budget=10.0, seed=7, fsync=False,
                       device="cpu")
    try:
        for bid, ts, rows in BATCHES + [BATCHES[0]]:
            sv.ingest(bid, ts, rows)
        with pytest.raises(LateRecordError):
            sv.ingest("late", 1.0, [[1.0, 2.0]])
    finally:
        sv.close()
    audit = str(root / "serve_audit.jsonl")
    srv = DpcorrServer(budget=1e6, max_delay_s=0.001, shard="off",
                       audit=audit, device="cpu")
    try:
        rs = np.random.RandomState(5)
        for i, fam in enumerate(("ni_sign", "int_sign") * 2):
            srv.estimate(EstimateRequest(
                fam, rs.randn(96).astype(np.float32),
                rs.randn(96).astype(np.float32), 1.0, 0.5, seed=i),
                timeout=60)
    finally:
        srv.close()
    fed = str(root / "fed")
    plan = FederationPlan(family="ni_sign", n=256, eps=1.0,
                          parties=[("p0", ["a", "b"]), ("p1", ["c"]),
                                   ("p2", ["d"])])
    data = {lab: np.random.default_rng(i).standard_normal(
        256).astype(np.float32) for i, (_p, lab) in enumerate(plan.columns())}
    ledgers = {p: PrivacyLedger(100.0, audit=AuditTrail(
        os.path.join(fed, f"audit.{p}.jsonl"))) for p, _ in plan.parties}
    os.makedirs(fed, exist_ok=True)
    run_federation_inproc(plan, data, ledgers=ledgers, transcript_dir=fed,
                          journal_dir=fed, device="cpu")
    return {"stream": wd, "audit": audit, "fed": fed}


def _copy(files, tmp_path):
    dst = tmp_path / "copy"
    shutil.copytree(os.path.dirname(files["stream"]), dst)
    return {k: str(dst / os.path.relpath(v, os.path.dirname(files["stream"])))
            for k, v in files.items()}


def _watch_all(tmp_path, files, name="ck.json"):
    s = _twin(tmp_path, name=name)
    s.add("add_stream", "s1", files["stream"])
    s.add("add_audit", "r0", files["audit"])
    s.add("add_transcripts", "fed", files["fed"])
    s.add("add_journals", "fed", files["fed"])
    return s


def test_services_files_are_clean_in_both_packages(service_files, tmp_path):
    files = _copy(service_files, tmp_path)
    s = _watch_all(tmp_path, files)
    assert s.poll() == [] and s.poll() == [] and s.rc == 0
    assert sorted(s.port.stats()["watchers"]) == [
        "fed/journals", "fed/transcripts", "r0/audit", "s1/conservation",
        "s1/stream"]


def _flip_wal(files):
    with open(os.path.join(files["stream"], "wal.jsonl"), "r+b") as f:
        f.seek(3)
        f.write(b"X")


def _dup_charge(files):
    with open(files["audit"]) as f:
        first = next(ln for ln in f if '"kind": "charge"' in ln)
    with open(files["audit"], "a") as f:
        f.write(first)


def _rewind_release(files):
    path = os.path.join(files["stream"], "releases.jsonl")
    with open(path) as f:
        entry = json.loads(f.readline())
    entry.update(window_id="90000-100000", charge_id="stream:x",
                 release_seq=1)
    _wline(path, entry)


@pytest.mark.parametrize("fault,kind", [
    (_flip_wal, "wal-regression"),
    (_dup_charge, "double-charged-artifact"),
    (_rewind_release, "wal-regression"),
])
def test_services_faults_caught_alike(service_files, tmp_path, fault, kind):
    """One fault in a copy of the services' files: both packages raise the
    same violations, the expected kind among them, and a restart from the
    checkpoint raises nothing again."""
    files = _copy(service_files, tmp_path)
    s = _watch_all(tmp_path, files)
    assert s.poll() == []
    fault(files)
    assert kind in {v.kind for v in s.poll()} and s.rc == 1
    assert _watch_all(tmp_path, files).poll() == []


# -------------------------------------------------------------- CLI ----

#: a child that can import neither torch nor jax runs one package's CLI
NO_STACK = """
import sys
sys.modules["torch"] = None
sys.modules["jax"] = None
pkg = sys.argv[1]
sys.argv = [pkg] + sys.argv[2:]
if pkg == "dpcorr_torch":
    from dpcorr_torch.__main__ import main
else:
    from dpcorr.__main__ import main
main()
"""


def _cli(pkg, argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return subprocess.run([sys.executable, "-c", NO_STACK, pkg, *argv],
                          capture_output=True, text=True, timeout=120,
                          env=env)


def _violations(stdout):
    out = []
    for line in stdout.splitlines():
        if line.startswith('{"violation"'):
            v = json.loads(line)["violation"]
            v.pop("at")
            out.append(v)
    return out


def test_obs_watch_cli_sets_rc_as_jax_does(tmp_path):
    """``obs watch --once --json`` of both packages, each from its own
    checkpoint, in a child that cannot import torch or jax: rc 0 on a
    clean workdir, 1 with the same violation lines after a tamper, 0
    again on the next run from the same checkpoint."""
    wd = _mk_stream_workdir(tmp_path)
    runs = {"dpcorr_torch": [], "dpcorr": []}

    def once():
        for pkg, got in runs.items():
            proc = _cli(pkg, ["obs", "watch", "--checkpoint",
                              str(tmp_path / f"{pkg}.ck.json"), "--stream",
                              f"ize={wd}", "--once", "--json"])
            got.append((proc.returncode, _violations(proc.stdout)))
            assert proc.returncode in (0, 1), proc.stderr

    once()
    _flip_wal({"stream": wd})
    once()
    once()
    assert runs["dpcorr_torch"] == runs["dpcorr"]
    rcs = [rc for rc, _ in runs["dpcorr_torch"]]
    assert rcs == [0, 1, 0]
    first = runs["dpcorr_torch"][1][1][0]
    assert first["kind"] == "wal-regression"
    assert "wal.jsonl" in first["artifact"]


def test_obs_watch_refuses_empty_watchlist(tmp_path):
    proc = _cli("dpcorr_torch", ["obs", "watch", "--checkpoint",
                                 str(tmp_path / "ck.json"), "--once"])
    assert proc.returncode != 0
    assert "nothing to watch" in proc.stderr
    proc = _cli("dpcorr_torch", ["obs", "watch", "--checkpoint",
                                 str(tmp_path / "ck.json"), "--audit",
                                 "a=x", "--budget-dir", "b=y", "--once"])
    assert proc.returncode != 0 and "no matching" in proc.stderr


def _canned_server(exposition: str, stats: dict, posts=None):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            blob = (exposition.encode() if self.path == "/metrics"
                    else json.dumps(stats).encode())
            self.send_response(200)
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_POST(self):  # noqa: N802
            n = int(self.headers.get("Content-Length", 0))
            if posts is not None:
                posts.append(self.rfile.read(n).decode())
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"{}")

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
