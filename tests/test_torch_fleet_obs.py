"""The port's fleet telemetry plane (``dpcorr_torch.obs.fleet`` and
``dpcorr_torch.obs.slo``) against ``dpcorr.obs.fleet`` and
``dpcorr.obs.slo``, on the CPU.

- the cases of the JAX package's ``tests/test_fleet.py`` on the port
  (all but the console's fleet frame, which waits for the console's
  port): kind-aware exposition parsing, the federated merge and its
  refusals, the exact aggregate, span and audit unions, the conservation
  gate, the burn-rate engine under a scripted clock, the collector and
  ``obs fleet snapshot | chrome | replay``;
- the two packages on the same inputs: merged expositions, aggregates,
  fleet replays and conservation verdicts byte-equal, and the same
  burn-rate transitions under one scripted clock.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from dpcorr_torch.obs.fleet import (
    FleetCollector,
    MetricFamily,
    aggregate_families,
    conservation,
    families_to_flat,
    fleet_chrome_trace,
    fleet_replay,
    ledger_parties,
    merge_expositions,
    merge_families,
    parse_families,
    parse_targets,
    render_families,
)
from dpcorr_torch.obs.metrics import Registry
from dpcorr_torch.obs.slo import (
    DEFAULT_WINDOWS,
    BurnRateEngine,
    Objective,
    http_trigger_hook,
    recorder_trigger_hook,
    stream_watermark_lag_objective,
)

BUCKETS = (0.1, 0.5, 1.0)


def _instance_registry(completed: int, slow: int, refused: int,
                       spent: float, registry_cls=Registry):
    """One synthetic serve-shaped instance: counters, a labelled counter,
    a latency histogram and a per-party spend gauge."""
    r = registry_cls()
    c = r.counter("dpcorr_serve_requests_total", "admitted")
    c.inc(completed + refused)
    ref = r.counter("dpcorr_serve_requests_refused_total", "refused",
                    labelnames=("reason",))
    if refused:
        ref.inc(refused, reason="budget")
    done = r.counter("dpcorr_serve_requests_completed_total",
                     "completed", labelnames=("mode",))
    if completed:
        done.inc(completed, mode="batched")
    h = r.histogram("dpcorr_serve_latency_seconds", "latency",
                    buckets=BUCKETS)
    for _ in range(completed - slow):
        h.observe(0.05)
    for _ in range(slow):
        h.observe(0.75)  # > 0.5: bad under the 0.5 s objective
    g = r.gauge("dpcorr_ledger_spent_eps", "spend",
                labelnames=("party",))
    g.set(spent, party="px")
    return r


# ------------------------------------------------- parse / round-trip ----
def test_parse_render_round_trip_is_exact():
    text = _instance_registry(10, 2, 1, 2.5).render()
    fams = parse_families(text)
    assert parse_families(render_families(fams)) == fams
    flat = families_to_flat(fams)
    assert flat["dpcorr_serve_requests_total"] == 11.0
    assert flat['dpcorr_serve_latency_seconds_bucket{le="0.5"}'] == 8.0


def test_parse_families_attaches_histogram_series():
    fams = parse_families(_instance_registry(4, 0, 0, 1.0).render())
    h = fams["dpcorr_serve_latency_seconds"]
    assert h.kind == "histogram"
    names = {s for s, _, _ in h.samples}
    assert names == {"dpcorr_serve_latency_seconds_bucket",
                     "dpcorr_serve_latency_seconds_sum",
                     "dpcorr_serve_latency_seconds_count"}


def test_parse_families_rejects_garbage():
    with pytest.raises(ValueError):
        parse_families("dpcorr_x{unclosed 1\n")
    with pytest.raises(ValueError, match="bad value"):
        parse_families("dpcorr_x 1.2.3\n")
    with pytest.raises(ValueError, match="unknown metric kind"):
        MetricFamily("x", "summary")


# --------------------------------------------------------------- merge ----
def _three_instances() -> dict[str, dict[str, MetricFamily]]:
    return {
        "a": parse_families(_instance_registry(10, 0, 1, 1.5).render()),
        "b": parse_families(_instance_registry(20, 0, 2, 2.5).render()),
        "c": parse_families(_instance_registry(5, 5, 0, 0.25).render()),
    }


def test_merge_labels_every_sample_and_aggregate_sums_exactly():
    merged = merge_families(_three_instances())
    flat = families_to_flat(merged)
    assert flat['dpcorr_serve_requests_total{instance="a"}'] == 11.0
    assert flat['dpcorr_serve_requests_total{instance="b"}'] == 22.0
    assert flat['dpcorr_serve_requests_total{instance="c"}'] == 5.0
    agg = families_to_flat(aggregate_families(merged))
    assert agg["dpcorr_serve_requests_total"] == 38.0
    assert agg['dpcorr_serve_requests_refused_total{reason="budget"}'] \
        == 3.0
    # cumulative histogram buckets add bucket-wise
    assert agg['dpcorr_serve_latency_seconds_bucket{le="0.5"}'] == 30.0
    assert agg['dpcorr_serve_latency_seconds_bucket{le="1"}'] == 35.0
    assert agg["dpcorr_serve_latency_seconds_count"] == 35.0
    assert parse_families(render_families(merged)) == merged


def test_merged_exposition_is_itself_scrapeable():
    merged = merge_families(_three_instances())
    again = parse_families(render_families(merged))
    assert families_to_flat(again) == families_to_flat(merged)


def test_matching_instance_self_report_passes():
    r = Registry()
    r.gauge("dpcorr_serve_instance_info", "id",
            labelnames=("instance",)).set(1, instance="a")
    merged = merge_families({"a": parse_families(r.render())})
    flat = families_to_flat(merged)
    assert flat['dpcorr_serve_instance_info{instance="a"}'] == 1.0


def test_colliding_instance_claim_refuses_loudly():
    r = Registry()
    r.gauge("dpcorr_serve_instance_info", "id",
            labelnames=("instance",)).set(1, instance="imposter")
    with pytest.raises(ValueError, match="imposter"):
        merge_families({"a": parse_families(r.render())})


def test_duplicate_instance_names_refuse():
    text = _instance_registry(1, 0, 0, 0.5).render()
    with pytest.raises(ValueError, match="duplicate"):
        merge_expositions([("a", text), ("a", text)])
    with pytest.raises(ValueError, match="duplicate"):
        parse_targets("a=http://h:1,a=http://h:2")


def test_kind_clash_across_instances_refuses():
    ra, rb = Registry(), Registry()
    ra.counter("dpcorr_thing", "as counter").inc()
    rb.gauge("dpcorr_thing", "as gauge").set(2)
    with pytest.raises(ValueError, match="already merged"):
        merge_families({"a": parse_families(ra.render()),
                        "b": parse_families(rb.render())})


def test_parse_targets_forms():
    assert parse_targets("a=http://h:1, b=http://h:2") == {
        "a": "http://h:1", "b": "http://h:2"}
    assert parse_targets(["http://h:1", ("z", "http://h:3")]) == {
        "instance-0": "http://h:1", "z": "http://h:3"}
    with pytest.raises(ValueError, match="no fleet targets"):
        parse_targets("")


# ------------------------------------------------------------ audit ε ----
def _events(n_charges: int, eps: float, refund_last: bool) -> list[dict]:
    evs = [{"kind": "charge", "charges": {"px": eps, "py": eps / 2},
            "charge_id": f"c{i}"} for i in range(n_charges)]
    if refund_last:
        evs.append({"kind": "refund",
                    "charges": {"px": eps, "py": eps / 2},
                    "charge_id": f"c{n_charges - 1}"})
    return evs


def test_fleet_replay_folds_in_sorted_instance_order():
    spools = {"b": _events(3, 0.25, False),
              "a": _events(2, 0.25, True)}
    doc = fleet_replay(spools)
    assert doc["per_instance"]["a"] == {"px": 0.25, "py": 0.125}
    assert doc["per_instance"]["b"] == {"px": 0.75, "py": 0.375}
    assert doc["fleet"] == {"px": 1.0, "py": 0.5}


def test_conservation_verdict_binary_exact():
    spools = {"a": _events(2, 0.25, False), "b": _events(4, 0.25, False)}
    ledgers = {"a": {"px": 0.5, "py": 0.25},
               "b": {"px": 1.0, "py": 0.5}}
    doc = conservation(spools, ledgers)
    assert doc["ok"] and doc["fleet_ok"]
    assert doc["fleet"] == doc["ledger_fleet"] == {"px": 1.5, "py": 0.75}
    # one instance off by an ulp-scale amount breaks the gate
    ledgers["b"] = {"px": 1.0 + 2**-40, "py": 0.5}
    bad = conservation(spools, ledgers)
    assert not bad["ok"] and bad["mismatches"][0]["instance"] == "b"


def test_ledger_parties_reads_a_stats_snapshot():
    assert ledger_parties({"ledger": {"parties": {
        "px": {"spent": 1.5, "budget": 4.0}, "py": 0.25}}}) == {
        "px": 1.5, "py": 0.25}
    assert ledger_parties({}) == {}


# ---------------------------------------------------------- span union ----
def _span(trace, name, ts, thread="main"):
    return {"trace_id": trace, "span_id": "s1", "parent_id": None,
            "name": name, "ts": ts, "dur_s": 0.01, "attrs": {},
            "thread": thread}


def test_fleet_chrome_trace_one_pid_per_instance():
    doc = fleet_chrome_trace({
        "b": [_span("t1", "serve.request", 2.0)],
        "a": [_span("t0", "serve.request", 1.0)],
    })
    evs = doc["traceEvents"]
    meta = {e["args"]["name"]: e["pid"] for e in evs
            if e.get("name") == "process_name"}
    assert meta == {"a": 1, "b": 2}  # sorted instances, stable pids
    spans = [e for e in evs if e.get("ph") == "X"]
    assert {e["pid"] for e in spans} == {1, 2}
    assert all(e["args"]["instance"] in ("a", "b") for e in spans)


# ------------------------------------------------------ both packages ----
def _expositions():
    """Three instances' exposition texts, two rendered by the port's
    registry and one by the JAX package's."""
    from dpcorr.obs import Registry as JaxRegistry

    return [("c", _instance_registry(5, 5, 0, 0.25).render()),
            ("a", _instance_registry(10, 0, 1, 1.5).render()),
            ("b", _instance_registry(20, 3, 2, 2.5,
                                     registry_cls=JaxRegistry).render())]


def test_merge_and_aggregate_byte_equal_to_jax():
    from dpcorr.obs import fleet as jfleet

    texts = _expositions()
    ours = merge_expositions(texts)
    theirs = jfleet.merge_expositions(texts)
    assert render_families(ours) == jfleet.render_families(theirs)
    assert render_families(aggregate_families(ours)) == \
        jfleet.render_families(jfleet.aggregate_families(theirs))
    assert json.dumps(families_to_flat(ours), sort_keys=True) == \
        json.dumps(jfleet.families_to_flat(theirs), sort_keys=True)
    assert [f.to_dict() for _, f in sorted(ours.items())] == \
        [f.to_dict() for _, f in sorted(theirs.items())]
    for bad in ([("a", texts[0][1]), ("a", texts[1][1])],):
        with pytest.raises(ValueError, match="duplicate"):
            merge_expositions(bad)
        with pytest.raises(ValueError, match="duplicate"):
            jfleet.merge_expositions(bad)


def test_replay_conservation_and_trace_byte_equal_to_jax():
    from dpcorr.obs import fleet as jfleet

    spools = {"r2": _events(3, 0.25, False), "r0": _events(5, 0.125, True),
              "r1": _events(1, 0.5, False)}
    ours, theirs = fleet_replay(spools), jfleet.fleet_replay(spools)
    assert json.dumps(ours) == json.dumps(theirs)
    ledgers = {n: dict(t) for n, t in ours["per_instance"].items()}
    ledgers["r1"]["py"] = 0.25 + 2**-30
    assert json.dumps(conservation(spools, ledgers)) == \
        json.dumps(jfleet.conservation(spools, ledgers))
    trace_in = {"b": [_span("t1", "x", 2.0, "w1"), _span("t2", "y", 3.0)],
                "a": [_span("t0", "x", 1.0)]}
    assert json.dumps(fleet_chrome_trace(trace_in)) == \
        json.dumps(jfleet.fleet_chrome_trace(trace_in))


def test_burn_rate_transitions_equal_jax():
    """One scripted clock, the same scrapes, both engines: the same
    transitions in the same order, and the same states."""
    from dpcorr.obs import fleet as jfleet
    from dpcorr.obs import slo as jslo

    def objectives(mod):
        return [mod.Objective(name="lat", kind="latency", target=0.05,
                              threshold_s=0.5),
                mod.Objective(name="err", kind="error", target=0.1),
                mod.Objective(name="eps", kind="eps_burn", target=1.0,
                              eps_per_s=0.01)]

    script = [(0.0, {"i": (10, 0, 0, 1.0), "j": (10, 0, 0, 1.0)}),
              (60.0, {"i": (20, 10, 0, 1.2), "j": (40, 0, 0, 1.1)}),
              (400.0, {"i": (520, 10, 5, 30.0), "j": (90, 0, 40, 1.2)}),
              (800.0, {"i": (1020, 10, 5, 30.5), "j": (500, 0, 40, 1.3)}),
              (5000.0, {"i": (1100, 10, 5, 31.0), "j": (600, 0, 41, 1.4)})]
    from dpcorr_torch.obs import slo

    engines = {"torch": (BurnRateEngine(objectives(slo)), parse_families),
               "jax": (jslo.BurnRateEngine(objectives(jslo)),
                       jfleet.parse_families)}
    fired = {k: [] for k in engines}
    for at, per in script:
        text = {inst: _instance_registry(*v).render()
                for inst, v in per.items()}
        for k, (eng, parse) in engines.items():
            eng.observe({inst: parse(t) for inst, t in text.items()}, at=at)
            fired[k].append([a.to_dict() for a in eng.evaluate(at=at)])
    assert json.dumps(fired["torch"]) == json.dumps(fired["jax"])
    assert any(step for step in fired["torch"])  # something did fire
    assert engines["torch"][0].states() == engines["jax"][0].states()


# --------------------------------------------------------- SLO engine ----
def _fams(completed: int, slow: int) -> dict[str, MetricFamily]:
    return parse_families(
        _instance_registry(completed, slow, 0, 1.0).render())


def test_latency_objective_requires_exact_bucket_bound():
    with pytest.raises(ValueError, match="bucket bound"):
        Objective(name="lat", kind="latency", target=0.05,
                  threshold_s=0.3).cumulative(_fams(4, 0))
    bad, total = Objective(
        name="lat", kind="latency", target=0.05,
        threshold_s=0.5).cumulative(_fams(10, 3))
    assert (bad, total) == (3.0, 10.0)


def test_objective_validation():
    with pytest.raises(ValueError, match="unknown kind"):
        Objective(name="x", kind="nope", target=1.0)
    with pytest.raises(ValueError, match="needs threshold_s"):
        Objective(name="x", kind="latency", target=1.0)
    with pytest.raises(ValueError, match="eps_per_s"):
        Objective(name="x", kind="eps_burn", target=1.0)
    with pytest.raises(ValueError, match="duplicate objective"):
        BurnRateEngine([Objective(name="e", kind="error", target=0.1)] * 2)


def test_burn_rate_engine_pages_offender_exactly_once():
    obj = Objective(name="lat", kind="latency", target=0.05,
                    threshold_s=0.5)
    paged = []
    eng = BurnRateEngine([obj], on_page=paged.append)
    eng.observe({"good": _fams(10, 0), "bad": _fams(10, 0)}, at=0.0)
    eng.observe({"good": _fams(40, 0), "bad": _fams(20, 10)}, at=60.0)
    fired = eng.evaluate(at=60.0)
    assert [a.instance for a in fired] == ["bad"]
    assert fired[0].severity == "page" and fired[0].previous == "ok"
    assert fired[0].burn_short == 20.0
    assert eng.state("lat", "good") == "ok"
    assert [a.instance for a in paged] == ["bad"]
    # exactly-once: re-evaluating the unchanged world fires nothing
    assert eng.evaluate(at=61.0) == []
    assert [a.instance for a in paged] == ["bad"]


def test_burn_rate_engine_recovers_to_ok():
    obj = Objective(name="lat", kind="latency", target=0.05,
                    threshold_s=0.5)
    eng = BurnRateEngine([obj])
    eng.observe({"i": _fams(10, 0)}, at=0.0)
    eng.observe({"i": _fams(20, 10)}, at=60.0)
    assert [a.severity for a in eng.evaluate(at=60.0)] == ["page"]
    eng.observe({"i": _fams(520, 10)}, at=400.0)
    eng.observe({"i": _fams(1020, 10)}, at=800.0)
    fired = eng.evaluate(at=800.0)
    assert [a.severity for a in fired] == ["ok"]
    assert eng.state("lat", "i") == "ok"
    assert [a.severity for a in eng.alerts] == ["page", "ok"]


def test_error_objective_and_scripted_windows():
    obj = Objective(name="err", kind="error", target=0.1)
    eng = BurnRateEngine([obj], windows=(("page", 60.0, 120.0, 2.0),))
    r0 = parse_families(_instance_registry(10, 0, 0, 1.0).render())
    r1 = parse_families(_instance_registry(10, 0, 5, 1.0).render())
    eng.observe({"i": r0}, at=0.0)
    eng.observe({"i": r1}, at=30.0)
    fired = eng.evaluate(at=30.0)
    assert [a.severity for a in fired] == ["page"]


def test_eps_burn_objective():
    obj = Objective(name="eps", kind="eps_burn", target=1.0,
                    eps_per_s=0.01)
    eng = BurnRateEngine([obj], windows=DEFAULT_WINDOWS)
    r0 = parse_families(_instance_registry(10, 0, 0, 1.0).render())
    r1 = parse_families(_instance_registry(10, 0, 0, 100.0).render())
    eng.observe({"i": r0}, at=0.0)
    eng.observe({"i": r1}, at=60.0)
    fired = eng.evaluate(at=60.0)
    # 99 ε in 60 s against a 0.01 ε/s schedule → burn 165 ≫ 14.4
    assert [a.severity for a in fired] == ["page"]
    assert fired[0].burn_short == 99.0 / (0.01 * 60.0)


def test_gauge_objective_pages_on_sustained_lag():
    obj = stream_watermark_lag_objective(max_lag_s=2.0)
    r = Registry()
    g = r.gauge("dpcorr_stream_watermark_lag_seconds", "lag")
    eng = BurnRateEngine([obj])
    for at, lag in ((0.0, 1.0), (60.0, 40.0)):
        g.set(lag)
        eng.observe({"s": parse_families(r.render())}, at=at)
    fired = eng.evaluate(at=60.0)
    assert [a.severity for a in fired] == ["page"]
    assert fired[0].burn_short == 40.0 / 2.0


def test_http_trigger_hook_never_raises_on_dead_instance():
    hook = http_trigger_hook({"i": "http://127.0.0.1:1"}, timeout_s=0.2)
    obj = Objective(name="lat", kind="latency", target=0.05,
                    threshold_s=0.5)
    eng = BurnRateEngine([obj], on_page=hook)
    eng.observe({"i": _fams(10, 0)}, at=0.0)
    eng.observe({"i": _fams(20, 10)}, at=60.0)
    assert [a.severity for a in eng.evaluate(at=60.0)] == ["page"]


def test_recorder_trigger_hook_dumps_the_installed_recorder(tmp_path):
    from dpcorr_torch.obs import recorder as obs_recorder
    from dpcorr_torch.obs.recorder import FlightRecorder, read_dump

    rec = FlightRecorder(str(tmp_path / "rec.json"))
    obs_recorder.install(rec)
    try:
        obj = Objective(name="lat", kind="latency", target=0.05,
                        threshold_s=0.5)
        eng = BurnRateEngine([obj], on_page=recorder_trigger_hook())
        eng.observe({"i": _fams(10, 0)}, at=0.0)
        eng.observe({"i": _fams(20, 10)}, at=60.0)
        assert [a.severity for a in eng.evaluate(at=60.0)] == ["page"]
    finally:
        obs_recorder.install(None)
    dump = read_dump(str(tmp_path / "rec.json"))
    assert dump["reason"] == "slo_page"
    assert dump["detail"]["instance"] == "i"


# ------------------------------------------------ collector + CLI ----
def _canned_fleet_server(exposition: str, stats: dict):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            if self.path == "/metrics":
                blob, ctype = exposition.encode(), "text/plain"
            elif self.path == "/stats":
                blob, ctype = json.dumps(stats).encode(), "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def test_collector_scrapes_and_survives_dead_instances():
    httpd = _canned_fleet_server(
        _instance_registry(7, 0, 0, 0.5).render(),
        {"requests_total": 7, "ledger": {"parties": {}}})
    try:
        port = httpd.server_address[1]
        snap = FleetCollector(
            {"up": f"http://127.0.0.1:{port}",
             "down": "http://127.0.0.1:1"}).scrape(timeout_s=5)
        assert set(snap.live()) == {"up"}
        assert "down" in snap.errors()
        flat = families_to_flat(snap.aggregate())
        assert flat["dpcorr_serve_requests_total"] == 7.0
        doc = snap.to_doc()
        assert doc["instances"]["up"]["stats"]["requests_total"] == 7
        assert doc["instances"]["down"]["error"]
        assert snap.stats() == {"up": {"requests_total": 7,
                                       "ledger": {"parties": {}}}}
    finally:
        httpd.shutdown()
        httpd.server_close()


def _cli(*argv, timeout=120):
    """``python -m dpcorr_torch ...`` with ``jax`` and ``dpcorr`` made
    unimportable: the obs commands need neither."""
    from test_torch_cli import _child_env

    script = ("import sys\n"
              "sys.modules['jax'] = None\n"
              "sys.modules['dpcorr'] = None\n"
              f"sys.argv = ['dpcorr_torch', *{list(argv)!r}]\n"
              "from dpcorr_torch.__main__ import main\n"
              "main()\n")
    return subprocess.run([sys.executable, "-c", script],
                          capture_output=True, text=True, timeout=timeout,
                          env=_child_env())


def test_obs_fleet_snapshot_cli(tmp_path):
    httpd = _canned_fleet_server(
        _instance_registry(3, 1, 0, 0.25).render(),
        {"requests_total": 3, "ledger": {"parties": {}}})
    out_path = str(tmp_path / "snap.json")
    try:
        port = httpd.server_address[1]
        run = _cli("obs", "fleet", "snapshot", "--targets",
                   f"solo=http://127.0.0.1:{port}", "--out", out_path,
                   "--json")
        assert run.returncode == 0, run.stderr
        doc = json.loads(run.stdout)
        assert doc["version"] == 1
        assert doc["instances"]["solo"]["error"] is None
        assert doc["aggregate"]["dpcorr_serve_requests_total"] == 3.0
        assert json.load(open(out_path)) == doc
    finally:
        httpd.shutdown()
        httpd.server_close()
    dead = _cli("obs", "fleet", "snapshot", "--targets",
                "x=http://127.0.0.1:1", "--timeout", "0.2")
    assert dead.returncode == 1


def test_obs_fleet_replay_and_chrome_cli_equal_jax(tmp_path):
    """``obs fleet replay --json`` prints the JAX command's document for
    the same trails, and ``obs fleet chrome`` writes its trace."""
    from dpcorr.obs import fleet as jfleet

    audits, spools = [], {}
    for name, evs in (("r0", _events(2, 0.25, True)),
                      ("r1", _events(3, 0.5, False))):
        path = tmp_path / f"{name}.jsonl"
        path.write_text("".join(json.dumps(e) + "\n" for e in evs))
        audits += ["--audit", f"{name}={path}"]
        spools[name] = str(path)
    run = _cli("obs", "fleet", "replay", *audits, "--json")
    assert run.returncode == 0, run.stderr
    assert json.loads(run.stdout) == jfleet.fleet_replay(spools)
    text = _cli("obs", "fleet", "replay", *audits)
    assert text.stdout.splitlines()[-1] == "fleet: px=1.75, py=0.875"
    spans = tmp_path / "a.spans.jsonl"
    spans.write_text(json.dumps(_span("t0", "serve.request", 1.0)) + "\n")
    out = str(tmp_path / "trace.json")
    run = _cli("obs", "fleet", "chrome", "--spool", f"a={spans}",
               "--out", out)
    assert run.returncode == 0, run.stderr
    assert json.load(open(out)) == jfleet.fleet_chrome_trace(
        {"a": str(spans)})
