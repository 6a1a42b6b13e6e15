"""The port's live ops console (``dpcorr_torch.obs.console``, behind
``python -m dpcorr_torch obs top``) against ``dpcorr.obs.console``.

Every frame — serve, fleet, federation (in ``test_torch_provenance.py``)
and stream — is string-equal to the JAX package's on the same stats and
exposition with ``now`` pinned: on the canned inputs of
``tests/test_obs.py``, ``tests/test_fleet.py`` and ``tests/test_stream.py``,
and on scrapes of the port's own serve replica and stream service running
on the CPU. The loops keep the JAX exit contract: 0 after a frame, 1 when
the first scrape reaches nobody.
"""

import http.server
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import dpcorr.obs.console as jconsole
from dpcorr.obs.fleet import FleetSnapshot as JaxFleetSnapshot
from dpcorr_torch.obs import console
from dpcorr_torch.obs.fleet import FleetCollector, FleetSnapshot
from dpcorr_torch.obs.metrics import Registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a pinned frame clock (the frames print local wall time)
NOW = 1_700_000_000.0


def _frames_equal(name, *args):
    got = getattr(console, name)(*args, now=NOW)
    assert got == getattr(jconsole, name)(*args, now=NOW)
    return got


# -------------------------------------------------------------- serve ----
CANNED_STATS = {
    "queue_depth": 3, "flush_ewma_s": 0.004,
    "breaker": {"open": 1, "half_open": 0,
                "tripped_buckets": {"ni_sign/n=128": "open"}},
    "brownout_active": True,
    "slo": {"burn_rate": 0.125, "window_requests": 64, "slo_s": 0.25,
            "window_s": 60.0},
    "kernel_compiles": 2, "kernel_hits": 30, "kernel_compile_dedup": 1,
    "kernel_cache_size": 2,
    "recompiles": {"new-signature": 1, "cache-evict": 0,
                   "jit-fallback": 0},
    "latency_s": {"p50": 0.003, "p99": 0.031},
    "exemplars": {"0.05": {"trace_id": "tdead", "value": 0.031}},
    "costs": {"records": 32, "kernel_s": 0.08, "queue_wait_s": 1.2,
              "compile_wait_s": 4.0},
    "requests_total": 40, "refused": {"budget": 2}, "shed": {},
    "requests_failed": 1,
    "ledger": {"parties": {"px": {"spent": 9.0, "budget": 100.0},
                           "py": 3.0}},
    "budget_dir": {"shards": 8, "resident_users": 5, "evicted_users": 1,
                   "counters": {"rehydrations": 2},
                   "refusals_by_level": {"user": 1, "party": 0,
                                         "global": 0}},
}


@pytest.mark.parametrize("stats", [CANNED_STATS, {}], ids=["full", "empty"])
def test_render_frame_shows_the_operator_story(stats):
    frame = _frames_equal("render_frame", stats, {})
    if stats:
        assert "queue depth" in frame and "     3" in frame
        assert "1 open" in frame and "ni_sign/n=128" in frame
        assert "brownout    : ACTIVE" in frame
        assert "12.50%" in frame and "trace=tdead" in frame
        assert "px=9" in frame and "2 refused" in frame
        assert "refusals  : user=1" in frame


class _CannedHandler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):  # noqa: N802
        if self.path == "/stats":
            body, ctype = json.dumps(CANNED_STATS).encode(), \
                "application/json"
        elif self.path == "/metrics":
            body, ctype = b"dpcorr_serve_queue_depth 3\n", "text/plain"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture
def canned_url():
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                            _CannedHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def test_run_top_once_against_canned_server(canned_url):
    assert console.scrape(canned_url) == jconsole.scrape(canned_url)
    lines = []
    assert console.run_top(canned_url, once=True, out=lines.append) == 0
    assert len(lines) == 1 and "brownout    : ACTIVE" in lines[0]


@pytest.mark.parametrize("loop", ["run_top", "run_stream_top"])
def test_run_top_once_unreachable_server_fails(loop):
    lines = []
    assert getattr(console, loop)("http://127.0.0.1:9", once=True,
                                  out=lines.append) == 1
    assert lines and lines[0].startswith("obs top: cannot scrape")


def test_run_top_redraws_until_max_frames(canned_url):
    lines = []
    assert console.run_top(canned_url, interval_s=0.0, out=lines.append,
                           max_frames=2) == 0
    assert len(lines) == 2 and all(s.startswith("\x1b[2J\x1b[H")
                                   for s in lines)


# -------------------------------------------------------------- fleet ----
def _instance_registry(completed, refused, spent):
    r = Registry()
    r.counter("dpcorr_serve_requests_total", "admitted").inc(
        completed + refused)
    ref = r.counter("dpcorr_serve_requests_refused_total", "refused",
                    labelnames=("reason",))
    if refused:
        ref.inc(refused, reason="budget")
    r.counter("dpcorr_serve_requests_completed_total", "completed",
              labelnames=("mode",)).inc(completed, mode="batched")
    r.gauge("dpcorr_ledger_spent_eps", "spend",
            labelnames=("party",)).set(spent, party="px")
    return r


@pytest.mark.parametrize("leases", [None, {"owned": [0, 3, 5],
                                           "n_shards": 8}])
def test_render_fleet_frame_rows_and_aggregate(leases):
    stats = {"batched_requests": 4, "unbatched_requests": 2,
             "queue_depth": 1, "refused": {"budget": 1},
             "latency_s": {"p50": 0.01, "p99": 0.02},
             "ledger": {"parties": {"px": {"spent": 0.5, "budget": 2.0}}}}
    if leases:
        stats["leases"] = leases
    instances = {
        "a": {"url": "http://h:1", "error": None, "stats": stats,
              "exposition": _instance_registry(6, 1, 0.5).render()},
        "dead": {"url": "http://h:2", "error": "URLError: refused",
                 "exposition": None, "stats": None}}
    frame = console.render_fleet_frame(FleetSnapshot(instances), now=NOW)
    assert frame == jconsole.render_fleet_frame(
        JaxFleetSnapshot(instances), now=NOW)
    assert "1/2 instances up" in frame
    assert "dead" in frame and "DOWN" in frame
    assert "px=0.5" in frame and "6 done" in frame
    assert ("3/8 shards held (5 orphaned)" in frame) == bool(leases)


def test_run_fleet_top_no_live_instance_fails():
    lines = []
    rc = console.run_fleet_top("x=http://127.0.0.1:1", once=True,
                               out=lines.append)
    assert rc == 1 and lines[0] == "obs top --fleet: no live instances:"
    rc = console.run_federation_top("x=http://127.0.0.1:1", once=True,
                                    out=lines.append)
    assert rc == 1 and "obs top --federation: no live parties:" in lines


# ------------------------------------------------- the port's serve ----
@pytest.fixture(scope="module")
def serve_url():
    """A port serve replica on the CPU behind its HTTP front end, after
    four answered requests."""
    from dpcorr_torch.obs.audit import AuditTrail
    from dpcorr_torch.serve import (
        DpcorrServer,
        EstimateRequest,
        make_http_server,
    )

    srv = DpcorrServer(budget=1e6, max_delay_s=0.001, shard="off",
                       audit=AuditTrail(), device="cpu")
    httpd = make_http_server(srv, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    rs = np.random.RandomState(3)
    for i, fam in enumerate(("ni_sign", "int_sign") * 2):
        srv.estimate(EstimateRequest(fam, rs.randn(96).astype(np.float32),
                                     rs.randn(96).astype(np.float32), 1.0,
                                     0.5, seed=i), timeout=60)
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    srv.close()


def test_serve_frame_over_a_live_port_replica(serve_url):
    polled = console.scrape(serve_url)
    stats = polled["stats"]
    frame = _frames_equal("render_frame", stats, polled["metrics"])
    assert f"traffic     : {stats['requests_total']} admitted" in frame
    assert stats["requests_total"] == 4
    spent = stats["ledger"]["parties"]["party-x"]["spent"]
    assert f"party-x={spent:.4g}/" in frame


def test_fleet_frame_over_a_live_replica_and_a_dead_one(serve_url):
    snap = FleetCollector(f"r0={serve_url},r1=http://127.0.0.1:1").scrape(
        timeout_s=2.0)
    frame = console.render_fleet_frame(snap, now=NOW)
    assert frame == jconsole.render_fleet_frame(
        JaxFleetSnapshot(snap.instances), now=NOW)
    assert "1/2 instances up" in frame
    assert any(ln.startswith("r1") and "DOWN" in ln
               for ln in frame.splitlines())
    assert "fleet       : 4 done" in frame


#: a child that can import neither torch nor jax runs the port's CLI
NO_STACK = """
import sys
sys.modules["torch"] = None
sys.modules["jax"] = None
from dpcorr_torch.__main__ import main
main(sys.argv[1:])
"""


def _cli(argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return subprocess.run([sys.executable, "-c", NO_STACK, *argv],
                          capture_output=True, text=True, timeout=120,
                          env=env)


def test_obs_top_cli_once(serve_url):
    """``obs top --once`` and ``--fleet`` in a child without torch: one
    frame, rc 0; nobody reachable: rc 1."""
    proc = _cli(["obs", "top", "--url", serve_url, "--once"])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("dpcorr obs top  ·  ")
    assert "traffic     : 4 admitted" in proc.stdout
    proc = _cli(["obs", "top", "--fleet",
                 f"r0={serve_url},r1=http://127.0.0.1:1", "--once"])
    assert proc.returncode == 0, proc.stderr
    assert "1/2 instances up" in proc.stdout and "DOWN" in proc.stdout
    proc = _cli(["obs", "top", "--url", "http://127.0.0.1:1", "--once"])
    assert proc.returncode == 1
    assert "cannot scrape" in proc.stdout


# ------------------------------------------------------------- stream ----
STREAM_STATS = {
    "stream_id": "s1", "families": ["ni_sign", "int_subg"],
    "window": {"size_s": 10.0, "slide_s": 5.0, "late_s": 2.0},
    "watermark": 48.0, "open_windows": 2, "pending_rows": 37,
    "eps_per_window": {"party/x": 1.2, "party/y": 1.2},
    "released": 4, "refused": ["w9"], "late_refused": 3,
    "seen_batches": 11,
    "ledger": {"budget_default": 10.0, "parties": {
        "party/x": {"spent": 4.8, "budget": 10.0, "remaining": 5.2}}},
    "budget_dir": {"shards": 4, "refusals_by_level": {"user": 2}},
}
STREAM_METRICS = {
    "dpcorr_stream_rows_total": 123.0,
    'dpcorr_stream_batches_total{kind="overload"}': 2.0,
    "dpcorr_stream_release_seconds_count": 4.0,
    "dpcorr_stream_release_seconds_sum": 0.8,
}


def test_render_stream_frame_canned():
    frame = _frames_equal("render_stream_frame", STREAM_STATS,
                          STREAM_METRICS)
    assert "s1" in frame and "ni_sign,int_subg" in frame
    assert "slide 5s" in frame and "late bound 2s" in frame
    assert "4 released" in frame and "1 refused" in frame
    assert "123 rows" in frame and "2 overload" in frame
    assert "3 late refused" in frame
    assert "200.00 ms mean over 4 windows" in frame
    assert "party/x" in frame and "refusals user=2" in frame


def test_render_stream_frame_shows_watermark_lag():
    stats = {"stream_id": "s1", "families": ["ni_sign"],
             "window": {"size_s": 10.0, "late_s": 0.0},
             "watermark": 48.0, "watermark_lag_s": 7.25,
             "open_windows": 0, "pending_rows": 0,
             "eps_per_window": {}, "released": 0, "refused": [],
             "late_refused": 0, "seen_batches": 0, "ledger": {}}
    assert "lag 7.2s" in _frames_equal("render_stream_frame", stats, {})
    del stats["watermark_lag_s"]
    frame = _frames_equal("render_stream_frame", stats,
                          {"dpcorr_stream_watermark_lag_seconds": 3.0})
    assert "lag 3.0s" in frame


def test_render_stream_frame_empty_window_table():
    stats = {"stream_id": "s1", "families": ["ni_sign"],
             "window": {"size_s": 10.0, "late_s": 0.0},
             "watermark": None, "open_windows": 0,
             "pending_rows": 0, "eps_per_window": {},
             "released": 0, "refused": [], "late_refused": 0,
             "seen_batches": 0, "ledger": {}}
    frame = _frames_equal("render_stream_frame", stats, {})
    assert "watermark   : —   lag —" in frame
    assert "0 released" in frame and "0 batches" in frame
    assert "release     :" not in frame


def test_stream_frame_over_the_port_service(tmp_path, capsys):
    """The port's stream service on the CPU behind its HTTP front end:
    the scraped frame equals JAX's, and ``run_stream_top --once`` exits 0
    with it."""
    from dpcorr_torch.stream.http import make_stream_http_server
    from dpcorr_torch.stream.service import StreamService
    from dpcorr_torch.stream.windows import WindowSpec

    sv = StreamService(str(tmp_path), WindowSpec(size_s=10.0),
                       ("ni_sign",), 0.8, 0.8, normalise=False,
                       budget=10.0, seed=7, fsync=False, device="cpu")
    httpd = make_stream_http_server(sv, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for bid, ts, rows in (("b1", 1.0, [[0.1, 0.2], [0.3, -0.4]]),
                              ("b2", 4.0, [[0.5, 0.6], [-0.1, 0.2]]),
                              ("hb", 25.0, [])):
            sv.ingest(bid, ts, rows)
        polled = console.scrape(base)
        frame = _frames_equal("render_stream_frame", polled["stats"],
                              polled["metrics"])
        assert "1 released" in frame and "4 rows" in frame
        assert console.run_stream_top(base, once=True) == 0
        assert "dpcorr obs top --stream" in capsys.readouterr().out
    finally:
        httpd.shutdown()
        httpd.server_close()
        sv.close()
