"""``python -m dpcorr_torch``: the same configurations, defaults and JSON
echo as ``python -m dpcorr``, on the card unless ``--device cpu``."""

import json

import numpy as np
import pytest
import torch

from dpcorr.__main__ import main as jax_main
from dpcorr_torch.__main__ import main
from dpcorr_torch.io.rds import read_rds_table

#: the reference's demo design point (vert-cor.R:449-458), as
#: tests/test_golden_demo.py pins it for the JAX package
DEMO = {"n": 2000, "rho": -0.95, "eps": [0.5, 1.0], "B": 8,
        "dgp": "gaussian", "dgp_args": {"mu": [2.0, 2.0],
                                        "sigma": [2.0, 0.1]},
        "normalise": True, "seed": 2025}


def test_demo_echoes_the_reference_config(capsys):
    main(["demo", "--device", "cpu", "--b", "8"])
    out = json.loads(capsys.readouterr().out)
    assert out["config"] == DEMO
    jax_main(["demo", "--b", "8"])
    want = json.loads(capsys.readouterr().out)
    assert out["config"] == want["config"]
    assert set(out["summary"]) == set(want["summary"]) == {"NI", "INT"}
    for meth in ("NI", "INT"):
        assert set(out["summary"][meth]) == set(want["summary"][meth])
        assert 0.0 <= out["summary"][meth]["coverage"] <= 1.0


@pytest.mark.parametrize("argv", [
    ["demo", "--b", "8"],
    ["demo", "--device", "cuda", "--b", "8"],
    ["grid", "--b", "2", "--backend", "bucketed"],
    ["acceptance", "--b", "8"],
    ["stress", "--b", "2"],
    ["hrs"],
    ["hrs-sweep", "--b", "2"],
    ["grid", "--b", "2", "--backend", "sharded"],
    ["grid-subg", "--b", "2", "--backend", "bucketed-sharded",
     "--local-devices", "2"],
    ["grid", "--b", "2", "--backend", "bucketed", "--n-hosts", "2",
     "--out", "unused"],
    ["grid", "--b", "2", "--n-hosts", "2", "--distributed", "--out",
     "unused"],
    ["stress", "--b", "2", "--backend", "sharded"],
])
def test_commands_raise_without_a_card(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_grid_subg_writes_tables_and_no_figures(tmp_path, capsys):
    main(["grid-subg", "--device", "cpu", "--b", "2", "--backend",
          "bucketed", "--bucket-merge", "eps", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "240 replicate rows" in out        # 120 points × 2
    assert "INT" in out and "no figures" in out
    table = read_rds_table(str(tmp_path / "detail_all.rds"))
    assert sorted(set(table["n"].values)) == [2500, 4000, 6000, 9000, 12000]
    with np.load(tmp_path / "summ_all.npz") as s:
        assert len(s["method"]) == 240
    assert not list(tmp_path.glob("*.png"))


def test_stress_and_demo_subg_run_on_the_cpu(capsys):
    main(["stress", "--device", "cpu", "--n", "4096", "--n-chunk", "1024",
          "--b", "2", "--family", "sign"])
    out = json.loads(capsys.readouterr().out)
    assert out["n"] == 4096 and out["stream_n_chunk"] == 1024
    assert 0.0 <= out["summary"]["NI"]["coverage"] <= 1.0
    # one replication a chunk on the CPU: three passes (the moments, NI,
    # INT) of 4 n-chunks over the 4,096 rows, for each of the 2
    assert out["counters"] == {"stream_chunks": 2 * 3 * 4,
                               "stream_rows": 2 * 3 * 4096}
    main(["demo-subg", "--device", "cpu", "--b", "2"])
    out = json.loads(capsys.readouterr().out)
    assert out["config"] == {"n": 5500, "rho": 0.6, "eps": [5.0, 1.0],
                             "B": 2}


def test_grid_flags_are_validated(tmp_path):
    with pytest.raises(SystemExit):
        main(["grid", "--device", "cpu", "--backend", "bogus"])
    with pytest.raises(SystemExit):
        main(["stress", "--device", "cpu", "--backend", "bucketed"])
    with pytest.raises(SystemExit):
        main(["grid", "--device", "tpu"])
    with pytest.raises(ValueError, match="needs --out"):
        main(["grid", "--device", "cpu", "--n-hosts", "2"])
    with pytest.raises(ValueError, match="needs --n-hosts"):
        main(["grid", "--device", "cpu", "--b", "2", "--distributed",
              "--out", str(tmp_path)])


#: the fields ``python -m dpcorr hrs`` prints (dpcorr/__main__.py:162-173)
HRS_FIELDS = {"n", "private_moments", "lambda", "rho_non_private", "NI",
              "INT_age_to_bmi"}


@pytest.fixture
def panel(tmp_path, monkeypatch):
    """A synthetic HRS panel at the default path's place."""
    from dpcorr_torch import hrs, perf_hrs

    path = tmp_path / "hrs_long_panel.rds"
    cols = perf_hrs.synthetic_panel(3, 16 * 400)
    perf_hrs.write_panel(str(path), cols)
    monkeypatch.setattr(hrs, "DEFAULT_PANEL", str(path))
    return cols


def test_hrs_prints_the_jax_commands_fields(panel, capsys):
    from dpcorr_torch import hrs

    main(["hrs", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == HRS_FIELDS
    want = hrs.point_estimates(cols=panel, device="cpu")
    assert out["n"] == want.n == 172
    assert out["NI"] == want.ni and out["INT_age_to_bmi"] == want.int_
    assert out["rho_non_private"] == want.std.rho_np
    assert out["lambda"] == {"age_z": want.std.lam_age,
                             "bmi_z": want.std.lam_bmi}


def test_hrs_sweep_writes_tables_and_no_figures(panel, tmp_path, capsys):
    from dpcorr_torch import hrs

    out_dir = tmp_path / "out"
    main(["hrs-sweep", "--device", "cpu", "--b", "3", "--out",
          str(out_dir)])
    printed = capsys.readouterr().out
    assert "eps=2.45: dispatched (23/23)" in printed
    assert "no figures" in printed
    assert not list(out_dir.glob("*.png"))
    with np.load(out_dir / "hrs_sweep_runs.npz") as runs:
        assert len(runs["rho_hat"]) == 23 * 2 * 3
        assert runs["method"].dtype.kind == "U"
    want = hrs.eps_sweep(cols=panel, reps=3, device="cpu")
    with np.load(out_dir / "hrs_sweep_summary.npz") as summ:
        assert list(summ.files) == list(want.summary)
        for c in summ.files:
            np.testing.assert_array_equal(summ[c], want.summary[c].astype(
                summ[c].dtype))


@pytest.mark.parametrize("cmd", ["hrs", "hrs-sweep"])
def test_hrs_commands_raise_without_the_panel(cmd, tmp_path, monkeypatch):
    from dpcorr_torch import hrs

    monkeypatch.setattr(hrs, "DEFAULT_PANEL", str(tmp_path / "none.rds"))
    with pytest.raises(FileNotFoundError, match="HRS panel not found"):
        main([cmd, "--device", "cpu"])


def test_local_devices_must_match_the_cards(monkeypatch):
    """On the card ``--local-devices`` must name the visible card count;
    it raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="differs from the 1 visible"):
        main(["grid", "--b", "2", "--backend", "sharded",
              "--local-devices", "2"])


def _detail(out_dir):
    with np.load(out_dir / "detail_all.npz") as z:
        return {k: z[k] for k in z.files}


def test_grid_backends_and_fan_out_agree(tmp_path, capsys):
    """``--backend bucketed-sharded --local-devices 3`` and ``--n-hosts 2
    --distributed`` reach the same grid as ``--backend bucketed``, bit for
    bit, with the per-host lines printed."""
    runs = {"bucketed": ["--backend", "bucketed"],
            "sharded": ["--backend", "bucketed-sharded", "--local-devices",
                        "3"],
            "fan-out": ["--backend", "bucketed", "--n-hosts", "2",
                        "--distributed"]}
    out = {}
    for name, flags in runs.items():
        main(["grid", "--device", "cpu", "--b", "2", *flags, "--out",
              str(tmp_path / name)])
        out[name] = capsys.readouterr().out
    assert "backend bucketed-sharded" in out["sharded"]
    assert "host 0/2: 72 points, K1 launches 0, merged True" in out["fan-out"]
    assert "host 1/2: 72 points, K1 launches 0, merged False" \
        in out["fan-out"]
    want = _detail(tmp_path / "bucketed")
    for name in ("sharded", "fan-out"):
        got = _detail(tmp_path / name)
        for col, v in want.items():
            np.testing.assert_array_equal(got[col], v, err_msg=(name, col))


def test_report_from_a_finished_out_directory(panel, tmp_path, capsys):
    """``report --from`` draws what ``grid --out`` and ``hrs-sweep --out``
    wrote, under the JAX command's file names (``python -m dpcorr grid
    --out`` and ``render_all``)."""
    import pandas as pd

    from dpcorr import report as jreport
    from dpcorr_torch import report

    out_dir = tmp_path / "v1"
    main(["grid", "--device", "cpu", "--b", "2", "--backend", "bucketed",
          "--out", str(out_dir)])
    main(["hrs-sweep", "--device", "cpu", "--b", "2", "--out",
          str(out_dir)])
    assert not list(out_dir.glob("*.pdf"))
    capsys.readouterr()
    main(["report", "--from", str(out_dir)])
    printed = capsys.readouterr().out
    frames = {k: pd.DataFrame(v) for k, v in
              report.read_tables(out_dir).items() if isinstance(v, dict)}
    want = [p.name for p in jreport.render_all(
        frames["detail"], frames["summ"], frames["hrs_summ"],
        out_dir=tmp_path / "jax")]
    assert want == ["fig1_mean_band_vs_rho.pdf",
                    "fig2_width_coverage_vs_n.pdf", "fig3_mse_vs_n.pdf",
                    "hrs_eps_sweep.pdf"]
    assert printed.split()[1:] == [str(out_dir / n) for n in want]
    assert all((out_dir / n).stat().st_size > 0 for n in want)
    main(["report", "--from", str(out_dir), "--family", "subg"])
    assert (out_dir / "subG_fig3_mse.pdf").exists()


def test_stress_sharded_matches_local(capsys):
    """``stress --backend sharded`` is the f32 partial sums of the same
    replications: the summary within 1e-6 of the local run's."""
    argv = ["stress", "--device", "cpu", "--n", "4096", "--n-chunk", "1024",
            "--b", "4", "--family", "sign"]
    out = {}
    for backend in ("local", "sharded"):
        main([*argv, "--backend", backend])
        out[backend] = json.loads(capsys.readouterr().out)["summary"]
    for meth in ("NI", "INT"):
        for k in ("mse", "coverage", "ci_length"):
            np.testing.assert_allclose(out["sharded"][meth][k],
                                       out["local"][meth][k], rtol=1e-6)


# ------------------------------------------------ protocol and federation
#: a child that refuses to import torch, then runs the port's CLI
NO_TORCH = """
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "torch" or name.startswith("torch."):
            raise ImportError("torch is blocked in this process")

sys.meta_path.insert(0, _Block())
from dpcorr_torch.__main__ import main
main(sys.argv[1:])
assert "torch" not in sys.modules
"""

FED_PARTIES = ["--party", "p0=a,b", "--party", "p1=c", "--party", "p2=d"]


def _no_torch(argv, cwd):
    import subprocess
    import sys

    return subprocess.run([sys.executable, "-c", NO_TORCH, *argv],
                          capture_output=True, text=True, timeout=120,
                          cwd=str(cwd), env=_child_env())


def _child_env():
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def test_grid_backends_named_in_the_cli_equal_the_grids():
    from dpcorr_torch.__main__ import GRID_BACKENDS
    from dpcorr_torch.grid import BACKENDS

    assert GRID_BACKENDS == BACKENDS


@pytest.mark.parametrize("argv", [
    ["protocol", "run", "--n", "64"],
    ["protocol", "run", "--transport", "tcp", "--n", "64"],
    ["party", "--role", "y", "--port", "0", "--n", "64"],
    ["federation", "run", *FED_PARTIES, "--n", "64"],
    ["federation", "party", *FED_PARTIES, "--name", "p2", "--n", "64"],
])
def test_protocol_commands_raise_without_a_card(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_protocol_run_echoes_the_jax_config(tmp_path, capsys):
    argv = ["protocol", "run", "--n", "600", "--family", "int_sign",
            "--eps1", "0.5", "--eps2", "2.0", "--transport", "tcp"]
    main(argv + ["--device", "cpu", "--transcript-dir",
                 str(tmp_path / "port")])
    out = json.loads(capsys.readouterr().out)
    jax_main(argv + ["--transcript-dir", str(tmp_path / "jax")])
    want = json.loads(capsys.readouterr().out)
    assert out.pop("device") == "cpu"
    assert set(out) == set(want)
    for key in ("spec", "session", "roles_agree"):
        assert out[key] == want[key]
    assert out["roles_agree"] is True
    for role in ("x", "y"):
        got, ref = out["results"][role], want["results"][role]
        assert set(got) == set(ref)
        assert got["role"] == ref["role"] and got["session"] == ref["session"]
        assert np.allclose([got[k] for k in ("rho_hat", "ci_low", "ci_high")],
                           [ref[k] for k in ("rho_hat", "ci_low", "ci_high")],
                           atol=1e-5, rtol=0)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) \
        == sorted(p.name for p in (tmp_path / "jax").iterdir())


def test_scan_and_plan_commands_run_without_torch(tmp_path, capsys):
    """``protocol scan``, ``federation plan`` and ``federation scan`` in a
    child process that cannot import torch: each prints what ``python -m
    dpcorr`` prints and exits 0 on the port's own transcripts."""
    main(["protocol", "run", "--device", "cpu", "--n", "600",
          "--transcript-dir", str(tmp_path / "two")])
    session = json.loads(capsys.readouterr().out)["session"]
    path = str(tmp_path / "two" / f"{session}.x.jsonl")
    proc = _no_torch(["protocol", "scan", "--transcript", path], tmp_path)
    assert proc.returncode == 0, proc.stderr
    rep = json.loads(proc.stdout)["scan"]
    assert rep["ok"] and rep["releases"] == 1
    jax_main(["protocol", "scan", "--transcript", path])
    assert json.loads(capsys.readouterr().out)["scan"] == rep

    plan_argv = ["federation", "plan", *FED_PARTIES, "--n", "400"]
    proc = _no_torch(plan_argv, tmp_path)
    assert proc.returncode == 0, proc.stderr
    jax_main(plan_argv)
    assert json.loads(proc.stdout) == json.loads(capsys.readouterr().out)

    main(["federation", "run", "--device", "cpu", *FED_PARTIES, "--n", "400",
          "--transcript-dir", str(tmp_path / "fed")])
    capsys.readouterr()
    proc = _no_torch(["federation", "scan", "--transcript-dir",
                      str(tmp_path / "fed")], tmp_path)
    assert proc.returncode == 0, proc.stderr
    cross = json.loads(proc.stdout)["cross_pair"]
    assert cross["ok"] and cross["labels"] == ["a", "b", "c"]


def test_federation_run_echoes_the_jax_config(capsys):
    argv = ["federation", "run", *FED_PARTIES, "--n", "400",
            "--family", "ni_subg", "--transport", "tcp"]
    main(argv + ["--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    jax_main(argv)
    want = json.loads(capsys.readouterr().out)
    assert out.pop("device") == "cpu"
    assert set(out) == set(want)
    for key in ("fed", "fed_hash", "plan", "eps", "parties_agree"):
        assert out[key] == want[key], key
    assert sorted(out["cells"]) == sorted(want["cells"])
    for key, val in out["cells"].items():
        assert np.allclose(list(val.values()),
                           list(want["cells"][key].values()),
                           atol=1e-5, rtol=2.5e-7)


def test_party_processes_hold_a_session_with_jax_banners(tmp_path, capsys):
    """``party --role y`` and ``--role x`` as two processes on the CPU,
    each with its ledger, audit trail, journal and transcript: the
    banners carry the JAX command's fields (and the device), both results
    agree with ``protocol run``'s, and each transcript scans clean and
    balances."""
    import socket
    import subprocess
    import sys

    from dpcorr_torch.obs.audit import read_events
    from dpcorr_torch.protocol.scan import ledger_balance, scan_transcript

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    common = ["--port", str(port), "--n", "600", "--family", "ni_sign",
              "--device", "cpu"]
    procs = {}
    for role in ("y", "x"):
        files = [f"--{k}={tmp_path / f'{k}.{role}.json'}"
                 for k in ("ledger", "journal")]
        files += [f"--{k}={tmp_path / f'{k}.{role}.jsonl'}"
                  for k in ("audit", "transcript")]
        procs[role] = subprocess.Popen(
            [sys.executable, "-m", "dpcorr_torch", "party", "--role", role,
             *common, *files], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=_child_env(),
            cwd=str(tmp_path))
    outs = {}
    for role, p in procs.items():
        stdout, stderr = p.communicate(timeout=120)
        assert p.returncode == 0, stderr
        banner, rest = stdout.split("\n", 1)
        outs[role] = (json.loads(banner)["party"],
                      json.loads(rest)["result"])
    assert set(outs["y"][0]) == {"role", "session", "instance",
                                 "listening", "device"}
    assert set(outs["x"][0]) == {"role", "session", "instance",
                                 "connecting", "device"}
    bits = {r: (o[1]["rho_hat"], o[1]["ci_low"], o[1]["ci_high"])
            for r, o in outs.items()}
    assert bits["x"] == bits["y"]
    main(["protocol", "run", "--device", "cpu", "--n", "600"])
    ref = json.loads(capsys.readouterr().out)["results"]["x"]
    assert bits["x"] == (ref["rho_hat"], ref["ci_low"], ref["ci_high"])
    for role in ("x", "y"):
        path = str(tmp_path / f"transcript.{role}.jsonl")
        assert scan_transcript(path)["ok"]
        assert ledger_balance(path, read_events(
            str(tmp_path / f"audit.{role}.jsonl")))["ok"]


def test_party_refuses_an_unreachable_chaos_plan(monkeypatch):
    # every registered point is reachable now that the fleet is ported
    # (chaos.UNREACHABLE_POINTS is empty); a plan on a point no code
    # traverses — an unknown one — is refused before anything runs
    from dpcorr_torch import chaos

    assert not chaos.UNREACHABLE_POINTS
    monkeypatch.setenv("DPCORR_CHAOS", "point=fleet.no_such_point")
    with pytest.raises(SystemExit, match="chaos plan refused"):
        main(["party", "--role", "y", "--port", "0", "--n", "64",
              "--device", "cpu"])


def _banner(argv, tmp_path, key):
    """Start ``python -m <argv>`` with ``--port 0``, read its one-line JSON
    banner, stop it."""
    import subprocess
    import sys

    p = subprocess.Popen([sys.executable, "-m", *argv, "--port", "0"],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=_child_env(), cwd=str(tmp_path))
    try:
        line = p.stdout.readline()
        assert line, p.stderr.read()
        return json.loads(line)[key]
    finally:
        p.terminate()
        p.wait(timeout=60)
        p.stdout.close()
        p.stderr.close()


def test_stream_banner_equals_jax(tmp_path):
    """``stream`` prints the JAX command's banner for the same arguments,
    apart from the device (and the bound port and workdir)."""
    args = ["stream", "--window-s", "2", "--slide-s", "1", "--late-s",
            "0.5", "--families", "ni_sign,int_subg", "--eps1", "0.4",
            "--eps2", "0.8", "--budget", "50", "--stream-id", "s1",
            "--user", "alice", "--user-budget", "3", "--global-budget",
            "40", "--max-pending-rows", "512"]
    ours = _banner(["dpcorr_torch", *args, "--workdir",
                    str(tmp_path / "p"), "--device", "cpu"], tmp_path,
                   "streaming")
    theirs = _banner(["dpcorr", *args, "--workdir", str(tmp_path / "j")],
                     tmp_path, "streaming")
    assert ours.pop("device") == "cpu"
    for b in (ours, theirs):
        b.pop("port")
        b.pop("workdir")
    assert ours == theirs
    assert ours["eps_per_window"] == pytest.approx({"party/x": 1.2,
                                                    "party/y": 2.4})


def test_stream_raises_without_a_card_and_refuses_fleet_chaos(monkeypatch,
                                                             tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["stream", "--workdir", str(tmp_path / "w"), "--port", "0"])
    monkeypatch.setenv("DPCORR_CHAOS", "point=fleet.no_such_point")
    with pytest.raises(SystemExit, match="chaos plan refused"):
        main(["stream", "--workdir", str(tmp_path / "w"), "--port", "0",
              "--device", "cpu"])


def test_serve_user_dir_echoes_its_options_as_jax(tmp_path):
    """``serve --user-dir`` builds a CompositeLedger and echoes the
    per-user options in the JAX command's banner fields."""
    args = ["serve", "--user-dir", str(tmp_path / "users"), "--user-budget",
            "2.5", "--user-shards", "4", "--global-budget", "30",
            "--user-max-resident", "16", "--user-compact-every", "8"]
    ours = _banner(["dpcorr_torch", *args, "--device", "cpu"], tmp_path,
                   "serving")
    theirs = _banner(["dpcorr", *args], tmp_path, "serving")
    for k in ("user_dir", "user_budget", "global_budget", "budget"):
        assert ours[k] == theirs[k], k
    with open(tmp_path / "users" / "meta.json") as fh:
        assert json.load(fh) == {"version": 1, "shards": 4}


# --------------------------------------- obs budget | chrome | dump
@pytest.fixture
def obs_files(tmp_path):
    """An audit trail, a span log and a flight-recorder dump written by the
    port's own obs layer."""
    from dpcorr_torch.obs.audit import AuditTrail
    from dpcorr_torch.obs.recorder import FlightRecorder
    from dpcorr_torch.obs.trace import Tracer

    audit = str(tmp_path / "audit.jsonl")
    trail = AuditTrail(audit)
    trail.record("charge", {"a": 2.0, "b": 1.0}, trace_id="t0")
    trail.record("refund", {"b": 1.0}, trace_id="t1")
    trail.record("refusal", {"a": 50.0}, trace_id="t2", party="a",
                 spent=2.0, budget=3.0)
    trail.close()
    spans = str(tmp_path / "spans.jsonl")
    rec = FlightRecorder(str(tmp_path / "dump.json"))
    tr = Tracer(spans)
    tr.add_observer(rec.record_span)
    with tr.span("serve.request"):
        with tr.span("serve.kernel"):
            pass
    with tr.span("serve.request"):
        pass
    rec.record_audit({"seq": 0, "kind": "charge", "charges": {"a": 2.0},
                      "trace_id": rec.snapshot("x")["spans"][0]["trace_id"]})
    return {"audit": audit, "spans": spans,
            "dump": rec.dump("breaker_open", bucket="ni_sign/n=128")}


def _both_clis(argv, capsys):
    out = []
    for fn in (main, jax_main):
        try:
            fn(argv)
            code = 0
        except SystemExit as e:
            code = e.code
        out.append((code, capsys.readouterr().out))
    assert out[0] == out[1]
    return out[0]


@pytest.mark.parametrize("extra", [["--json"], [],
                                   ["--party", "a", "--json"]])
def test_obs_budget_replays_the_trail_as_jax(obs_files, capsys, extra):
    code, out = _both_clis(["obs", "budget", "--audit", obs_files["audit"],
                            *extra], capsys)
    assert code == 0
    if extra == ["--json"]:
        doc = json.loads(out)
        assert doc["events"] == 3 and doc["spent"] == {"a": 2.0, "b": 0.0}
        assert [r["trace_id"] for r in doc["timeline"]] == ["t0", "t1", "t2"]
    elif extra:
        doc = json.loads(out)
        assert doc["spent"] == {"a": 2.0}
        assert [r["seq"] for r in doc["timeline"]] == [0, 2]
    else:
        assert "refusal" in out and "replayed spend" in out


def test_obs_budget_proves_a_budget_directory(tmp_path, capsys):
    """``--budget-dir`` folds the trail's user legs against the port's
    directory: OK and exit 0 when they agree; a forged user charge in the
    trail exits 1 naming the user, in both packages alike."""
    from dpcorr_torch.obs.audit import AuditTrail
    from dpcorr_torch.serve.budget_dir import BudgetDirectory

    root = str(tmp_path / "users")
    bd = BudgetDirectory(root, user_budget=50.0, shards=4)
    bd.charge("alice", 0.8, charge_id="c1")
    bd.charge("bob", 0.25, charge_id="c2")
    bd.close()
    audit = str(tmp_path / "audit.jsonl")
    trail = AuditTrail(audit)
    trail.record("charge", {"user/alice": 0.8}, trace_id="c1",
                 charge_id="c1")
    trail.record("charge", {"user/bob": 0.25}, trace_id="c2",
                 charge_id="c2")
    argv = ["obs", "budget", "--audit", audit, "--budget-dir", root]
    code, out = _both_clis(argv + ["--json"], capsys)
    assert code == 0
    assert json.loads(out)["budget_dir"] == {
        "ok": True, "users": 2, "replayed_users": 2, "mismatches": []}
    trail.record("charge", {"user/alice": 3.0}, trace_id="z",
                 charge_id="forged")
    trail.close()
    code, out = _both_clis(argv, capsys)
    assert code == 1
    assert "MISMATCH" in out and "alice: replayed 3.8 != directory 0.8" in out


def test_obs_chrome_writes_the_jax_trace(obs_files, tmp_path, capsys):
    outs = {}
    for pkg, fn in (("port", main), ("jax", jax_main)):
        path = str(tmp_path / f"chrome.{pkg}.json")
        fn(["obs", "chrome", "--trace", obs_files["spans"], "--out", path])
        assert capsys.readouterr().out == f"wrote {path} (3 spans)\n"
        with open(path) as f:
            outs[pkg] = json.load(f)
    assert outs["port"] == outs["jax"]
    names = [e["name"] for e in outs["port"]["traceEvents"]
             if e.get("ph") == "X"]
    assert sorted(names) == ["serve.kernel", "serve.request",
                             "serve.request"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("as_json", [False, True])
def test_obs_dump_replays_as_jax(obs_files, capsys, trace, as_json):
    from dpcorr_torch.obs.recorder import read_dump

    dump = read_dump(obs_files["dump"])
    tid = dump["spans"][0]["trace_id"]
    argv = ["obs", "dump", obs_files["dump"]]
    argv += ["--trace-id", tid] if trace else []
    argv += ["--json"] if as_json else []
    code, out = _both_clis(argv, capsys)
    assert code == 0
    if trace and as_json:
        story = json.loads(out)
        assert [s["name"] for s in story["spans"]] == ["serve.request",
                                                       "serve.kernel"]
        assert story["eps_net"] == {"a": 2.0}
    elif trace:
        assert out.startswith(f"trace {tid} (2 spans)")
    elif as_json:
        doc = json.loads(out)
        assert doc["reason"] == "breaker_open" and doc["spans"] == 3
        assert len(doc["trace_ids"]) == 2
    else:
        assert out.startswith("flight-recorder dump: reason=breaker_open")


def test_obs_file_commands_run_without_torch(obs_files, tmp_path):
    for argv in (["obs", "budget", "--audit", obs_files["audit"], "--json"],
                 ["obs", "dump", obs_files["dump"], "--json"],
                 ["obs", "chrome", "--trace", obs_files["spans"], "--out",
                  str(tmp_path / "c.json")]):
        proc = _no_torch(argv, tmp_path)
        assert proc.returncode == 0, proc.stderr
