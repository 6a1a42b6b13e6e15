"""The port's environment doctor (``python -m dpcorr_torch doctor``)
against ``dpcorr.utils.doctor``, on a host with no card.

Contracts: the report keys that have a counterpart are the JAX
doctor's; without a card the verdict names the missing device and never
reads ok; the build cache's stale libraries are found against the
sources' digests; the stray rule (parent pid 1, a worker process of
this checkout, never a service, not this process or its ancestors)
beside the JAX rule on one faked process list, and ``--sweep``;
the device probe runs in its own process group under a hard timeout.
"""

import json
import os
import subprocess
import sys

import pytest

from dpcorr.utils import doctor as jdoctor
from dpcorr_torch.__main__ import main as port_main
from dpcorr_torch.ops import _build
from dpcorr_torch.utils import doctor

CARD = {"available": True, "cards": ["NVIDIA H100 80GB HBM3, 700.00 W"]}
NVCC = {"found": True, "path": "/usr/local/cuda/bin/nvcc",
        "version": "Cuda compilation tools, release 12.4", "sm_90a": True}


def test_report_keys_correspond_to_jax(monkeypatch):
    """Every key of the JAX report but the relay and the queue (no
    counterpart on a card host) is in the port's, with and without
    --probe and --sweep."""
    monkeypatch.setattr(jdoctor, "find_stray_workers", lambda: [])
    monkeypatch.setattr(jdoctor, "check_relay", lambda: {
        "alive": False, "open_ports": [], "checked": [1]})
    for probe, sweep in ((False, False), (True, True)):
        theirs = jdoctor.diagnose(probe=probe, sweep=sweep)
        ours = doctor.diagnose(probe=probe, sweep=sweep)
        assert set(theirs) - {"relay", "queue"} <= set(ours)
        assert set(ours) - set(theirs) == {"cards", "nvcc"}
        assert isinstance(ours["stray_workers"], list)
        assert ("swept" in ours) == sweep
        assert ("device_probe" in ours) == probe


def test_no_card_verdict_names_it_and_is_not_ok(capsys):
    report = doctor.diagnose(probe=True)
    assert not report["cards"]["available"]
    assert report["verdict"].startswith("no-card")
    assert not report["verdict"].startswith("ok")
    assert report["device_probe"] == {
        "ok": False, "skipped": "no card visible to nvidia-smi"}
    port_main(["doctor", "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert doc["verdict"].startswith("no-card")
    port_main(["doctor"])
    text = capsys.readouterr().out
    assert "verdict        : no-card" in text


@pytest.mark.parametrize("cards,nvcc,strays,sweep,probe,verdict", [
    (CARD, NVCC, [], False, None, "ok (card visible"),
    (CARD, NVCC, [], False, {"ok": True, "card": "c", "capability": "9.0"},
     "ok"),
    (CARD, NVCC, [], False, {"ok": False, "error": "boom"},
     "device-probe-failed"),
    (CARD, {"found": False, "error": "nvcc not found"}, [], False, None,
     "no-nvcc"),
    (CARD, {**NVCC, "sm_90a": False}, [], False, None, "no-nvcc"),
    (CARD, NVCC, [{"pid": 4, "cmdline": "x"}], False, None,
     "stray-client (run --sweep"),
    (CARD, NVCC, [{"pid": 4, "cmdline": "x"}], True, None,
     "stray-client-unkillable"),
    ({"available": False, "cards": []}, NVCC, [], False, None, "no-card"),
])
def test_verdicts(monkeypatch, cards, nvcc, strays, sweep, probe, verdict):
    monkeypatch.setattr(doctor, "check_cards", lambda: cards)
    monkeypatch.setattr(doctor, "check_nvcc", lambda: nvcc)
    monkeypatch.setattr(doctor, "find_strays", lambda: strays)
    monkeypatch.setattr(doctor, "sweep_strays", lambda s: [])
    monkeypatch.setattr(doctor, "probe_device", lambda: probe)
    report = doctor.diagnose(probe=probe is not None, sweep=sweep)
    if verdict == "ok":
        assert report["verdict"] == "ok"
    else:
        assert report["verdict"].startswith(verdict)
    assert doctor.render_text(report).endswith(report["verdict"])


def test_stale_builds_found_in_a_scratch_build_dir(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel v2\n")
    (csrc / "r.cpp").write_text("// reader\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    absent = doctor.check_build_cache()
    assert absent["present"] is False
    assert absent["current"] == {"k": False, "r": False}
    build.mkdir()
    lib = _build.library_path("k")
    lib.write_bytes(b"\0" * 100)
    lib.with_suffix(".log").write_text("ptxas info")
    (build / "k-0123456789abcdef.so").write_bytes(b"\0" * 50)
    (build / "r-fedcba9876543210.so").write_bytes(b"\0" * 10)
    got = doctor.check_build_cache()
    assert got["current"] == {"k": True, "r": False}
    assert got["stale"] == ["k-0123456789abcdef.so", "r-fedcba9876543210.so"]
    assert got["logs"] == 1 and got["bytes"] == 100 + 10 + 50 + 10
    assert len(got["libraries"]) == 3
    (csrc / "k.cu").write_text("// kernel v3\n")  # an edit stales it
    assert doctor.check_build_cache()["current"]["k"] is False
    assert lib.name in doctor.check_build_cache()["stale"]


def _fake_proc(base, pid, argv, ppid, cwd=None, pythonpath=None):
    d = base / str(pid)
    d.mkdir(parents=True)
    (d / "cmdline").write_bytes(b"\0".join(a.encode() for a in argv) + b"\0")
    (d / "stat").write_text(f"{pid} ({os.path.basename(argv[0])}) S {ppid} "
                            f"{pid} {pid} 0 -1\n")
    if cwd is not None:
        os.symlink(cwd, d / "cwd")
    env = [b"HOME=/h"] + ([f"PYTHONPATH={pythonpath}".encode()]
                          if pythonpath is not None else [])
    (d / "environ").write_bytes(b"\0".join(env) + b"\0")


def test_stray_rule_on_a_faked_process_list(tmp_path, monkeypatch):
    """One faked /proc, read by both rules. The JAX rule flags only its
    ``bench.py --worker`` orphans; the port's only its own workers (the
    fan-out worker, the root scripts) of this checkout. Neither flags a
    service whose parent is init, another checkout's worker, a worker
    with a live parent, or this process."""
    proc, root, other = tmp_path / "proc", tmp_path / "repo", tmp_path / "b"
    root.mkdir()
    other.mkdir()
    services = {
        11: ["python", "-m", "dpcorr_torch", "serve", "--port", "0"],
        12: ["python", "-m", "dpcorr_torch", "stream", "--workdir", "w"],
        13: ["python", "-m", "dpcorr_torch", "fleet", "up"],
        14: ["python", "-m", "dpcorr_torch", "party", "--role", "x"],
        15: ["python", "-m", "dpcorr_torch", "federation", "party"],
        16: ["python", "-m", "dpcorr", "serve"],
        17: ["bash", "-c", "echo dpcorr_torch chip_smoke.py"],
    }
    for pid, argv in services.items():
        _fake_proc(proc, pid, argv, 1, cwd=str(root), pythonpath=str(root))
    worker = ["python", "-m", "dpcorr_torch.parallel.multihost"]
    _fake_proc(proc, 21, worker, 1, cwd="/", pythonpath=f"{root}:/x")
    _fake_proc(proc, 22, worker, 4242, cwd=str(root), pythonpath=str(root))
    _fake_proc(proc, 23, worker, 1, cwd=str(other), pythonpath=str(other))
    _fake_proc(proc, 24, ["python3", "chip_smoke.py"], 1, cwd=str(root))
    _fake_proc(proc, 25, ["python3", f"{root}/plan_ab.py", "--sketch"], 1,
               cwd="/")
    _fake_proc(proc, 26, ["python3", f"{other}/chip_smoke.py"], 1,
               cwd=str(root))
    _fake_proc(proc, 27, ["python3", "chip_smoke.py"], 1, cwd=str(other))
    _fake_proc(proc, 31, ["python", "bench.py", "--worker", "tpu"], 1,
               cwd=str(root))
    _fake_proc(proc, 32, ["python", "bench.py", "--worker", "tpu"], 4242,
               cwd=str(root))
    pids = sorted(int(d.name) for d in proc.iterdir())

    class _Glob:
        @staticmethod
        def glob(pattern):
            assert pattern == "/proc/[0-9]*"
            return [str(proc / str(pid)) for pid in pids]

    monkeypatch.setattr(jdoctor, "glob", _Glob)
    theirs = {s["pid"] for s in jdoctor.find_stray_workers()}
    ours = doctor.find_strays(pids=[*pids, 99], proc=str(proc),
                              root=str(root))
    assert theirs == {31}
    assert {s["pid"] for s in ours} == {21, 24, 25}
    assert not (theirs | {s["pid"] for s in ours}) & set(services)
    assert ours[0]["cmdline"] == "python -m dpcorr_torch.parallel.multihost"
    assert doctor.find_strays(pids=[], proc=str(proc), root=str(root)) == []


def test_stray_rule_spares_this_process_and_its_ancestors(tmp_path):
    """The doctor that a root script runs never flags the script, even
    when the script's parent is init: this process and its parent, faked
    as orphaned ``chip_smoke.py`` runs of the checkout, stay off the
    list, while a third such run is a stray."""
    proc, root = tmp_path / "proc", tmp_path / "repo"
    root.mkdir()
    mine = (os.getpid(), os.getppid())
    other = max(mine) + 1
    for pid in (*mine, other):
        _fake_proc(proc, pid, ["python3", "chip_smoke.py"], 1, cwd=str(root))
    got = doctor.find_strays(pids=[*mine, other], proc=str(proc),
                             root=str(root))
    assert [s["pid"] for s in got] == [other]


def test_sweep_kills_what_it_can():
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(60)"])
    try:
        swept = doctor.sweep_strays([{"pid": child.pid}, {"pid": 2 ** 22 + 7}])
        assert swept == [child.pid]
        assert child.wait(timeout=10) == -9
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()


def test_device_probe_subprocess_reports_and_times_out(monkeypatch):
    """The probe initialises CUDA only in its own process group: here it
    reports that torch sees no card; a hung probe is killed at its
    timeout."""
    got = doctor.probe_device(timeout_s=120)
    assert got["ok"] is False and "no CUDA device" in got["error"]
    monkeypatch.setattr(doctor, "_PROBE", "import time; time.sleep(60)")
    assert doctor.probe_device(timeout_s=1.0) == {
        "ok": False, "error": "timeout after 1s"}
