"""The port's runtime lock witness (dpcorr_torch/utils/syncwatch.py) and
its ``lint --witness`` gate (dpcorr_torch/analysis/witness.py), held to
tests/test_syncwatch.py case by case, plus the two packages in one
process and the two gates on the same artifacts.

The in-process tests drive _WatchedLock directly (the factory only wraps
locks whose creation frame is a dpcorr_torch source file, which test
files are not); the factory's frame filter itself is covered by
constructing a real port object after enable().
"""

import json
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from dpcorr.analysis.witness import run_witness_check as jax_witness_check
from dpcorr.utils import syncwatch as jax_syncwatch
from dpcorr_torch.analysis.cli import main as lint_main
from dpcorr_torch.analysis.witness import run_witness_check
from dpcorr_torch.utils import syncwatch

REPO = Path(__file__).parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "lint"
ARTIFACT = f"{syncwatch.ARTIFACT_PREFIX}1.json"


@pytest.fixture
def watch():
    syncwatch.enable()
    try:
        yield syncwatch
    finally:
        syncwatch.disable()
        syncwatch._tls.stack = []


def make_lock(site, kind="lock"):
    real = syncwatch._real_rlock() if kind == "rlock" \
        else syncwatch._real_lock()
    with syncwatch._meta:
        syncwatch._locks.setdefault(site, kind)
    return syncwatch._WatchedLock(real, site, kind)


# ------------------------------------------------------- recording ----
def test_nested_acquisition_records_one_edge(watch):
    a = make_lock("dpcorr_torch/x.py:10")
    b = make_lock("dpcorr_torch/x.py:20")
    with a:
        with b:
            pass
    snap = watch.snapshot()
    assert snap["edges"] == [["dpcorr_torch/x.py:10", "dpcorr_torch/x.py:20"]]
    assert snap["inversions"] == []
    assert snap["locks"]["dpcorr_torch/x.py:10"] == {"kind": "lock"}
    # repeating the same ordering adds nothing
    with a:
        with b:
            pass
    assert watch.snapshot()["edges"] == snap["edges"]


def test_order_inversion_detected_live(watch, capsys):
    a = make_lock("dpcorr_torch/x.py:10")
    b = make_lock("dpcorr_torch/x.py:20")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    snap = watch.snapshot()
    assert len(snap["edges"]) == 2
    assert snap["inversions"] == [
        {"held": "dpcorr_torch/x.py:20", "acquiring": "dpcorr_torch/x.py:10",
         "thread": threading.current_thread().name}]
    assert "lock-order inversion" in capsys.readouterr().err


def test_reentrant_rlock_records_no_self_edge(watch):
    r = make_lock("dpcorr_torch/x.py:30", kind="rlock")
    with r:
        with r:
            pass
    snap = watch.snapshot()
    assert snap["edges"] == []
    assert snap["inversions"] == []
    assert not syncwatch._held()  # push/pop stayed balanced


def test_fsync_under_lock_counted(watch, tmp_path):
    a = make_lock("dpcorr_torch/x.py:40")
    fd = os.open(str(tmp_path / "f"), os.O_CREAT | os.O_WRONLY)
    try:
        with a:
            os.fsync(fd)  # patched while enabled
        os.fsync(fd)      # not under any watched lock: not counted
    finally:
        os.close(fd)
    assert watch.snapshot()["fsync_under_lock"] == {"dpcorr_torch/x.py:40": 1}


def test_factory_wraps_only_port_created_locks(watch):
    # created from this (non-port) frame: passes through untouched
    plain = threading.Lock()
    assert not isinstance(plain, syncwatch._WatchedLock)
    # created inside the port: wrapped, site = creation line
    from dpcorr_torch.obs.metrics import Registry
    reg = Registry()
    assert isinstance(reg._lock, syncwatch._WatchedLock)
    assert reg._lock.site.startswith("dpcorr_torch/obs/metrics.py:")


def test_enable_idempotent_and_disable_restores():
    syncwatch.enable()
    factory = threading.Lock
    syncwatch.enable()
    assert threading.Lock is factory  # second enable is a no-op
    syncwatch.disable()
    assert threading.Lock is syncwatch._real_lock
    assert os.fsync is syncwatch._real_fsync
    assert syncwatch.snapshot()["edges"] == []


def test_dump_writes_witness_artifact(watch, tmp_path):
    a = make_lock("dpcorr_torch/x.py:10")
    b = make_lock("dpcorr_torch/x.py:20")
    with a:
        with b:
            pass
    path = watch.dump(str(tmp_path))
    assert os.path.basename(path) == \
        f"{syncwatch.ARTIFACT_PREFIX}{os.getpid()}.json"
    art = json.loads(Path(path).read_text())
    assert art["pid"] == os.getpid() and art["end"] == "exit"
    assert art["argv"] == sys.argv
    assert art["edges"] == [["dpcorr_torch/x.py:10", "dpcorr_torch/x.py:20"]]
    assert art["edge_threads"] == {
        "dpcorr_torch/x.py:10 -> dpcorr_torch/x.py:20":
            threading.current_thread().name}
    assert not list(tmp_path.glob("*.tmp.*"))  # dump is tmp+replace


# ---------------------------------------------------- witness gate ----
# static model for the gate tests: deep/lockorder_ok.py declares locks
# at lines 9 (_a) and 10 (_b) and the one order _a -> _b.
OK_FIX = "deep/lockorder_ok.py"
SITE_A = f"{OK_FIX}:9"
SITE_B = f"{OK_FIX}:10"


def write_witness(d, edges=(), inversions=(), name=ARTIFACT):
    d.mkdir(parents=True, exist_ok=True)
    (d / name).write_text(json.dumps({
        "pid": 1, "locks": {}, "edges": [list(e) for e in edges],
        "edge_threads": {}, "inversions": list(inversions),
        "fsync_under_lock": {}, "threads": ["MainThread"]}))


def test_witness_missing_dir_and_empty_dir_are_usage_errors(tmp_path):
    assert run_witness_check([OK_FIX], str(FIXTURES),
                             str(tmp_path / "nope")) == 2
    (tmp_path / "empty").mkdir()
    assert run_witness_check([OK_FIX], str(FIXTURES),
                             str(tmp_path / "empty")) == 2
    # the JAX package's artifact is not this gate's
    write_witness(tmp_path / "jax", edges=[(SITE_A, SITE_B)],
                  name="witness-1.json")
    assert run_witness_check([OK_FIX], str(FIXTURES),
                             str(tmp_path / "jax")) == 2


def test_witness_predicted_edge_is_clean(tmp_path, capsys):
    write_witness(tmp_path, edges=[(SITE_A, SITE_B)])
    assert run_witness_check([OK_FIX], str(FIXTURES),
                             str(tmp_path)) == 0
    assert "witness: clean" in capsys.readouterr().out


def test_witness_line_slack_matches_nearby_site(tmp_path):
    # creation frame two lines below the static site: same lock
    write_witness(tmp_path, edges=[(f"{OK_FIX}:11", SITE_B)])
    assert run_witness_check([OK_FIX], str(FIXTURES),
                             str(tmp_path)) == 0


def test_witness_unpredicted_edge_fails(tmp_path, capsys):
    write_witness(tmp_path, edges=[(SITE_B, SITE_A)])  # reverse order
    assert run_witness_check([OK_FIX], str(FIXTURES),
                             str(tmp_path)) == 1
    assert "observed-but-unpredicted lock order" in \
        capsys.readouterr().out


def test_witness_unknown_site_counts_as_unpredicted(tmp_path, capsys):
    write_witness(tmp_path, edges=[("dpcorr_torch/nowhere.py:1", SITE_B)])
    assert run_witness_check([OK_FIX], str(FIXTURES),
                             str(tmp_path), as_json=True) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["unknown_sites"] == ["dpcorr_torch/nowhere.py:1"]
    assert not report["ok"]


def test_witness_runtime_inversion_fails(tmp_path, capsys):
    write_witness(tmp_path, edges=[(SITE_A, SITE_B)],
                  inversions=[{"held": SITE_A, "acquiring": SITE_B,
                               "thread": "T1"}])
    assert run_witness_check([OK_FIX], str(FIXTURES),
                             str(tmp_path)) == 1
    assert "runtime lock-order inversion" in capsys.readouterr().out


def test_witness_cross_process_cycle_fails(tmp_path, capsys):
    """Two witnesses, each edge individually predicted by the cyclic
    fixture's (deliberately cyclic) model — the union still cycles."""
    cyc = "deep/lockorder_cycle_bad.py"
    write_witness(tmp_path, edges=[(f"{cyc}:9", f"{cyc}:10")])
    write_witness(tmp_path, edges=[(f"{cyc}:10", f"{cyc}:9")],
                  name=f"{syncwatch.ARTIFACT_PREFIX}2.json")
    assert run_witness_check([cyc], str(FIXTURES), str(tmp_path)) == 1
    assert "observed lock-order cycle" in capsys.readouterr().out


def test_cli_witness_wiring(tmp_path, capsys):
    write_witness(tmp_path, edges=[(SITE_A, SITE_B)])
    assert lint_main(["--root", str(FIXTURES),
                      "--witness", str(tmp_path), OK_FIX]) == 0
    capsys.readouterr()
    assert lint_main(["--root", str(FIXTURES),
                      "--witness", str(tmp_path / "nope"), OK_FIX]) == 2


def test_witness_gate_is_torch_free(tmp_path):
    """`dpcorr_torch lint --witness` end to end in a process that cannot
    import torch: builds the full static lock model of dpcorr_torch/ and
    diffs a witness dir."""
    write_witness(tmp_path)  # no observed edges: trivially clean
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.modules['torch'] = None; "
         "from dpcorr_torch.analysis import cli; "
         f"rc = cli.main(['--witness', {str(tmp_path)!r}, 'dpcorr_torch']); "
         "assert 'torch' not in [m for m in sys.modules "
         "if sys.modules[m] is not None], 'witness gate pulled torch'; "
         "sys.exit(rc)"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, (r.stdout[-800:], r.stderr[-800:])


def test_syncwatch_dump_survives_chaos_kill(tmp_path):
    """enable() registers the dump with chaos.on_crash, so a planned
    os._exit(42) kill still leaves a witness artifact behind, marked as
    the chaos kill it was."""
    from dpcorr_torch import chaos

    code = (
        "import os\n"
        "os.environ['DPCORR_SYNCWATCH'] = '1'\n"
        f"os.environ['DPCORR_SYNCWATCH_DIR'] = {str(tmp_path)!r}\n"
        "import dpcorr_torch\n"
        "from dpcorr_torch import chaos\n"
        "from dpcorr_torch.obs.metrics import Registry\n"
        "c = Registry().counter('x', 'help')\n"
        "c.inc()\n"
        "plan = chaos.ChaosPlan('ledger.pre_persist', hit=1)\n"
        "chaos.install(plan)\n"
        "chaos.point('ledger.pre_persist')\n"
        "raise SystemExit('chaos point did not fire')\n")
    r = subprocess.run([sys.executable, "-c", code],
                       capture_output=True, text=True, timeout=120,
                       cwd=REPO)
    assert r.returncode == chaos.EXIT_CODE, (r.stdout, r.stderr)
    arts = list(tmp_path.glob(f"{syncwatch.ARTIFACT_PREFIX}*.json"))
    assert len(arts) == 1
    art = json.loads(arts[0].read_text())
    assert art["end"] == "chaos:ledger.pre_persist"
    assert any(site.startswith("dpcorr_torch/obs/metrics.py:")
               for site in art["locks"])
    assert not any(site.startswith("dpcorr/") for site in art["locks"])


# --------------------------------------------- both packages at once ----
@pytest.mark.parametrize("port_first", [False, True])
def test_both_packages_in_one_process(tmp_path, port_first):
    """Both watchers enabled in one process, in either order: neither
    wraps the other package's locks, the port's locks are its own
    watcher's when it is enabled last, both dump into one directory
    without overwriting each other, and each gate reads only its own
    package's artifact."""
    from dpcorr.obs.metrics import Registry as JaxRegistry
    from dpcorr_torch.obs.metrics import Registry as PortRegistry

    order = ([syncwatch, jax_syncwatch] if port_first
             else [jax_syncwatch, syncwatch])
    try:
        for w in order:
            w.enable()
        jax_lock, port_lock = JaxRegistry()._lock, PortRegistry()._lock
        assert not isinstance(jax_lock, syncwatch._WatchedLock)
        assert not isinstance(port_lock, jax_syncwatch._WatchedLock)
        if isinstance(jax_lock, jax_syncwatch._WatchedLock):
            assert jax_lock.site.startswith("dpcorr/obs/metrics.py:")
        if not port_first:
            assert isinstance(port_lock, syncwatch._WatchedLock)
            assert port_lock.site.startswith("dpcorr_torch/obs/metrics.py:")
        paths = [w.dump(str(tmp_path)) for w in order]
    finally:
        for w in reversed(order):
            w.disable()
        syncwatch._tls.stack = []
        jax_syncwatch._tls.stack = []
    assert threading.Lock is syncwatch._real_lock
    assert sorted(os.path.basename(p) for p in paths) == sorted(
        [f"{syncwatch.ARTIFACT_PREFIX}{os.getpid()}.json",
         f"witness-{os.getpid()}.json"])
    tree = tmp_path / "tree"
    tree.mkdir()
    (tree / "m.py").write_text("")
    for gate, name in ((run_witness_check,
                        f"{syncwatch.ARTIFACT_PREFIX}{os.getpid()}.json"),
                       (jax_witness_check, f"witness-{os.getpid()}.json")):
        report = _report(gate, ["m.py"], tree, tmp_path)
        assert report["witness_files"] == [name]


def _report(gate, paths, root, witness_dir) -> dict:
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        gate(paths, str(root), str(witness_dir), as_json=True)
    return json.loads(buf.getvalue())


# ------------------------------------------- the two gates, same input ----
SCENARIOS = {
    "clean": dict(edges=[(9, 10)]),
    "slack": dict(edges=[(11, 10)]),
    "unpredicted": dict(edges=[(10, 9)]),
    "unknown": dict(edges=[("nowhere", 10)]),
    "inversion": dict(edges=[(9, 10)], inversions=[(9, 10)]),
    "cycle": dict(fixture="lockorder_cycle_bad.py", edges=[(9, 10)],
                  second=[(10, 9)]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_gate_reports_equal_with_paths_renamed(tmp_path, scenario):
    """One fixture tree laid out under dpcorr/ and dpcorr_torch/, one
    witness per package naming the same lines: both packages'
    run_witness_check give the same exit code and the same report once
    the package name and the artifact prefix are renamed."""
    spec = SCENARIOS[scenario]
    fixture = spec.get("fixture", "lockorder_ok.py")
    reports = {}
    for pkg, gate, prefix in (("dpcorr", jax_witness_check, "witness-"),
                              ("dpcorr_torch", run_witness_check,
                               syncwatch.ARTIFACT_PREFIX)):
        root = tmp_path / pkg
        (root / pkg / "deep").mkdir(parents=True)
        shutil.copy(FIXTURES / "deep" / fixture, root / pkg / "deep" / fixture)
        rel = f"{pkg}/deep/{fixture}"

        def site(line, rel=rel, pkg=pkg):
            return (f"{pkg}/nowhere.py:1" if line == "nowhere"
                    else f"{rel}:{line}")

        wdir = root / "w"
        write_witness(wdir, edges=[(site(a), site(b))
                                   for a, b in spec["edges"]],
                      inversions=[{"held": site(a), "acquiring": site(b),
                                   "thread": "T1"}
                                  for a, b in spec.get("inversions", ())],
                      name=f"{prefix}1.json")
        if "second" in spec:
            write_witness(wdir, edges=[(site(a), site(b))
                                       for a, b in spec["second"]],
                          name=f"{prefix}2.json")
        rc = gate([pkg], str(root), str(wdir))
        rep = _report(gate, [pkg], root, wdir)
        reports[pkg] = (rc, json.loads(json.dumps(rep).replace(
            "dpcorr_torch", "dpcorr").replace(prefix, "witness-")))
    assert reports["dpcorr_torch"] == reports["dpcorr"]
    want_ok = scenario in ("clean", "slack")
    assert reports["dpcorr"][0] == (0 if want_ok else 1)
