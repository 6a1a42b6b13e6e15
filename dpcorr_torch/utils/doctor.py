"""Environment health report: ``python -m dpcorr_torch doctor``.

Counterpart of ``dpcorr/utils/doctor.py`` for a host with an NVIDIA
card. One command runs the whole diagnosis and prints a table or one JSON
line with a one-word verdict. The process never initialises CUDA itself:
the card is read through ``nvidia-smi`` and, with ``--probe``, a
subprocess.

Checks:

- **cards**: ``nvidia-smi --query-gpu=name,power.limit`` — which cards
  the host shows, by name and power limit;
- **nvcc**: the compiler K1 is built with (``ops._build.nvcc_path``),
  its version, and whether it targets ``sm_90a``;
- **compile_cache**: the build cache ``dpcorr_torch/_build/`` — its
  libraries, their ``ptxas`` logs, bytes, whether each source's library
  is current, and the libraries stale against the sources' digests
  (never loaded; a build makes the current one);
- **stray_workers**: worker processes of this checkout holding a card
  (``nvidia-smi --query-compute-apps``) that were reparented to init —
  the orchestrator they served died and nothing will reap them;
  ``--sweep`` kills them. The JAX package's rule flags only its
  ``bench.py --worker`` processes; here the workers are the grid's
  fan-out workers (``-m dpcorr_torch.parallel.multihost``) and the root
  scripts ``chip_smoke.py`` / ``plan_ab.py``, each only when it belongs
  to this checkout. The services (``serve``, ``stream``, ``fleet``,
  ``party``, ``federation``) are never strays: started detached, their
  parent is init by design;
- **device_probe** (``--probe`` only): initialise CUDA in a subprocess of
  its own process group with a hard timeout, and report the card's name,
  compute capability and ``card_line()``.

The JAX doctor's relay check and ``--queue-dir`` have no counterpart: a
card host has no tunnel relay and no TPU validation queue.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys

#: this checkout's root: a stray must belong to it
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: the grid's fan-out worker, which exists to serve the grid that started it
_WORKER_MODULE = "dpcorr_torch.parallel.multihost"
#: the root scripts that drive the card for a caller
_ROOT_SCRIPTS = ("chip_smoke.py", "plan_ab.py")


def _nvidia_smi(*query: str, timeout: float = 30.0) -> list[str] | None:
    """``nvidia-smi`` output lines for ``query``; None when the tool is
    missing or fails."""
    try:
        out = subprocess.run(["nvidia-smi", *query], capture_output=True,
                             text=True, timeout=timeout)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def check_cards() -> dict:
    """The cards ``nvidia-smi`` shows, as ``name, power.limit`` lines."""
    lines = _nvidia_smi("--query-gpu=name,power.limit",
                        "--format=csv,noheader")
    if lines is None:
        return {"available": False, "cards": [],
                "error": "nvidia-smi missing or failed"}
    return {"available": bool(lines), "cards": lines}


def check_nvcc() -> dict:
    """Where ``nvcc`` is, its version line, and whether it accepts K1's
    target (a dry run of ``-gencode arch=compute_90a,code=sm_90a``:
    nothing is compiled)."""
    from dpcorr_torch.ops import _build

    try:
        path = _build.nvcc_path()
    except RuntimeError as e:
        return {"found": False, "error": str(e)}
    out = {"found": True, "path": path}
    try:
        ver = subprocess.run([path, "--version"], capture_output=True,
                             text=True, timeout=60)
        dry = subprocess.run([path, "-gencode", "arch=compute_90a,code=sm_90a",
                              "--dryrun", "-c", "-x", "cu", os.devnull,
                              "-o", os.devnull], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return {**out, "error": f"{type(e).__name__}: {e}"}
    lines = ver.stdout.strip().splitlines()
    out["version"] = lines[-1] if lines else ""
    out["sm_90a"] = dry.returncode == 0
    return out


def check_build_cache() -> dict:
    """State of the build cache (``ops._build.BUILD_DIR``) against the
    sources in ``ops._build.CSRC``: each source's current library present
    or not, and the libraries whose digest matches no current source."""
    from dpcorr_torch.ops import _build

    path = _build.BUILD_DIR
    names = sorted(p.stem for p in (*_build.CSRC.glob("*.cu"),
                                    *_build.CSRC.glob("*.cpp")))
    current = {name: _build.library_path(name) for name in names}
    if not path.is_dir():
        return {"path": str(path), "present": False,
                "current": {name: False for name in names}, "stale": []}
    libs = sorted(p.name for p in path.glob("*.so"))
    logs = sorted(p.name for p in path.glob("*.log"))
    total = 0
    for p in path.iterdir():
        try:
            total += p.stat().st_size
        except OSError:
            pass
    wanted = {p.name for p in current.values()}
    return {"path": str(path), "present": True, "libraries": libs,
            "logs": len(logs), "bytes": total,
            "current": {name: lib.exists() for name, lib in current.items()},
            "stale": [lib for lib in libs if lib not in wanted]}


def _proc_info(pid: int, proc: str = "/proc") -> dict | None:
    """``argv``, parent pid, working directory and ``PYTHONPATH`` of
    ``pid`` from ``proc``; None when it is gone or unreadable. The
    directory and the path are None or empty when they cannot be read
    (another user's process)."""
    base = os.path.join(proc, str(pid))
    try:
        with open(os.path.join(base, "cmdline"), "rb") as f:
            argv = [a.decode(errors="replace")
                    for a in f.read().split(b"\0") if a]
        with open(os.path.join(base, "stat")) as f:
            ppid = int(f.read().rsplit(")", 1)[1].split()[1])
    except (OSError, ValueError, IndexError):
        return None
    try:
        cwd = os.readlink(os.path.join(base, "cwd"))
    except OSError:
        cwd = None
    pythonpath = ""
    try:
        with open(os.path.join(base, "environ"), "rb") as f:
            for entry in f.read().split(b"\0"):
                if entry.startswith(b"PYTHONPATH="):
                    pythonpath = entry[len(b"PYTHONPATH="):].decode(
                        errors="replace")
    except OSError:
        pass
    return {"argv": argv, "ppid": ppid, "cwd": cwd, "pythonpath": pythonpath}


def _under(path: str, root: str) -> bool:
    path, root = os.path.realpath(path), os.path.realpath(root)
    return path == root or path.startswith(root + os.sep)


def is_checkout_worker(info: dict, root: str = ROOT) -> bool:
    """A worker process of the checkout at ``root``: the grid's fan-out
    worker (``<python> -m dpcorr_torch.parallel.multihost``, with
    ``root`` on its ``PYTHONPATH`` or as its working directory), or a
    root script (``chip_smoke.py``, ``plan_ab.py``) whose path lies at
    ``root``. A service command is none of these."""
    argv, cwd = info["argv"], info["cwd"]
    if argv[1:3] == ["-m", _WORKER_MODULE]:
        paths = [p for p in info["pythonpath"].split(os.pathsep) if p]
        return (any(os.path.realpath(p) == os.path.realpath(root)
                     for p in paths)
                or (cwd is not None and _under(cwd, root)))
    for a in argv[1:]:
        if os.path.basename(a) not in _ROOT_SCRIPTS:
            continue
        if not os.path.isabs(a):
            if cwd is None:
                return False
            a = os.path.join(cwd, a)
        return os.path.dirname(os.path.realpath(a)) == os.path.realpath(root)
    return False


def card_pids() -> list[int] | None:
    """Pids holding a card (``nvidia-smi --query-compute-apps``); None
    when ``nvidia-smi`` is missing or fails."""
    lines = _nvidia_smi("--query-compute-apps=pid", "--format=csv,noheader")
    if lines is None:
        return None
    return [int(ln) for ln in lines if ln.isdigit()]


def _ancestors(proc: str = "/proc") -> set[int]:
    """This process and its ancestors: a doctor run by a root script
    never flags the script that runs it."""
    out, pid = set(), os.getpid()
    while pid > 1 and pid not in out:
        out.add(pid)
        info = _proc_info(pid, proc)
        if info is None:
            break
        pid = info["ppid"]
    return out


def find_strays(pids=None, proc: str = "/proc",
                root: str = ROOT) -> list[dict]:
    """Worker processes of the checkout at ``root`` (``is_checkout_worker``)
    holding a card whose parent is init (pid 1): a live orchestrator
    keeps a live parent, so pid 1 means the orchestrator died and the
    worker holds its card with nothing left to reap it. ``pids``: the
    card's compute processes (default: ``nvidia-smi``); ``proc``: where
    to read them. This process and its ancestors are never strays."""
    if pids is None:
        pids = card_pids() or []
    mine = _ancestors()
    strays = []
    for pid in pids:
        info = _proc_info(pid, proc)
        if info is None:
            continue  # exited between the query and the read
        if (info["ppid"] == 1 and pid not in mine
                and is_checkout_worker(info, root)):
            strays.append({"pid": pid, "cmdline": " ".join(info["argv"])})
    return strays


def sweep_strays(strays: list[dict]) -> list[int]:
    swept = []
    for s in strays:
        try:
            os.kill(s["pid"], signal.SIGKILL)
            swept.append(s["pid"])
        except OSError:
            pass
    return swept


_PROBE = """\
import json, torch
if not torch.cuda.is_available():
    raise SystemExit("no CUDA device is available to torch")
from dpcorr_torch.utils.device import card_line
major, minor = torch.cuda.get_device_capability(0)
print(json.dumps({"platform": "cuda", "device": torch.cuda.get_device_name(0),
                  "capability": f"{major}.{minor}", "card": card_line(),
                  "count": torch.cuda.device_count()}))
"""


def probe_device(timeout_s: float = 120.0) -> dict:
    """Initialise CUDA in a throwaway process GROUP with a hard timeout,
    and reap the whole group on every exit path, so a hung CUDA
    initialisation can hold neither this process nor the card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    p = subprocess.Popen([sys.executable, "-c", _PROBE],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, start_new_session=True, env=env)
    try:
        out, err = p.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": f"timeout after {timeout_s:.0f}s"}
    finally:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        if p.poll() is None:
            p.wait()
    if p.returncode != 0:
        return {"ok": False, "error": (err or "")[-300:]}
    try:
        return {"ok": True, **json.loads(out.strip().splitlines()[-1])}
    except (ValueError, IndexError):
        return {"ok": False, "error": f"unparseable: {out[-200:]!r}"}


def diagnose(probe: bool = False, sweep: bool = False) -> dict:
    """The whole report; ``verdict`` is its one-word triage."""
    cards = check_cards()
    strays = find_strays() if cards["available"] else []
    report = {
        "cards": cards,
        "nvcc": check_nvcc(),
        "compile_cache": check_build_cache(),
        "stray_workers": strays,
    }
    remaining = list(strays)
    if sweep:
        report["swept"] = sweep_strays(strays) if strays else []
        remaining = [s for s in strays
                     if s["pid"] not in set(report["swept"])]
    if probe:
        report["device_probe"] = (
            probe_device() if cards["available"] else
            {"ok": False, "skipped": "no card visible to nvidia-smi"})
    if not cards["available"]:
        report["verdict"] = ("no-card (nvidia-smi shows no CUDA device; "
                             "CPU work only, with --device cpu)")
    elif remaining:
        report["verdict"] = ("stray-client (run --sweep, then re-probe)"
                             if not sweep else
                             "stray-client-unkillable (sweep could not "
                             "remove pids %s)" % [s["pid"]
                                                  for s in remaining])
    elif probe and not report["device_probe"].get("ok"):
        report["verdict"] = "device-probe-failed (the card does not answer)"
    elif not report["nvcc"]["found"] or not report["nvcc"].get("sm_90a"):
        report["verdict"] = ("no-nvcc (K1 is built from source for sm_90a "
                             "and cannot be built here)")
    else:
        report["verdict"] = ("ok" if probe else
                             "ok (card visible; --probe to confirm it)")
    return report


def render_text(report: dict) -> str:
    lines = []
    c = report["cards"]
    lines.append("cards          : " + (
        "; ".join(c["cards"]) if c["available"]
        else f"none ({c.get('error', 'nvidia-smi lists no card')})"))
    n = report["nvcc"]
    lines.append("nvcc           : " + (
        f"{n['path']} ({n.get('version', '?')}; sm_90a "
        f"{'yes' if n.get('sm_90a') else 'NO'})" if n["found"]
        else f"not found ({n.get('error', '?')})"))
    b = report["compile_cache"]
    if b["present"]:
        cur = ", ".join(f"{k} {'current' if v else 'not built'}"
                        for k, v in sorted(b["current"].items()))
        lines.append(f"build cache    : {len(b['libraries'])} libraries, "
                     f"{b['logs']} logs, {b['bytes'] / 1e6:.1f} MB at "
                     f"{b['path']}; {cur}; stale {len(b['stale'])}")
    else:
        lines.append(f"build cache    : absent ({b['path']}; built at "
                     f"first use)")
    s = report["stray_workers"]
    lines.append(f"stray clients  : {len(s)}" + (
        " -> " + ", ".join(str(x["pid"]) for x in s) if s else ""))
    if "swept" in report:
        lines.append(f"swept          : {report['swept']}")
    if "device_probe" in report:
        p = report["device_probe"]
        lines.append("device probe   : " + (
            f"ok — {p['card']} (compute {p['capability']})" if p.get("ok")
            else f"skipped — {p['skipped']}" if "skipped" in p
            else f"FAILED — {p.get('error', '?')}"))
    lines.append(f"verdict        : {report['verdict']}")
    return "\n".join(lines)
