"""K1's stage ladder on the card: probe each level, stop at the first fault.

Counterpart of ``benchmarks/pallas_bisect.py`` (its interface and its
orchestrator's protocol; the port keeps its own copy of the level names
and settings and imports nothing of that script). The ladder builds the
fused kernel K1 up one stage per level:

    L1  prng       K1's Philox words, summed as int32
    L2  boxmuller  + the 23-bit uniforms and Box–Muller
    L3  genmask    + the pair x, y and the position weights
    L4  center     + the clip and the DP centering, planes in shared memory
                   where they fit (drawn again in the sweep above that)
    L5  matmul     + the signs of batch elements, summed per batch
    L6  full       K1 itself (``ni_sign_fused``), b = 8
    L7  fullbig    K1, b = 4096

L1-L5 launch the ladder kernel (``ops/ladder.py`` →
``csrc/fused_ni_ladder.cu``); L6-L7 launch K1 (``ops/fused_ni.py``).

Orchestrator protocol: a health check in a fresh process (a 256×256
product on the device), then each level in its own process group under a
hard timeout, killed as a group on timeout with its partial output kept;
STOP at the first timeout or error, with a health check after it. The
report (``probes``, ``culprit``, ``wedged``) goes to ``--out``, by default
``dpcorr_torch/_build/bisect.json``.

Run from the repository root:

    python -m dpcorr_torch.bisect                  (orchestrator, the card)
    python -m dpcorr_torch.bisect --level matmul   (one probe, in process)
    python -m dpcorr_torch.bisect --device cpu     (the plain versions)

``--device cpu`` runs each level's plain version on the in-kernel draws
laid out by ``ladder.philox_bits`` and ``fused_ni.philox_uniforms``, the
counterpart of the script's ``DPCORR_BISECT_INTERPRET``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
DEFAULT_OUT = _PKG / "_build" / "bisect.json"

EPS1, EPS2, RHO = 1.0, 1.0, 0.5
LEVELS = ["prng", "boxmuller", "genmask", "center", "matmul", "full",
          "fullbig"]
#: replications of each level's probe (the script's b)
PROBE_B = {"fullbig": 4096}
PROBE_B_DEFAULT = 8
#: replications the plain K1 takes at a time on the CPU (L7's 4096 at
#: once would hold ~1 GB of int64 Philox words at n = 10⁴)
CPU_CHUNK = 512

HEALTH_TIMEOUT = 240.0
PROBE_TIMEOUT = 330.0


def default_n() -> int:
    """``DPCORR_BISECT_N``, else 10,000, as the script reads it."""
    return int(os.environ.get("DPCORR_BISECT_N", 10_000))


# --------------------------------------------------------------------------
# Probe worker: build (cached), launch and check ONE level in this process.
# --------------------------------------------------------------------------

def _seeds(b: int, device):
    import torch

    return torch.stack([torch.arange(b, dtype=torch.int32),
                        torch.zeros(b, dtype=torch.int32)], 1).to(device)


def _k1(seeds, n: int, device) -> tuple:
    """K1's NI (ρ̂, CI low, CI high) on these seeds: the kernel on the
    card, the plain version on the kernel's draws (``philox_uniforms``)
    on the CPU, a chunk of replications at a time."""
    import torch

    from dpcorr_torch.ops import fused_ni

    if device.type != "cpu":
        return fused_ni.ni_sign_fused(seeds, RHO, n, EPS1, EPS2,
                                      device=device)[:3]
    parts = []
    for s in torch.split(seeds, CPU_CHUNK):
        u = fused_ni.philox_uniforms(s, n, EPS1, EPS2)
        parts.append(fused_ni.ni_sign_fused(s, RHO, n, EPS1, EPS2,
                                            uniforms=u, device=device)[:3])
    return tuple(torch.cat(f) for f in zip(*parts))


def probe_level(level: str, n: int | None = None,
                device: str = "cuda") -> dict:
    """One ladder level: build (cached), launch once, check that the
    values are finite. The script's keys (``level``, ``ok``, ``finite``,
    ``secs``, ``sample`` or ``mean_rho_hat``) plus ``device``,
    ``launches`` (of the level's kernel in this probe's run) and, on the
    card, ``ms`` (one launch by CUDA events)."""
    import torch

    from dpcorr_torch.ops import fused_ni, ladder
    from dpcorr_torch.utils.device import resolve_device, time_cuda

    n = default_n() if n is None else n
    dev = resolve_device(device)
    t0 = time.perf_counter()
    b = PROBE_B.get(level, PROBE_B_DEFAULT)
    seeds = _seeds(b, dev)
    want = LEVELS.index(level) + 1
    counts = (ladder.KERNEL_LAUNCHES if want <= 5
              else fused_ni.KERNEL_LAUNCHES)
    name = "fused_ni_ladder" if want <= 5 else "fused_ni"
    before = counts[name]
    if want <= 5:
        bits = (ladder.philox_bits(seeds, n, EPS1, EPS2)
                if dev.type == "cpu" else None)

        def run():
            return ladder.ladder_sums(seeds, RHO, n, EPS1, EPS2, want, bits)

        vals = run()
        finite = bool(torch.isfinite(vals).all())
        result = {"sample": round(float(vals[0]), 3)}
    else:
        def run():
            return _k1(seeds, n, dev)

        rho_hat, lo, hi = run()
        finite = bool(torch.isfinite(rho_hat).all()
                      & torch.isfinite(lo).all() & torch.isfinite(hi).all())
        result = {"mean_rho_hat": round(float(rho_hat.mean()), 4)}
    launches = counts[name] - before
    out = {"level": level, "ok": True, "finite": finite,
           "secs": round(time.perf_counter() - t0, 1), **result,
           "device": str(dev), "launches": launches}
    if dev.type == "cuda":
        out["ms"] = time_cuda(run, 5)
    return out


# --------------------------------------------------------------------------
# Orchestrator
# --------------------------------------------------------------------------

def _run(cmd: list[str], timeout_s: float, env: dict | None = None):
    """Run cmd in its own process group; kill the whole group on timeout.
    Returns (rc | None-on-timeout, stdout, stderr, elapsed).

    The group also dies with the orchestrator: a probe orphaned by a
    SIGTERM or ctrl-C would go on holding the card."""
    t0 = time.time()
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True, env=env)
    try:
        try:
            so, se = p.communicate(timeout=timeout_s)
            return p.returncode, so, se, time.time() - t0
        except subprocess.TimeoutExpired:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            # drain what the probe printed before the kill: the hanging
            # probe is the one whose partial output matters
            so, se = p.communicate()
            return None, so or "", se or "", time.time() - t0
    finally:
        if p.poll() is None:  # abnormal exit path (signal, bug): reap
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            except PermissionError:
                p.kill()
            try:  # bounded: an unkillable probe must not hang shutdown
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass


def _env() -> dict:
    """The probes' environment: this checkout first on the import path."""
    env = dict(os.environ)
    root = str(_PKG.parent)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    return env


def health_check(device: str) -> tuple[bool, float, str]:
    """A 256×256 product on the device in a fresh process: (ok, seconds,
    what it printed)."""
    where = "cuda:0" if device == "cuda" else device
    code = ("import torch; "
            f"x = torch.ones((256, 256), device={where!r}); "
            "name = (torch.cuda.get_device_name(0) if x.is_cuda "
            "else str(x.device)); "
            "print('HEALTH-OK', float((x @ x).sum()), name)")
    rc, so, _, dt = _run([sys.executable, "-c", code], HEALTH_TIMEOUT,
                         _env())
    ok = rc == 0 and "HEALTH-OK" in so
    return ok, dt, so.strip().splitlines()[-1] if so.strip() else ""


def _tail(text: str) -> str:
    return " | ".join((text or "").strip().splitlines()[-3:])[:400]


def orchestrate(start: str = "prng", n: int | None = None,
                device: str = "cuda", out: Path | str = DEFAULT_OUT,
                log=print) -> dict:
    """Health check, then each level from ``start`` in its own process
    group; STOP at the first timeout or error. Writes and returns the
    report."""
    n = default_n() if n is None else n
    report = {"config": {"n": n, "eps1": EPS1, "eps2": EPS2,
                         "device": device},
              "probes": [], "culprit": None, "wedged": False}
    ok, dt, said = health_check(device)
    log(f"initial health: {'OK' if ok else 'FAILED'} ({dt:.0f}s) {said}")
    report["initial_health_s"] = round(dt, 1)
    report["health"] = said
    if not ok:
        report["wedged"] = True
        _write(report, out, log)
        return report

    for level in LEVELS[LEVELS.index(start):]:
        log(f"probe {level} ...")
        rc, so, se, dt = _run(
            [sys.executable, "-m", "dpcorr_torch.bisect", "--level", level,
             "--n", str(n), "--device", device], PROBE_TIMEOUT, _env())
        entry = {"level": level, "elapsed_s": round(dt, 1)}
        if rc is None:
            entry["result"] = "TIMEOUT (killed)"
            if se.strip():
                entry["stderr_tail"] = _tail(se)
        elif rc != 0:
            entry["result"] = "ERROR"
            entry["stderr_tail"] = _tail(se)
        else:
            for line in reversed((so or "").strip().splitlines()):
                try:
                    entry["result"] = json.loads(line)
                    break
                except json.JSONDecodeError:
                    continue
            else:
                entry["result"] = "NO-JSON"
        report["probes"].append(entry)
        log(f"  -> {entry['result']}")

        if rc != 0:  # timeout or error: the culprit; check health, stop
            report["culprit"] = level
            ok, dt, _ = health_check(device)
            report["post_hang_health"] = {"ok": ok, "secs": round(dt, 1)}
            log(f"post-hang health: {'OK' if ok else 'WEDGED'} ({dt:.0f}s)")
            if not ok:
                report["wedged"] = True
            break
    _write(report, out, log)
    return report


def _write(report: dict, out, log) -> None:
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    log(f"wrote {out}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dpcorr_torch.bisect",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--level", choices=LEVELS)
    ap.add_argument("--start", default="prng", choices=LEVELS,
                    help="first ladder level to probe (skip known-good)")
    ap.add_argument("--n", type=int, default=None,
                    help="observations per replication (default "
                         "DPCORR_BISECT_N or 10000)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    if args.level:
        # probe worker: keep SIG_DFL, so a probe stuck in a native build or
        # launch stays killable by SIGTERM
        print(json.dumps(probe_level(args.level, args.n, args.device)),
              flush=True)
        return 0

    # orchestrator only: SIGTERM must run _run's finally, so a killed
    # bisect cannot strand a probe holding the card (latched against a
    # second delivery)
    def _sigterm_to_exit(signum, frame):
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, _sigterm_to_exit)
    orchestrate(args.start, args.n, args.device, args.out,
                log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
