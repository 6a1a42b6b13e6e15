"""The grid over several worker processes (the JAX package's multi-host
fan-out, ``dpcorr/parallel/multihost.py``).

The design grid is embarrassingly parallel, as the reference's forked R
processes are (vert-cor.R:534-554): each worker runs a deterministic
slice of the grid into the shared per-point ``design_*.npz`` cache (the
one the single-process grid resumes from), and the merge re-runs the grid
with resume on, which by then loads every point. A worker owns whole
(n, ε) buckets, round-robin by bucket order, so a bucket stays one call
(one K1 launch when fused) and its keys are the single-process grid's
(``design_key(master, i)`` of the global index): the merged grid is
bit-equal to ``run_grid`` with the same knobs.

Workers are fresh processes (``python -m dpcorr_torch.parallel.multihost``,
the spec on stdin, one JSON report line on stdout), so several can share
one card. ``distributed=True`` makes them a ``torch.distributed`` group
(gloo, which needs no device of its own and allows two ranks on one
card): rank and size come from the runtime, a barrier closes the fan-out,
rank 0 merges. Each worker reports its own K1 launch count, which the
parent's counter cannot see.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from dpcorr_torch import grid as grid_mod
from dpcorr_torch.grid import GridConfig, GridResult, run_grid
from dpcorr_torch.parallel.mesh import rep_devices
from dpcorr_torch.utils import rng
from dpcorr_torch.utils.device import resolve_device

__all__ = ["grid_slice", "run_grid_host", "run_grid_multihost",
           "init_distributed", "run_grid_process"]

_REPO = Path(__file__).resolve().parents[2]


def grid_slice(design: dict, host_id: int, n_hosts: int) -> dict:
    """The design rows host ``host_id`` owns: whole (n, ε) buckets,
    round-robin by first appearance, rows in design-index order. Every
    host computes the same partition with no coordination."""
    if not 0 <= host_id < n_hosts:
        raise ValueError(f"host_id {host_id} not in [0, {n_hosts})")
    bucket = list(zip(design["n"].tolist(), design["eps1"].tolist(),
                      design["eps2"].tolist()))
    mine = set(list(dict.fromkeys(bucket))[host_id::n_hosts])
    take = np.flatnonzero([b in mine for b in bucket])
    take = take[np.argsort(design["i"][take], kind="stable")]
    return {c: v[take] for c, v in design.items()}


def run_grid_host(gcfg: GridConfig, host_id: int, n_hosts: int,
                  devices=None) -> int:
    """Run this host's slice into the shared cache at ``gcfg.out_dir``
    (the only channel between hosts) through the grid's own backend;
    returns the number of design points owned. A failed point or bucket
    raises, as ``run_grid`` does."""
    if not gcfg.out_dir:
        raise ValueError("multi-host execution needs a shared out_dir")
    grid_mod.validate_config(gcfg)
    mine = grid_slice(gcfg.design_points(), host_id, n_hosts)
    if not len(mine["i"]):
        return 0
    out_dir = Path(gcfg.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = resolve_device(gcfg.device)
    _, _, failures = grid_mod.run_rows(
        gcfg, grid_mod._rows(mine), rng.master_key(gcfg.seed, dev), out_dir,
        dev, devices)
    grid_mod._raise_if_failed(failures, len(mine["i"]))
    return len(mine["i"])


def init_distributed(init_method: str, world_size: int, rank: int) -> None:
    """Join a ``torch.distributed`` gloo group (``tcp://host:port``, the
    size and this process's rank given explicitly); a rank that waits
    longer than ten minutes for the others raises."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(minutes=10))


def run_grid_process(gcfg: GridConfig, devices=None) -> GridResult | None:
    """SPMD entry: every rank of an initialised group calls this with the
    same config. Host identity comes from the runtime, a barrier waits for
    every rank's cache writes, then rank 0 merges and returns the result
    (other ranks return None)."""
    import torch.distributed as dist

    host, n_hosts = dist.get_rank(), dist.get_world_size()
    run_grid_host(gcfg, host, n_hosts, devices)
    dist.barrier()  # the fan-out's one collective
    if host != 0:
        return None
    return run_grid(dataclasses.replace(gcfg, resume=True), devices)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spec(gcfg: GridConfig) -> dict:
    out = {f.name: getattr(gcfg, f.name) for f in dataclasses.fields(gcfg)}
    if out["device"] is not None:
        out["device"] = str(out["device"])
    out["dgp_args"] = dict(out["dgp_args"])
    return out


def _run_workers(gcfg: GridConfig, n_hosts: int, dist: dict | None,
                 local_devices: int | None):
    """Start every worker with its spec, then collect them: (errors,
    reports)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_REPO)] + [p for p in (env.get("PYTHONPATH") or "").split(
            os.pathsep) if p])
    # the workers share this host's cores: each gets its share of the
    # parent's threads (oversubscribed intra-op pools spin against each
    # other)
    threads = max(1, torch.get_num_threads() // n_hosts)
    procs = []
    for h in range(n_hosts):
        spec = {"host_id": h, "n_hosts": n_hosts, "gcfg": _spec(gcfg),
                "local_devices": local_devices, "threads": threads}
        if dist:
            spec["dist"] = {**dist, "rank": h}
        proc = subprocess.Popen(
            [sys.executable, "-m", "dpcorr_torch.parallel.multihost"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env)
        # deliver the spec now so the workers run together; drop the handle
        # so communicate() does not flush a closed file
        proc.stdin.write(json.dumps(spec))
        proc.stdin.close()
        proc.stdin = None
        procs.append(proc)
    # drain every worker's pipes at once: a rank blocked on a full pipe
    # would otherwise hold the others at the barrier
    with ThreadPoolExecutor(len(procs)) as pool:
        outs = list(pool.map(lambda p: p.communicate(), procs))
    errs, reports = [], []
    for h, (proc, (out, err)) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            tail = err.strip().splitlines()[-3:]
            errs.append(f"host {h}: rc={proc.returncode}: " + " | ".join(tail))
            continue
        for line in reversed(out.strip().splitlines()):
            try:
                rep = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rep, dict) and "host_id" in rep:
                reports.append(rep)
                break
    return errs, reports


def run_grid_multihost(gcfg: GridConfig, n_hosts: int = 2,
                       distributed: bool = False,
                       local_device_count: int | None = None) -> GridResult:
    """Fan the grid out over ``n_hosts`` worker processes, then assemble
    the merged result from the shared cache (cache hits only).

    Each worker runs on ``gcfg.device`` (the card unless the config names
    the CPU; several workers may share one card); ``local_device_count``
    is the width of each worker's device list for the sharded backends.
    ``distributed=True`` joins the workers into a gloo group
    (:func:`run_grid_process`). A failed worker fails the run. The
    result's ``hosts`` holds the workers' reports, each with its own K1
    launch count (``launches``) and the seconds of its grid work, the
    group's set-up, barrier and merge included (``seconds``)."""
    if not gcfg.out_dir:
        raise ValueError("multi-host execution needs a shared out_dir")
    grid_mod.validate_config(gcfg)
    resolve_device(gcfg.device)  # no card and no CPU asked for: raise here

    def attempt():
        dist = ({"init_method": f"tcp://127.0.0.1:{_free_port()}",
                 "world_size": n_hosts} if distributed else None)
        return _run_workers(gcfg, n_hosts, dist, local_device_count)

    errs, reports = attempt()
    if errs and distributed and any(w in e.lower() for e in errs
                                    for w in ("address", "bind")):
        # the free-port pick is check-then-use: another process can take
        # the port before rank 0's store binds it; one retry with a fresh
        # port, and a second failure is a real error
        errs, reports = attempt()
    if errs:
        raise RuntimeError(f"{len(errs)}/{n_hosts} hosts failed: "
                           + "; ".join(errs)[:800])
    if distributed:
        bad = [r for r in reports if r["process_count"] != n_hosts]
        merged = sum(r["merged"] for r in reports)
        if bad or merged > 1 or (merged == 0 and len(reports) == n_hosts):
            raise RuntimeError(f"distributed group inconsistent: {reports!r}")
    if len(reports) < n_hosts:
        # every worker exited 0, so its slice is in the cache; the merge
        # below reads the cache whatever the reports say
        warnings.warn(f"only {len(reports)}/{n_hosts} worker reports parsed "
                      "from stdout; trusting the merged cache instead",
                      RuntimeWarning, stacklevel=2)
    # cache hits only: the parent recomputes nothing, on any device list
    res = run_grid(dataclasses.replace(gcfg, resume=True))
    res.hosts = sorted(reports, key=lambda r: r["host_id"])
    return res


def _worker_main() -> None:
    from dpcorr_torch.ops import fused_ni

    spec = json.loads(sys.stdin.read())
    torch.set_num_threads(spec["threads"])
    gd = spec["gcfg"]
    # JSON gives lists where the config holds tuples
    gd["eps_pairs"] = tuple(tuple(p) for p in gd["eps_pairs"])
    for k in ("n_grid", "rho_grid"):
        gd[k] = tuple(gd[k])
    gcfg = GridConfig(**gd)
    devices = (rep_devices(spec["local_devices"], device=gcfg.device)
               if "sharded" in gcfg.backend else None)
    dist = spec.get("dist")
    host_id, n_hosts = spec["host_id"], spec["n_hosts"]
    t0 = time.perf_counter()
    if dist:
        import torch.distributed as tdist

        init_distributed(dist["init_method"], dist["world_size"],
                         dist["rank"])
        try:
            host_id, n_hosts = tdist.get_rank(), tdist.get_world_size()
            merged = run_grid_process(gcfg, devices) is not None
        finally:
            tdist.destroy_process_group()
    else:
        run_grid_host(gcfg, host_id, n_hosts, devices)
        merged = False
    print(json.dumps({
        "host_id": host_id, "process_count": n_hosts,
        "points": len(grid_slice(gcfg.design_points(), host_id,
                                 n_hosts)["i"]),
        "local_devices": len(devices) if devices else 1,
        "merged": merged, "launches": fused_ni.KERNEL_LAUNCHES["fused_ni"],
        "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    _worker_main()
