"""Command-line entry points: ``python -m dpcorr_torch <command>``.

Counterpart of the simulation commands of ``python -m dpcorr``:

- ``demo``        single-design-point Gaussian demo (vert-cor.R:449-466)
- ``demo-subg``   sub-Gaussian single point (ver-cor-subG.R:224-233)
- ``grid``        v1 Gaussian sign grid + summaries (vert-cor.R:486-597)
- ``grid-subg``   v2 bounded-factor sub-Gaussian grid (ver-cor-subG.R:245-335)
- ``hrs``         HRS point estimates (real-data-sims.R:259-333)
- ``hrs-sweep``   HRS ε-sweep (real-data-sims.R:342-448), tables only
- ``stress``      stress-scale streaming run (BASELINE.md config 5)
- ``acceptance``  the B ≥ 10⁶ coverage campaign (``dpcorr_torch.acceptance``)
- ``report``      the paper's figures from the tables a finished ``--out``
  directory holds (``dpcorr_torch.report``)
- ``serve``       the online DP-correlation server: micro-batched queries
  behind a per-party ε ledger, over HTTP (``dpcorr_torch.serve``)

Every command but ``report`` runs on the card (``--device cuda``, the
default) and raises without one unless ``--device cpu`` is given. Grids
persist per-design-point ``.npz`` caches and the merged tables
(``detail_all.npz``, ``summ_all.npz``, ``detail_all.rds``) into
``--out`` and resume from them; they draw no figures (``report --from
DIR`` draws them where matplotlib is installed). ``--n-hosts k`` fans a
grid out over k worker processes (``dpcorr_torch.parallel.multihost``),
``--distributed`` makes them a gloo group. The HRS commands read the
panel at ``dpcorr_torch.hrs.DEFAULT_PANEL`` and raise when it is not
there; ``hrs-sweep --out`` writes ``hrs_sweep_runs.npz``,
``hrs_sweep_summary.npz`` and ``hrs_sweep.json`` (its non-private ρ).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _device(args):
    """The run's device: the card unless ``--device cpu``; raises when
    there is no card and the CPU was not asked for."""
    from dpcorr_torch.utils.device import resolve_device

    return resolve_device(None if args.device == "cuda" else args.device)


def _add_common(p, backends=("local",)):
    """Shared flags. ``backends`` lists only the execution backends the
    subcommand implements."""
    p.add_argument("--out", default=None, help="output directory")
    p.add_argument("--b", type=int, default=None, help="MC replications")
    p.add_argument("--seed", type=int, default=2025)
    p.add_argument("--backend", default=backends[0], choices=list(backends))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run: the card (default; raises without "
                        "one) or the CPU")


def cmd_demo(args):
    from dpcorr_torch.sim import SimConfig, run_sim_one

    cfg = SimConfig(n=2000, rho=-0.95, eps1=0.5, eps2=1.0,
                    b=args.b or 1000, seed=args.seed,
                    dgp="gaussian", dgp_args={"mu": (2.0, 2.0),
                                              "sigma": (2.0, 0.1)})
    t0 = time.perf_counter()
    res = run_sim_one(cfg, device=_device(args))
    # the config echo is the full design point, as the JAX package prints
    # it: tests pin it against vert-cor.R:449-458
    print(json.dumps({"config": {"n": cfg.n, "rho": cfg.rho,
                                 "eps": [cfg.eps1, cfg.eps2], "B": cfg.b,
                                 "dgp": cfg.dgp,
                                 "dgp_args": {k: list(v) for k, v in
                                              dict(cfg.dgp_args).items()},
                                 "normalise": cfg.normalise,
                                 "seed": cfg.seed},
                      "summary": res.summary,
                      "seconds": round(time.perf_counter() - t0, 2)},
                     indent=2))


def cmd_demo_subg(args):
    from dpcorr_torch.sim import SimConfig, run_sim_one

    cfg = SimConfig(n=5500, rho=0.6, eps1=5.0, eps2=1.0, b=args.b or 500,
                    seed=args.seed, dgp="bounded_factor", use_subg=True)
    res = run_sim_one(cfg, device=_device(args))
    print(json.dumps({"config": {"n": cfg.n, "rho": cfg.rho,
                                 "eps": [cfg.eps1, cfg.eps2], "B": cfg.b},
                      "summary": res.summary}, indent=2))


def _format_table(table: dict) -> str:
    """A dict of numpy columns as aligned text, floats to 4 places."""
    cols = list(table)
    cells = [[f"{v:.4f}" if isinstance(v, (float, np.floating)) else str(v)
              for v in table[c]] for c in cols]
    widths = [max([len(c)] + [len(x) for x in cs])
              for c, cs in zip(cols, cells)]
    lines = [" ".join(c.rjust(w) for c, w in zip(cols, widths))]
    for row in zip(*cells):
        lines.append(" ".join(x.rjust(w) for x, w in zip(row, widths)))
    return "\n".join(lines)


def _grid_devices(args, dev):
    """The sharded backends' devices: ``--local-devices`` CPU entries
    under ``--device cpu``; on the card every visible card, and
    ``--local-devices`` must name that count."""
    import torch

    from dpcorr_torch.parallel.mesh import rep_devices

    if args.local_devices is not None and dev.type == "cuda" and \
            args.local_devices != torch.cuda.device_count():
        raise ValueError(f"--local-devices {args.local_devices} differs "
                         f"from the {torch.cuda.device_count()} visible "
                         f"cards; it sets the CPU device list's width")
    if "sharded" not in args.backend:
        return None
    return rep_devices(args.local_devices, device=dev)


def _run_grid(args, gcfg):
    """One grid run through ``run_grid``, or with ``--n-hosts`` > 1
    through ``run_grid_multihost``, the entry points the R seam uses."""
    from dpcorr_torch.grid import run_grid

    devices = _grid_devices(args, gcfg.device)
    t0 = time.perf_counter()
    if args.n_hosts > 1:
        from dpcorr_torch.parallel import run_grid_multihost

        res = run_grid_multihost(gcfg, n_hosts=args.n_hosts,
                                 distributed=args.distributed,
                                 local_device_count=args.local_devices)
    elif args.distributed:
        raise ValueError("--distributed needs --n-hosts >= 2")
    else:
        res = run_grid(gcfg, devices)
    dt = time.perf_counter() - t0
    reps = len(res.detail_all["repl"])
    print(f"grid: {reps} replicate rows in {dt:.1f}s "
          f"({reps / dt:.0f} reps/sec incl. build), backend "
          f"{gcfg.backend}, fused {gcfg.fused}")
    for h in res.hosts:
        print(f"host {h['host_id']}/{h['process_count']}: {h['points']} "
              f"points, K1 launches {h['launches']}, merged {h['merged']}")
    print(_format_table(res.summ_all))
    if gcfg.out_dir:
        print(f"tables: {gcfg.out_dir}/detail_all.npz, summ_all.npz, "
              f"detail_all.rds (no figures; draw them with report --from)")


def _grid_kwargs(args) -> dict:
    if args.n_hosts > 1 and not args.out:
        raise ValueError("--n-hosts needs --out: the workers share its "
                         "per-point cache")
    return dict(b=args.b or 250, seed=args.seed, backend=args.backend,
                fused=args.fused, bucket_merge=args.bucket_merge,
                out_dir=args.out, device=_device(args))


def cmd_grid(args):
    from dpcorr_torch.grid import GridConfig

    _run_grid(args, GridConfig(**_grid_kwargs(args)))


def cmd_grid_subg(args):
    from dpcorr_torch.grid import GridConfig

    _run_grid(args, GridConfig(
        n_grid=(2500, 4000, 6000, 9000, 12000),  # ver-cor-subG.R:245
        dgp="bounded_factor", use_subg=True, **_grid_kwargs(args)))


def cmd_hrs(args):
    from dpcorr_torch import hrs

    cfg = hrs.HrsConfig(panel_path=hrs.DEFAULT_PANEL, seed=args.seed)
    res = hrs.point_estimates(cfg, device=_device(args))
    print(json.dumps({
        "n": res.n,
        "private_moments": {
            "age": {"mean": res.std.age_mean, "sd": res.std.age_sd},
            "bmi": {"mean": res.std.bmi_mean, "sd": res.std.bmi_sd}},
        "lambda": {"age_z": res.std.lam_age, "bmi_z": res.std.lam_bmi},
        "rho_non_private": res.std.rho_np,
        "NI": res.ni, "INT_age_to_bmi": res.int_}, indent=2))


def cmd_hrs_sweep(args):
    from dpcorr_torch import hrs

    cfg = hrs.HrsConfig(panel_path=hrs.DEFAULT_PANEL, seed=args.seed)
    sweep = hrs.eps_sweep(cfg, reps=args.b or 200, progress=True,
                          device=_device(args))
    print(_format_table(sweep.summary))
    if args.out:
        from dpcorr_torch.report import write_hrs_tables

        paths = write_hrs_tables(args.out, sweep)
        print(f"tables: {', '.join(str(p) for p in paths)} (no figures; "
              f"draw them with report --from)")


def cmd_stress(args):
    """Stress-scale run (BASELINE.md config 5 shape): the streaming
    n-blocked estimators; prints reps/sec."""
    from dpcorr_torch.sim import SimConfig, run_sim_one, stress_chunk_size

    dev = _device(args)
    b = args.b or 256
    chunk = args.chunk_size or stress_chunk_size(b, on_card=dev.type
                                                 == "cuda")
    cfg = SimConfig(
        n=args.n, rho=0.5, eps1=1.0, eps2=1.0, b=b,
        dgp="bounded_factor" if args.family == "subg" else "gaussian",
        use_subg=args.family == "subg",
        stream_n_chunk=args.n_chunk,
        chunk_size=chunk)
    t0 = time.perf_counter()
    if args.backend == "sharded":
        from dpcorr_torch.parallel import run_summary_sharded

        summary = run_summary_sharded(cfg, device=dev)
    else:
        summary = run_sim_one(cfg, device=dev).summary
    dt = time.perf_counter() - t0
    print(json.dumps({
        "n": cfg.n, "b": cfg.b, "family": args.family,
        "stream_n_chunk": cfg.stream_n_chunk,
        "seconds": round(dt, 2),
        "reps_per_sec_incl_compile": round(cfg.b / dt, 2),
        "summary": summary}, indent=2))


def cmd_acceptance(args):
    """B ≥ 10⁶ coverage campaign at the BASELINE 1e-3 criterion
    (vert-cor.R:687 oracle; see dpcorr_torch.acceptance)."""
    from dpcorr_torch import acceptance

    table = acceptance.run_campaign(b=args.b or 1_000_000,
                                    out=args.out_json, device=_device(args))
    print(acceptance.dumps(table))


def cmd_report(args):
    """The paper's figures from a finished ``--out`` directory's tables,
    with the JAX command's file names (host only; needs matplotlib)."""
    from dpcorr_torch.report import render_from

    paths = render_from(args.src, family=args.family)
    print("figures:", *(str(p) for p in paths))


def cmd_serve(args):
    """Online serving (counterpart of ``python -m dpcorr serve``): binds
    first, so ``--port 0`` resolves before the server is built, prints
    the ``{"serving": …}`` banner and serves until interrupted."""
    import signal
    import socket

    from dpcorr_torch import chaos
    from dpcorr_torch.obs import trace as obs_trace
    from dpcorr_torch.obs.recorder import FlightRecorder
    from dpcorr_torch.serve.server import DpcorrServer, make_http_server

    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((args.host, args.port))
    sock.listen(128)
    bound_port = sock.getsockname()[1]
    if args.instance is None:
        args.instance = f"serve-{bound_port}"
    subst = {"instance": args.instance, "port": str(bound_port)}
    for attr in ("trace", "audit", "flight_recorder", "ledger",
                 "warmup_manifest"):
        val = getattr(args, attr)
        if val:
            for k, v in subst.items():
                val = val.replace("{%s}" % k, v)
            setattr(args, attr, val)
    if args.trace:
        obs_trace.configure(args.trace)
    for spec in args.fault or ():
        # chaos faults at boot (testing only): drilling the breaker and
        # brownout on a replica
        chaos.install_fault(chaos.fault_from_spec(spec))
    rec = None
    if args.flight_recorder:
        # the handler goes in before the server build, so a USR2 during
        # the build dumps empty rings instead of killing the process
        rec = FlightRecorder(args.flight_recorder)
        signal.signal(signal.SIGUSR2,
                      lambda signum, frame: rec.dump("sigusr2"))
    server = DpcorrServer(
        budget=args.budget, ledger_path=args.ledger, seed=args.seed,
        max_batch=args.max_batch, max_delay_s=args.max_delay_ms / 1000.0,
        max_queue=args.max_queue, shard=args.shard,
        batch_mode=args.batch_mode, max_kernels=args.max_kernels,
        audit=args.audit, warmup=args.warmup,
        warmup_manifest=args.warmup_manifest,
        breaker_threshold=args.breaker_threshold,
        breaker_reset_s=args.breaker_reset_s,
        shed_queue_frac=args.shed_queue_frac,
        flush_slo_s=(args.flush_slo_ms / 1000.0
                     if args.flush_slo_ms is not None else None),
        brownout_enter_s=args.brownout_enter_s,
        brownout_exit_s=args.brownout_exit_s,
        brownout_min_priority=args.brownout_min_priority,
        instance=args.instance, device=_device(args))
    if rec is not None:
        server.attach_recorder(rec)
    httpd = make_http_server(server, host=args.host, port=args.port,
                             sock=sock)
    print(json.dumps({"serving": {
        "host": args.host, "port": bound_port, "instance": args.instance,
        "device": str(server.device), "budget": args.budget,
        "ledger": args.ledger, "max_batch": args.max_batch,
        "max_delay_ms": args.max_delay_ms, "batch_mode": args.batch_mode,
        "trace": args.trace, "audit": args.audit,
        "warmup": server.readiness(),
        "warmup_manifest": args.warmup_manifest,
        "flight_recorder": args.flight_recorder,
        "breaker": {"threshold": args.breaker_threshold,
                    "reset_s": args.breaker_reset_s},
        "brownout": {"queue_frac": args.shed_queue_frac,
                     "flush_slo_ms": args.flush_slo_ms,
                     "enter_s": args.brownout_enter_s,
                     "exit_s": args.brownout_exit_s,
                     "min_priority": args.brownout_min_priority},
        "faults": args.fault}}), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()


def _add_serve(sub) -> None:
    p = sub.add_parser("serve", help="online micro-batched DP-correlation "
                       "service with a per-party privacy-budget ledger")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run: the card (default; raises without "
                        "one) or the CPU")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8321,
                   help="HTTP port (0 = ephemeral; the bound port is "
                        "printed in the banner line)")
    p.add_argument("--instance", default=None,
                   help="instance name labelling /stats and /metrics "
                        "(default serve-<port>)")
    p.add_argument("--budget", type=float, default=100.0,
                   help="default per-party ε budget (basic composition)")
    p.add_argument("--ledger", default=None,
                   help="ledger persistence path (JSON, the JAX package's "
                        "format); restarts resume the spend table")
    p.add_argument("--max-batch", dest="max_batch", type=int, default=64,
                   help="flush a bucket at this many live requests")
    p.add_argument("--max-delay-ms", dest="max_delay_ms", type=float,
                   default=5.0,
                   help="flush a bucket once its oldest request has "
                        "waited this long")
    p.add_argument("--max-queue", dest="max_queue", type=int, default=4096,
                   help="backpressure: refuse admissions beyond this many "
                        "pending requests")
    p.add_argument("--shard", default="auto", choices=["auto", "off"],
                   help="shard wide flushes over the visible cards")
    p.add_argument("--batch-mode", dest="batch_mode", default="exact",
                   choices=["exact", "vector"],
                   help="batch engine: 'exact' (lane by lane; bit-equal "
                        "to direct calls) or 'vector' (one call over the "
                        "lanes; estimators.registry states its contract)")
    p.add_argument("--max-kernels", dest="max_kernels", type=int,
                   default=128, help="LRU cap on live kernel-cache entries")
    p.add_argument("--seed", type=int, default=2025)
    p.add_argument("--trace", default=None,
                   help="span JSONL path (also DPCORR_TRACE)")
    p.add_argument("--audit", default=None,
                   help="privacy-budget audit-trail JSONL path")
    p.add_argument("--warmup", default=None,
                   help="warm signature spec, entries "
                        "family:n:eps1:eps2[:bpads[:alpha[:normalise]]] "
                        "separated by ';' (bpads: comma list or 'auto' = "
                        "every pow2 up to --max-batch), built in the "
                        "background behind GET /readyz")
    p.add_argument("--warmup-manifest", dest="warmup_manifest",
                   default=None,
                   help="kernel-manifest JSON path: replayed as warmup on "
                        "boot, rewritten with the resident set on shutdown")
    p.add_argument("--breaker-threshold", dest="breaker_threshold",
                   type=int, default=5,
                   help="circuit breaker: consecutive kernel failures in "
                        "one bucket before it opens")
    p.add_argument("--breaker-reset-s", dest="breaker_reset_s",
                   type=float, default=30.0,
                   help="circuit breaker: cooldown before an open bucket "
                        "admits one half-open probe")
    p.add_argument("--shed-queue-frac", dest="shed_queue_frac",
                   type=float, default=0.75,
                   help="brownout: queue fraction counted as pressure")
    p.add_argument("--flush-slo-ms", dest="flush_slo_ms", type=float,
                   default=None,
                   help="brownout: flush-latency EWMA above this also "
                        "counts as pressure (default: queue-only)")
    p.add_argument("--brownout-enter-s", dest="brownout_enter_s",
                   type=float, default=0.5,
                   help="brownout: sustained-pressure seconds before "
                        "entering")
    p.add_argument("--brownout-exit-s", dest="brownout_exit_s",
                   type=float, default=2.0,
                   help="brownout: calm seconds before exiting")
    p.add_argument("--brownout-min-priority", dest="brownout_min_priority",
                   type=int, default=0,
                   help="brownout: reject requests below this priority "
                        "while active")
    p.add_argument("--fault", action="append", default=None,
                   metavar="SPEC",
                   help="install a chaos fault before serving, e.g. "
                        "'point=serve.kernel,mode=fail,times=3' "
                        "(repeatable; testing only)")
    p.add_argument("--flight-recorder", dest="flight_recorder",
                   default=None, metavar="PATH",
                   help="flight-recorder dump path: recent spans, audit "
                        "events, logs and metrics, dumped on chaos "
                        "crashes, breaker trips, brownout transitions and "
                        "SIGUSR2")
    p.set_defaults(fn=cmd_serve)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dpcorr_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    from dpcorr_torch.grid import BACKENDS

    backends_by_cmd = {"grid": BACKENDS, "grid-subg": BACKENDS,
                       "stress": ("local", "sharded")}
    for name, fn in [("demo", cmd_demo), ("demo-subg", cmd_demo_subg),
                     ("grid", cmd_grid), ("grid-subg", cmd_grid_subg),
                     ("hrs", cmd_hrs), ("hrs-sweep", cmd_hrs_sweep),
                     ("stress", cmd_stress), ("acceptance", cmd_acceptance)]:
        p = sub.add_parser(name)
        _add_common(p, backends_by_cmd.get(name, ("local",)))
        if name == "stress":
            p.add_argument("--n", type=int, default=1_000_000)
            p.add_argument("--n-chunk", dest="n_chunk", type=int,
                           default=65_536)
            p.add_argument("--family", choices=["sign", "subg"],
                           default="subg")
            p.add_argument("--chunk-size", dest="chunk_size", type=int,
                           default=None,
                           help="replications resident at once (default: "
                                "sim.stress_chunk_size)")
        if name == "acceptance":
            p.add_argument("--out-json", dest="out_json", default=None)
        if name in ("grid", "grid-subg"):
            p.add_argument("--n-hosts", dest="n_hosts", type=int, default=1,
                           help="fan the grid out over this many worker "
                                "processes (needs --out; see "
                                "dpcorr_torch.parallel.multihost)")
            p.add_argument("--distributed", action="store_true",
                           help="with --n-hosts: the workers form a "
                                "torch.distributed gloo group (rank and "
                                "size from the runtime, a barrier, rank-0 "
                                "merge)")
            p.add_argument("--local-devices", dest="local_devices",
                           type=int, default=None,
                           help="devices each process shards over for the "
                                "sharded backends: CPU entries under "
                                "--device cpu; on the card it must equal "
                                "the visible card count")
            p.add_argument("--fused", default="off", choices=["off", "auto"],
                           help="run eligible (n, eps) buckets through the "
                                "fused kernel (card + --backend bucketed "
                                "only; the Gaussian sign pair)")
            p.add_argument("--bucket-merge", dest="bucket_merge",
                           default="off", choices=["off", "eps"],
                           help="eps: merge subG buckets across eps pairs "
                                "(one call per n, eps per replication; "
                                "subG + --backend bucketed only)")
        p.set_defaults(fn=fn)
    p = sub.add_parser("report")
    p.add_argument("--from", dest="src", required=True,
                   help="a finished grid, grid-subg or hrs-sweep --out "
                        "directory; the figures are written there")
    p.add_argument("--family", choices=["v1", "subg"], default="v1",
                   help="the grid's figure family")
    p.set_defaults(fn=cmd_report)
    _add_serve(sub)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
