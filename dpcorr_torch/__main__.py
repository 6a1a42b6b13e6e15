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
- ``party``       one side of the two-party protocol over TCP
  (``dpcorr_torch.protocol``)
- ``protocol``    ``run``: both roles in one process; ``scan``: the
  transcript auditor
- ``federation``  ``plan | run | party | scan``: the N-party k×k matrix
- ``stream``      always-on windowed DP releases over an HTTP ingest
  stream (``dpcorr_torch.stream``)
- ``fleet``       ``front``: the HTTP router over running serve replicas;
  ``up``: N supervised serve replicas over one leased budget directory
  behind a front end (``dpcorr_torch.serve.fleet``)
- ``chaos``       the step-kill sweep: two party processes, the victim
  killed at each crash point and restarted, results bit-identical and ε
  spent once
- ``obs``         ``budget | chrome | dump``: audit-trail replay, span
  export and flight-recorder dumps; ``top``: the live console
  (``dpcorr_torch.obs.console``); ``provenance``: the federation's
  ε-provenance DAG (``dpcorr_torch.obs.provenance``); ``watch``: the
  invariant sentinel (``dpcorr_torch.obs.sentinel``); ``fleet snapshot |
  chrome | replay``: the fleet telemetry plane
  (``dpcorr_torch.obs.fleet``); ``geometry``: the autotuner's cache;
  ``hlo show | diff``: the JAX package's signature dumps;
  ``trajectory``: the bench-trajectory report
- ``doctor``      environment health triage (cards, ``nvcc``, the build
  cache, stray processes holding a card; ``--probe`` initialises CUDA in
  a subprocess)
- ``lint``        the AST-based privacy/RNG/concurrency invariant checker
  over the port's own source (``dpcorr_torch.analysis``); ``--deep`` adds
  the call-graph families, ``--witness DIR`` diffs runtime lock-order
  artifacts (``DPCORR_SYNCWATCH=1``) against the static lock model

Every command but ``report``, ``protocol scan``, ``federation plan``,
``federation scan``, ``fleet front``, ``obs``, ``doctor`` and ``lint``
(which compute nothing)
runs on the card (``--device cuda``, the default) and raises without one
unless ``--device cpu`` is given; ``fleet up`` and ``chaos`` pass their
``--device`` on to the processes they start. Grids
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
import sys
import time

import numpy as np

#: ``grid.BACKENDS``, named here so that building the parser imports no
#: torch (the torch-free commands run where torch is not installed;
#: tests/test_torch_cli.py holds the two equal)
GRID_BACKENDS = ("local", "sharded", "bucketed", "bucketed-sharded")


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
                precompile=args.precompile, out_dir=args.out,
                device=_device(args))


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
    n-blocked estimators; prints reps/sec and the run's streaming counters
    (n-chunks and rows streamed)."""
    from dpcorr_torch.models.estimators import streaming
    from dpcorr_torch.obs import transfer
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
    counters = streaming.default_counters()
    before = counters.snapshot()
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
        "counters": transfer.diff(counters.snapshot(), before),
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
    advertise_url = (f"http://{args.host}:{bound_port}"
                     if args.host not in ("0.0.0.0", "::")
                     else f"http://127.0.0.1:{bound_port}")
    server = DpcorrServer(
        budget=args.budget, ledger_path=args.ledger, seed=args.seed,
        max_batch=args.max_batch, max_delay_s=args.max_delay_ms / 1000.0,
        max_queue=args.max_queue, shard=args.shard,
        batch_mode=args.batch_mode, max_kernels=args.max_kernels,
        audit=args.audit, warmup=args.warmup,
        warmup_manifest=args.warmup_manifest, aot=args.aot == "on",
        breaker_threshold=args.breaker_threshold,
        breaker_reset_s=args.breaker_reset_s,
        shed_queue_frac=args.shed_queue_frac,
        flush_slo_s=(args.flush_slo_ms / 1000.0
                     if args.flush_slo_ms is not None else None),
        brownout_enter_s=args.brownout_enter_s,
        brownout_exit_s=args.brownout_exit_s,
        brownout_min_priority=args.brownout_min_priority,
        user_dir=args.user_dir, user_budget=args.user_budget,
        user_shards=args.user_shards,
        user_max_resident=args.user_max_resident,
        user_compact_every=args.user_compact_every,
        user_renew_period_s=args.user_renew_period_s,
        user_burst_cap=args.user_burst_cap,
        global_budget=args.global_budget,
        instance=args.instance, lease_dir=args.lease_dir,
        lease_ttl_s=args.lease_ttl_s, lease_target=args.lease_target,
        advertise_url=advertise_url, device=_device(args))
    if rec is not None:
        server.attach_recorder(rec)
    httpd = make_http_server(server, host=args.host, port=args.port,
                             sock=sock)
    print(json.dumps({"serving": {
        "host": args.host, "port": bound_port, "instance": args.instance,
        "lease_dir": args.lease_dir, "advertise_url": advertise_url,
        "device": str(server.device), "budget": args.budget,
        "ledger": args.ledger, "max_batch": args.max_batch,
        "max_delay_ms": args.max_delay_ms, "batch_mode": args.batch_mode,
        "trace": args.trace, "audit": args.audit,
        "user_dir": args.user_dir, "user_budget": args.user_budget,
        "global_budget": args.global_budget,
        "warmup": server.readiness(),
        "warmup_manifest": args.warmup_manifest, "aot": args.aot,
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
    p.add_argument("--user-dir", dest="user_dir", default=None,
                   help="per-user budget directory root (sharded WAL + "
                        "snapshot store, the JAX package's format): "
                        "enables per-user admission for requests carrying "
                        "'user'; restarts recover exact balances")
    p.add_argument("--user-budget", dest="user_budget", type=float,
                   default=1.0,
                   help="per-user ε budget per renewal window")
    p.add_argument("--user-shards", dest="user_shards", type=int,
                   default=8,
                   help="directory shard count (pinned in meta.json on "
                        "first boot; reopens adopt the persisted count)")
    p.add_argument("--user-max-resident", dest="user_max_resident",
                   type=int, default=None,
                   help="LRU cap on in-memory users per shard; colder "
                        "users spill to disk and rehydrate on touch "
                        "(default: unbounded)")
    p.add_argument("--user-compact-every", dest="user_compact_every",
                   type=int, default=256,
                   help="fold the shard WAL into its snapshot every this "
                        "many journal appends")
    p.add_argument("--user-renew-period-s", dest="user_renew_period_s",
                   type=float, default=86400.0,
                   help="per-user window length: spend resets every "
                        "period (daily ε refresh by default)")
    p.add_argument("--user-burst-cap", dest="user_burst_cap",
                   type=float, default=0.0,
                   help="unspent window ε carried into the next window "
                        "as burst credit, capped here (0 disables)")
    p.add_argument("--global-budget", dest="global_budget", type=float,
                   default=None,
                   help="whole-replica ε ceiling, charged atomically with "
                        "the per-party legs (reserved principal "
                        "global/total)")
    p.add_argument("--lease-dir", dest="lease_dir", default=None,
                   help="fleet mode (requires --user-dir): shard-lease "
                        "directory SHARED by all replicas of one budget "
                        "directory; each shard's journal is only ever "
                        "written by the replica holding its lease")
    p.add_argument("--lease-ttl-s", dest="lease_ttl_s", type=float,
                   default=3.0,
                   help="lease validity window; a silent replica loses "
                        "its shards this long after its last heartbeat")
    p.add_argument("--lease-target", dest="lease_target", type=int,
                   default=None,
                   help="cap on proactively acquired shards (fleet up "
                        "passes ceil(shards/replicas) so the first "
                        "replica up does not hoard the ring); orphaned "
                        "shards are rescued regardless")
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
    p.add_argument("--aot", default="on", choices=["on", "off"],
                   help="build kernel-cache entries ahead of their first "
                        "flush (utils.compile; warm signatures also run "
                        "once before /readyz turns 200); 'off' builds lazy "
                        "units on first flush (A/B measurement)")
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


# --------------------------------------------------------------- fleet
def _child_env(drop_chaos: bool = False) -> dict:
    """The environment of a process this CLI starts (``python -m
    dpcorr_torch ...``): this one's, with the package's root first on
    ``PYTHONPATH`` so the child imports the same package from any working
    directory; ``drop_chaos`` removes ``DPCORR_CHAOS``, so a restarted
    victim does not re-arm the kill it is recovering from."""
    import os

    import dpcorr_torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(
        dpcorr_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    if drop_chaos:
        env.pop("DPCORR_CHAOS", None)
    return env


def cmd_fleet(args):
    """The fleet's deployment plane (counterpart of ``python -m dpcorr
    fleet``): ``front`` routes over already-running replicas, ``up``
    boots and supervises N ``serve`` replicas on ``--device`` plus a
    front end in one command. A replica that cannot come up (no card and
    no ``--device cpu``) ends the command with the supervisor's
    ``ReplicaDiedError`` naming the replica and its log."""
    import math
    import os
    import threading

    from dpcorr_torch.serve.fleet.frontend import (
        FleetFrontend,
        make_frontend_http_server,
    )

    def _serve_front(fe, host, port, banner_extra):
        httpd = make_frontend_http_server(fe, host, port)
        bound = httpd.server_address[1]
        banner = {"host": host, "port": bound,
                  "lease_dir": args.lease_dir}
        banner.update(banner_extra)
        print(json.dumps({"fleet_front": banner}), flush=True)

        def _poll():
            while True:
                try:
                    fe.poll_ready()
                except Exception:
                    pass
                time.sleep(args.health_interval_s)

        threading.Thread(target=_poll, name="fleet-health",
                         daemon=True).start()
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.shutdown()

    if args.fleet_cmd == "front":
        replicas = {}
        for spec in args.replica:
            name, sep, url = spec.partition("=")
            if not sep or not url:
                raise SystemExit(f"--replica wants name=url, got {spec!r}")
            replicas[name] = url
        fe = FleetFrontend(replicas, lease_dir=args.lease_dir)
        _serve_front(fe, args.host, args.port,
                     {"replicas": dict(sorted(replicas.items()))})
        return

    # fleet up: boot N real serve replicas over one shared budget
    # directory + lease dir, supervise them, front them
    from dpcorr_torch.serve.fleet.supervisor import ReplicaSpec, Supervisor

    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    budget_root = os.path.join(workdir, "budget")
    lease_dir = os.path.join(workdir, "leases")
    args.lease_dir = lease_dir
    target = math.ceil(args.user_shards / args.replicas)
    env = _child_env()
    specs = []
    for i in range(args.replicas):
        name = f"r{i}"
        argv = [sys.executable, "-m", "dpcorr_torch", "serve",
                "--port", "0", "--instance", name,
                "--device", args.device,
                "--budget", str(args.budget),
                "--ledger", os.path.join(workdir, f"{name}_ledger.json"),
                "--audit", os.path.join(workdir, f"{name}_audit.jsonl"),
                "--user-dir", budget_root,
                "--user-shards", str(args.user_shards),
                "--user-budget", str(args.user_budget),
                "--lease-dir", lease_dir,
                "--lease-ttl-s", str(args.lease_ttl_s),
                "--lease-target", str(target),
                "--max-delay-ms", str(args.max_delay_ms)]
        specs.append(ReplicaSpec(
            name=name, argv=argv, env=env,
            stderr_path=os.path.join(workdir, f"{name}.log")))
    fe = FleetFrontend({}, lease_dir=lease_dir)
    sup = Supervisor(specs,
                     on_up=lambda name, url, banner:
                     fe.set_replica(name, url))
    print(json.dumps({"fleet_up": {"replicas": args.replicas,
                                   "workdir": workdir,
                                   "device": args.device,
                                   "booting": True}}), flush=True)
    sup.start()
    try:
        _serve_front(fe, args.host, args.port,
                     {"replicas": sup.urls()})
    finally:
        sup.stop()


def _add_fleet(sub) -> None:
    pfl = sub.add_parser("fleet", help="horizontally scaled serve: a "
                         "front-end router over N replicas with leased "
                         "budget shards")
    pfls = pfl.add_subparsers(dest="fleet_cmd", required=True)
    pff = pfls.add_parser("front", help="HTTP front end over "
                          "already-running serve replicas (either "
                          "package's)")
    pff.add_argument("--replica", action="append", required=True,
                     metavar="NAME=URL",
                     help="one serve replica (repeatable), e.g. "
                          "r0=http://127.0.0.1:8321")
    pff.add_argument("--lease-dir", dest="lease_dir", default=None,
                     help="the fleet's shared lease directory: routes "
                          "each user to the replica owning their "
                          "budget shard")
    pff.add_argument("--host", default="127.0.0.1")
    pff.add_argument("--port", type=int, default=8330)
    pff.add_argument("--health-interval-s", dest="health_interval_s",
                     type=float, default=0.5,
                     help="readyz poll cadence per replica")
    pff.set_defaults(fn=cmd_fleet)
    pfu = pfls.add_parser("up", help="boot + supervise N serve replicas "
                          "over one shared budget directory, plus a "
                          "front end; a dead replica is restarted with "
                          "identical argv and its shards re-leased")
    pfu.add_argument("--workdir", required=True,
                     help="fleet state root: budget/ (shared directory), "
                          "leases/, per-replica ledger/audit/logs")
    pfu.add_argument("--replicas", type=int, default=3)
    pfu.add_argument("--budget", type=float, default=100.0)
    pfu.add_argument("--user-budget", dest="user_budget", type=float,
                     default=1.0)
    pfu.add_argument("--user-shards", dest="user_shards", type=int,
                     default=16)
    pfu.add_argument("--lease-ttl-s", dest="lease_ttl_s", type=float,
                     default=3.0)
    pfu.add_argument("--max-delay-ms", dest="max_delay_ms", type=float,
                     default=5.0)
    pfu.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                     help="where the replicas compute: the card (default; "
                          "a replica without one dies at boot) or the CPU")
    pfu.add_argument("--host", default="127.0.0.1")
    pfu.add_argument("--port", type=int, default=8330)
    pfu.add_argument("--health-interval-s", dest="health_interval_s",
                     type=float, default=0.5)
    pfu.set_defaults(fn=cmd_fleet)


# ------------------------------------------------ protocol and federation
def _party_columns(args, n: int):
    """Synthetic bivariate-normal columns, derived identically in both
    party processes from the public spec seed (a numpy Generator, not the
    estimators' key-tree), as ``python -m dpcorr`` derives them. Each
    process keeps only its own column."""
    rng = np.random.default_rng(args.seed)
    cov = [[1.0, args.rho], [args.rho, 1.0]]
    xy = rng.multivariate_normal([0.0, 0.0], cov, size=n)
    return (np.asarray(xy[:, 0], np.float32),
            np.asarray(xy[:, 1], np.float32))


def _protocol_spec(args):
    from dpcorr_torch.protocol.party import ProtocolSpec

    return ProtocolSpec(family=args.family, n=args.n, eps1=args.eps1,
                        eps2=args.eps2, alpha=args.alpha,
                        normalise=args.normalise == "on",
                        seed=args.seed, noise_mode=args.noise_mode,
                        session=args.session or "")


def _result_json(res) -> dict:
    return {"role": res.role, "session": res.session,
            "rho_hat": res.rho_hat, "ci_low": res.ci_low,
            "ci_high": res.ci_high, "trace_id": res.trace_id,
            "stats": res.stats}


def _fault(args) -> dict | None:
    fault = None
    if args.fault_drop or args.fault_delay_ms or args.fault_duplicate:
        fault = {"drop": args.fault_drop,
                 "delay_s": args.fault_delay_ms / 1000.0,
                 "duplicate": args.fault_duplicate}
    if args.fault_seed is not None:
        # one knob reproducing every side's fault stream; the runner
        # stamps it into each transcript header
        fault = dict(fault or {})
        fault["seed"] = args.fault_seed
    return fault


def _arm_chaos(args):
    """The crash plan of ``--chaos`` or ``DPCORR_CHAOS``, armed; a plan
    that does not parse (an unknown point, a bad field) is refused."""
    from dpcorr_torch import chaos

    try:
        plan = (chaos.plan_from_spec(args.chaos) if args.chaos
                else chaos.plan_from_env())
    except ValueError as e:
        raise SystemExit(f"chaos plan refused: {e}") from e
    if plan is not None:
        chaos.install(plan)
    return plan


def cmd_party(args):
    """One side of the two-party protocol over TCP (counterpart of
    ``python -m dpcorr party``): role y listens, role x connects; each
    process holds one column and computes on ``--device``.

    With ``--journal`` the session is crash-safe: state journals durably
    as the session goes, the TCP link redials through peer restarts, and
    rerunning the same command after a crash resumes the session. A
    ``--chaos`` plan (or ``DPCORR_CHAOS``) arms a kill at a named crash
    point."""
    import os

    from dpcorr_torch.obs import trace as obs_trace
    from dpcorr_torch.obs.audit import AuditTrail
    from dpcorr_torch.protocol.journal import SessionJournal
    from dpcorr_torch.protocol.messages import Transcript
    from dpcorr_torch.protocol.party import Party
    from dpcorr_torch.protocol.transport import (
        ReconnectingTcpLink,
        ReliableChannel,
        tcp_accept,
        tcp_connect,
        tcp_listen,
    )
    from dpcorr_torch.serve.ledger import PrivacyLedger

    device = _device(args)
    plan = _arm_chaos(args)
    if args.trace:
        obs_trace.configure(args.trace)
    spec = _protocol_spec(args)
    if args.data:
        col = np.asarray(np.load(args.data), np.float32)
        if col.shape != (spec.n,):
            raise SystemExit(f"--data has shape {col.shape}, spec says "
                             f"({spec.n},)")
    else:
        cols = _party_columns(args, spec.n)
        col = cols[0] if args.role == "x" else cols[1]
    srv = None
    # a journaled restart must not block on a live peer before the
    # session logic runs: when the peer already finished and left, the
    # bounded resume handshake concludes peer-gone and the session
    # completes from the journal, so the first accept/connect goes
    # lazily through the reconnecting link
    resuming = bool(args.journal) and os.path.exists(args.journal)
    if args.role == "y":
        srv, bound = tcp_listen(args.host, args.port)
        print(json.dumps({"party": {"role": "y", "session": spec.session,
                                    "instance": args.instance,
                                    "listening": [args.host, bound],
                                    "device": str(device)}}), flush=True)
        if args.journal:
            # keep the server socket: a crashed peer's restart redials
            # the same port and the reconnecting link re-accepts it
            first = (None if resuming
                     else tcp_accept(srv, timeout_s=args.connect_timeout))
            link = ReconnectingTcpLink(
                lambda: tcp_accept(srv, timeout_s=5.0), link=first,
                max_outage_s=args.connect_timeout)
        else:
            link = tcp_accept(srv, timeout_s=args.connect_timeout)
            srv.close()
            srv = None
    else:
        print(json.dumps({"party": {"role": "x", "session": spec.session,
                                    "instance": args.instance,
                                    "connecting": [args.host, args.port],
                                    "device": str(device)}}), flush=True)
        if args.journal:
            first = (None if resuming
                     else tcp_connect(args.host, args.port,
                                      timeout_s=args.connect_timeout))
            link = ReconnectingTcpLink(
                lambda: tcp_connect(args.host, args.port, timeout_s=5.0),
                link=first, max_outage_s=args.connect_timeout)
        else:
            link = tcp_connect(args.host, args.port,
                               timeout_s=args.connect_timeout)
    audit = AuditTrail(args.audit) if args.audit else None
    ledger = PrivacyLedger(args.budget, path=args.ledger, audit=audit)
    if args.user_dir:
        # per-user admission rides the gate unchanged: the composite
        # derives the user/ leg inside the same charge/refund calls, and
        # both stores recover their exact balances on restart
        from dpcorr_torch.serve.budget_dir import (
            BudgetDirectory,
            CompositeLedger,
        )

        directory = BudgetDirectory(
            args.user_dir, shards=args.user_shards,
            user_budget=args.user_budget,
            max_resident=args.user_max_resident,
            compact_every=args.user_compact_every, audit=audit)
        ledger = CompositeLedger(ledger, directory,
                                 user=args.user or f"user-{args.role}")
    channel = ReliableChannel(link, timeout_s=args.timeout,
                              max_retries=args.max_retries)
    transcript = Transcript(args.transcript)
    if args.instance:
        transcript.meta(instance=args.instance)
    if plan is not None:
        # the kill plan is in the transcript header, so a chaos run
        # replays from its own log
        transcript.meta(chaos=plan.to_dict(), session=spec.session)
    journal = SessionJournal(args.journal) if args.journal else None
    party = Party(args.role, col, spec, channel, ledger,
                  transcript=transcript, recv_timeout_s=args.recv_timeout,
                  journal=journal, device=device)
    try:
        res = party.run()
    finally:
        link.close()
        if srv is not None:
            srv.close()
        if args.user_dir:
            ledger.close()  # CompositeLedger: releases shard spill files
    print(json.dumps({"result": _result_json(res)}, indent=2))


def cmd_protocol_run(args):
    """Both roles in one process (threads) over the chosen transport, on
    ``--device`` (counterpart of ``python -m dpcorr protocol run``)."""
    from dpcorr_torch.protocol.party import ProtocolError
    from dpcorr_torch.protocol.runner import run_inproc, run_tcp

    device = _device(args)
    spec = _protocol_spec(args)
    x, y = _party_columns(args, spec.n)
    run = run_tcp if args.transport == "tcp" else run_inproc
    try:
        results = run(spec, x, y, fault=_fault(args),
                      transcript_dir=args.transcript_dir,
                      timeout_s=args.timeout, max_retries=args.max_retries,
                      device=device)
    except ProtocolError as e:
        raise SystemExit(f"protocol aborted: {e}") from e
    out = {"spec": spec.to_public(), "session": spec.session,
           "device": str(device),
           "results": {r: _result_json(res)
                       for r, res in sorted(results.items())}}
    agree = (results["x"].rho_hat == results["y"].rho_hat
             and results["x"].ci_low == results["y"].ci_low
             and results["x"].ci_high == results["y"].ci_high)
    out["roles_agree"] = agree
    print(json.dumps(out, indent=2))
    if not agree:
        raise SystemExit("role results diverged")


def cmd_protocol_scan(args):
    """Offline transcript audit (``protocol.scan``): message schema and no
    raw columns, and with ``--audit`` the ε balance. Needs no torch;
    exits 1 on any violation."""
    from dpcorr_torch.obs.audit import read_events
    from dpcorr_torch.protocol.scan import ledger_balance, scan_transcript

    rep = scan_transcript(args.transcript)
    out = {"scan": rep}
    ok = rep["ok"]
    if args.audit:
        bal = ledger_balance(args.transcript, read_events(args.audit))
        out["balance"] = bal
        ok = ok and bal["ok"]
    print(json.dumps(out, indent=2))
    if not ok:
        sys.exit(1)


def _federation_plan(args):
    """The public federation plan a subcommand runs under: from a
    ``--plan`` JSON file (the document every party process of one
    federation must share) or inline ``--party`` flags (their order is
    the plan order)."""
    from dpcorr_torch.protocol.matrix import FederationPlan

    if args.plan:
        with open(args.plan, encoding="utf-8") as fh:
            doc = json.load(fh)
        return FederationPlan.from_public(doc.get("plan", doc))
    if not args.party:
        raise SystemExit("pass --party NAME=LAB1[,LAB2...] (repeatable; "
                         "order is the plan order) or --plan FILE")
    parties = []
    for spec in args.party:
        name, sep, labs = spec.partition("=")
        labels = [s for s in labs.split(",") if s]
        if not sep or not name or not labels:
            raise SystemExit(f"--party {spec!r}: expected "
                             "NAME=LAB1[,LAB2...]")
        parties.append((name, labels))
    return FederationPlan(family=args.family, n=args.n, eps=args.eps,
                          parties=parties, alpha=args.alpha,
                          normalise=args.normalise == "on",
                          seed=args.seed, noise_mode=args.noise_mode,
                          max_cells_per_round=args.max_cells_per_round)


def _federation_columns(plan, rho: float) -> dict:
    """Synthetic equicorrelated columns for all k labels, from the public
    plan seed (a numpy Generator), as ``python -m dpcorr`` derives them:
    every party process re-derives the same draw and keeps only its own
    labels."""
    k = plan.k
    if not -1.0 / max(k - 1, 1) < rho < 1.0:
        raise SystemExit(f"--rho {rho} is not a valid equicorrelation "
                         f"for k={k} (need -1/(k-1) < rho < 1)")
    cov = np.full((k, k), float(rho))
    np.fill_diagonal(cov, 1.0)
    xy = np.random.default_rng(plan.seed).multivariate_normal(
        np.zeros(k), cov, size=plan.n)
    return {label: np.asarray(xy[:, idx], np.float32)
            for idx, (_owner, label) in enumerate(plan.columns())}


def cmd_federation_plan(args):
    """Compile and print the federation schedule: cells, links, rounds,
    artifact charge venues and the ε arithmetic (optimal against naive
    per cell). Plan arithmetic only; needs no torch."""
    print(json.dumps(_federation_plan(args).describe(), indent=2))


def cmd_federation_run(args):
    """The whole federation in one process, every party on a thread over
    queue-pair or loopback-TCP wires, on ``--device``."""
    from dpcorr_torch.protocol.federation import (
        run_federation_inproc,
        run_federation_tcp,
    )
    from dpcorr_torch.protocol.party import ProtocolError

    device = _device(args)
    plan = _federation_plan(args)
    data = _federation_columns(plan, args.rho)
    run = (run_federation_tcp if args.transport == "tcp"
           else run_federation_inproc)
    try:
        results = run(plan, data, fault=_fault(args),
                      transcript_dir=args.transcript_dir,
                      timeout_s=args.timeout,
                      max_retries=args.max_retries, engine=args.engine,
                      device=device)
    except ProtocolError as e:
        raise SystemExit(f"federation aborted: {e}") from e
    # every cell two parties both see must agree bitwise: the wire result
    # is the finisher's result, so disagreement means corruption
    cells: dict = {}
    agree = True
    for _name, res in sorted(results.items()):
        for key, val in res.cells.items():
            if key in cells and cells[key] != val:
                agree = False
            cells.setdefault(key, val)
    out = {"fed": plan.fed, "fed_hash": plan.fed_hash(),
           "plan": plan.to_public(), "device": str(device),
           "cells": {key: cells[key] for key in sorted(cells)},
           "eps": {"optimal": plan.optimal_eps(),
                   "naive_per_cell": plan.naive_eps(),
                   "per_party": plan.party_eps()},
           "parties": {name: {"cells": res.cells, "eps": res.eps,
                              "stats": res.stats}
                       for name, res in sorted(results.items())},
           "parties_agree": agree}
    print(json.dumps(out, indent=2))
    if not agree:
        raise SystemExit("parties diverged on a shared cell")


def cmd_federation_party(args):
    """One real party process of a multi-process federation over TCP, on
    ``--device``: for each pair link the lower party dials (``--peer
    NAME=HOST:PORT``) and the higher listens (``--listen``, the bound
    port announced in the banner). With ``--journal-dir`` every link is
    crash-safe: rerun the same command after a crash and the matrix
    resumes."""
    import os

    from dpcorr_torch.obs import trace as obs_trace
    from dpcorr_torch.obs.audit import AuditTrail
    from dpcorr_torch.obs.endpoint import start_obs_server
    from dpcorr_torch.obs.metrics import Registry
    from dpcorr_torch.protocol.federation import serve_federation_party
    from dpcorr_torch.serve.ledger import PrivacyLedger

    device = _device(args)
    _arm_chaos(args)
    fed = _federation_plan(args)
    name = args.name
    instance = args.instance or name
    if args.trace:
        # a directory spools per instance (trace.<instance>.jsonl), so k
        # parties can share one --trace value
        trace_path = (os.path.join(args.trace, f"trace.{instance}.jsonl")
                      if os.path.isdir(args.trace) else args.trace)
        obs_trace.configure(trace_path)
    my_idx = fed.party_index(name)
    columns = {lab: col for lab, col
               in _federation_columns(fed, args.rho).items()
               if lab in fed.party_labels(name)}
    listen = None
    if args.listen:
        host, sep, port = args.listen.rpartition(":")
        if not sep:
            raise SystemExit(f"--listen {args.listen!r}: expected "
                             "HOST:PORT")
        listen = (host, int(port))
    peers = {}
    for spec in args.peer or []:
        peer, sep, addr = spec.partition("=")
        host, sep2, port = addr.rpartition(":")
        if not sep or not sep2:
            raise SystemExit(f"--peer {spec!r}: expected NAME=HOST:PORT")
        peers[peer] = (host, int(port))
    accepts = any(fed.party_index(q if p == name else p) < my_idx
                  for p, q in fed.party_links(name))
    registry = Registry()
    party_box: list = []
    obs_port = None
    if args.obs_port is not None:
        # the scrape surface is up before any banner, so a scraper can
        # watch the whole run
        _srv, obs_port = start_obs_server(
            registry,
            stats_fn=lambda: (party_box[0].stats_snapshot()
                              if party_box else
                              {"kind": "federation_party",
                               "instance": instance, "party": name,
                               "fed": fed.fed, "starting": True}),
            port=args.obs_port)

    def banner(**extra):
        doc = {"federation": fed.fed, "name": name, "instance": instance,
               "device": str(device)}
        if obs_port is not None:
            doc["obs_port"] = obs_port
        doc.update(extra)
        print(json.dumps({"party": doc}), flush=True)

    def on_listening(host, port):
        banner(listening=[host, port])

    if not accepts:
        # pure dialers print a banner too: a script that starts the
        # parties reads every party's stdout alike (banners, then result)
        banner(dialing=sorted(peers))
    audit = AuditTrail(args.audit) if args.audit else None
    ledger = PrivacyLedger(args.budget, path=args.ledger, audit=audit)
    res = serve_federation_party(
        name, fed, columns, ledger=ledger, listen=listen, peers=peers,
        transcript_dir=args.transcript_dir,
        journal_dir=args.journal_dir, timeout_s=args.timeout,
        max_retries=args.max_retries,
        connect_timeout_s=args.connect_timeout,
        recv_timeout_s=args.recv_timeout, engine=args.engine,
        on_listening=on_listening, registry=registry,
        instance=args.instance, on_party=party_box.append, device=device)
    print(json.dumps({"result": {"party": res.party, "fed": res.fed,
                                 "cells": res.cells, "eps": res.eps,
                                 "stats": res.stats}}, indent=2))


def cmd_federation_scan(args):
    """Offline federation audit (needs no torch): each transcript's schema
    scan, the cross-pair correlation-leak gate (a reused column release
    must be byte-identical in every pair session; exit 1 names the
    offending pair), and with ``--audit NAME=PATH`` each party's
    whole-matrix ε balance against its plan-derived local spend."""
    import glob as globmod
    import os

    from dpcorr_torch.obs import recorder as obs_recorder
    from dpcorr_torch.obs.audit import read_events
    from dpcorr_torch.protocol.matrix import FederationPlan
    from dpcorr_torch.protocol.scan import (
        federation_balance,
        scan_federation,
        scan_transcript,
    )

    transcripts = list(args.transcript or [])
    if args.transcript_dir:
        for path in sorted(globmod.glob(
                os.path.join(args.transcript_dir, "*.jsonl"))):
            base = os.path.basename(path)
            if not base.startswith(("audit.", "trace.")):
                transcripts.append(path)
    if not transcripts:
        raise SystemExit("pass --transcript (repeatable) or "
                         "--transcript-dir")
    plan = None
    if args.plan:
        with open(args.plan, encoding="utf-8") as fh:
            doc = json.load(fh)
        plan = FederationPlan.from_public(doc.get("plan", doc))
    per = {t: scan_transcript(t) for t in transcripts}
    cross = scan_federation(transcripts)
    ok = all(r["ok"] for r in per.values()) and cross["ok"]
    out = {"transcripts": per, "cross_pair": cross}
    balances = {}
    for spec in args.audit or []:
        pname, sep, path = spec.partition("=")
        if not sep:
            raise SystemExit(f"--audit {spec!r}: expected NAME=PATH")
        mine = [t for t in transcripts
                if os.path.basename(t).split(".")[-2] == pname]
        expected = (sum(plan.local_charges(pname)["charges"].values())
                    if plan is not None else 0.0)
        bal = federation_balance(mine, read_events(path),
                                 expected_local_eps=expected)
        balances[pname] = bal
        ok = ok and bal["ok"]
    if balances:
        out["balance"] = balances
    print(json.dumps(out, indent=2))
    if not ok:
        obs_recorder.trigger(
            "federation_scan_violation", violations=cross["violations"],
            transcripts=sorted(os.path.basename(t) for t in transcripts))
        sys.exit(1)


# --------------------------------------------------------------- chaos
#: Federation chaos cases map the sweep's victim role onto a party of the
#: fixed 3-party topology (p0:[a,b] p1:[c] p2:[d]), chosen so each point
#: fires in the victim: pre_release in link initiators (p0 initiates both
#: its links, p1 initiates p1-p2), pre_finish in finishers (p1 finishes
#: p0-p1, p2 finishes both its links), mid_matrix in any party joining
#: link threads (the JAX command's table).
_FED_VICTIMS = {
    "federation.pre_release": {"x": "p0", "y": "p1"},
    "federation.pre_finish": {"x": "p1", "y": "p2"},
    "federation.mid_matrix": {"x": "p0", "y": "p1"},
}


def _parse_party_result(text: str) -> dict:
    """Drop the single-line ``{"party": ...}`` banners of a party's stdout
    and parse the multi-line ``{"result": ...}`` document after them."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    while lines:
        try:
            obj = json.loads(lines[0])
        except json.JSONDecodeError:
            break
        if isinstance(obj, dict) and "party" in obj:
            lines.pop(0)
        else:
            break
    return json.loads("\n".join(lines))["result"]


def _budget_dir_replay(audit_path: str, budget_dir: str) -> list[dict]:
    """The per-user audit: each user's lifetime spend folded from the
    trail's ``user/`` legs against the lifetime the directory's shard
    files recover to (snapshot + WAL, the restart's own arithmetic).
    Returns the mismatches (the JAX package's ``obs budget --budget-dir``
    check)."""
    from dpcorr_torch.obs.audit import read_events, replay
    from dpcorr_torch.obs.budget_replay import (
        USER_PREFIX,
        read_user_balances,
    )

    replayed = {p[len(USER_PREFIX):]: v
                for p, v in replay(read_events(audit_path)).items()
                if p.startswith(USER_PREFIX)}
    bal = read_user_balances(budget_dir)
    out = []
    for user in sorted(set(replayed) | set(bal)):
        want = replayed.get(user, 0.0)
        got = bal.get(user, {}).get("l", 0.0)
        if abs(want - got) > 1e-9:
            out.append({"user": user, "replayed": want, "directory": got})
    return out


def cmd_chaos(args):
    """Deterministic step-kill sweep (counterpart of ``python -m dpcorr
    chaos``): per (family, victim role, crash point) case, run the
    two-party protocol as two real TCP party processes on ``--device``
    with journals, ledgers, audit trails, transcripts and per-user budget
    directories, kill the victim at the named point (exit 42), restart it
    with the same command line, and hold the finished session bit-equal
    to an uninterrupted in-process reference on the same device, with
    each role's ε (party and user) spent exactly once. Federation points
    run the 3-party case."""
    import os
    import subprocess
    import tempfile

    from dpcorr_torch import chaos
    from dpcorr_torch.protocol.party import ProtocolSpec
    from dpcorr_torch.protocol.runner import run_inproc

    device = _device(args)
    points = (args.points.split(",") if args.points
              else list(chaos.MATRIX_POINTS))
    roles = args.roles.split(",") if args.roles else ["x", "y"]
    families = (args.families.split(",") if args.families
                else [args.family])
    if args.chaos_seed is not None:
        plan = chaos.plan_from_seed(args.chaos_seed)
        points, roles = [plan.point], [plan.role]
    for point in points:
        if point not in chaos.KNOWN_POINTS:
            raise SystemExit(f"unknown chaos point {point!r}")
    workdir = args.workdir or tempfile.mkdtemp(prefix="dpcorr-chaos-")
    os.makedirs(workdir, exist_ok=True)
    # the restarted victim must NOT re-arm the kill it is recovering from
    env = _child_env(drop_chaos=True)

    def spec_for(family: str) -> ProtocolSpec:
        return ProtocolSpec(family=family, n=args.n, eps1=args.eps1,
                            eps2=args.eps2, alpha=args.alpha,
                            normalise=args.normalise == "on",
                            seed=args.seed, noise_mode=args.noise_mode)

    # the oracle every crashed run must match bit for bit: one clean
    # uninterrupted run per family, same spec, same columns, same device
    refs = {}
    for family in families:
        if any(not p.startswith("federation.") for p in points):
            cx, cy = _party_columns(args, args.n)
            refs[family] = run_inproc(spec_for(family), cx, cy,
                                      device=device)["x"]

    def launch(argv: list[str], case_dir: str, role: str):
        errlog = open(os.path.join(case_dir, f"{role}.stderr.log"), "ab")
        try:
            return subprocess.Popen(argv, stdout=subprocess.PIPE,
                                    stderr=errlog, env=env, text=True)
        finally:
            errlog.close()  # the child holds its own descriptor

    reports = []
    failures = []
    fed_refs = {}  # family -> uninterrupted in-process federation oracle
    for family in families:
        for role in roles:
            for point in points:
                case = f"{family}.{role}.{point}"
                case_dir = os.path.join(workdir, case.replace(".", "_"))
                os.makedirs(case_dir, exist_ok=True)
                t0 = time.perf_counter()
                if point.startswith("federation."):
                    # federation crash windows never fire in a two-party
                    # session: the case is a 3-party matrix over TCP,
                    # with the victim role mapped onto a party
                    errs = _run_federation_chaos_case(
                        args, family, role, point, case_dir, launch,
                        fed_refs, device)
                else:
                    errs = _run_chaos_case(
                        args, family, role, point, case_dir,
                        refs[family], spec_for(family), launch)
                reports.append({"case": case, "ok": not errs,
                                "errors": errs, "dir": case_dir,
                                "seconds": time.perf_counter() - t0})
                failures.extend(f"{case}: {e}" for e in errs)
    print(json.dumps({"workdir": workdir, "device": str(device),
                      "cases": reports, "ok": not failures}, indent=2))
    if failures:
        sys.exit(1)


def _party_argv(args, family: str, role: str, port: int,
                case_dir: str) -> list[str]:
    """One chaos case's party command line. Every case also runs a
    per-user budget directory with the most hostile knobs it supports —
    evict after every release (max-resident 0) and compact after every
    charge — so each protocol send crosses every directory persist
    window, and the post-restart check proves exact per-user balances."""
    import os

    return [sys.executable, "-m", "dpcorr_torch", "party",
            "--role", role, "--host", "127.0.0.1", "--port", str(port),
            "--device", args.device,
            "--family", family, "--n", str(args.n),
            "--eps1", str(args.eps1), "--eps2", str(args.eps2),
            "--alpha", str(args.alpha), "--normalise", args.normalise,
            "--seed", str(args.seed), "--noise-mode", args.noise_mode,
            "--rho", str(args.rho),
            "--timeout", str(args.timeout),
            "--max-retries", str(max(args.max_retries, 40)),
            "--connect-timeout", str(args.case_timeout),
            "--recv-timeout", str(args.case_timeout),
            "--journal", os.path.join(case_dir, f"journal.{role}.json"),
            "--ledger", os.path.join(case_dir, f"ledger.{role}.json"),
            "--audit", os.path.join(case_dir, f"audit.{role}.jsonl"),
            "--user", f"user-{role}",
            "--user-dir", os.path.join(case_dir, f"budget-{role}"),
            "--user-budget", "100", "--user-shards", "2",
            "--user-max-resident", "0", "--user-compact-every", "1",
            "--transcript",
            os.path.join(case_dir, f"transcript.{role}.jsonl")]


def _run_chaos_case(args, family, role, point, case_dir, ref, spec,
                    launch) -> list[str]:
    """One two-party (family, victim role, point) case; returns the error
    strings (none when the case held)."""
    import os
    import subprocess

    from dpcorr_torch import chaos
    from dpcorr_torch.obs.audit import read_events
    from dpcorr_torch.obs.budget_replay import read_user_balances
    from dpcorr_torch.protocol.scan import ledger_balance, scan_transcript

    # seed-derived sweeps pass the seed form through: the victim
    # re-derives the same (point, role) and keeps the seed on the plan,
    # so the transcript header records the provenance of the run
    if getattr(args, "chaos_seed", None) is not None:
        chaos_spec = f"seed={args.chaos_seed}"
    else:
        chaos_spec = f"point={point},hit=1,mode=exit"
    timeout = args.case_timeout
    procs = {}
    try:
        y_argv = _party_argv(args, family, "y", 0, case_dir)
        procs["y"] = launch(
            y_argv + (["--chaos", chaos_spec] if role == "y" else []),
            case_dir, "y")
        line = procs["y"].stdout.readline()
        if not line:
            return [f"party y printed no banner; see "
                    f"{case_dir}/y.stderr.log"]
        port = int(json.loads(line)["party"]["listening"][1])
        x_argv = _party_argv(args, family, "x", port, case_dir)
        procs["x"] = launch(
            x_argv + (["--chaos", chaos_spec] if role == "x" else []),
            case_dir, "x")
        victim = procs[role]
        try:
            rc = victim.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return [f"victim {role} did not crash at {point} within "
                    f"{timeout:.0f}s"]
        victim.stdout.read()  # drain the dead pipe
        if rc != chaos.EXIT_CODE:
            return [f"victim {role} exited {rc}, expected the chaos "
                    f"kill code {chaos.EXIT_CODE}; see "
                    f"{case_dir}/{role}.stderr.log"]
        # restart: the same command line, minus the kill plan (y rebinds
        # its concrete port — port 0 was only for discovery)
        restart_argv = (_party_argv(args, family, "y", port, case_dir)
                        if role == "y" else x_argv)
        procs[role] = launch(restart_argv, case_dir, role)
        results = {}
        for r in ("x", "y"):
            try:
                rc = procs[r].wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                return [f"party {r} hung after restart (>{timeout:.0f}s)"]
            out = procs[r].stdout.read()
            if rc != 0:
                return [f"party {r} exited {rc} after restart; see "
                        f"{case_dir}/{r}.stderr.log"]
            results[r] = _parse_party_result(out)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stdout.close()

    errs = []
    for r in ("x", "y"):
        got = results[r]
        if (got["rho_hat"] != ref.rho_hat or got["ci_low"] != ref.ci_low
                or got["ci_high"] != ref.ci_high):
            errs.append(
                f"role {r} result {got['rho_hat']!r} diverged from the "
                f"uninterrupted reference {ref.rho_hat!r}")
        transcript = os.path.join(case_dir, f"transcript.{r}.jsonl")
        rep = scan_transcript(transcript)
        if not rep["ok"]:
            errs.append(f"role {r} transcript scan: {rep['violations']}")
        audit = os.path.join(case_dir, f"audit.{r}.jsonl")
        bal = ledger_balance(transcript, read_events(audit))
        if not bal["ok"]:
            errs.append(f"role {r} ledger balance: "
                        f"sends {bal['unmatched_sends']} "
                        f"charges {bal['unmatched_charges']}")
        with open(os.path.join(case_dir, f"ledger.{r}.json")) as fh:
            spent = json.load(fh)["spent"]
        for party_name, eps in spec.charges_for(r).items():
            if abs(spent.get(party_name, 0.0) - eps) > 1e-9:
                errs.append(
                    f"role {r} spent {spent.get(party_name, 0.0)!r} for "
                    f"{party_name}, expected exactly one charge of "
                    f"{eps!r}")
        # the per-user directory recovers to the exact balance: every
        # release charged the bound user once, through whatever persist
        # window the kill landed in (read_user_balances IS the restart's
        # recovery arithmetic)
        budget_dir = os.path.join(case_dir, f"budget-{r}")
        want = sum(spec.charges_for(r).values())
        got_l = read_user_balances(budget_dir).get(
            f"user-{r}", {}).get("l", 0.0)
        if abs(got_l - want) > 1e-9:
            errs.append(
                f"role {r} user directory recovered lifetime {got_l!r} "
                f"for user-{r}, expected exactly-once charges "
                f"totalling {want!r}")
        # and the trail's user legs fold to the directory's arithmetic
        bad = _budget_dir_replay(audit, budget_dir)
        if bad:
            errs.append(f"role {r} audit replay disagreed with the "
                        f"directory: {bad}")
    return errs


def _run_federation_chaos_case(args, family, role, point, case_dir,
                               launch, fed_refs, device) -> list[str]:
    """One federation chaos case: three real party processes over TCP
    computing the 4×4 matrix, the mapped victim killed at the named
    federation point (exit 42) and restarted with the same command line;
    the finished matrix must be bit-equal to an uninterrupted in-process
    reference with every party's ε spent once at the release-reuse
    optimum."""
    import os
    import subprocess

    from dpcorr_torch import chaos
    from dpcorr_torch.obs.audit import read_events
    from dpcorr_torch.protocol.federation import run_federation_inproc
    from dpcorr_torch.protocol.matrix import FederationPlan
    from dpcorr_torch.protocol.scan import (
        federation_balance,
        scan_federation,
        scan_transcript,
    )

    plan = FederationPlan(
        family=family, n=args.n, eps=args.eps1,
        parties=[("p0", ["a", "b"]), ("p1", ["c"]), ("p2", ["d"])],
        alpha=args.alpha, normalise=args.normalise == "on",
        seed=args.seed, noise_mode=args.noise_mode)
    victim_name = _FED_VICTIMS[point][role]
    if family not in fed_refs:
        fed_refs[family] = run_federation_inproc(
            plan, _federation_columns(plan, args.rho), device=device)
    ref = fed_refs[family]
    plan_path = os.path.join(case_dir, "plan.json")
    with open(plan_path, "w", encoding="utf-8") as fh:
        json.dump(plan.to_public(), fh)

    def argv(name: str, listen_port, peers: dict) -> list[str]:
        cmd = [sys.executable, "-m", "dpcorr_torch", "federation",
               "party", "--name", name, "--plan", plan_path,
               "--device", args.device,
               "--rho", str(args.rho), "--budget", "100",
               "--timeout", str(args.timeout),
               "--max-retries", str(max(args.max_retries, 40)),
               "--connect-timeout", str(args.case_timeout),
               "--recv-timeout", str(args.case_timeout),
               "--ledger", os.path.join(case_dir, f"ledger.{name}.json"),
               "--audit", os.path.join(case_dir, f"audit.{name}.jsonl"),
               "--transcript-dir", case_dir,
               "--journal-dir", case_dir]
        if listen_port is not None:
            cmd += ["--listen", f"127.0.0.1:{listen_port}"]
        for peer, port in sorted(peers.items()):
            cmd += ["--peer", f"{peer}=127.0.0.1:{port}"]
        return cmd

    chaos_spec = f"point={point},hit=1,mode=exit"
    timeout = args.case_timeout
    procs: dict = {}
    ports: dict = {}

    def spawn(name, listen_port, peers):
        extra = ["--chaos", chaos_spec] if name == victim_name else []
        procs[name] = launch(argv(name, listen_port, peers) + extra,
                             case_dir, name)

    def peers_of(name) -> dict:
        # plan topology: the lower party of each link dials the higher
        dials = {"p2": (), "p1": ("p2",), "p0": ("p1", "p2")}[name]
        return {peer: ports[peer] for peer in dials}

    def read_port(name) -> int:
        line = procs[name].stdout.readline()
        if not line:
            raise RuntimeError(f"party {name} printed no banner; see "
                               f"{case_dir}/{name}.stderr.log")
        return int(json.loads(line)["party"]["listening"][1])

    try:
        # listeners first: p2 accepts p0+p1; p1 accepts p0, dials p2;
        # p0 dials both (it is the lower party of both its links)
        spawn("p2", 0, {})
        ports["p2"] = read_port("p2")
        spawn("p1", 0, peers_of("p1"))
        ports["p1"] = read_port("p1")
        spawn("p0", None, peers_of("p0"))
        victim = procs[victim_name]
        try:
            rc = victim.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return [f"victim {victim_name} did not crash at {point} "
                    f"within {timeout:.0f}s"]
        victim.stdout.read()  # drain the dead pipe
        if rc != chaos.EXIT_CODE:
            return [f"victim {victim_name} exited {rc}, expected the "
                    f"chaos kill code {chaos.EXIT_CODE}; see "
                    f"{case_dir}/{victim_name}.stderr.log"]
        # restart: the same command line minus the kill plan (listeners
        # rebind their discovered port; the peers' reconnecting links
        # redial it)
        procs[victim_name].stdout.close()
        procs[victim_name] = launch(
            argv(victim_name, ports.get(victim_name),
                 peers_of(victim_name)), case_dir, victim_name)
        results = {}
        for name in ("p0", "p1", "p2"):
            try:
                rc = procs[name].wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                return [f"party {name} hung after the restart "
                        f"(>{timeout:.0f}s)"]
            out = procs[name].stdout.read()
            if rc != 0:
                return [f"party {name} exited {rc} after the restart; "
                        f"see {case_dir}/{name}.stderr.log"]
            results[name] = _parse_party_result(out)
    except RuntimeError as e:
        return [str(e)]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stdout.close()

    errs = []
    all_transcripts = []
    for name in ("p0", "p1", "p2"):
        if results[name]["cells"] != ref[name].cells:
            errs.append(f"party {name} matrix diverged from the "
                        "uninterrupted in-process reference")
        # ε spent exactly once, at the release-reuse optimum share
        with open(os.path.join(case_dir, f"ledger.{name}.json")) as fh:
            spent = json.load(fh)["spent"]
        want = plan.party_eps()[name]
        if abs(spent.get(name, 0.0) - want) > 1e-9:
            errs.append(f"party {name} spent {spent.get(name, 0.0)!r}, "
                        f"expected exactly-once charges totalling "
                        f"{want!r}")
        tscripts = [
            os.path.join(case_dir,
                         f"{plan.link_session(p, q)}.{name}.jsonl")
            for p, q in plan.party_links(name)]
        all_transcripts.extend(tscripts)
        for t in tscripts:
            rep = scan_transcript(t)
            if not rep["ok"]:
                errs.append(f"party {name} transcript scan: "
                            f"{rep['violations']}")
        bal = federation_balance(
            tscripts,
            read_events(os.path.join(case_dir, f"audit.{name}.jsonl")),
            expected_local_eps=sum(
                plan.local_charges(name)["charges"].values()))
        if not bal["ok"]:
            errs.append(f"party {name} ledger balance: "
                        f"sends {bal['unmatched_sends']} "
                        f"charges {bal['unmatched_charges']} "
                        f"local {bal['local_eps']!r}")
    cross = scan_federation(all_transcripts)
    if not cross["ok"]:
        errs.append(f"cross-pair federation scan: {cross['violations']}")
    return errs


def _add_chaos(sub) -> None:
    pc_ = sub.add_parser("chaos", help="deterministic step-kill sweep: "
                         "two party processes over real TCP, kill the "
                         "victim at each named crash point, restart it, "
                         "assert bit-identical results and exactly-once "
                         "ε spend")
    pc_.add_argument("--points", default=None,
                     help="comma list of crash points (default: the "
                          "standard matrix, dpcorr_torch.chaos."
                          "MATRIX_POINTS)")
    pc_.add_argument("--roles", default=None,
                     help="comma list of victim roles from {x,y} "
                          "(default: both)")
    pc_.add_argument("--families", default=None,
                     help="comma list of estimator families to sweep "
                          "(default: just --family)")
    pc_.add_argument("--workdir", default=None,
                     help="artifact directory — per-case journals, "
                          "ledgers, audits, transcripts, stderr logs "
                          "(default: a fresh temp dir)")
    pc_.add_argument("--chaos-seed", dest="chaos_seed", type=int,
                     default=None,
                     help="derive one (point, victim) case from a seed "
                          "(dpcorr_torch.chaos.plan_from_seed) instead of "
                          "sweeping")
    pc_.add_argument("--case-timeout", dest="case_timeout", type=float,
                     default=180.0,
                     help="per-process wait bound within one case "
                          "(seconds)")
    _add_spec_flags(pc_)
    pc_.set_defaults(fn=cmd_chaos)


# ----------------------------------------------------------------- obs
def cmd_obs_fleet_snapshot(args):
    """One scrape of the whole fleet → one JSON artifact: per-instance
    stats, the merged (instance-labelled) exposition, the exact
    aggregate. Exits 1 when no instance answered."""
    from dpcorr_torch.obs.fleet import FleetCollector

    snap = FleetCollector(args.targets).scrape(timeout_s=args.timeout)
    doc = snap.to_doc()
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
    errors = snap.errors()
    if args.json or not args.out:
        print(json.dumps(doc if args.json else {
            "instances": sorted(snap.instances),
            "live": sorted(snap.live()),
            "errors": errors,
            "out": args.out,
        }, indent=2))
    else:
        print(f"fleet snapshot: {len(snap.live())}/"
              f"{len(snap.instances)} instances live -> {args.out}")
        for name, err in sorted(errors.items()):
            print(f"  DOWN {name}: {err}")
    raise SystemExit(1 if errors and not snap.live() else 0)


def cmd_obs_fleet_chrome(args):
    """Union many instances' span spools into ONE Chrome trace (one pid
    per instance) — the fleet postmortem timeline."""
    from dpcorr_torch.obs.fleet import parse_targets, write_fleet_chrome_trace

    spools = parse_targets(args.spool)
    out = write_fleet_chrome_trace(spools, args.out)
    print(f"wrote fleet chrome trace for {len(spools)} instances "
          f"-> {out}")


def cmd_obs_fleet_replay(args):
    """Fleet-wide audit replay: per-instance ε tables plus the fleet fold
    (the sum of per-instance ledgers, binary-exact)."""
    from dpcorr_torch.obs.fleet import fleet_replay, parse_targets

    doc = fleet_replay(parse_targets(args.audit))
    if args.json:
        print(json.dumps(doc, indent=2))
        return
    for inst in sorted(doc["per_instance"]):
        table = doc["per_instance"][inst]
        spent = ", ".join(f"{p}={e:.6g}"
                          for p, e in sorted(table.items()))
        print(f"{inst}: {spent or '(no spend)'}")
    print("fleet: " + ", ".join(f"{p}={e:.6g}" for p, e in
                                sorted(doc["fleet"].items())))


def cmd_obs_trajectory(args):
    """Bench-trajectory dashboard: the repo's BENCH_*/MULTICHIP_*/
    benchmarks-results artifacts as per-(device_kind, metric) series,
    naming the first artifact that bent the curve. ``--check`` exits 1
    when any series regressed below the floor."""
    from dpcorr_torch.obs import trajectory as traj_mod

    roots = args.root or traj_mod.default_roots(args.repo)
    report = traj_mod.build_report(roots, args.floor)
    if args.format == "json":
        sys.stdout.write(traj_mod.render_json(report))
    elif args.format == "markdown":
        sys.stdout.write(traj_mod.render_markdown(report))
    else:
        sys.stdout.write(traj_mod.render_console(report))
    if args.check and report.regressions:
        sys.exit(1)


def cmd_obs_hlo(args):
    """The JAX package's signature dumps: ``show`` lists one dump's
    signatures with cost and fingerprint; ``diff`` explains what changed
    between two. The port writes none (it compiles no HLO)."""
    from dpcorr_torch.obs import hlo as hlo_mod

    try:
        if args.hlo_cmd == "show":
            sigs = hlo_mod.load_dump(args.path)
            if args.json:
                print(json.dumps(sigs, indent=2, sort_keys=True))
            else:
                sys.stdout.write(hlo_mod.render_show(sigs))
            return
        diff = hlo_mod.diff_dumps(hlo_mod.load_dump(args.old),
                                  hlo_mod.load_dump(args.new))
        if args.json:
            print(json.dumps(diff, indent=2, sort_keys=True))
        else:
            sys.stdout.write(hlo_mod.render_diff(diff))
    except (OSError, ValueError) as e:
        print(f"obs hlo: {e}", file=sys.stderr)
        sys.exit(1)


def cmd_obs_geometry(args):
    """The geometry autotuner's cache per (device_kind, family, n,
    dtype): tuned entries with their probe rate and staleness, and any
    env pin (``DPCORR_BENCH_CHUNK``/``DPCORR_BENCH_BLOCK_REPS``) that
    outranks them. Exits 1 on a corrupt cache file (the hot path shrugs
    and re-probes; the CLI must not)."""
    import os

    from dpcorr_torch.utils import geometry as geo_mod

    path = args.path or geo_mod.cache_path()
    pin = {k: os.environ[k] for k in ("DPCORR_BENCH_CHUNK",
                                      "DPCORR_BENCH_BLOCK_REPS")
           if os.environ.get(k)}
    if path is None:
        print("geometry cache disabled (DPCORR_GEOMETRY_CACHE).")
        rows = []
    elif not os.path.exists(path):
        print(f"geometry cache {path}: not present (no run has tuned "
              f"on this host yet).")
        rows = []
    else:
        try:
            rows = geo_mod.entries(geo_mod.load_strict(path))
        except (OSError, ValueError) as e:
            print(f"obs geometry: corrupt cache {path}: {e}",
                  file=sys.stderr)
            sys.exit(1)
    if args.json:
        print(json.dumps({"path": path, "env_pin": pin, "entries": rows},
                         indent=2, sort_keys=True))
        return
    if pin:
        print("env pin (outranks every tuned entry): "
              + " ".join(f"{k}={v}" for k, v in sorted(pin.items())))
    if rows:
        print(f"geometry cache {path}: {len(rows)} tuned entries")
        for row in rows:
            if row.get("note"):
                print(f"  {row['key']}: {row['note']}")
                continue
            age = row.get("age_s")
            age_txt = "unstamped" if age is None else \
                f"{age / 86400:.1f}d old" if age >= 86400 else \
                f"{age / 3600:.1f}h old"
            rps = row.get("reps_per_sec")
            rps_txt = f"{rps:,.0f} reps/s probe" if rps else "no probe rate"
            print(f"  [{row['device_kind']}] {row['family']} "
                  f"n={row['n']} {row['dtype']}: "
                  f"chunk={row['chunk_size']} block={row['block_reps']} "
                  f"({rps_txt}, {age_txt}, source=tuned)")


def cmd_obs_budget(args):
    """Replay a privacy-budget audit trail: the per-event ε timeline and
    the replayed per-party spend table, which must equal the ledger
    snapshot's ``spent`` values. With ``--budget-dir`` the replay also
    folds the trail's sharded ``user/<id>`` legs and proves each user's
    lifetime spend equal to what the directory's shard files reconstruct
    (snapshot + WAL, the recovery path a restart takes); exit 1 on a
    mismatch."""
    from dpcorr_torch.obs.audit import read_events, replay, timeline
    from dpcorr_torch.obs.budget_replay import USER_PREFIX, read_user_balances

    events = read_events(args.audit)
    rows = timeline(events, party=args.party)
    totals = replay(events)
    dir_check = None
    if args.budget_dir:
        replayed_users = {p[len(USER_PREFIX):]: s
                          for p, s in totals.items()
                          if p.startswith(USER_PREFIX)}
        bal = read_user_balances(args.budget_dir)
        mismatches = []
        for user in sorted(set(replayed_users) | set(bal)):
            want = replayed_users.get(user, 0.0)
            got = bal.get(user, {}).get("l", 0.0)
            if abs(want - got) > 1e-9:
                mismatches.append({"user": user, "replayed": want,
                                   "directory": got})
        dir_check = {"ok": not mismatches, "users": len(bal),
                     "replayed_users": len(replayed_users),
                     "mismatches": mismatches}
    if args.party is not None:
        totals = {args.party: totals.get(args.party, 0.0)}
    if args.json:
        out = {"events": len(events), "timeline": rows, "spent": totals}
        if dir_check is not None:
            out["budget_dir"] = dir_check
        print(json.dumps(out, indent=2))
    else:
        for r in rows:
            after = " ".join(f"{p}={s:.6g}"
                             for p, s in sorted(r["spent_after"].items()))
            print(f"[{r['seq']:6d}] {r['kind']:<8} "
                  f"trace={r['trace_id'] or '-':<17} {after}")
        print(f"{len(events)} events; replayed spend:")
        for p, s in sorted(totals.items()):
            print(f"  {p}: {s:.6g}")
        if dir_check is not None:
            print(f"budget dir: {dir_check['users']} users on disk, "
                  f"{dir_check['replayed_users']} in the trail — "
                  f"{'OK' if dir_check['ok'] else 'MISMATCH'}")
            for m in dir_check["mismatches"]:
                print(f"  {m['user']}: replayed {m['replayed']:.6g} != "
                      f"directory {m['directory']:.6g}")
    if dir_check is not None and not dir_check["ok"]:
        sys.exit(1)


def cmd_obs_chrome(args):
    """Convert a span JSONL log to Chrome trace-event JSON (open in
    Perfetto / chrome://tracing)."""
    from dpcorr_torch.obs.trace import read_spans, write_chrome_trace

    n = len(read_spans(args.trace))
    write_chrome_trace(args.trace, args.out)
    print(f"wrote {args.out} ({n} spans)")


def cmd_obs_dump(args):
    """Replay a flight-recorder dump: summary mode lists what the rings
    held at dump time; ``--trace-id`` rebuilds one request's span chain,
    cost record and ledger-consistent ε trail from the dump alone."""
    from dpcorr_torch.obs.recorder import read_dump, reconstruct

    dump = read_dump(args.path)
    if args.trace_id:
        rc = reconstruct(dump, args.trace_id)
        if args.json:
            print(json.dumps(rc, indent=2))
            return
        print(f"trace {args.trace_id} ({len(rc['spans'])} spans)")
        for s in rc["spans"]:
            dur = s.get("dur_s")
            dur_txt = f"{dur * 1e3:9.3f} ms" if dur is not None else \
                "      open"
            print(f"  {dur_txt}  {s['name']}")
        if rc["cost"] is not None:
            print("cost: " + json.dumps(rc["cost"]))
        if rc["audit"]:
            print(f"audit: {len(rc['audit'])} events, "
                  f"eps_net={json.dumps(rc['eps_net'])}")
        return
    summary = {"reason": dump["reason"], "ts": dump["ts"],
               "detail": dump.get("detail", {}),
               "spans": len(dump["spans"]),
               "audit_events": len(dump["audit"]),
               "log_lines": len(dump["logs"]),
               "metric_samples": len(dump.get("metric_samples", [])),
               "cost_records": len(dump["costs"]),
               "trace_ids": sorted({s.get("trace_id")
                                    for s in dump["spans"]
                                    if s.get("trace_id")})}
    if args.json:
        print(json.dumps(summary, indent=2))
        return
    print(f"flight-recorder dump: reason={summary['reason']} "
          f"detail={json.dumps(summary['detail'])}")
    print(f"  {summary['spans']} spans over "
          f"{len(summary['trace_ids'])} traces, "
          f"{summary['audit_events']} audit events, "
          f"{summary['log_lines']} log lines, "
          f"{summary['cost_records']} cost records")
    for tid in summary["trace_ids"][:20]:
        print(f"  trace {tid}")
    if len(summary["trace_ids"]) > 20:
        print(f"  ... {len(summary['trace_ids']) - 20} more")


def cmd_obs_top(args):
    """Live ops console over a serve replica's /metrics + /stats — or,
    with --fleet / --federation, over every replica or federation party
    process in a target map at once; --stream renders a stream
    service's."""
    from dpcorr_torch.obs import console

    if args.federation:
        rc = console.run_federation_top(args.federation,
                                        interval_s=args.interval,
                                        once=args.once)
    elif args.fleet:
        rc = console.run_fleet_top(args.fleet, interval_s=args.interval,
                                   once=args.once)
    elif args.stream:
        rc = console.run_stream_top(args.url, interval_s=args.interval,
                                    once=args.once)
    else:
        rc = console.run_top(args.url, interval_s=args.interval,
                             once=args.once)
    raise SystemExit(rc)


def cmd_obs_provenance(args):
    """Build the federation ε-provenance DAG: merge every party's
    transcripts + audit trails + journals against the plan, prove
    exactly-once charging and byte-identical reuse at the
    ``2·f·ε·(k−1)`` optimum, and exit 1 naming the offending party on any
    divergence. ``--out`` writes the JSON document, ``--dot`` the
    Graphviz rendering, ``--cell I,J`` prints one cell's full story."""
    from dpcorr_torch.obs.provenance import (
        build_provenance,
        discover_federation,
    )

    plan, transcripts, audits, journals = discover_federation(
        args.plan, transcript_dir=args.transcript_dir,
        transcript_specs=args.transcript, audit_specs=args.audit,
        journal_dir=args.journal_dir)
    if not any(transcripts.values()):
        raise SystemExit("no transcripts found: pass --transcript-dir "
                         "or --transcript NAME=PATH")
    prov = build_provenance(plan, transcripts, audits=audits,
                            journals=journals)
    doc = prov.to_doc()
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
    if args.dot:
        with open(args.dot, "w", encoding="utf-8") as f:
            f.write(prov.to_dot())
    if args.cell:
        i, _, j = args.cell.partition(",")
        print(json.dumps(prov.cell_story(int(i), int(j)), indent=2))
    elif args.json:
        print(json.dumps(doc, indent=2))
    else:
        eps = doc["eps"]
        exact = prov.total_eps == prov.expected_eps
        print(f"provenance {prov.fed}: "
              f"{doc['counts']['nodes']} nodes, "
              f"{doc['counts']['edges']} edges; "
              f"eps total={eps['total']:.6g} "
              f"optimal={eps['optimal']:.6g} "
              f"{'EXACT' if exact else 'MISMATCH'}")
        for pname, rec in sorted(eps["parties"].items()):
            print(f"  {pname}: spent={rec['spent']:.6g} "
                  f"share={rec['share']:.6g}")
        for d in prov.divergences:
            print(f"  DIVERGENCE [{d['kind']}] party={d['party']}: "
                  f"{d['detail']}")
    if not prov.ok:
        from dpcorr_torch.obs import recorder as obs_recorder

        obs_recorder.trigger(
            "federation_scan_violation",
            divergences=[{"kind": d["kind"], "party": d["party"]}
                         for d in prov.divergences])
        sys.exit(1)


def cmd_obs_watch(args):
    """Live invariant sentinel: tail the durable artifacts the services
    write — audit trails, the stream's ingest WAL and release journal,
    budget directories, federation transcripts and session journals —
    and re-prove ε conservation and durability incrementally, within a
    poll of the write. Typed violations name the offending artifact, arm
    the offender's flight recorder and page through the burn-rate
    engine; exit 1 when this run detected anything. Restart-safe from
    its own checkpoint."""
    from dpcorr_torch.obs.sentinel import Sentinel

    def specs(pairs, flag):
        out = {}
        for spec in pairs or ():
            name, sep, value = spec.partition("=")
            if not sep or not name or not value:
                raise SystemExit(f"{flag} {spec!r}: expected NAME=PATH")
            out[name] = value
        return out

    streams = specs(args.stream, "--stream")
    audits = specs(args.audit, "--audit")
    budget_dirs = specs(args.budget_dir, "--budget-dir")
    transcripts = specs(args.transcripts, "--transcripts")
    journals = specs(args.journals, "--journals")
    urls = specs(args.url, "--url")
    if not (streams or audits or transcripts or journals):
        raise SystemExit("nothing to watch: pass --stream/--audit/"
                         "--transcripts/--journals NAME=PATH")
    for name in budget_dirs:
        if name not in audits:
            raise SystemExit(f"--budget-dir {name}=...: no matching "
                             f"--audit {name}=... to fold against")
    sentinel = Sentinel(args.checkpoint, urls=urls,
                        instance=args.instance)
    for name, workdir in sorted(streams.items()):
        sentinel.add_stream(name, workdir, url=urls.get(name))
    for name, path in sorted(audits.items()):
        sentinel.add_audit(name, path, url=urls.get(name),
                           budget_dir=budget_dirs.get(name))
    for name, d in sorted(transcripts.items()):
        sentinel.add_transcripts(name, d)
    for name, d in sorted(journals.items()):
        sentinel.add_journals(name, d)

    obs_server = None
    banner = {"instance": args.instance,
              "checkpoint": args.checkpoint,
              "watchers": sentinel.stats()["watchers"]}
    if args.obs_port is not None:
        from dpcorr_torch.obs.endpoint import start_obs_server

        obs_server, obs_port = start_obs_server(
            sentinel.registry, stats_fn=sentinel.stats,
            port=args.obs_port)
        banner["obs_port"] = obs_port
    print(json.dumps({"sentinel": banner}), flush=True)

    def on_violation(v):
        if args.json:
            print(json.dumps({"violation": v.to_dict()}), flush=True)
        else:
            print(f"VIOLATION [{v.kind}] source={v.source} "
                  f"artifact={v.artifact}: {v.detail}", flush=True)
    sentinel.on_violation = on_violation
    try:
        rc = sentinel.run(interval_s=args.interval,
                          max_polls=1 if args.once else args.max_polls)
    except KeyboardInterrupt:
        rc = sentinel.rc
    finally:
        if obs_server is not None:
            obs_server.shutdown()
    if args.json:
        print(json.dumps({"summary": sentinel.stats()}, indent=2))
    sys.exit(rc)


def _add_obs(sub) -> None:
    """Every ``obs`` subcommand of ``python -m dpcorr``, with its flags,
    outputs and exit codes. None computes on a device: they read files
    and scrape endpoints, and import no torch."""
    po_ = sub.add_parser("obs", help="observability tooling: audit-trail "
                         "replay, Chrome-trace export, flight-recorder "
                         "dumps, the live console, federation provenance, "
                         "the invariant sentinel, the fleet telemetry "
                         "plane, the geometry cache, signature dumps, the "
                         "bench trajectory")
    obs_sub = po_.add_subparsers(dest="obs_cmd", required=True)
    pob = obs_sub.add_parser("budget", help="per-party ε-spend timeline "
                             "replayed from a ledger audit trail")
    pob.add_argument("--audit", required=True,
                     help="audit-trail JSONL path (serve --audit)")
    pob.add_argument("--party", default=None,
                     help="restrict the timeline to one party")
    pob.add_argument("--budget-dir", dest="budget_dir", default=None,
                     help="per-user budget directory root: fold the "
                          "trail's sharded user/ legs and prove them "
                          "equal to the directory's on-disk recovery "
                          "arithmetic (exit 1 on mismatch)")
    pob.add_argument("--json", action="store_true")
    pob.set_defaults(fn=cmd_obs_budget)
    poc = obs_sub.add_parser("chrome", help="convert a span JSONL log "
                             "to Chrome trace-event JSON (Perfetto)")
    poc.add_argument("--trace", required=True,
                     help="span-trace JSONL path (serve --trace)")
    poc.add_argument("--out", required=True,
                     help="output Chrome trace JSON path")
    poc.set_defaults(fn=cmd_obs_chrome)
    pod = obs_sub.add_parser("dump", help="replay a flight-recorder "
                             "dump: span chains, cost records and the "
                             "ε trail")
    pod.add_argument("path", help="dump path (serve --flight-recorder)")
    pod.add_argument("--trace-id", dest="trace_id", default=None,
                     help="reconstruct one request's span chain + "
                          "cost record + ε trail")
    pod.add_argument("--json", action="store_true")
    pod.set_defaults(fn=cmd_obs_dump)
    pot = obs_sub.add_parser("top", help="live ops console over a "
                             "serve replica's /metrics + /stats")
    pot.add_argument("--url", default="http://127.0.0.1:8321",
                     help="serve base URL")
    pot.add_argument("--interval", type=float, default=2.0,
                     help="refresh seconds")
    pot.add_argument("--fleet", default=None, metavar="TARGETS",
                     help="multi-instance view: comma-separated "
                          "name=url targets (bare urls get positional "
                          "names); overrides --url")
    pot.add_argument("--federation", default=None, metavar="TARGETS",
                     help="federation view: comma-separated name=url "
                          "targets pointing at party --obs-port "
                          "endpoints; overrides --url and --fleet")
    pot.add_argument("--stream", action="store_true",
                     help="render the stream console (windows, "
                          "watermark, ε/window) instead of the serve one")
    pot.add_argument("--once", action="store_true",
                     help="render one frame and exit (scripting)")
    pot.set_defaults(fn=cmd_obs_top)
    pop = obs_sub.add_parser(
        "provenance", help="federation ε-provenance DAG: merge per-party "
        "transcripts/audits/journals against the plan, prove "
        "exactly-once charging + byte-identical reuse at the 2fε(k-1) "
        "optimum; exit 1 names the offending party")
    pop.add_argument("--plan", required=True,
                     help="federation plan JSON (`federation plan` "
                          "output or its `plan` field)")
    pop.add_argument("--transcript-dir", dest="transcript_dir",
                     default=None,
                     help="directory of {session}.{party}.jsonl "
                          "pair-link transcripts (party inferred from "
                          "the filename)")
    pop.add_argument("--transcript", action="append", default=None,
                     metavar="NAME=PATH",
                     help="explicit party transcript (repeatable; "
                          "bare PATH infers the party from the "
                          "filename)")
    pop.add_argument("--audit", action="append", default=None,
                     metavar="NAME=PATH",
                     help="party audit trail (repeatable) — required "
                          "to *prove* exactly-once charging rather "
                          "than infer it from transcripts")
    pop.add_argument("--journal-dir", dest="journal_dir", default=None,
                     help="session-journal directory (adds resume "
                          "lineage to round nodes)")
    pop.add_argument("--out", default=None,
                     help="write the provenance JSON document here")
    pop.add_argument("--dot", default=None,
                     help="write the Graphviz DOT rendering here")
    pop.add_argument("--cell", default=None, metavar="I,J",
                     help="print one cell's full story (rounds, "
                          "artifacts, charges) instead of the summary")
    pop.add_argument("--json", action="store_true",
                     help="print the full document to stdout")
    pop.set_defaults(fn=cmd_obs_provenance)
    pow_ = obs_sub.add_parser(
        "watch", help="live invariant sentinel: tail audit trails, "
        "stream WAL/journal, budget dirs and transcripts; typed "
        "violations page, arm the offender's flight recorder and set "
        "exit 1")
    pow_.add_argument("--checkpoint", required=True,
                      help="the sentinel's own fsynced offset/state "
                           "checkpoint: restarts resume mid-file and "
                           "never re-alert on re-read")
    pow_.add_argument("--stream", action="append",
                      metavar="NAME=WORKDIR",
                      help="watch a stream workdir (wal.jsonl, "
                           "releases.jsonl, audit.jsonl, budget_dir)")
    pow_.add_argument("--audit", action="append", metavar="NAME=PATH",
                      help="watch a bare audit trail (serve --audit / "
                           "party --audit)")
    pow_.add_argument("--budget-dir", dest="budget_dir",
                      action="append", metavar="NAME=ROOT",
                      help="ε-conservation leg for --audit NAME: the "
                           "directory's on-disk user balances must "
                           "equal the trail's user/ fold")
    pow_.add_argument("--transcripts", action="append",
                      metavar="NAME=DIR",
                      help="watch pair-link transcripts for re-noised "
                           "or double-charged artifacts")
    pow_.add_argument("--journals", action="append", metavar="NAME=DIR",
                      help="watch session-journal snapshots for "
                           "resume-breaking corruption")
    pow_.add_argument("--url", action="append", metavar="NAME=URL",
                      help="NAME's live base URL: its ledger gauges "
                           "are scraped for the conservation check and "
                           "its flight recorder armed (POST "
                           "/obs/trigger) on violation")
    pow_.add_argument("--interval", type=float, default=1.0,
                      help="poll seconds (detection latency bound)")
    pow_.add_argument("--max-polls", dest="max_polls", type=int,
                      default=None, help="stop after N polls")
    pow_.add_argument("--once", action="store_true",
                      help="one poll, then exit with the rc")
    pow_.add_argument("--instance", default="sentinel")
    pow_.add_argument("--obs-port", dest="obs_port", type=int,
                      default=None,
                      help="the sentinel's own scrape surface "
                           "(dpcorr_sentinel_* metrics + /stats)")
    pow_.add_argument("--json", action="store_true")
    pow_.set_defaults(fn=cmd_obs_watch)
    potr = obs_sub.add_parser(
        "trajectory", help="bench-trajectory dashboard: per-(device_kind, "
        "metric) series over the committed BENCH_*/MULTICHIP_*/"
        "benchmarks-results artifacts; names the first artifact that "
        "bent the curve")
    potr.add_argument("--root", action="append", default=None,
                      help="artifact root (file or dir, repeatable); "
                           "default: repo root + benchmarks/results")
    potr.add_argument("--repo", default=".",
                      help="repo root for the default artifact roots")
    potr.add_argument("--floor", type=float, default=0.85,
                      help="regression floor vs best-so-far (0.85 = "
                           "flag a drop below 85%%)")
    potr.add_argument("--format", choices=["console", "json", "markdown"],
                      default="console")
    potr.add_argument("--check", action="store_true",
                      help="exit 1 when any series regressed")
    potr.set_defaults(fn=cmd_obs_trajectory)
    poh = obs_sub.add_parser(
        "hlo", help="show or diff the JAX package's persisted HLO "
        "signature dumps (cost, memory, fingerprints, op histograms); "
        "the port writes none")
    hlo_sub = poh.add_subparsers(dest="hlo_cmd", required=True)
    pohs = hlo_sub.add_parser("show", help="list one dump's signatures")
    pohs.add_argument("path", help="dpcorr_hlo_dump JSON path")
    pohs.add_argument("--json", action="store_true")
    pohs.set_defaults(fn=cmd_obs_hlo)
    pohd = hlo_sub.add_parser(
        "diff", help="explain what changed between two dumps: "
        "fingerprint flips, FLOP/byte/memory deltas, op-count deltas")
    pohd.add_argument("old", help="baseline dump")
    pohd.add_argument("new", help="candidate dump")
    pohd.add_argument("--json", action="store_true")
    pohd.set_defaults(fn=cmd_obs_hlo)
    pog = obs_sub.add_parser(
        "geometry", help="autotuner cache view: tuned (chunk x block) per "
        "(device_kind, family, n, dtype) with env-pin provenance and "
        "staleness; exit 1 on a corrupt cache")
    pog.add_argument("--path", default=None,
                     help="cache path (default: the resolved "
                          "DPCORR_GEOMETRY_CACHE / ~/.cache location)")
    pog.add_argument("--json", action="store_true")
    pog.set_defaults(fn=cmd_obs_geometry)
    pof = obs_sub.add_parser("fleet", help="fleet telemetry plane: scrape "
                             "+ merge N instances, union spools, replay "
                             "the fleet ε table")
    fleet_sub = pof.add_subparsers(dest="fleet_cmd", required=True)
    pofs = fleet_sub.add_parser("snapshot", help="scrape every target's "
                                "/metrics + /stats into one artifact: "
                                "merged instance-labelled exposition + "
                                "exact aggregate + per-instance stats")
    pofs.add_argument("--targets", required=True,
                      help="comma-separated name=url (bare urls get "
                           "positional instance-N names; duplicate "
                           "names are refused)")
    pofs.add_argument("--out", default=None,
                      help="write the snapshot JSON here")
    pofs.add_argument("--timeout", type=float, default=5.0)
    pofs.add_argument("--json", action="store_true",
                      help="print the full snapshot document")
    pofs.set_defaults(fn=cmd_obs_fleet_snapshot)
    pofc = fleet_sub.add_parser("chrome", help="union many span spools "
                                "into ONE Chrome trace, one pid per "
                                "instance (Perfetto-viewable)")
    pofc.add_argument("--spool", action="append", required=True,
                      metavar="NAME=PATH",
                      help="instance span spool (repeatable)")
    pofc.add_argument("--out", required=True)
    pofc.set_defaults(fn=cmd_obs_fleet_chrome)
    pofr = fleet_sub.add_parser("replay", help="fleet-wide audit "
                                "replay: per-instance ε tables + the "
                                "binary-exact fleet fold")
    pofr.add_argument("--audit", action="append", required=True,
                      metavar="NAME=PATH",
                      help="instance audit spool (repeatable)")
    pofr.add_argument("--json", action="store_true")
    pofr.set_defaults(fn=cmd_obs_fleet_replay)


def cmd_doctor(args):
    import os

    from dpcorr_torch.utils import doctor

    report = doctor.diagnose(probe=args.probe, sweep=args.sweep)
    try:
        if args.json:
            print(json.dumps(report))
        else:
            print(doctor.render_text(report))
        sys.stdout.flush()
    except BrokenPipeError:
        # `doctor | head` must not stack-trace, and the interpreter's
        # exit-time flush would re-raise: hand it a dead fd instead
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())


def _add_doctor(sub) -> None:
    pd_ = sub.add_parser(
        "doctor", help="environment health report: the cards nvidia-smi "
        "shows, nvcc and sm_90a, the build cache (dpcorr_torch/_build, "
        "stale libraries), stray worker processes of this checkout "
        "holding a card (fan-out workers, chip_smoke.py, plan_ab.py; "
        "never a service). The JAX doctor's relay check and --queue-dir have no "
        "counterpart here: a card host has no tunnel relay and no TPU "
        "validation queue")
    pd_.add_argument("--probe", action="store_true",
                     help="also initialise CUDA in a subprocess (its own "
                          "process group, hard timeout) and report the "
                          "card's name, compute capability and power limit")
    pd_.add_argument("--sweep", action="store_true",
                     help="kill stray worker processes of this checkout "
                          "that hold a card and were reparented to init")
    pd_.add_argument("--json", action="store_true")
    pd_.set_defaults(fn=cmd_doctor)


def cmd_lint(args):
    from dpcorr_torch.analysis import cli as lint_cli

    sys.exit(lint_cli.run(args))


def _add_lint(sub) -> None:
    from dpcorr_torch.analysis import cli as lint_cli

    pl_ = sub.add_parser("lint", help="AST-based privacy/RNG/concurrency "
                         "invariant checker over the port's own source "
                         "(imports no torch)")
    lint_cli.add_arguments(pl_)
    pl_.set_defaults(fn=cmd_lint)


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run: the card (default; raises without "
                        "one) or the CPU")


def _add_spec_flags(p) -> None:
    p.add_argument("--family", default="ni_sign",
                   choices=["ni_sign", "int_sign", "ni_subg", "int_subg"])
    p.add_argument("--n", type=int, default=4000)
    p.add_argument("--eps1", type=float, default=1.0)
    p.add_argument("--eps2", type=float, default=0.5)
    p.add_argument("--alpha", type=float, default=0.05)
    p.add_argument("--normalise", default="on", choices=["on", "off"])
    p.add_argument("--seed", type=int, default=2025)
    p.add_argument("--session", default=None,
                   help="session id (default: derived from the spec hash, "
                        "so both parties agree without coordination)")
    p.add_argument("--noise-mode", dest="noise_mode", default="replay",
                   choices=["replay", "hardened"],
                   help="key layout (utils.rng.party_root): 'replay' is "
                        "bit-equal to the monolithic estimators; "
                        "'hardened' gives each party a disjoint key "
                        "subtree")
    p.add_argument("--rho", type=float, default=0.6,
                   help="synthetic-data correlation (ignored with --data)")
    p.add_argument("--timeout", type=float, default=10.0,
                   help="per-message ack timeout (seconds)")
    p.add_argument("--max-retries", dest="max_retries", type=int,
                   default=10)
    _add_device(p)


def _add_fault_flags(p, seed_help: str) -> None:
    p.add_argument("--fault-drop", dest="fault_drop", type=float,
                   default=0.0, help="fault injection: drop rate")
    p.add_argument("--fault-delay-ms", dest="fault_delay_ms", type=float,
                   default=0.0, help="fault injection: per-frame delay")
    p.add_argument("--fault-duplicate", dest="fault_duplicate", type=float,
                   default=0.0, help="fault injection: duplicate rate")
    p.add_argument("--fault-seed", dest="fault_seed", type=int,
                   default=None, help=seed_help)


def _add_protocol(sub) -> None:
    """``party`` and ``protocol run | scan``, with the JAX package's flags
    (``--device`` in place of ``--platform``)."""
    pp_ = sub.add_parser("party", help="one side of the two-party DP "
                         "protocol over TCP: role y listens, role x "
                         "connects; each process holds one column")
    pp_.add_argument("--role", required=True, choices=["x", "y"])
    pp_.add_argument("--instance", default=None,
                     help="instance name, stamped into the banner and the "
                          "transcript header")
    pp_.add_argument("--host", default="127.0.0.1")
    pp_.add_argument("--port", type=int, required=True)
    pp_.add_argument("--connect-timeout", dest="connect_timeout",
                     type=float, default=30.0,
                     help="seconds to keep dialing (x) or await the peer "
                          "(y)")
    pp_.add_argument("--data", default=None,
                     help="this party's column as a .npy file (shape "
                          "(n,)); default: synthetic from --rho/--seed")
    pp_.add_argument("--budget", type=float, default=100.0,
                     help="this party's ε budget (basic composition)")
    pp_.add_argument("--ledger", default=None,
                     help="ledger persistence path (JSON), the format of "
                          "serve --ledger and of the JAX package")
    pp_.add_argument("--user", default=None,
                     help="principal this party's releases are charged "
                          "to in the per-user directory (default with "
                          "--user-dir: user-<role>)")
    pp_.add_argument("--user-dir", dest="user_dir", default=None,
                     help="per-user budget directory root: wraps the "
                          "ledger in a CompositeLedger so every gated "
                          "release also charges the bound user, "
                          "idempotently across crash-restarts")
    pp_.add_argument("--user-budget", dest="user_budget", type=float,
                     default=1.0, help="per-user ε budget per window")
    pp_.add_argument("--user-shards", dest="user_shards", type=int,
                     default=8, help="directory shard count")
    pp_.add_argument("--user-max-resident", dest="user_max_resident",
                     type=int, default=None,
                     help="LRU cap on in-memory users per shard")
    pp_.add_argument("--user-compact-every", dest="user_compact_every",
                     type=int, default=256,
                     help="WAL-to-snapshot compaction interval (appends)")
    pp_.add_argument("--transcript", default=None,
                     help="JSONL wire transcript path (audit it with "
                          "`protocol scan`)")
    pp_.add_argument("--trace", default=None,
                     help="span-trace JSONL path; the trace ID crosses "
                          "the wire, so both parties' logs join")
    pp_.add_argument("--audit", default=None,
                     help="budget audit-trail JSONL path")
    pp_.add_argument("--journal", default=None,
                     help="session journal path (JSON): rerun the same "
                          "command after a crash and the session resumes")
    pp_.add_argument("--chaos", default=None,
                     help="crash plan 'point=NAME[,hit=K][,mode=exit|"
                          "raise]' or 'seed=N' (dpcorr_torch.chaos); "
                          "default: $DPCORR_CHAOS; recorded in the "
                          "transcript header")
    pp_.add_argument("--recv-timeout", dest="recv_timeout", type=float,
                     default=30.0,
                     help="seconds to wait for the peer's next message "
                          "(raise it when the peer may restart)")
    _add_spec_flags(pp_)
    pp_.set_defaults(fn=cmd_party)

    pr_ = sub.add_parser("protocol", help="two-party protocol tooling: "
                         "both roles in one process, and the torch-free "
                         "transcript auditor")
    pr_sub = pr_.add_subparsers(dest="protocol_cmd", required=True)
    prr = pr_sub.add_parser("run", help="drive both roles in-process over "
                            "queue-pair or loopback-TCP transport")
    prr.add_argument("--transport", default="inproc",
                     choices=["inproc", "tcp"])
    prr.add_argument("--transcript-dir", dest="transcript_dir",
                     default=None,
                     help="write each party's wire transcript JSONL here")
    _add_fault_flags(prr, "base seed for both sides' fault injectors "
                          "(stamped into the transcript headers)")
    _add_spec_flags(prr)
    prr.set_defaults(fn=cmd_protocol_run)
    prs = pr_sub.add_parser("scan", help="audit a party transcript: "
                            "schema and no raw columns, and with --audit "
                            "the transcript-ledger ε balance; exit 1 on "
                            "violations (needs no torch)")
    prs.add_argument("--transcript", required=True,
                     help="party transcript JSONL")
    prs.add_argument("--audit", default=None,
                     help="that party's audit-trail JSONL; enables the ε "
                          "balance check")
    prs.set_defaults(fn=cmd_protocol_scan)


def _add_federation(sub) -> None:
    """``federation plan | run | party | scan``, with the JAX package's
    flags (``--device`` in place of ``--platform``)."""
    pf_ = sub.add_parser("federation", help="N-party federation: the k×k "
                         "DP correlation matrix over multiplexed pair "
                         "sessions, at the release-reuse ε optimum")
    pf_sub = pf_.add_subparsers(dest="federation_cmd", required=True)

    def fed_flags(p):
        p.add_argument("--plan", default=None,
                       help="federation plan JSON file (the document "
                            "`federation plan` prints, or its inner "
                            "public dict); overrides --party and the spec "
                            "flags")
        p.add_argument("--party", action="append", default=None,
                       metavar="NAME=LAB1[,LAB2...]",
                       help="one party and its column labels (repeatable; "
                            "order is the plan order)")
        p.add_argument("--family", default="ni_sign",
                       choices=["ni_sign", "int_sign", "ni_subg",
                                "int_subg"])
        p.add_argument("--n", type=int, default=4000)
        p.add_argument("--eps", type=float, default=1.0,
                       help="the federation's shared per-column ε")
        p.add_argument("--alpha", type=float, default=0.05)
        p.add_argument("--normalise", default="on", choices=["on", "off"])
        p.add_argument("--seed", type=int, default=2025)
        p.add_argument("--noise-mode", dest="noise_mode",
                       default="replay", choices=["replay", "hardened"])
        p.add_argument("--max-cells-per-round",
                       dest="max_cells_per_round", type=int, default=0,
                       help="chunk a link's cells into rounds of this size "
                            "(0: all of a link's cells in one round)")

    def run_flags(p):
        p.add_argument("--rho", type=float, default=0.6,
                       help="synthetic-data equicorrelation across the k "
                            "columns")
        p.add_argument("--engine", default="exact",
                       choices=["exact", "vector"],
                       help="batched finish engine "
                            "(split_reference.finish_batch): 'exact' is "
                            "the bit-identity contract, 'vector' one call "
                            "over the round's cells")
        p.add_argument("--timeout", type=float, default=10.0,
                       help="per-message ack timeout (seconds)")
        p.add_argument("--max-retries", dest="max_retries", type=int,
                       default=10)
        _add_device(p)

    pfp = pf_sub.add_parser("plan", help="compile and print the schedule: "
                            "cells, links, rounds, artifact charge venues "
                            "and the ε arithmetic (needs no torch)")
    fed_flags(pfp)
    pfp.set_defaults(fn=cmd_federation_plan)

    pfr = pf_sub.add_parser("run", help="the whole federation in one "
                            "process over queue-pair or loopback-TCP "
                            "transport")
    fed_flags(pfr)
    run_flags(pfr)
    pfr.add_argument("--transport", default="inproc",
                     choices=["inproc", "tcp"])
    pfr.add_argument("--transcript-dir", dest="transcript_dir",
                     default=None,
                     help="write every pair link's per-party transcript "
                          "JSONL here (audit with `federation scan`)")
    _add_fault_flags(pfr, "base seed for every endpoint's fault injector")
    pfr.set_defaults(fn=cmd_federation_run)

    pft = pf_sub.add_parser("party", help="one real party process of a "
                            "multi-process federation over TCP; with "
                            "--journal-dir the matrix is crash-safe")
    fed_flags(pft)
    run_flags(pft)
    pft.add_argument("--name", required=True,
                     help="this process's party name in the plan")
    pft.add_argument("--listen", default=None, metavar="HOST:PORT",
                     help="bind here for peers that dial this party (port "
                          "0: ephemeral, announced in the banner)")
    pft.add_argument("--peer", action="append", default=None,
                     metavar="NAME=HOST:PORT",
                     help="where to dial a higher-indexed link peer "
                          "(repeatable)")
    pft.add_argument("--budget", type=float, default=100.0,
                     help="this party's ε budget (basic composition)")
    pft.add_argument("--ledger", default=None,
                     help="ledger persistence path (JSON)")
    pft.add_argument("--audit", default=None,
                     help="budget audit-trail JSONL path")
    pft.add_argument("--trace", default=None,
                     help="span-trace JSONL path, or a directory that "
                          "spools to trace.<instance>.jsonl")
    pft.add_argument("--instance", default=None,
                     help="instance name for the banner and the span "
                          "spool; default: --name")
    pft.add_argument("--obs-port", dest="obs_port", type=int,
                     default=None, metavar="PORT",
                     help="serve /metrics + /stats + POST /obs/trigger on "
                          "this port (0: ephemeral, announced in the "
                          "banner)")
    pft.add_argument("--transcript-dir", dest="transcript_dir",
                     default=None, help="per-link transcript directory")
    pft.add_argument("--journal-dir", dest="journal_dir", default=None,
                     help="per-link session journal directory: every "
                          "pair session crash-safe")
    pft.add_argument("--chaos", default=None,
                     help="crash plan 'point=NAME[,hit=K][,mode=exit|"
                          "raise]' or 'seed=N'; default: $DPCORR_CHAOS")
    pft.add_argument("--connect-timeout", dest="connect_timeout",
                     type=float, default=30.0,
                     help="seconds to keep dialing or await each peer")
    pft.add_argument("--recv-timeout", dest="recv_timeout", type=float,
                     default=30.0,
                     help="seconds to wait for a peer's next message")
    pft.set_defaults(fn=cmd_federation_party)

    pfs = pf_sub.add_parser("scan", help="audit a federation's pair "
                            "transcripts: schema and no raw columns, the "
                            "cross-pair correlation-leak gate and each "
                            "party's ε balance (needs no torch)")
    pfs.add_argument("--transcript", action="append", default=None,
                     help="pair-link transcript JSONL (repeatable)")
    pfs.add_argument("--transcript-dir", dest="transcript_dir",
                     default=None,
                     help="scan every *.jsonl here (audit. and trace. "
                          "prefixes skipped)")
    pfs.add_argument("--audit", action="append", default=None,
                     metavar="NAME=PATH",
                     help="party NAME's audit-trail JSONL: enables its "
                          "whole-matrix ε balance check (repeatable)")
    pfs.add_argument("--plan", default=None,
                     help="the federation plan JSON, from which the "
                          "balance check derives each party's local-cell "
                          "ε (default: 0)")
    pfs.set_defaults(fn=cmd_federation_scan)


# ------------------------------------------------------------- streaming
def _stream_placement(args, device):
    """``--placement`` / ``--mesh-devices`` as a ``dpcorr_torch.plan``
    placement (None without ``--placement``: the monolithic release)."""
    if args.placement is None:
        return None
    from dpcorr_torch.plan import MeshPlacement, resolve_placement

    if args.placement == "mesh" and args.mesh_devices:
        return MeshPlacement(n_devices=args.mesh_devices, device=device)
    return resolve_placement(args.placement, device=device)


def cmd_stream(args):
    """Always-on windowed DP correlation over an ingest stream
    (counterpart of ``python -m dpcorr stream``): event-time windows, one
    atomic ε charge per window, crash-exact releases, on ``--device``.
    Binds before the banner, so ``--port 0`` resolves first."""
    import signal

    from dpcorr_torch.stream.http import make_stream_http_server
    from dpcorr_torch.stream.service import StreamService
    from dpcorr_torch.stream.windows import WindowSpec

    device = _device(args)
    plan = _arm_chaos(args)
    rec = None
    if args.flight_recorder:
        from dpcorr_torch.obs.recorder import FlightRecorder, install

        rec = FlightRecorder(args.flight_recorder)
        install(rec)
        signal.signal(signal.SIGUSR2,
                      lambda signum, frame: rec.dump("sigusr2"))
    spec = WindowSpec(size_s=args.window_s, slide_s=args.slide_s,
                      late_s=args.late_s)
    service = StreamService(
        args.workdir, spec, args.families.split(","),
        args.eps1, args.eps2, normalise=args.normalise == "on",
        budget=args.budget, seed=args.seed,
        party_x=args.party_x, party_y=args.party_y,
        stream_id=args.stream_id, user=args.user,
        user_budget=args.user_budget, global_budget=args.global_budget,
        max_pending_rows=args.max_pending_rows,
        placement=_stream_placement(args, device), device=device)
    if rec is not None:
        rec.watch_registry(service.registry)
        rec.watch_costs(service.costs)
    # instance identity: the self-claim gauge a scraper verifies against
    # its target name
    instance = args.instance or args.stream_id
    service.registry.gauge(
        "dpcorr_stream_instance_info",
        "stream identity: constant 1 labelled by instance name",
        labelnames=("instance",)).set(1, instance=instance)
    obs_server = obs_port = None
    if args.obs_port is not None:
        from dpcorr_torch.obs.endpoint import start_obs_server

        obs_server, obs_port = start_obs_server(
            service.registry, stats_fn=service.stats,
            host=args.host, port=args.obs_port)
    httpd = make_stream_http_server(service, host=args.host,
                                    port=args.port)
    bound_port = httpd.server_address[1]
    print(json.dumps({"streaming": {
        "host": args.host, "port": bound_port,
        "instance": instance, "obs_port": obs_port,
        "workdir": args.workdir, "stream_id": args.stream_id,
        "families": list(service.families),
        "window_s": args.window_s, "slide_s": args.slide_s,
        "late_s": args.late_s, "eps1": args.eps1, "eps2": args.eps2,
        "normalise": args.normalise == "on", "budget": args.budget,
        "eps_per_window": service.per_window_charges,
        "released": len(service.journal.entries()),
        "chaos": plan.to_dict() if plan is not None else None,
        "flight_recorder": args.flight_recorder,
        "device": str(service.device)}}), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
        if obs_server is not None:
            obs_server.shutdown()
        service.close()


def _add_stream(sub) -> None:
    """``stream``, with the JAX package's flags (``--device`` in place of
    ``--platform``)."""
    pst = sub.add_parser("stream", help="always-on windowed DP "
                         "correlation over an ingest stream")
    pst.add_argument("--workdir", required=True,
                     help="durable state directory: ingest WAL, release "
                          "journal, ledger snapshot, audit trail "
                          "(restart-safe — a kill -9 resumes from here)")
    pst.add_argument("--host", default="127.0.0.1")
    pst.add_argument("--port", type=int, default=8324,
                     help="HTTP ingest/subscribe port (0 = ephemeral; "
                          "read the bound port from the banner)")
    pst.add_argument("--window-s", dest="window_s", type=float,
                     default=10.0, help="event-time window size")
    pst.add_argument("--slide-s", dest="slide_s", type=float,
                     default=None,
                     help="sliding hop (default: tumbling)")
    pst.add_argument("--late-s", dest="late_s", type=float, default=0.0,
                     help="bounded lateness: watermark trails the max "
                          "event time seen by this much")
    pst.add_argument("--families", default="ni_sign",
                     help="comma list of estimator families released "
                          "per window")
    pst.add_argument("--eps1", type=float, default=1.0)
    pst.add_argument("--eps2", type=float, default=0.5)
    pst.add_argument("--normalise", default="on", choices=["on", "off"])
    pst.add_argument("--budget", type=float, default=100.0,
                     help="per-party ε budget (refuse-before-release: "
                          "an exhausted window is refused, never noised)")
    pst.add_argument("--seed", type=int, default=2025)
    pst.add_argument("--party-x", dest="party_x", default="party/x")
    pst.add_argument("--party-y", dest="party_y", default="party/y")
    pst.add_argument("--stream-id", dest="stream_id", default="stream",
                     help="charge-id namespace: per-window charges are "
                          "stream:<stream-id>:<window-id>")
    pst.add_argument("--user", default=None,
                     help="bind every window's charge to this user in a "
                          "per-user budget directory under the workdir "
                          "(renewal period = the window hop)")
    pst.add_argument("--user-budget", dest="user_budget", type=float,
                     default=None,
                     help="per-renewal-window user ε budget "
                          "(default: --budget)")
    pst.add_argument("--global-budget", dest="global_budget", type=float,
                     default=None,
                     help="instance-wide ε cap across every principal")
    pst.add_argument("--max-pending-rows", dest="max_pending_rows",
                     type=int, default=1 << 20,
                     help="bounded ingest: refuse batches (429 + "
                          "Retry-After) past this many buffered rows")
    pst.add_argument("--chaos", default=None, metavar="SPEC",
                     help="install a chaos kill plan, e.g. "
                          "'point=stream.pre_release,hit=1,mode=exit' "
                          "(also honoured from DPCORR_CHAOS; testing only)")
    pst.add_argument("--flight-recorder", dest="flight_recorder",
                     default=None, metavar="PATH",
                     help="flight-recorder dump path (armed for "
                          "stream_release_failed and chaos kills)")
    pst.add_argument("--instance", default=None,
                     help="identity claimed in the "
                          "dpcorr_stream_instance_info gauge "
                          "(default: --stream-id)")
    pst.add_argument("--obs-port", dest="obs_port", type=int,
                     default=None,
                     help="observability endpoint port (0 = ephemeral; "
                          "/metrics, /stats, /healthz, POST "
                          "/obs/trigger)")
    pst.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                     help="where window releases run: the card (default; "
                          "raises without one) or the CPU")
    pst.add_argument("--placement", default=None,
                     choices=["local", "mesh"],
                     help="execution placement for window finalize "
                          "(dpcorr_torch.plan): 'mesh' splits each pass's "
                          "chunk set over the devices and tree-merges "
                          "the shard sketches, byte-equal to the default "
                          "monolithic release")
    pst.add_argument("--mesh-devices", dest="mesh_devices", type=int,
                     default=None,
                     help="device count for --placement mesh (default: "
                          "every visible card, or one CPU entry with "
                          "--device cpu)")
    pst.set_defaults(fn=cmd_stream)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="dpcorr_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    backends_by_cmd = {"grid": GRID_BACKENDS, "grid-subg": GRID_BACKENDS,
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
            p.add_argument("--precompile", default="auto",
                           choices=["off", "auto", "on"],
                           help="accepted as in python -m dpcorr and "
                                "inert: eager torch has no bucket program "
                                "to build ahead, so every value runs the "
                                "same units (GridConfig.precompile)")
        p.set_defaults(fn=fn)
    p = sub.add_parser("report")
    p.add_argument("--from", dest="src", required=True,
                   help="a finished grid, grid-subg or hrs-sweep --out "
                        "directory; the figures are written there")
    p.add_argument("--family", choices=["v1", "subg"], default="v1",
                   help="the grid's figure family")
    p.set_defaults(fn=cmd_report)
    _add_serve(sub)
    _add_fleet(sub)
    _add_protocol(sub)
    _add_chaos(sub)
    _add_obs(sub)
    _add_doctor(sub)
    _add_lint(sub)
    _add_federation(sub)
    _add_stream(sub)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
