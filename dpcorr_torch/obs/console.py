"""Live ops console behind ``python -m dpcorr_torch obs top``: a terminal
view of a server (counterpart of ``dpcorr/obs/console.py``, whose frames
it renders character for character from the same scrape).

Scrapes the serving front end's own endpoints (``GET /stats`` for the
structured snapshot, ``GET /metrics`` for the exposition series — the
same two sources every dashboard would use, so what the console shows
is exactly what production monitoring sees) and renders a compact
refreshing frame:

- queue depth / max-queue pressure and the flush EWMA;
- circuit-breaker state per tripped bucket and the brownout latch;
- SLO burn rate (the rolling-window gauges serve.stats publishes:
  fraction of recent requests over the latency SLO);
- compile activity (kernel compiles / hits / dedup, cache size);
- latency p50/p99 with the exemplar trace IDs linking slow buckets to
  concrete requests;
- top-ε principals — the parties spending budget fastest, from the
  ledger snapshot.

``--once`` prints a single frame and exits (scripts, the card tests);
otherwise the frame redraws every ``--interval`` seconds until
interrupted.

stdlib-only on purpose: it computes nothing on a device and imports no
torch, so it runs on an operator laptop against a remote server.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

from dpcorr_torch.obs.metrics import parse_exposition

#: ANSI clear-screen + home — what the refresh loop prefixes frames with.
_CLEAR = "\x1b[2J\x1b[H"


def scrape(base_url: str, timeout_s: float = 5.0) -> dict:
    """One poll: ``{"stats": <//stats JSON>, "metrics": {series: value}}``.
    Raises ``urllib.error.URLError`` / ``ValueError`` on an unreachable
    or non-conforming server — the caller decides whether to retry."""
    base = base_url.rstrip("/")
    with urllib.request.urlopen(f"{base}/stats",
                                timeout=timeout_s) as resp:
        stats = json.loads(resp.read().decode("utf-8"))
    with urllib.request.urlopen(f"{base}/metrics",
                                timeout=timeout_s) as resp:
        metrics = parse_exposition(resp.read().decode("utf-8"))
    return {"stats": stats, "metrics": metrics}


def _fmt_eps(v: float) -> str:
    return f"{v:.4g}"


def top_parties(ledger_snapshot: dict | None, k: int = 5) -> list[tuple]:
    """(party, spent, budget) rows, highest spend first."""
    if not ledger_snapshot:
        return []
    parties = ledger_snapshot.get("parties", {})
    rows = []
    for name, rec in parties.items():
        if isinstance(rec, dict):
            rows.append((name, float(rec.get("spent", 0.0)),
                         float(rec.get("budget", 0.0))))
        else:
            rows.append((name, float(rec), 0.0))
    rows.sort(key=lambda r: r[1], reverse=True)
    return rows[:k]


def render_frame(stats: dict, metrics: dict,
                 now: float | None = None) -> str:
    """One console frame from a scrape — pure (canned-dict testable)."""
    lines = []
    ts = time.strftime("%H:%M:%S",
                       time.localtime(now if now is not None
                                      else time.time()))
    lines.append(f"dpcorr obs top  ·  {ts}")
    lines.append("-" * 64)

    depth = stats.get("queue_depth", 0)
    ewma = stats.get("flush_ewma_s", 0.0)
    lines.append(f"queue depth : {depth:>6}    flush ewma: {ewma * 1e3:8.2f} ms")

    brk = stats.get("breaker", {})
    tripped = brk.get("tripped_buckets", {})
    state = ("OK" if not tripped else
             f"{brk.get('open', 0)} open / {brk.get('half_open', 0)} half-open")
    lines.append(f"breaker     : {state}")
    for bucket, st in sorted(tripped.items()):
        lines.append(f"              {bucket}: {st}")
    lines.append(f"brownout    : "
                 f"{'ACTIVE' if stats.get('brownout_active') else 'off'}")

    burn = stats.get("slo", {})
    if burn:
        lines.append(
            f"slo burn    : {burn.get('burn_rate', 0.0) * 100:6.2f}% of "
            f"{burn.get('window_requests', 0)} req over "
            f"{burn.get('slo_s', 0.0) * 1e3:g} ms "
            f"(window {burn.get('window_s', 0.0):g}s)")

    lines.append(
        f"kernels     : {stats.get('kernel_compiles', 0)} compiles / "
        f"{stats.get('kernel_hits', 0)} hits / "
        f"{stats.get('kernel_compile_dedup', 0)} dedup   "
        f"cache {stats.get('kernel_cache_size', 0)}")

    rec = stats.get("recompiles", {})
    if rec and any(rec.values()):
        lines.append(
            f"recompiles  : {rec.get('new-signature', 0)} new-signature / "
            f"{rec.get('cache-evict', 0)} cache-evict / "
            f"{rec.get('jit-fallback', 0)} jit-fallback")

    lat = stats.get("latency_s", {})
    if lat:
        lines.append(f"latency     : p50 {lat.get('p50', 0.0) * 1e3:8.2f} ms"
                     f"   p99 {lat.get('p99', 0.0) * 1e3:8.2f} ms")
    ex = stats.get("exemplars", {})
    if ex:
        slowest = max(ex.items(),
                      key=lambda kv: kv[1].get("value", 0.0))
        lines.append(f"exemplar    : le={slowest[0]} "
                     f"trace={slowest[1].get('trace_id')} "
                     f"({slowest[1].get('value', 0.0) * 1e3:.2f} ms)")

    costs = stats.get("costs", {})
    if costs:
        lines.append(
            f"cost window : {costs.get('records', 0)} records   "
            f"kernel {costs.get('kernel_s', 0.0):.3f}s   "
            f"queue {costs.get('queue_wait_s', 0.0):.3f}s   "
            f"compile {costs.get('compile_wait_s', 0.0):.3f}s")

    lines.append(
        f"traffic     : {stats.get('requests_total', 0)} admitted   "
        f"{sum(stats.get('refused', {}).values())} refused   "
        f"{sum(stats.get('shed', {}).values())} shed   "
        f"{stats.get('requests_failed', 0)} failed")

    rows = top_parties(stats.get("ledger"))
    if rows:
        lines.append("top ε       : " + "   ".join(
            f"{name}={_fmt_eps(spent)}"
            + (f"/{_fmt_eps(budget)}" if budget else "")
            for name, spent, budget in rows))

    bd = stats.get("budget_dir")
    if bd:
        c = bd.get("counters", {})
        lines.append(
            f"budget dir  : {bd.get('shards', 0)} shards   "
            f"{bd.get('resident_users', 0)} resident / "
            f"{bd.get('evicted_users', 0)} evicted users   "
            f"{c.get('rehydrations', 0)} rehydrations")
        refusals = bd.get("refusals_by_level", {})
        if any(refusals.values()):
            lines.append("  refusals  : " + "   ".join(
                f"{lvl}={refusals.get(lvl, 0)}"
                for lvl in ("user", "party", "global")))
    return "\n".join(lines)


def render_fleet_frame(snapshot, now: float | None = None) -> str:
    """One fleet frame from a :class:`dpcorr_torch.obs.fleet.FleetSnapshot` —
    one row per instance (dead instances marked DOWN with their scrape
    error) plus an aggregate line computed from the merged registry, so
    the totals the console shows are exactly what the federated
    exposition would report."""
    lines = []
    ts = time.strftime("%H:%M:%S",
                       time.localtime(now if now is not None
                                      else time.time()))
    n_live = len(snapshot.live())
    n_all = len(snapshot.instances)
    lines.append(f"dpcorr obs top --fleet  ·  {ts}  ·  "
                 f"{n_live}/{n_all} instances up")
    lines.append("-" * 72)
    lines.append(f"{'instance':<14} {'done':>7} {'refused':>7} "
                 f"{'queue':>5} {'shards':>7} {'p50 ms':>8} "
                 f"{'p99 ms':>8}  top ε")
    lease_owned: dict[str, int] = {}  # instance -> shards held
    lease_total = 0  # n_shards of the shared directory (0 = no fleet)
    for name in sorted(snapshot.instances):
        rec = snapshot.instances[name]
        if rec.get("error") is not None:
            lines.append(f"{name:<14} DOWN  {rec['error']}")
            continue
        stats = rec.get("stats") or {}
        lat = stats.get("latency_s", {})
        rows = top_parties(stats.get("ledger"), k=1)
        top = (f"{rows[0][0]}={_fmt_eps(rows[0][1])}" if rows else "-")
        done = (stats.get("batched_requests", 0)
                + stats.get("unbatched_requests", 0))
        leases = stats.get("leases")
        if leases:
            held = len(leases.get("owned", ()))
            lease_owned[name] = held
            lease_total = max(lease_total,
                              int(leases.get("n_shards") or 0))
            shards = f"{held}/{leases.get('n_shards', '?')}"
        else:
            shards = "-"
        lines.append(
            f"{name:<14} {done:>7} "
            f"{sum(stats.get('refused', {}).values()):>7} "
            f"{stats.get('queue_depth', 0):>5} "
            f"{shards:>7} "
            f"{lat.get('p50', 0.0) * 1e3:>8.2f} "
            f"{lat.get('p99', 0.0) * 1e3:>8.2f}  {top}")
    lines.append("-" * 72)
    if lease_owned:
        held = sum(lease_owned.values())
        own = "  ".join(f"{n}={k}" for n, k in sorted(lease_owned.items()))
        orphans = max(0, lease_total - held)
        lines.append(f"leases      : {held}/{lease_total} shards held "
                     f"({orphans} orphaned)   {own}")
    if n_live:
        agg = snapshot.aggregate()

        def total(name: str) -> float:
            # sum every child of the family (completed_total is
            # labelled by mode; refused_total by reason)
            fam = agg.get(name)
            if fam is None:
                return 0.0
            return sum(v for s, _, v in fam.samples if s == name)

        lines.append(
            "fleet       : "
            f"{total('dpcorr_serve_requests_completed_total'):g} done   "
            f"{total('dpcorr_serve_requests_refused_total'):g} refused   "
            f"{total('dpcorr_serve_requests_failed_total'):g} failed   "
            f"queue {total('dpcorr_serve_queue_depth'):g}")
    else:
        lines.append("fleet       : no live instances")
    return "\n".join(lines)


def render_federation_frame(snapshot, now: float | None = None) -> str:
    """One federation frame from a :class:`~dpcorr_torch.obs.fleet.FleetSnapshot`
    of party processes (``dpcorr federation party --obs-port``): one
    row per party — matrix cells completed, link count, ε spent against
    the plan share, round count and mean round latency, release-cache
    hits/builds — plus a federation line proving all live parties agree
    on the fed id and the single plan-derived trace id."""
    lines = []
    ts = time.strftime("%H:%M:%S",
                       time.localtime(now if now is not None
                                      else time.time()))
    n_live = len(snapshot.live())
    n_all = len(snapshot.instances)
    lines.append(f"dpcorr obs top --federation  ·  {ts}  ·  "
                 f"{n_live}/{n_all} parties up")
    lines.append("-" * 76)
    lines.append(f"{'party':<12} {'cells':>9} {'links':>5} "
                 f"{'ε spent/share':>15} {'rounds':>6} "
                 f"{'rt mean ms':>10} {'cache h/b':>9}")
    families = snapshot.families()
    feds, traces, done_total, cells_total = set(), set(), 0, 0
    for name in sorted(snapshot.instances):
        rec = snapshot.instances[name]
        if rec.get("error") is not None:
            lines.append(f"{name:<12} DOWN  {rec['error']}")
            continue
        stats = rec.get("stats") or {}
        fams = families.get(name, {})

        def total(family: str, sample: str | None = None,
                  **match) -> float:
            fam = fams.get(family)  # noqa: B023 (read-only loop var)
            if fam is None:
                return 0.0
            want = sample if sample is not None else family
            return sum(v for s, ls, v in fam.samples
                       if s == want
                       and all(dict(ls).get(k) == mv
                               for k, mv in match.items()))

        feds.add(stats.get("fed"))
        traces.add(stats.get("trace_id"))
        done = int(stats.get("cells_done", 0))
        out_of = int(stats.get("cells_total", 0))
        done_total, cells_total = done_total + done, max(cells_total,
                                                         out_of)
        eps = stats.get("eps", {})
        rounds = total("dpcorr_federation_rounds_total")
        rt_count = total("dpcorr_federation_round_latency_seconds",
                         "dpcorr_federation_round_latency_seconds_count")
        rt_sum = total("dpcorr_federation_round_latency_seconds",
                       "dpcorr_federation_round_latency_seconds_sum")
        rt_mean = (rt_sum / rt_count * 1e3) if rt_count else 0.0
        hits = total("dpcorr_federation_release_cache_total",
                     outcome="hit")
        builds = total("dpcorr_federation_release_cache_total",
                       outcome="build")
        lines.append(
            f"{name:<12} {done:>4}/{out_of:<4} "
            f"{len(stats.get('links', ())):>5} "
            f"{_fmt_eps(eps.get('spent', 0.0)):>7}/"
            f"{_fmt_eps(eps.get('share', 0.0)):<7} "
            f"{rounds:>6g} {rt_mean:>10.2f} "
            f"{hits:>4g}/{builds:<4g}")
    lines.append("-" * 76)
    if n_live:
        fed = feds.pop() if len(feds) == 1 else f"DISAGREE {sorted(feds)}"
        trace = (traces.pop() if len(traces) == 1
                 else f"DISAGREE {sorted(traces)}")
        lines.append(f"federation  : {fed}   trace {trace}   "
                     f"cells {done_total} done "
                     f"(matrix {cells_total})")
    else:
        lines.append("federation  : no live parties")
    return "\n".join(lines)


def run_federation_top(targets, interval_s: float = 2.0,
                       once: bool = False, out=None,
                       max_frames: int | None = None) -> int:
    """The ``dpcorr obs top --federation`` loop over party
    ``--obs-port`` endpoints; exit contract mirrors
    :func:`run_fleet_top`."""
    from dpcorr_torch.obs.fleet import FleetCollector
    emit = out if out is not None else print
    collector = FleetCollector(targets)
    frames = 0
    while True:
        snapshot = collector.scrape()
        if not snapshot.live() and frames == 0:
            emit("obs top --federation: no live parties:")
            for name, err in sorted(snapshot.errors().items()):
                emit(f"  {name}: {err}")
            return 1
        frame = render_federation_frame(snapshot)
        if once:
            emit(frame)
            return 0
        emit(_CLEAR + frame)
        frames += 1
        if max_frames is not None and frames >= max_frames:
            return 0
        time.sleep(interval_s)


def run_fleet_top(targets, interval_s: float = 2.0, once: bool = False,
                  out=None, max_frames: int | None = None) -> int:
    """The ``dpcorr obs top --fleet`` loop. Exit 0 after any frame with
    at least one live instance; 1 when the first scrape reaches nobody
    (mirrors :func:`run_top`'s unreachable-server contract)."""
    from dpcorr_torch.obs.fleet import FleetCollector
    emit = out if out is not None else print
    collector = FleetCollector(targets)
    frames = 0
    while True:
        snapshot = collector.scrape()
        if not snapshot.live() and frames == 0:
            emit("obs top --fleet: no live instances:")
            for name, err in sorted(snapshot.errors().items()):
                emit(f"  {name}: {err}")
            return 1
        frame = render_fleet_frame(snapshot)
        if once:
            emit(frame)
            return 0
        emit(_CLEAR + frame)
        frames += 1
        if max_frames is not None and frames >= max_frames:
            return 0
        time.sleep(interval_s)


def render_stream_frame(stats: dict, metrics: dict,
                        now: float | None = None) -> str:
    """One ``obs top --stream`` frame over a ``dpcorr stream``
    instance's /stats + /metrics — pure (canned-dict testable)."""
    lines = []
    ts = time.strftime("%H:%M:%S",
                       time.localtime(now if now is not None
                                      else time.time()))
    lines.append(f"dpcorr obs top --stream  ·  {ts}")
    lines.append("-" * 64)

    win = stats.get("window", {})
    shape = f"{win.get('size_s', 0):g}s"
    if win.get("slide_s"):
        shape += f" / slide {win['slide_s']:g}s"
    shape += f"   late bound {win.get('late_s', 0):g}s"
    lines.append(f"stream      : {stats.get('stream_id', '?')}   "
                 f"families {','.join(stats.get('families', []))}")
    lines.append(f"window      : {shape}")

    wm = stats.get("watermark")
    lag = stats.get("watermark_lag_s")
    if lag is None:
        lag = metrics.get("dpcorr_stream_watermark_lag_seconds")
    lines.append(
        f"watermark   : {'—' if wm is None else f'{wm:.3f}'}   "
        f"lag {'—' if lag is None else f'{lag:.1f}s'}   "
        f"open {stats.get('open_windows', 0)} windows / "
        f"{stats.get('pending_rows', 0)} pending rows")

    eps_w = stats.get("eps_per_window", {})
    released = stats.get("released", 0)
    lines.append(
        f"windows     : {released} released   "
        f"{len(stats.get('refused', []))} refused   "
        f"ε/window " + "  ".join(f"{p}={_fmt_eps(v)}"
                                 for p, v in sorted(eps_w.items())))

    overload_key = 'dpcorr_stream_batches_total{kind="overload"}'
    lines.append(
        f"ingest      : {stats.get('seen_batches', 0)} batches   "
        f"{int(metrics.get('dpcorr_stream_rows_total', 0))} rows   "
        f"{stats.get('late_refused', 0)} late refused   "
        f"{int(metrics.get(overload_key, 0))} overload")

    rel_count = metrics.get(
        'dpcorr_stream_release_seconds_count', 0)
    rel_sum = metrics.get('dpcorr_stream_release_seconds_sum', 0.0)
    if rel_count:
        lines.append(f"release     : {rel_sum / rel_count * 1e3:8.2f} ms"
                     f" mean over {int(rel_count)} windows")

    rows = top_parties(stats.get("ledger"))
    if rows:
        lines.append("top ε       : " + "   ".join(
            f"{name}={_fmt_eps(spent)}"
            + (f"/{_fmt_eps(budget)}" if budget else "")
            for name, spent, budget in rows))

    bd = stats.get("budget_dir")
    if bd:
        refusals = bd.get("refusals_by_level", {})
        lines.append(
            f"budget dir  : {bd.get('shards', 0)} shards   refusals "
            + "  ".join(f"{lvl}={refusals.get(lvl, 0)}"
                        for lvl in ("user", "party", "global")))
    return "\n".join(lines)


def run_stream_top(url: str, interval_s: float = 2.0,
                   once: bool = False, out=None,
                   max_frames: int | None = None) -> int:
    """The ``dpcorr obs top --stream`` loop — same scrape/retry/exit
    contract as :func:`run_top`, rendering the stream frame."""
    emit = out if out is not None else print
    frames = 0
    while True:
        try:
            polled = scrape(url)
        except (urllib.error.URLError, ValueError, OSError) as e:
            if frames == 0:
                emit(f"obs top: cannot scrape {url}: {e}")
                return 1
            emit(f"obs top: scrape failed ({e}); retrying")
            time.sleep(interval_s)
            continue
        frame = render_stream_frame(polled["stats"], polled["metrics"])
        if once:
            emit(frame)
            return 0
        emit(_CLEAR + frame)
        frames += 1
        if max_frames is not None and frames >= max_frames:
            return 0
        time.sleep(interval_s)


def run_top(url: str, interval_s: float = 2.0, once: bool = False,
            out=None, max_frames: int | None = None) -> int:
    """The ``dpcorr obs top`` loop. Returns a process exit code: 0 on
    any successful frame, 1 when the first scrape fails (an unreachable
    server is a failure, not a hang)."""
    emit = out if out is not None else print
    frames = 0
    while True:
        try:
            polled = scrape(url)
        except (urllib.error.URLError, ValueError, OSError) as e:
            if frames == 0:
                emit(f"obs top: cannot scrape {url}: {e}")
                return 1
            emit(f"obs top: scrape failed ({e}); retrying")
            time.sleep(interval_s)
            continue
        frame = render_frame(polled["stats"], polled["metrics"])
        if once:
            emit(frame)
            return 0
        emit(_CLEAR + frame)
        frames += 1
        if max_frames is not None and frames >= max_frames:
            return 0
        time.sleep(interval_s)
