"""The design grid (reference layers L4/L5).

Counterpart of ``dpcorr/grid.py``. Replaces the ``expand.grid`` +
``mclapply`` fan-out + ``rbindlist`` aggregation (vert-cor.R:486-597,
ver-cor-subG.R:245-335) with:

- a typed :class:`GridConfig` instead of script globals;
- per-design-point execution (``backend="local"``) or one call per
  (n, ε) bucket over the flattened (point × replication) axis
  (``backend="bucketed"``), with ρ, and under ``bucket_merge="eps"`` ε,
  per replication; ``"sharded"`` and ``"bucketed-sharded"`` split each
  point's replications, or each bucket's flat axis, over the devices of
  ``parallel.rep_devices`` (``dpcorr_torch.parallel.backend``), bit-equal
  to their unsharded twins;
- fused buckets (``fused="auto"``): the Gaussian sign pair of a bucket
  in one launch of the fused kernel on the card
  (``dpcorr_torch/ops/fused_ni.py``);
- per-design-point ``.npz`` persistence with resume, stamped so that
  caches of another configuration, body or package never load;
- fail-loud error handling per design point or bucket: failures are
  recorded, the rest of the grid runs, one error is raised at the end;
- the JAX package's spans (``dpcorr_torch.obs.trace``): a ``grid.run``
  root, and under it ``grid.dispatch`` and ``grid.fetch`` per bucket or
  ``grid.point`` per point, with the same attributes; no-ops when no
  tracer is configured;
- the reference's grouped summaries (vert-cor.R:575-597).

Tables are dicts of numpy columns in the JAX package's column and row
order (the card's machine has neither pandas nor pyarrow), persisted as
``detail_all.npz``, ``summ_all.npz`` and ``detail_all.rds`` (R's
``readRDS`` reads the last, vert-cor.R:569).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Any, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from dpcorr_torch import sim as sim_mod
from dpcorr_torch.models.estimators.common import (
    k_pad_for,
    warn_f32_geometry_band_once,
)
from dpcorr_torch.obs import prof as prof_mod
from dpcorr_torch.obs import trace as obs_trace
from dpcorr_torch.ops import fused_ni
from dpcorr_torch.sim import DETAIL_FIELDS, SimConfig
from dpcorr_torch.utils import rng
from dpcorr_torch.utils.device import resolve_device

log = logging.getLogger("dpcorr_torch.grid")

#: stamp suffix of a fused bucket's points: the kernel's Philox stream is
#: another stream family than the key-tree's, so its caches never mix
#: with the unfused body's
FUSED_STAMP = "|fused=cuda-philox"


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """The design grid and its execution knobs.

    Defaults mirror the reference's v1 grid section (vert-cor.R:486-499).
    ``backend``: "local" (one design point at a time), "sharded" (its
    replications over the devices), "bucketed" (one call per (n, ε)
    bucket) or "bucketed-sharded" (each bucket's flat point × replication
    axis over the devices). ``fused``: "off" or "auto", which sends each
    bucket the fused kernel covers (:func:`_fused_bucket_ok`) through one
    kernel launch; its results come from the kernel's Philox stream, are
    statistically equivalent to the unfused body's, and are stamped
    apart. ``bucket_merge``: "off" or "eps", which groups sub-Gaussian
    buckets by n only, ε per replication (``sim._run_detail_flat_eps``):
    statistically equal to "off", not bit-equal (a padded noise layout),
    stamped apart. ``device``: where the grid runs; the card unless the
    caller names another.

    ``geometry``: "pinned" (``chunk_size`` as given) or "auto": each
    bucket's chunk width is read from this host's geometry cache
    (``utils.geometry.lookup`` for :meth:`grid_family` at the point's n,
    filled by an ``autotune`` run), else ``chunk_size``. Read-only: the
    grid never probes. On the card a tuned width can change the unfused
    body's last bits (within 1e-5; :func:`_stamp`), so its points are
    stamped with that width and never mix with another width's caches.

    ``precompile``: "off", "auto" or "on", validated as in the JAX
    package so its command lines parse, and otherwise inert: every value
    dispatches the same lazy unit, and ``precompiled`` is False in the
    timings and on ``grid.dispatch``. The JAX package compiles each
    bucket's XLA program ahead on a thread pool; eager torch has no such
    build step (K1, the one kernel, is built once per process and the
    fused buckets were skipped there too), so a warm run would only do
    each bucket's work twice: on an H100 (80GB HBM3, 700 W) that took the
    unfused v1 grid from 1.54 s to 9.38 s. Either way gives the same
    bits (``test_precompile_off_and_on_bit_equal`` in
    ``tests/test_torch_geometry.py`` holds that).
    """

    n_grid: Sequence[int] = (1000, 1500, 2500, 4000, 6000, 9000)
    rho_grid: Sequence[float] = (0.0, 0.15, 0.3, 0.4, 0.5, 0.65, 0.8, 0.9)
    eps_pairs: Sequence[tuple[float, float]] = ((0.5, 0.5), (1.0, 1.0),
                                                (1.5, 0.5))
    b: int = 250
    alpha: float = 0.05
    dgp: Any = "gaussian"
    dgp_args: Mapping[str, Any] | tuple = ()
    use_subg: bool = False
    ci_mode: str = "auto"
    normalise: bool = True
    mixquant_mode: str = "det"
    seed: int = rng.MASTER_SEED
    chunk_size: int = 4096
    geometry: str = "pinned"
    backend: str = "local"
    fused: str = "off"
    bucket_merge: str = "off"
    precompile: str = "auto"
    out_dir: str | None = None
    resume: bool = True
    device: Any = None

    def design_points(self) -> dict[str, np.ndarray]:
        """expand.grid(n, rho, eps_idx) with n fastest, then ρ, then ε:
        the reference's row order (vert-cor.R:507-511). Columns i, n,
        rho, eps1, eps2, eps_idx."""
        rows = [(n, r, e1, e2, k)
                for k, (e1, e2) in enumerate(self.eps_pairs)
                for r in self.rho_grid for n in self.n_grid]
        cols = {"n": np.int64, "rho": np.float64, "eps1": np.float64,
                "eps2": np.float64, "eps_idx": np.int64}
        out = {"i": np.arange(len(rows), dtype=np.int64)}
        for j, (name, dtype) in enumerate(cols.items()):
            # dpcorr-lint: ignore[sync-in-loop] — host lists: no device value in reach
            out[name] = np.asarray([row[j] for row in rows], dtype=dtype)
        return out

    def grid_family(self) -> str:
        """The geometry-cache family of this grid's estimator pair
        (``utils.geometry`` cache key axis)."""
        return "grid-subg" if self.use_subg else "grid-sign"

    def _resolve_chunk(self, row) -> int:
        if self.geometry != "auto":
            return self.chunk_size
        from dpcorr_torch.utils import geometry as geometry_mod
        from dpcorr_torch.utils.device import device_kind

        geo = geometry_mod.lookup(
            self.grid_family(), int(row.n),
            device_kind=device_kind(self.device),
            eps_pairs=[(float(row.eps1), float(row.eps2))])
        return geo.chunk_size if geo is not None else self.chunk_size

    def sim_config(self, row) -> SimConfig:
        return SimConfig(
            n=int(row.n), rho=float(row.rho),
            eps1=float(row.eps1), eps2=float(row.eps2),
            b=self.b, alpha=self.alpha, dgp=self.dgp, dgp_args=self.dgp_args,
            use_subg=self.use_subg, ci_mode=self.ci_mode,
            normalise=self.normalise, mixquant_mode=self.mixquant_mode,
            seed=self.seed, chunk_size=self._resolve_chunk(row),
        )


class _Row(NamedTuple):
    """One design point: a row of :meth:`GridConfig.design_points`."""

    i: int
    n: int
    rho: float
    eps1: float
    eps2: float


def _rows(design: Mapping[str, np.ndarray]) -> list[_Row]:
    return [_Row(int(i), int(n), float(r), float(e1), float(e2))
            for i, n, r, e1, e2 in zip(design["i"], design["n"],
                                       design["rho"], design["eps1"],
                                       design["eps2"], strict=True)]


@dataclasses.dataclass
class GridResult:
    """``detail_all``, ``summ_all``, ``timings``: dicts of numpy columns;
    ``hosts``: the worker reports of a fanned-out run
    (``parallel.run_grid_multihost``)."""

    detail_all: dict
    summ_all: dict
    timings: dict
    hosts: list = dataclasses.field(default_factory=list)


def _design_path(out_dir: Path, i: int) -> Path:
    return out_dir / f"design_{i:05d}.npz"


def _stamp(cfg: SimConfig) -> str:
    """Cache-validity stamp: the exact SimConfig plus the port's PRNG tag
    (``rng.impl_tag``), so neither another configuration nor the JAX
    package's caches load.

    mc-mode real-variant runs also stamp the mixquant draw count (2000
    there, real-data-sims.R:161-164), as the JAX package does. The chunk
    width stays literal, where the JAX package canonicalises every width
    ≥ 2 (bit-equal there): on the card a reduction over n runs in another
    order when another number of replications is resident, so the
    unfused body's last bits depend on the width
    (``test_chunk_width_changes_unfused_bits_on_the_card`` in
    ``tests/test_torch_cuda.py``), and a cache of one width must not load
    under another."""
    stamp = f"{cfg!r}|prng={rng.impl_tag()}"
    if cfg.mixquant_mode == "mc" and cfg.subg_variant == "real":
        stamp += "|mixquant_nsim=2000"
    return stamp


def _load_cached(path: Path | None, resume: bool, stamp: str):
    if path is not None and resume and path.exists():
        with np.load(path) as loaded:
            if str(loaded["config_stamp"]) == stamp:
                return {f: loaded[f] for f in DETAIL_FIELDS}
    return None


BACKENDS = ("local", "sharded", "bucketed", "bucketed-sharded")


def validate_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {', '.join(BACKENDS)}; "
                         f"got {backend!r}")


def validate_fused(fused: str, backend: str) -> None:
    """Fail-fast for the fused knob: a typo'd value or a never-fusing
    backend raises before any work is dispatched."""
    if fused == "all":
        raise ValueError(
            "fused='all' (the fused subG pair) was retired in r05; use "
            "'auto' (the sign kernel) or 'off'")
    if fused not in ("off", "auto"):
        raise ValueError(
            f"fused must be 'off' or 'auto', got {fused!r}")
    if fused != "off" and backend != "bucketed":
        raise ValueError(
            f"fused={fused!r} requires backend='bucketed', got {backend!r}")


def validate_precompile(precompile: str) -> None:
    """Fail-fast for the precompile knob (a value check: no value changes
    what runs, :class:`GridConfig`)."""
    if precompile not in ("off", "auto", "on"):
        raise ValueError(
            f"precompile must be 'off', 'auto' or 'on', got {precompile!r}")


def validate_geometry(geometry: str) -> None:
    """Fail-fast for the geometry knob (a value check: every backend
    builds its SimConfigs through ``sim_config``)."""
    if geometry not in ("pinned", "auto"):
        raise ValueError(
            f"geometry must be 'pinned' or 'auto', got {geometry!r}")


def validate_bucket_merge(bucket_merge: str, backend: str,
                          use_subg: bool, eps_pairs) -> None:
    """Fail-fast for the ε-merge knob: merged buckets exist only for the
    sub-Gaussian families on the bucketed backend, and the named sender
    needs ε₁ ≥ ε₂ on every pair."""
    if bucket_merge not in ("off", "eps"):
        raise ValueError(f"bucket_merge must be 'off' or 'eps', "
                         f"got {bucket_merge!r}")
    if bucket_merge == "off":
        return
    if backend != "bucketed":
        raise ValueError(f"bucket_merge={bucket_merge!r} requires "
                         f"backend='bucketed', got {backend!r}")
    if not use_subg:
        raise ValueError("bucket_merge='eps' is subG-only: the sign "
                         "estimators have no dynamic-geometry variant")
    bad = [(e1, e2) for e1, e2 in eps_pairs if e1 < e2]
    if bad:
        raise ValueError(
            "bucket_merge='eps' names the sender as the ε₁ side, so every "
            f"pair needs ε₁ ≥ ε₂; violating pairs: {bad} (swap the "
            "columns, or use bucket_merge='off')")
    # merged buckets take the per-replication (f32) geometry rule where
    # the unmerged path uses the static f64 rule: say once if any pair
    # sits in the ~1e-6 band where the two choose adjacent m
    warn_f32_geometry_band_once(eps_pairs, where="validate_bucket_merge")


def _fused_bucket_ok(gcfg: GridConfig, cfg: SimConfig) -> str | None:
    """Which fused kernel, if any, covers this (n, ε) bucket: ``"sign"``
    (the Gaussian sign pair, ``ops/fused_ni.py``) or None. Gated on the
    opt-in (``fused="auto"``), the bucketed backend, a CUDA device, det
    mixquant (the kernel emits scalars; the MC quantile draws from the
    key-tree), the Gaussian DGP without subG or streaming, and the
    kernel's geometry: m ≤ 128 and k ≥ 2 (``use_fused_ni``, the JAX
    package's rule), at every n: above the shared-memory cap on the
    planes the kernel's variant without them runs."""
    validate_fused(gcfg.fused, "bucketed")  # pure value check here
    if gcfg.fused == "off" or gcfg.backend != "bucketed":
        return None
    if cfg.stream_n_chunk or cfg.mixquant_mode != "det":
        return None
    if cfg.use_subg or cfg.dgp != "gaussian":
        return None
    if resolve_device(gcfg.device).type != "cuda":
        return None
    ok = fused_ni.use_fused_ni(cfg.n, cfg.eps1, cfg.eps2)
    return "sign" if ok else None


def _raise_if_failed(failures, n_points: int) -> None:
    """Aggregate fail-loud raise shared by both backends."""
    if failures:
        raise RuntimeError(
            f"{len(failures)}/{n_points} design points failed; first: "
            f"{failures[0][0]} -> {failures[0][1]!r}")


class _Bucket(NamedTuple):
    rows: list
    to_run: list
    stamps: dict
    paths: dict
    fused: str | None
    cfg: SimConfig
    k_pad: int | None
    scan_s: float


def _group(rows: list[_Row], merged: bool) -> list[list[_Row]]:
    """Rows by (n, ε), or by n when merged, in first-appearance order."""
    groups: dict[tuple, list[_Row]] = {}
    for r in rows:
        groups.setdefault((r.n,) if merged else (r.n, r.eps1, r.eps2),
                          []).append(r)
    return list(groups.values())


def _dispatch(gcfg: GridConfig, bk: _Bucket, master: torch.Tensor,
              ex) -> torch.Tensor:
    """Enqueue one bucket's work through the plan executor ``ex`` without
    reading anything back: returns its (12, points · b) detail on the
    device. The bucket's design indices and ρ (and ε, merged) are placed
    on the device in one counted copy each from pinned memory, which
    waits for nothing queued there (``plan.preshard``); the keys of
    every point,
    ``rep_keys(design_key(master, i), b)`` concatenated, come from one
    key-tree call for the whole bucket. A ``bucketed-sharded`` grid's
    executor is a mesh: the flat axis is padded to a multiple of its
    devices and split over them (``parallel.run_detail_flat_sharded``)."""
    b, cfg, to_run = gcfg.b, bk.cfg, bk.to_run
    from dpcorr_torch.plan import preshard

    f32 = ["rho"] + (["eps1", "eps2"] if bk.k_pad is not None else [])
    pts = preshard([torch.tensor([r.i for r in to_run])]
                   + [torch.tensor([getattr(r, f) for r in to_run],
                                   dtype=torch.float32) for f in f32],
                   ex.placement.replicated_sharding(), ex.counters(),
                   non_blocking=True)
    with sim_mod.stage("rep_keys"):
        design = rng.design_key(master, pts[0])
        keys = rng.rep_keys(design, b).flatten(0, -2)
    per_rep = [v.repeat_interleave(b) for v in pts[1:]]
    rhos = per_rep[0]
    if bk.fused:
        with sim_mod.stage("kernel_seeds"):
            seeds = rng.kernel_seeds(keys).contiguous()
        args = dict(cfg.dgp_args)
        dev = ex.placement.replicated_sharding()
        unit = ex.lazy_unit(lambda s, r: sim_mod.sim_detail_fused(
            s, r, cfg.n, cfg.eps1, cfg.eps2, mu=args.get("mu", (0.0, 0.0)),
            sigma=args.get("sigma", (1.0, 1.0)), alpha=cfg.alpha,
            ci_mode=cfg.ci_mode, normalise=cfg.normalise, device=dev))
        raw = ex.dispatch(unit, (seeds, rhos))
    elif bk.k_pad is not None:
        cfg_noeps = dataclasses.replace(cfg, rho=0.0, seed=0, eps1=1.0,
                                        eps2=1.0)
        unit = ex.lazy_unit(lambda k, r, e1, e2: sim_mod._run_detail_flat_eps(
            cfg_noeps, k, r, e1, e2, bk.k_pad))
        raw = ex.dispatch(unit, (keys, *per_rep))
    else:
        cfg_norho = dataclasses.replace(cfg, rho=0.0, seed=0)
        if gcfg.backend == "bucketed-sharded":
            from dpcorr_torch.parallel.backend import run_detail_flat_sharded

            raw = run_detail_flat_sharded(cfg_norho, keys, rhos, executor=ex)
        else:
            unit = ex.lazy_unit(
                lambda k, r: sim_mod._run_detail_flat(cfg_norho, k, r))
            raw = ex.dispatch(unit, (keys, rhos))
    return torch.stack(raw)


def _run_grid_bucketed(gcfg: GridConfig, rows: list[_Row],
                       master: torch.Tensor, out_dir: Path | None, dev,
                       devices=None):
    """All design points of one (n, ε) bucket in one call over the
    flattened (point × replication) axis, ρ per replication, in three
    phases: scan every bucket's cache, dispatch every bucket without a
    host read (bucket j runs on the device while bucket j + 1 is
    enqueued), fetch in dispatch order with one device-to-host copy per
    bucket. Per-point keys still fold the design index
    (``design_key(master, i)``), so the unfused buckets are bit-equal to
    the local backend point by point and share its cache. A bucket that
    fails at any phase, a fused one included, is recorded and the rest
    run; nothing is rerun another way."""
    from dpcorr_torch import plan as plan_mod

    details, timings, failures = {}, [], []
    merged = gcfg.bucket_merge == "eps"
    tr = obs_trace.tracer()
    # one plan executor for the whole grid: a mesh over ``devices`` for
    # the sharded backend, the grid's device otherwise
    ex = plan_mod.Executor(
        "mesh" if gcfg.backend == "bucketed-sharded" else "local",
        devices=devices, device=dev)

    def fail(bucket_rows, phase, e):
        log.error("bucket (n=%d eps=(%.2f,%.2f), %d points) failed at %s: "
                  "%s", bucket_rows[0].n, bucket_rows[0].eps1,
                  bucket_rows[0].eps2, len(bucket_rows), phase, e)
        failures.extend((r.i, e) for r in bucket_rows if r.i not in details)

    # Phase 0: scan every bucket's cache
    t_scan0 = time.perf_counter()
    buckets = []
    for grp in _group(rows, merged):
        t0 = time.perf_counter()
        try:
            cfg = gcfg.sim_config(grp[0])
            fused = None if merged else _fused_bucket_ok(gcfg, cfg)
            # the pad bound is part of the merged layout: from the bucket's
            # full ε set, and stamped so grids with other ε sets never mix
            k_pad = (k_pad_for(cfg.n, [r.eps1 * r.eps2 for r in grp])
                     if merged else None)
            suffix = (FUSED_STAMP if fused else
                      f"|geom=dyn,kpad={k_pad}" if merged else "")
            stamps = {r.i: _stamp(dataclasses.replace(
                cfg, rho=r.rho, eps1=r.eps1, eps2=r.eps2)) + suffix
                for r in grp}
            paths = {r.i: _design_path(out_dir, r.i) if out_dir else None
                     for r in grp}
            to_run = []
            for r in grp:
                cached = _load_cached(paths[r.i], gcfg.resume, stamps[r.i])
                if cached is None:
                    to_run.append(r)
                else:
                    details[r.i] = cached
        except Exception as e:  # fail loudly per bucket
            fail(grp, "scan", e)
            continue
        buckets.append(_Bucket(grp, to_run, stamps, paths, fused, cfg, k_pad,
                               time.perf_counter() - t0))
    prof_mod.note_phase("grid.scan", time.perf_counter() - t_scan0,
                        buckets=len(buckets))

    # Phase 1: dispatch every bucket; nothing is read back here. One span
    # per bucket, under grid.run by the thread's span stack (the port
    # compiles nothing ahead, so ``precompiled`` is always False)
    t_disp0 = time.perf_counter()
    pending = []
    for bk in buckets:
        t0 = time.perf_counter()
        dsp = tr.start_span("grid.dispatch", n=bk.rows[0].n,
                            points=len(bk.rows))
        try:
            raw = _dispatch(gcfg, bk, master, ex) if bk.to_run else None
        except Exception as e:
            fail(bk.rows, "dispatch", e)
            dsp.set(error=type(e).__name__)
            continue
        else:
            dsp.set(points_run=len(bk.to_run), fused=bool(bk.fused),
                    precompiled=False)
        finally:
            dsp.end()
        pending.append((bk, raw, bk.scan_s + time.perf_counter() - t0))
    prof_mod.note_phase("grid.dispatch", time.perf_counter() - t_disp0,
                        buckets=len(pending))

    # Phase 2: fetch in dispatch order; device-side failures surface here.
    # Per-bucket times overlap under dispatch-ahead, so throughput is
    # reported at grid level: total reps over the two phases' wall clock.
    t_fetch0 = time.perf_counter()
    total_ran = 0
    for bk, raw, dispatch_s in pending:
        t0 = time.perf_counter()
        fsp = tr.start_span("grid.fetch", n=bk.rows[0].n,
                            points=len(bk.rows), points_run=len(bk.to_run))
        try:
            if bk.to_run:
                # dpcorr-lint: ignore[sync-in-loop] — the bucket's one host read, after the plan's fetch
                host = ex.fetch(raw).numpy()
                for j, r in enumerate(bk.to_run):
                    sl = slice(j * gcfg.b, (j + 1) * gcfg.b)
                    detail = {f: host[c, sl].copy()
                              for c, f in enumerate(DETAIL_FIELDS)}
                    details[r.i] = detail
                    if bk.paths[r.i] is not None:
                        np.savez(bk.paths[r.i], config_stamp=bk.stamps[r.i],
                                 **detail)
        except Exception as e:
            fail(bk.rows, "fetch", e)
            fsp.set(error=type(e).__name__)
            continue
        finally:
            fsp.end()
        fetch_s = time.perf_counter() - t0
        total_ran += len(bk.to_run)
        timings.append({
            "n": bk.rows[0].n,
            # a merged bucket spans every ε pair at this n: its per-pair
            # labels are NaN and the count says what was merged
            "eps1": np.nan if merged else bk.rows[0].eps1,
            "eps2": np.nan if merged else bk.rows[0].eps2,
            "merged_eps_pairs": (len({(r.eps1, r.eps2) for r in bk.rows})
                                 if merged else 1),
            "points": len(bk.rows), "points_run": len(bk.to_run),
            "fused": bool(bk.fused), "precompiled": False,
            "seconds": dispatch_s + fetch_s,
            "dispatch_s": dispatch_s, "fetch_s": fetch_s,
        })
    prof_mod.note_phase("grid.fetch", time.perf_counter() - t_fetch0,
                        points_run=total_ran)
    wall = (time.perf_counter() - t_fetch0) + sum(p[2] for p in pending)
    grid_rps = np.nan if not total_ran else total_ran * gcfg.b / wall
    for t in timings:
        t["grid_reps_per_sec"] = grid_rps
    return details, timings, failures


def _run_grid_local(gcfg: GridConfig, rows: list[_Row],
                    master: torch.Tensor, out_dir: Path | None, dev,
                    devices=None):
    """One design point at a time through ``run_sim_one``, or with the
    ``sharded`` backend ``parallel.run_detail_sharded`` over ``devices``,
    each persisted before the next runs."""
    details, timings, failures = {}, [], []
    tr = obs_trace.tracer()
    for row in rows:
        path = _design_path(out_dir, row.i) if out_dir else None
        t0 = time.perf_counter()
        psp = tr.start_span("grid.point", i=row.i, n=row.n, rho=row.rho)
        try:
            cfg = gcfg.sim_config(row)
            stamp = _stamp(cfg)
            detail = _load_cached(path, gcfg.resume, stamp)
            cached = detail is not None
            if not cached:
                key = rng.design_key(master, row.i)
                if gcfg.backend == "sharded":
                    from dpcorr_torch.parallel.backend import (
                        run_detail_sharded,
                    )

                    res = run_detail_sharded(cfg, key=key, devices=devices)
                else:
                    res = sim_mod.run_sim_one(cfg, key=key, device=dev)
                # dpcorr-lint: ignore[sync-in-loop] — per-point fetch boundary (the local backend persists each point before the next dispatches)
                detail = {k: v.cpu().numpy() for k, v in res.detail.items()}
                if path is not None:
                    np.savez(path, config_stamp=stamp, **detail)
        except Exception as e:  # fail loudly per point
            log.error("design point %d (n=%d rho=%.2f eps=(%.2f,%.2f)) "
                      "failed: %s", row.i, row.n, row.rho, row.eps1,
                      row.eps2, e)
            failures.append((row.i, e))
            psp.set(error=type(e).__name__)
            continue
        else:
            psp.set(cached=cached)
        finally:
            psp.end()
        dt = time.perf_counter() - t0
        details[row.i] = detail
        timings.append({"i": row.i, "n": row.n, "rho": row.rho,
                        "eps1": row.eps1, "eps2": row.eps2, "seconds": dt,
                        "cached": cached,
                        "reps_per_sec": np.nan if cached else gcfg.b / dt})
    return details, timings, failures


def _columns(records: list[dict]) -> dict[str, np.ndarray]:
    """A list of same-keyed dicts as a dict of numpy columns."""
    if not records:
        return {}
    # dpcorr-lint: ignore[sync-in-loop] — host records: no device value in reach
    return {k: np.asarray([r[k] for r in records]) for k in records[0]}


def _assemble_details(design: Mapping[str, np.ndarray], by_i: dict,
                      b: int) -> dict[str, np.ndarray]:
    """Per-point detail joined with its design metadata into the
    reference's stacked replicate table (vert-cor.R:557-568), in
    design-row order: repl, the 12 detail fields, n, rho_true, eps1,
    eps2."""
    order = [int(i) for i in design["i"]]
    out = {"repl": np.tile(np.arange(1, b + 1, dtype=np.int64), len(order))}
    for f in DETAIL_FIELDS:
        out[f] = np.concatenate([by_i[i][f] for i in order])
    out["n"] = np.repeat(design["n"], b)
    out["rho_true"] = np.repeat(design["rho"], b)
    out["eps1"] = np.repeat(design["eps1"], b)
    out["eps2"] = np.repeat(design["eps2"], b)
    return out


def validate_config(gcfg: GridConfig) -> None:
    """Every knob's fail-fast check, before any work is dispatched."""
    validate_backend(gcfg.backend)
    validate_geometry(gcfg.geometry)
    validate_precompile(gcfg.precompile)
    validate_fused(gcfg.fused, gcfg.backend)
    validate_bucket_merge(gcfg.bucket_merge, gcfg.backend, gcfg.use_subg,
                          gcfg.eps_pairs)


def grid_devices(gcfg: GridConfig, devices=None):
    """The shards of a sharded backend: ``devices`` as given, else every
    card, or one CPU entry under ``device="cpu"``; None for the other
    backends."""
    if "sharded" not in gcfg.backend:
        return None
    from dpcorr_torch.parallel.mesh import rep_devices

    return devices or rep_devices(device=gcfg.device)


def run_rows(gcfg: GridConfig, rows: list[_Row], master: torch.Tensor,
             out_dir: Path | None, dev, devices=None):
    """``rows`` through the grid's backend: returns (detail by design
    index, timings, failures)."""
    run = (_run_grid_bucketed if gcfg.backend.startswith("bucketed")
           else _run_grid_local)
    return run(gcfg, rows, master, out_dir, dev, grid_devices(gcfg, devices))


def run_grid(gcfg: GridConfig, devices=None) -> GridResult:
    """Run the whole grid; returns replicate-level and grouped summaries.

    Per-point keys fold the design index into the master key, the
    counterpart of the reference's ``seed = 1e6 + i`` (vert-cor.R:531).
    ``devices``: the shards of the sharded backends (default: every card,
    or one CPU entry under ``device="cpu"``).
    """
    validate_config(gcfg)
    dev = resolve_device(gcfg.device)
    design = gcfg.design_points()
    master = rng.master_key(gcfg.seed, dev)
    out_dir = Path(gcfg.out_dir) if gcfg.out_dir else None
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
    # the root span of one grid run: the dispatch, fetch and point spans
    # parent under it through the thread's span stack
    with obs_trace.tracer().span("grid.run", backend=gcfg.backend,
                                 points=len(design["i"]), b=gcfg.b):
        by_i, timings, failures = run_rows(gcfg, _rows(design), master,
                                           out_dir, dev, devices)
        _raise_if_failed(failures, len(design["i"]))
        detail_all = _assemble_details(design, by_i, gcfg.b)
        summ_all = summarize_grid(detail_all)
        if out_dir:
            _persist_tables(out_dir, detail_all, summ_all)
        return GridResult(detail_all, summ_all, _columns(timings))


def _persist_tables(out_dir: Path, detail_all: dict, summ_all: dict) -> None:
    """The merged tables: ``.npz`` for the Python world (in place of the
    JAX package's parquet), and the reference's own artifact,
    ``detail_all.rds``, a data.frame R's ``readRDS`` reads directly
    (``saveRDS(detail_all, "sim_detail_all.rds")``, vert-cor.R:569)."""
    from dpcorr_torch.io.rds_write import write_rds_frame

    np.savez(out_dir / "detail_all.npz", **detail_all)
    np.savez(out_dir / "summ_all.npz", **summ_all)
    write_rds_frame(str(out_dir / "detail_all.rds"), detail_all)


def _group_mean(col: np.ndarray, groups: np.ndarray,
                n_groups: int) -> np.ndarray:
    """Mean of ``col`` per group, NaN skipped, as pandas'
    ``groupby(...).mean()`` computes it: a Kahan-compensated sum in the
    column's own dtype, in row order within each group, divided by the
    count in that dtype (so f32 columns give the same f32 means). The
    loop runs over positions within a group, vectorised over groups."""
    order = np.argsort(groups, kind="stable")
    counts = np.bincount(groups, minlength=n_groups)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(col)) - starts[groups[order]]
    width = int(counts.max(initial=0))
    vals = np.zeros((n_groups, width), col.dtype)
    live = np.zeros((n_groups, width), bool)
    vals[groups[order], rank] = col[order]
    live[groups[order], rank] = True
    live &= ~np.isnan(vals)
    total = np.zeros(n_groups, col.dtype)
    comp = np.zeros(n_groups, col.dtype)
    nobs = np.zeros(n_groups, np.int64)
    with np.errstate(invalid="ignore", divide="ignore"):
        for j in range(width):
            ok = live[:, j]
            y = vals[:, j] - comp
            t = total + y
            c = (t - total) - y
            c[np.isnan(c)] = 0  # an infinite value: keep the sum infinite
            total = np.where(ok, t, total)
            comp = np.where(ok, c, comp)
            nobs += ok
        return np.where(nobs > 0, total / nobs.astype(col.dtype),
                        np.nan).astype(col.dtype)


def summarize_grid(detail_all: Mapping[str, np.ndarray]) -> dict:
    """Grouped NI/INT summaries by (n, rho_true, eps1, eps2)
    (vert-cor.R:575-597): mse, bias, coverage, ci_len per method, groups
    in first-appearance order, the NI rows then the INT rows: the JAX
    package's frame (``groupby(sort=False).mean()``) column for column,
    with f32 means of the f32 columns."""
    keys = ("n", "rho_true", "eps1", "eps2")
    # dpcorr-lint: ignore[sync-in-loop] — host columns: no device value in reach
    stacked = np.stack([np.asarray(detail_all[k], np.float64) for k in keys],
                       axis=1)
    _, first, inverse = np.unique(stacked, axis=0, return_index=True,
                                  return_inverse=True)
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    groups = rank[inverse.ravel()]
    g = len(order)
    firsts = first[order]

    def mean(name):
        return _group_mean(np.asarray(detail_all[name]), groups, g)

    rho_mean = mean("rho_true")
    parts = []
    for meth in ("NI", "INT"):
        p = meth.lower()
        # dpcorr-lint: ignore[sync-in-loop] — host columns: no device value in reach
        part = {k: np.asarray(detail_all[k])[firsts] for k in keys}
        part["mse"] = mean(f"{p}_se2")
        part["bias"] = mean(f"{p}_hat") - rho_mean
        part["coverage"] = mean(f"{p}_cover")
        part["ci_len"] = mean(f"{p}_ci_len")
        part["method"] = np.full(g, meth)
        parts.append(part)
    return {k: np.concatenate([pt[k] for pt in parts]) for k in parts[0]}
