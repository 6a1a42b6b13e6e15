"""Per-host batch-geometry autotuner for the replication hot path.

Counterpart of ``dpcorr/utils/geometry.py``, in the same JSON format and
with the same key strings, so either package's :func:`entries` reads the
other's cache file:

- :func:`autotune` probe-times a small ladder of (chunk, block) shapes —
  chunk first at a fixed probe block, then block at the winning chunk —
  and returns the fastest; a runner is one ``RepBlockPipeline.run(1,
  start_block=…)`` (:func:`pipeline_runner`), whose one fetch makes it
  synchronous;
- the winner is persisted per ``(device_kind, family, n, dtype)`` in a
  JSON cache, by default the port's own
  (``~/.cache/dpcorr_torch/geometry.json``, so the two packages' tuned
  shapes never mix; ``DPCORR_GEOMETRY_CACHE`` overrides, ``=0``
  disables), and the grid's ``geometry="auto"`` reads it (:func:`lookup`);
- ``DPCORR_BENCH_CHUNK`` / ``DPCORR_BENCH_BLOCK_REPS`` pin the shape
  outright (``source="pinned"``).

Device kinds are ``utils.device.device_kind``'s: ``"cpu"`` or the card's
(``"cuda-h100"``). The ladder floors at chunk 2 as the JAX package's
does (width 1 lowers differently there). On the card widths ≥ 2 do not
all give the same bits: at n = 10⁴ the unfused NI fields differ at width
2 from widths 64-16384, by up to 1.2e-7 (``chip_smoke.py`` phase 17b,
PERF.md §5), so the grid's stamp keeps the width (``grid._stamp``).

The ``dtype`` cache axis folds in the port's f32/f64 geometry-band
detector (``models.estimators.common.f32_geometry_band``), as the JAX
package does.

**No fallback on the card.** The JAX autotuner catches a failed probe,
warns and returns the ladder default (``dpcorr/utils/geometry.py``,
``autotune``). This one catches nothing: a probe runs K1 or the unfused
body on the card, and a build or launch error there raises to the caller
rather than hiding behind a default shape.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

log = logging.getLogger("dpcorr_torch.geometry")

#: minimum vmap-chunk width the JAX package keeps bit-safe; kept here so
#: both packages' ladders and pins floor alike
CHUNK_FLOOR = 2

#: probe ladders per device kind: (chunk candidates, block candidates).
#: "cpu" is the JAX package's CPU ladder. "cuda-h100" brackets the card's
#: own numbers (PERF.md §5): the unfused body at n = 10⁴ runs at about
#: 31 µs per replication whatever its chunk, the fused one (K1) at about
#: 0.5 µs with 2¹⁴ replications per launch, and a chunk of 2¹⁴ unfused
#: replications holds ~1.3 GB per (n, 2) f32 table. With 2¹⁴ and 2¹⁶
#: blocks one (family, n = 10⁴) probe took 7.13 s unfused and 0.22 s
#: fused on an H100 (``chip_smoke.py`` phase 17c).
LADDERS: dict[str, tuple[tuple[int, ...], tuple[int, ...]]] = {
    "cpu": ((2, 4, 16, 64), (2048, 4096, 8192)),
    "cuda-h100": ((2048, 4096, 16384), (1 << 14, 1 << 16)),
}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One chosen replication-block shape and where it came from:
    ``autotune`` (probed now), ``cache`` (probed by an earlier run on
    this host), ``pinned`` (env override)."""

    chunk_size: int
    block_reps: int
    source: str
    reps_per_sec: float | None = None

    def as_detail(self) -> dict:
        """The bench-JSON ``detail.geometry`` stamp."""
        d = {"chunk_size": self.chunk_size, "block_reps": self.block_reps,
             "source": self.source}
        if self.reps_per_sec is not None:
            d["probe_reps_per_sec"] = round(self.reps_per_sec, 1)
        return d


def chunk_floor(width: int) -> int:
    """Clamp a requested chunk width to :data:`CHUNK_FLOOR`."""
    return max(CHUNK_FLOOR, int(width))


def dtype_tag(dtype: str = "f32", eps_pairs=None, n: int | None = None,
              ) -> str:
    """Cache-key dtype component, band-split by the port's detector
    (``common.f32_geometry_band``) so in-band ε sets never share a tuned
    shape with the off-band program."""
    if eps_pairs:
        from dpcorr_torch.models.estimators.common import f32_geometry_band

        if f32_geometry_band(eps_pairs, n=n):
            return f"{dtype}-band"
    return dtype


def cache_path() -> str | None:
    """Resolved persistent-cache path, or None when disabled."""
    raw = os.environ.get("DPCORR_GEOMETRY_CACHE")
    if raw is not None:
        if raw.strip().lower() in ("0", "off", "none", ""):
            return None
        return raw
    return os.path.join(os.path.expanduser("~"), ".cache", "dpcorr_torch",
                        "geometry.json")


def _cache_key(device_kind: str, family: str, n: int, dtype: str,
               device_count: int = 1, mesh_shape=None) -> str:
    """Cache key; multi-device runs get a fifth ``dev=`` axis (count
    plus mesh shape), single-device keys keep the 4-part form."""
    key = f"{device_kind}|{family}|n={int(n)}|{dtype}"
    if int(device_count or 1) > 1:
        key += f"|dev={int(device_count)}"
        if mesh_shape:
            key += "".join(f":{a}={int(s)}"
                           for a, s in sorted(dict(mesh_shape).items()))
    return key


def _load(path: str) -> dict:
    try:
        with open(path, encoding="utf-8") as f:
            state = json.load(f)
        return state if isinstance(state, dict) else {}
    except (OSError, ValueError):
        return {}


def load_strict(path: str) -> dict:
    """Like :func:`_load` but corrupt/unreadable raises — the CLI's
    contract (``obs geometry`` exits 1 on a corrupt cache where the hot
    path shrugs and re-probes)."""
    with open(path, encoding="utf-8") as f:
        state = json.load(f)
    if not isinstance(state, dict):
        raise ValueError(f"{path}: geometry cache is not a JSON object")
    return state


def entries(state: dict, *, now: float | None = None) -> list[dict]:
    """Decompose a cache dict into display rows for the CLI: the
    ``device_kind|family|n=N|dtype`` key split back into its axes, plus
    ``age_s`` staleness from ``captured_utc`` (None when unstamped).
    Malformed keys/values become ``note``-carrying rows, never a crash.
    """
    now = time.time() if now is None else now
    rows: list[dict] = []
    for key in sorted(state):
        val = state[key]
        row: dict = {"key": key}
        parts = key.split("|")
        if len(parts) in (4, 5) and parts[2].startswith("n="):
            row.update(device_kind=parts[0], family=parts[1],
                       n=parts[2][2:], dtype=parts[3])
            if len(parts) == 5:
                if parts[4].startswith("dev="):
                    row["devices"] = parts[4][4:]
                else:
                    row["note"] = "unrecognized key shape"
        else:
            row["note"] = "unrecognized key shape"
        if isinstance(val, dict):
            row["chunk_size"] = val.get("chunk_size")
            row["block_reps"] = val.get("block_reps")
            row["reps_per_sec"] = val.get("reps_per_sec")
            cap = val.get("captured_utc")
            row["captured_utc"] = cap
            row["age_s"] = None
            if isinstance(cap, str) and cap:
                try:
                    import calendar

                    row["age_s"] = max(0.0, now - calendar.timegm(
                        time.strptime(cap, "%Y-%m-%dT%H:%M:%SZ")))
                except ValueError:
                    row["note"] = "unparseable captured_utc"
        else:
            row["note"] = "entry is not an object"
        rows.append(row)
    return rows


def _store(path: str, key: str, geo: Geometry) -> None:
    state = _load(path)
    state[key] = {"chunk_size": geo.chunk_size,
                  "block_reps": geo.block_reps,
                  "reps_per_sec": geo.reps_per_sec,
                  "captured_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                                time.gmtime())}
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(state, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError as e:  # a read-only home must not fail the run
        log.warning("geometry cache write to %s failed: %s", path, e)


#: in-process memo: one probe per (device_kind, family, n, dtype) per
#: process even when the persistent cache is disabled
_MEMO: dict[str, Geometry] = {}


def _pinned() -> Geometry | None:
    chunk = os.environ.get("DPCORR_BENCH_CHUNK")
    block = os.environ.get("DPCORR_BENCH_BLOCK_REPS")
    if chunk is None and block is None:
        return None
    # a half-pin inherits the other axis from the device's ladder
    return Geometry(chunk_size=chunk_floor(int(chunk)) if chunk else 0,
                    block_reps=int(block) if block else 0,
                    source="pinned")


def resolve_pinned(geo: Geometry, device_kind: str) -> Geometry:
    """Fill a half-pinned geometry's zero axes from the ladder default."""
    chunks, blocks = LADDERS.get(device_kind, LADDERS["cpu"])
    return dataclasses.replace(
        geo,
        chunk_size=geo.chunk_size or chunks[-1],
        block_reps=geo.block_reps or blocks[-1])


def _cached(key: str, use_cache: bool = True) -> Geometry | None:
    """The in-process memo's entry for ``key``, else the persistent
    cache's (memoized)."""
    geo = _MEMO.get(key)
    if geo is not None:
        return geo
    path = cache_path() if use_cache else None
    if path:
        hit = _load(path).get(key)
        if hit:
            geo = Geometry(chunk_size=chunk_floor(hit["chunk_size"]),
                           block_reps=int(hit["block_reps"]),
                           source="cache",
                           reps_per_sec=hit.get("reps_per_sec"))
            _MEMO[key] = geo
            return geo
    return None


def lookup(family: str, n: int, *, device_kind: str = "cpu",
           dtype: str = "f32", eps_pairs=None, env_pin: bool = True,
           device_count: int = 1, mesh_shape=None) -> Geometry | None:
    """Read-only geometry resolution (no probing): env pin → in-process
    memo → persistent cache. The grid's ``geometry="auto"`` path: a probe
    inside a resumable grid would burn replications and jitter its
    timings, so the grid only reads what an :func:`autotune` run on this
    host already measured. Returns None on a cold host; the caller keeps
    its configured shape. ``env_pin=False`` skips the env-pin rung."""
    pinned = _pinned() if env_pin else None
    if pinned is not None:
        return resolve_pinned(pinned, device_kind)
    return _cached(_cache_key(device_kind, family, n,
                              dtype_tag(dtype, eps_pairs, n),
                              device_count, mesh_shape))


def autotune(family: str, n: int, make_runner, *,
             device_kind: str = "cpu", dtype: str = "f32",
             eps_pairs=None, ladder=None, probe_reps: int | None = None,
             clock=time.perf_counter, use_cache: bool = True,
             force: bool = False, env_pin: bool = True,
             device_count: int = 1, mesh_shape=None) -> Geometry:
    """Choose (chunk_size, block_reps) for one replication workload.

    ``make_runner(chunk, block)`` must return a zero-arg callable that
    runs ONE block of ``block`` replications synchronously
    (:func:`pipeline_runner`); the tuner makes a warm call first. The
    probe protocol is the JAX package's and deterministic given the
    clock: chunk first at the smallest block candidate, then block at the
    winning chunk, ties broken toward the earlier ladder entry.

    Resolution order: env pin → in-process memo → persistent cache →
    probe (winner persisted). ``force=True`` skips memo and cache reads,
    never the env pin. A runner that raises propagates (module
    docstring): there is no ladder-default fallback.
    """
    pinned = _pinned() if env_pin else None
    if pinned is not None:
        return resolve_pinned(pinned, device_kind)

    key = _cache_key(device_kind, family, n,
                     dtype_tag(dtype, eps_pairs, n), device_count,
                     mesh_shape)
    if not force:
        geo = _cached(key, use_cache)
        if geo is not None:
            return geo

    chunks, blocks = ladder or LADDERS.get(device_kind, LADDERS["cpu"])
    chunks = tuple(chunk_floor(c) for c in chunks)
    probe_block = probe_reps or blocks[0]

    def timed(chunk: int, block: int) -> float:
        run = make_runner(chunk, block)
        run()  # warm: first launches and allocations excluded
        t0 = clock()
        run()
        return max(clock() - t0, 1e-9)

    best_chunk = min(chunks, key=lambda c: timed(c, probe_block))
    per_rep = {b: timed(best_chunk, b) / b for b in blocks}
    best_block = min(blocks, key=lambda b: per_rep[b])
    geo = Geometry(chunk_size=best_chunk, block_reps=best_block,
                   source="autotune", reps_per_sec=1.0 / per_rep[best_block])
    _MEMO[key] = geo
    if use_cache:
        path = cache_path()
        if path:
            _store(path, key, geo)
    return geo


def pipeline_runner(rep_fn, out_len: int, *, key, device=None):
    """``make_runner`` for :func:`autotune` over ``rep_fn``: each call
    builds a ``sim.RepBlockPipeline`` at (chunk, block) and returns a
    callable that runs one block of it, each call at the next block
    address from 2²⁰ on (probe keys away from a run's first blocks),
    synchronous through the pipeline's one fetch. ``runner.probes``
    counts the blocks run."""
    from dpcorr_torch.sim import RepBlockPipeline

    nxt = [1 << 20]

    def make_runner(chunk: int, block: int):
        pipe = RepBlockPipeline(rep_fn, out_len, key=key, block_reps=block,
                                chunk_size=chunk, device=device)

        def run():
            make_runner.probes += 1
            nxt[0] += 1
            return pipe.run(1, start_block=nxt[0])

        return run

    make_runner.probes = 0
    return make_runner
