"""Mergeable window sketches: the streaming accumulators made explicit.

Counterpart of ``dpcorr/stream/sketch.py``. A :class:`SketchState` maps
**chunk index → that chunk's stat tuple**, computed by one chunk function
per family. Merging two sketches is a *disjoint dict union* — associative
and commutative by construction, with no float reassociation anywhere —
and the fold back to totals happens once, at finalize, in a fixed
ascending-chunk float64 left fold on the host, so

    finalize(merge(shard_a, shard_b)) == finalize(monolithic)

holds **bitwise** for every partition of the chunk set, on the card as
on the CPU. Two rules keep it so on the card:

- a chunk's stats are a pure function of that chunk: each chunk is
  computed alone, at the fixed padded shape ``(n_chunk, 2)`` — never
  stacked with other chunks into one call, since a batched reduction on
  the card is not bit-equal to the single one;
- a shard keeps its per-chunk scalars on the device and copies them to
  the host once per pass (a copy changes no bit), so a pass costs one
  host read however many chunks it holds.

Noise addressing: every draw hangs off the per-window root
``stream(master, "stream/<window_id>")`` at the *same substream names*
as the monolithic streaming estimators (``ni_sign/lap_x``,
``int_sign/est`` → ``int_sign/flips``, …), so a replayed window is a pure
function of (master seed, window id, admitted rows). Keys are derived on
the host (``rng.fold_in_words``, bit-equal to the tensor key-tree) and
copied to the device once each: on the card every ``fold_in`` as tensor
ops would cost about a hundred launches. The finishers' interval
constructors derive their own substreams on the device, as the
estimators do.

The four chunk functions are built once per (kind, statics) through the
compile layer (``utils.compile``), as the JAX module's are: a
:class:`SingleFlight` dedups concurrent first builds and each build is
timed into the process :class:`CompileObserver` set by
:func:`set_compile_observer`, so stream builds land in the same
``dpcorr_compile_*`` series as the serving cache's. A build here only
makes the closure (eager torch compiles nothing), so the series counts
builds and their causes; their seconds are microseconds. The built
functions and the observer are process-wide: the ``StreamService`` made
last in a process owns the series, and a build made for an earlier
service is not recorded again for a later one. Every host-to-device
copy (a chunk's rows, a key) goes through ``plan.placement.put`` on a
device resolved once per entry point and is tallied per thread; every
device read is one counted fetch per pass, which adds the pass's
tallied copies to the transfer counters (``obs.transfer``), so they
report a release's copies and host reads without a lock per copy.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Mapping, Sequence

import numpy as np
import torch

from dpcorr_torch.models.estimators.common import batch_geometry
from dpcorr_torch.models.estimators.families import FAMILIES
from dpcorr_torch.models.estimators.int_sign import interval_from_rho
from dpcorr_torch.models.estimators.ni_sign import crit_value
from dpcorr_torch.models.estimators.streaming import (
    _int_subg_interval,
    _int_subg_roles,
    _ni_batch_noise,
    _ni_chunk_stats,
    _ni_from_sums,
    _ni_subg_interval,
    choose_n_chunk,
)
from dpcorr_torch.ops.lambdas import lambda_n
from dpcorr_torch.ops.noise import clip_sym, laplace
from dpcorr_torch.ops.standardize import priv_moments_from_sums
from dpcorr_torch.obs import transfer as transfer_mod
from dpcorr_torch.plan.placement import (
    CopyTally,
    canonical_device,
    put,
    put_ints,
)
from dpcorr_torch.utils import compile as compile_mod
from dpcorr_torch.utils import rng
from dpcorr_torch.utils.device import f32_on, resolve_device

__all__ = [
    "ChunkGrid", "ReleaseParams", "SketchState", "grid_for",
    "moments_for_window", "placement_shards", "release_from_sketch",
    "release_window", "sketch_window", "tree_merge", "window_key",
]

_HALF_PI = math.pi / 2.0
#: z_{0.975} as ``jax.scipy.special.ndtri`` computes it in f32. Torch's f32
#: ndtri gives 1.959964394569397, one ulp above, so the NI-sign finisher
#: keeps the JAX package's constant at the default α.
_JAX_Z_0975 = 1.9599642753601074


# ------------------------------------------------------------- keys ----
def _words(key) -> tuple[int, ...]:
    # every word, two or four: a four-word key is folded as its impl
    return tuple(int(v) for v in
                 rng.key_data(torch.as_tensor(key)).cpu().tolist())


def _sub(words: tuple[int, ...], name: str) -> tuple[int, ...]:
    """``rng.stream`` on host words."""
    # dpcorr-lint: ignore[rng-raw-api] — rng.stream on host words: no launch, bit-equal to the tensor key
    return rng.fold_in_words(words, rng.stream_index(name))


_HOST = torch.device("cpu")
_LOCAL = threading.local()


def _device(device) -> torch.device:
    """The release's device, resolved once per entry point to the
    indexed form ``plan.placement.put`` compares against, so the chunk
    and key copies below pay no device lookup each."""
    return canonical_device(resolve_device(device))


def _tally() -> CopyTally:
    """This thread's copies since its last :func:`_fetch`."""
    tally = getattr(_LOCAL, "tally", None)
    if tally is None:
        tally = _LOCAL.tally = CopyTally()
    return tally


def _put(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device`` (from :func:`_device`), tallied."""
    return put(t, device, _tally())


def _fetch(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host: the pass's one counted fetch, which also adds
    the pass's tallied copies to the transfer counters
    (``obs.transfer``)."""
    host = t.cpu()
    tc = transfer_mod.default_counters()
    _tally().flush(tc)
    tc.fetches.inc()
    return host


def _key_on(words: tuple[int, ...], device: torch.device) -> torch.Tensor:
    return put_ints(words, device, _tally())


def window_key(master, window_id: str) -> torch.Tensor:
    """Per-window noise root: the ``stream/<window_id>`` subtree of the
    party root, as a (words,) int64 key on the CPU (bit-equal to
    ``dpcorr.stream.sketch.window_key``). Every family substream below it
    keeps its monolithic name, so a window's noise is addressed by
    (master, window id) alone — the replay/crash-exactness contract."""
    if not window_id:
        raise ValueError("window_id must be non-empty")
    return _key_on(_sub(_words(master), f"stream/{window_id}"), _HOST)


@dataclasses.dataclass(frozen=True)
class ReleaseParams:
    """Everything that decides a window release besides the data and
    the window key."""

    family: str
    eps1: float
    eps2: float
    normalise: bool = True
    alpha: float = 0.05
    eta1: float = 1.0
    eta2: float = 1.0
    target_chunk: int = 65536

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}; "
                             f"expected one of {FAMILIES}")
        if self.eps1 <= 0.0 or self.eps2 <= 0.0:
            raise ValueError(
                f"eps must be positive, got ({self.eps1}, {self.eps2})")

    @property
    def needs_moments(self) -> bool:
        """Sign families under ``normalise`` standardize privately
        first — a second pass whose moments every shard must agree on
        before any estimate chunk can be computed."""
        return self.normalise and self.family in ("ni_sign", "int_sign")


@dataclasses.dataclass(frozen=True)
class ChunkGrid:
    """The chunk geometry of one window: fixed by (family, n, ε) alone,
    so every shard derives the identical grid independently."""

    family: str
    n: int
    n_chunk: int
    n_chunks: int
    m: int
    k: int

    @property
    def kc(self) -> int:
        return self.n_chunk // self.m


def grid_for(params: ReleaseParams, n: int) -> ChunkGrid:
    """Chunk grid for an n-row window. NI families align ``n_chunk`` to
    the batch size m (:func:`choose_n_chunk`) so batches never straddle
    chunks; INT families stream per-sample (m = 1)."""
    if params.family in ("ni_sign", "ni_subg"):
        m, k = batch_geometry(n, params.eps1, params.eps2)
    else:
        m, k = 1, n
    n_chunk = choose_n_chunk(n, m, params.target_chunk)
    return ChunkGrid(params.family, n, n_chunk, -(-n // n_chunk), m, k)


# --------------------------------------------------------- sketches ----
class SketchState:
    """Per-chunk sufficient statistics of one window pass.

    ``meta`` pins what the stats are a function of (family, pass, n,
    grid, params, moments); ``chunks`` maps chunk index → a
    tuple-of-tuples of floats (JSON-safe, exact for float32 values).
    Two sketches merge only when their meta agrees; overlapping chunk
    indices must carry identical stats (the same chunk computed twice
    is fine, a *conflicting* recomputation is corruption)."""

    __slots__ = ("meta", "chunks")

    def __init__(self, meta: Mapping,
                 chunks: Mapping[int, tuple] | None = None):
        self.meta = dict(meta)
        self.chunks: dict[int, tuple] = {
            int(c): _freeze_stats(st) for c, st in (chunks or {}).items()}

    def merge(self, other: "SketchState") -> "SketchState":
        """Disjoint-union merge — associative, commutative and
        bit-deterministic: no arithmetic happens here at all."""
        if self.meta != other.meta:
            raise ValueError(
                f"cannot merge sketches of different windows/passes: "
                f"{self.meta} != {other.meta}")
        for c, st in other.chunks.items():
            if c in self.chunks and self.chunks[c] != st:
                raise ValueError(
                    f"chunk {c} carries conflicting stats in the two "
                    f"sketches — same window recomputed differently")
        merged = dict(self.chunks)
        merged.update(other.chunks)
        return SketchState(self.meta, merged)

    def missing(self, grid: ChunkGrid) -> list[int]:
        return [c for c in range(grid.n_chunks) if c not in self.chunks]

    def to_dict(self) -> dict:
        """Wire/journal form (strict JSON; chunk keys as strings)."""
        return {"meta": dict(self.meta),
                "chunks": {str(c): [list(s) for s in st]
                           for c, st in sorted(self.chunks.items())}}

    @classmethod
    def from_dict(cls, d: Mapping) -> "SketchState":
        return cls(d["meta"], {int(c): tuple(tuple(float(v) for v in s)
                                             for s in st)
                               for c, st in d["chunks"].items()})


def _freeze_stats(st) -> tuple:
    return tuple(tuple(float(v) for v in s) for s in st)


def tree_merge(sketches: Sequence[SketchState]) -> SketchState:
    """Pairwise binary tree reduction of shard sketches — the merge
    shape a mesh of N workers produces. Because :meth:`SketchState.merge`
    is a disjoint dict union with no arithmetic, the result is bitwise
    identical to any other merge order."""
    level = list(sketches)
    if not level:
        raise ValueError("tree_merge needs at least one sketch")
    while len(level) > 1:
        nxt = [level[i].merge(level[i + 1])
               for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def _fold(sketch: SketchState, grid: ChunkGrid) -> list[list[float]]:
    """Canonical reduction: ascending-chunk left fold in float64. The
    ONE place partial sums are combined, so the result cannot depend on
    which shard held which chunk."""
    miss = sketch.missing(grid)
    if miss:
        raise ValueError(f"sketch incomplete: missing chunks {miss[:8]}"
                         f"{'…' if len(miss) > 8 else ''} of "
                         f"{grid.n_chunks}")
    totals: list[list[float]] | None = None
    for c in range(grid.n_chunks):
        st = sketch.chunks[c]
        if totals is None:
            totals = [list(s) for s in st]
        else:
            for t, s in zip(totals, st):
                for i, v in enumerate(s):
                    t[i] += v
    return totals


# -------------------------------------------------- chunk functions ----
# One chunk at the fixed padded shape (n_chunk, 2) → that chunk's stats
# as device tensors; the four are the JAX module's chunk kernels.
def _row_mask(c: int, n: int, n_chunk: int, device) -> torch.Tensor:
    return (c * n_chunk + torch.arange(n_chunk, device=device)) < n


def _pass_a_chunk(xy, c: int, n: int, n_chunk: int, l_raw):
    xyc = clip_sym(xy, l_raw)
    w = _row_mask(c, n, n_chunk, xy.device).to(xyc.dtype)[:, None]
    return torch.stack([(xyc * w).sum(0), (xyc * xyc * w).sum(0)])


def _ni_transforms(mode: str, mo: dict, lam1, lam2):
    if mode == "sign_norm":
        def tx(v):
            return torch.sign((clip_sym(v, mo["l_clip"]) - mo["mu_x"])
                              * mo["inv_x"])

        def ty(v):
            return torch.sign((clip_sym(v, mo["l_clip"]) - mo["mu_y"])
                              * mo["inv_y"])
    elif mode == "sign_raw":
        tx = ty = torch.sign
    else:  # "clip": NI subG transforms

        def tx(v):
            return clip_sym(v, lam1)

        def ty(v):
            return clip_sym(v, lam2)
    return tx, ty


def _int_sign_chunk(xy, c: int, n: int, n_chunk: int, flip_key, p_keep,
                    mo: dict | None):
    if mo is not None:
        sx = (clip_sym(xy[:, 0], mo["l_clip"]) - mo["mu_x"]) * mo["inv_x"]
        sy = (clip_sym(xy[:, 1], mo["l_clip"]) - mo["mu_y"]) * mo["inv_y"]
    else:
        sx, sy = xy[:, 0], xy[:, 1]
    s = rng.bernoulli(flip_key, p_keep, (n_chunk,))
    core = (2.0 * s.to(torch.float32) - 1.0) * torch.sign(sx) \
        * torch.sign(sy)
    w = _row_mask(c, n, n_chunk, xy.device)
    return torch.where(w, core, 0.0).sum()[None]


def _int_subg_chunk(xy, c: int, n: int, n_chunk: int, noise_key,
                    sender_is_x: bool, lam_s, lam_r, eps_s):
    """``streaming._int_subg_chunk_stats`` with the chunk's key given
    (derived on the host)."""
    xs = xy[:, 0] if sender_is_x else xy[:, 1]
    xo = xy[:, 1] if sender_is_x else xy[:, 0]  # other: not clipped
    noise = laplace(noise_key, (n_chunk,), 2.0 * lam_s / eps_s)
    uc = clip_sym((clip_sym(xs, lam_s) + noise) * xo, lam_r)
    uc = torch.where(_row_mask(c, n, n_chunk, xy.device), uc, 0.0)
    return torch.stack([uc.sum(), (uc * uc).sum()])


# ---------------------------------------------------- chunk kernels ----
# Built once per (kind, statics) through the compile layer; a built
# kernel closes over its statics only, never over a window's values.
_KERNELS: dict = {}
_FLIGHT = compile_mod.SingleFlight()
_OBSERVER: compile_mod.CompileObserver | None = None


def set_compile_observer(obs) -> None:
    """Route subsequent chunk-kernel builds through a service's observer
    (its /metrics registry). Process-wide, like the built functions: the
    last caller owns the series, and functions already built are not
    recorded again."""
    global _OBSERVER
    _OBSERVER = obs


def _get_kernel(kind: str, statics: tuple, build):
    """Build once per (kind, statics) through :class:`SingleFlight` and
    ``aot_compile`` (timed, no warm run)."""
    key = (kind,) + statics
    fn = _KERNELS.get(key)
    if fn is not None:
        return fn

    def _build():
        fn = compile_mod.aot_compile(
            build, signature={"kernel": f"stream.{kind}",
                              "statics": repr(statics)},
            observer=_OBSERVER)
        _KERNELS[key] = fn
        return fn

    fn, _leader = _FLIGHT.do(key, _build)
    return fn


def _pass_a_kernel(n_chunk: int):
    return _get_kernel("pass_a", (n_chunk,), lambda: (
        lambda xy, c, n, l_raw: _pass_a_chunk(xy, c, n, n_chunk, l_raw)))


def _ni_kernel(mode: str, n_chunk: int, m: int):
    kc = n_chunk // m

    def fn(xy, c, k, lap_x, lap_y, mo, lam1, lam2):
        tx, ty = _ni_transforms(mode, mo, lam1, lam2)
        return torch.stack(_ni_chunk_stats(xy, c, tx, ty, m, kc, k, lap_x,
                                           lap_y))

    return _get_kernel(f"ni.{mode}", (n_chunk, m), lambda: fn)


def _int_sign_kernel(mode: str, n_chunk: int):
    return _get_kernel(f"int_sign.{mode}", (n_chunk,), lambda: (
        lambda xy, c, n, flip_key, p_keep, mo: _int_sign_chunk(
            xy, c, n, n_chunk, flip_key, p_keep, mo)))


def _int_subg_kernel(sender_is_x: bool, n_chunk: int):
    return _get_kernel("int_subg", (sender_is_x, n_chunk), lambda: (
        lambda xy, c, n, noise_key, lam_s, lam_r, eps_s: _int_subg_chunk(
            xy, c, n, n_chunk, noise_key, sender_is_x, lam_s, lam_r,
            eps_s)))


# -------------------------------------------------- window pipeline ----
def _padded(xy: np.ndarray, grid: ChunkGrid) -> np.ndarray:
    pad = grid.n_chunks * grid.n_chunk - grid.n
    if pad:
        xy = np.concatenate(
            [xy, np.zeros((pad, 2), dtype=xy.dtype)], axis=0)
    return xy


def _chunk(xy_pad: np.ndarray, c: int, grid: ChunkGrid,
           device) -> torch.Tensor:
    return _put(torch.from_numpy(
        xy_pad[c * grid.n_chunk:(c + 1) * grid.n_chunk]), device)


def _meta(params: ReleaseParams, grid: ChunkGrid, pass_name: str,
          moments: Mapping | None) -> dict:
    meta = {"family": params.family, "pass": pass_name, "n": grid.n,
            "n_chunk": grid.n_chunk, "m": grid.m, "k": grid.k,
            "eps1": params.eps1, "eps2": params.eps2,
            "normalise": params.normalise, "alpha": params.alpha}
    if moments is not None:
        meta["moments"] = {k: float(v) for k, v in sorted(moments.items())}
    return meta


def _host_stats(ids, parts: list) -> dict[int, tuple]:
    """Per-chunk device stats → host tuples of f64, one copy per pass."""
    if not parts:
        return {}
    host = _fetch(torch.stack(parts)).to(torch.float64).numpy()
    return {c: tuple(tuple(float(v) for v in np.atleast_1d(row))
                     for row in host[i])
            for i, c in enumerate(ids)}


def moments_for_window(pass_a: SketchState, params: ReleaseParams,
                       grid: ChunkGrid, wkey, device=None) -> dict:
    """DP standardization moments from a complete pass-A sketch: the
    window's private (μ, 1/σ) per column, drawn from the window key at
    the family's monolithic substream addresses (``<ns>/std_x`` /
    ``<ns>/std_y``), with 1/σ computed in f32 on ``device`` once per
    window. Every shard computing pass B must be handed these exact
    values (they ride the pass-B meta)."""
    device = _device(device)
    totals = _fold(pass_a, grid)
    s1, s2 = totals
    l_clip = math.sqrt(2.0 * math.log(grid.n))
    words = _words(wkey)
    vals = []
    for col, (eps, name) in enumerate(
            ((params.eps1, "std_x"), (params.eps2, "std_y"))):
        mu, var = priv_moments_from_sums(
            _key_on(_sub(words, f"{params.family}/{name}"), device),
            f32_on(s1[col], device), f32_on(s2[col], device), grid.n,
            eps, l_clip)
        vals += [mu, 1.0 / torch.sqrt(var)]
    mu_x, inv_x, mu_y, inv_y = _fetch(torch.stack(vals)).tolist()
    return {"mu_x": mu_x, "inv_x": inv_x, "mu_y": mu_y, "inv_y": inv_y,
            "l_clip": l_clip}


def sketch_window(xy, params: ReleaseParams, wkey,
                  pass_name: str = "estimate",
                  chunk_ids: Sequence[int] | None = None,
                  moments: Mapping | None = None,
                  device=None) -> SketchState:
    """Sketch one pass over (a shard of) a window on ``device``.

    ``xy`` is the full (n, 2) admitted-row array — the shard split is
    over *chunk indices* (``chunk_ids``; None = all), which is what
    makes shard sketches mergeable: chunk c's stats are a pure function
    of (rows of chunk c, window key, params), identical whichever shard
    computes them. ``pass_name`` is ``"pass_a"`` (clipped moment sums,
    normalise families) or ``"estimate"``; the estimate pass of a
    normalise family requires ``moments`` from
    :func:`moments_for_window`."""
    device = _device(device)
    xy = np.ascontiguousarray(np.asarray(xy, dtype=np.float32))
    if xy.ndim != 2 or xy.shape[1] != 2:
        raise ValueError(f"xy must be (n, 2), got {xy.shape}")
    grid = grid_for(params, xy.shape[0])
    if pass_name not in ("pass_a", "estimate"):
        raise ValueError(f"unknown pass {pass_name!r}")
    if pass_name == "pass_a" and not params.needs_moments:
        raise ValueError(
            f"family {params.family!r} (normalise={params.normalise}) "
            f"has no standardization pass")
    if pass_name == "estimate" and params.needs_moments \
            and moments is None:
        raise ValueError("estimate pass of a normalise family needs "
                         "moments= from moments_for_window()")
    ids = list(range(grid.n_chunks)) if chunk_ids is None \
        else sorted({int(c) for c in chunk_ids})
    for c in ids:
        if not 0 <= c < grid.n_chunks:
            raise ValueError(f"chunk id {c} outside grid "
                             f"[0, {grid.n_chunks})")
    xy_pad = _padded(xy, grid)
    if pass_name == "pass_a":
        l_raw = f32_on(math.sqrt(2.0 * math.log(grid.n)), device)
        kern = _pass_a_kernel(grid.n_chunk)
        parts = [kern(_chunk(xy_pad, c, grid, device), c, grid.n, l_raw)
                 for c in ids]
    else:
        parts = _estimate_parts(xy_pad, params, grid, _words(wkey), ids,
                                moments, device)
    return SketchState(
        _meta(params, grid, pass_name,
              moments if pass_name == "estimate" else None),
        _host_stats(ids, parts))


def _moments_on(moments: Mapping | None, device) -> dict | None:
    if moments is None:
        return None
    return {k: f32_on(moments[k], device)
            for k in ("mu_x", "inv_x", "mu_y", "inv_y", "l_clip")}


def _estimate_parts(xy_pad, params: ReleaseParams, grid: ChunkGrid,
                    words, ids, moments, device) -> list:
    fam = params.family
    chunk = lambda c: _chunk(xy_pad, c, grid, device)  # noqa: E731
    mo = _moments_on(moments, device)
    if fam in ("ni_sign", "ni_subg"):
        if fam == "ni_sign":
            mode = "sign_norm" if params.normalise else "sign_raw"
            scale_x = f32_on(2.0 / (grid.m * params.eps1), device)
            scale_y = f32_on(2.0 / (grid.m * params.eps2), device)
            lam1 = lam2 = None
        else:
            mode = "clip"
            lam1 = lambda_n(grid.n, params.eta1, device)
            lam2 = lambda_n(grid.n, params.eta2, device)
            scale_x = 2.0 * lam1 / (grid.m * params.eps1)
            scale_y = 2.0 * lam2 / (grid.m * params.eps2)
        # the (k,) batch-noise draws at the monolithic addresses, padded
        # to the data-chunk grid (n_chunks*kc >= k) — every shard
        # re-derives the identical vectors from the window key
        lap_x, lap_y = _ni_batch_noise(
            _key_on(_sub(words, f"{fam}/lap_x"), device),
            _key_on(_sub(words, f"{fam}/lap_y"), device),
            grid.k, scale_x, scale_y, grid.n_chunks * grid.kc)
        kern = _ni_kernel(mode, grid.n_chunk, grid.m)
        return [kern(chunk(c), c, grid.k, lap_x, lap_y, mo, lam1, lam2)
                for c in ids]
    if fam == "int_sign":
        eps_s = max(params.eps1, params.eps2)
        e_s = math.exp(eps_s)
        p_keep = e_s / (e_s + 1.0)
        flip_base = _sub(_sub(words, "int_sign/est"), "int_sign/flips")
        kern = _int_sign_kernel(
            "sign_norm" if params.normalise else "sign_raw", grid.n_chunk)
        return [kern(chunk(c), c, grid.n,
                     # dpcorr-lint: ignore[rng-raw-api] — rng.chunk_key on host words, as _sub
                     _key_on(rng.fold_in_words(flip_base, c), device),
                     p_keep, mo if params.normalise else None)
                for c in ids]
    sender_is_x, eps_s, _eps_r, lam_s, lam_r = _int_subg_roles(
        grid.n, params.eps1, params.eps2, params.eta1, params.eta2, device)
    noise_base = _sub(words, "int_subg/lap_sender")
    eps_s = f32_on(eps_s, device)
    kern = _int_subg_kernel(bool(sender_is_x), grid.n_chunk)
    return [kern(chunk(c), c, grid.n,
                 # dpcorr-lint: ignore[rng-raw-api] — rng.chunk_key on host words, as _sub
                 _key_on(rng.fold_in_words(noise_base, c), device),
                 lam_s, lam_r, eps_s) for c in ids]


# ---------------------------------------------------------- release ----
def release_from_sketch(sketch: SketchState, params: ReleaseParams,
                        wkey, device=None) -> dict:
    """Fold a complete estimate sketch and finish the release on
    ``device``: the window-level noise draws (central Laplace, CI
    construction) at their monolithic substream addresses under the
    window key. Returns the strict-JSON release record;
    ``json.dumps(..., sort_keys=True)`` of it is the byte-identity
    surface the crash gates compare."""
    device = _device(device)
    grid = ChunkGrid(params.family, int(sketch.meta["n"]),
                     int(sketch.meta["n_chunk"]), -1,
                     int(sketch.meta["m"]), int(sketch.meta["k"]))
    grid = dataclasses.replace(
        grid, n_chunks=-(-grid.n // grid.n_chunk))
    totals = _fold(sketch, grid)
    words = _words(wkey)
    fam = params.family
    if fam == "ni_sign":
        res = _finish_ni_sign(totals, params, grid, device)
    elif fam == "ni_subg":
        res = _finish_ni_subg(totals, params, grid, device)
    elif fam == "int_sign":
        res = _finish_int_sign(totals, params, grid, words, device)
    else:
        res = _finish_int_subg(totals, params, grid, words, device)
    rho, lo, hi = _fetch(torch.stack(list(res))).tolist()
    return {"family": fam, "n": grid.n, "m": grid.m, "k": grid.k,
            "eps1": params.eps1, "eps2": params.eps2,
            "normalise": params.normalise, "alpha": params.alpha,
            "rho": float(rho), "lo": float(lo), "hi": float(hi)}


def _finish_ni_sign(totals, params, grid, device):
    (st,), (st2,) = totals
    eta_hat, s_eta = _ni_from_sums(f32_on(st, device), f32_on(st2, device),
                                   grid.k)
    rho_hat = torch.sin(math.pi * eta_hat / 2.0)
    crit = (f32_on(_JAX_Z_0975, device) if params.alpha == 0.05
            else crit_value(params.alpha, device))
    half = (crit * s_eta
            / torch.sqrt(f32_on(float(grid.k), device)))
    lo = torch.sin(_HALF_PI * torch.clamp_min(eta_hat - half, -1.0))
    hi = torch.sin(_HALF_PI * torch.clamp_max(eta_hat + half, 1.0))
    return rho_hat, lo, hi


def _finish_ni_subg(totals, params, grid, device):
    (st,), (st2,) = totals
    eta_hat, s_t = _ni_from_sums(f32_on(st, device), f32_on(st2, device),
                                 grid.k)
    lam1 = lambda_n(grid.n, params.eta1, device)
    lam2 = lambda_n(grid.n, params.eta2, device)
    res = _ni_subg_interval(eta_hat, s_t, grid.k, grid.m, lam1, lam2,
                            params.alpha)
    return res.rho_hat, res.ci_low, res.ci_high


def _finish_int_sign(totals, params, grid, words, device):
    ((sum_core,),) = totals
    eps_s = max(params.eps1, params.eps2)
    eps_r = min(params.eps1, params.eps2)
    e_s = math.exp(eps_s)
    est = _sub(words, "int_sign/est")
    scale_z = 2.0 * (e_s + 1.0) / (grid.n * (e_s - 1.0) * eps_r)
    z = laplace(_key_on(_sub(est, "int_sign/lap_z"), device), (), scale_z)
    eta_hat = ((e_s + 1.0) / (grid.n * (e_s - 1.0))
               * f32_on(sum_core, device) + z)
    rho_hat = torch.sin(math.pi * eta_hat / 2.0)
    res = interval_from_rho(_key_on(words, device), rho_hat, grid.n, eps_s,
                            eps_r, params.alpha, "auto", "det")
    return res.rho_hat, res.ci_low, res.ci_high


def _finish_int_subg(totals, params, grid, words, device):
    (s1,), (s2,) = totals
    _sx, eps_s, eps_r, lam_s, lam_r = _int_subg_roles(
        grid.n, params.eps1, params.eps2, params.eta1, params.eta2, device)
    res = _int_subg_interval(_key_on(words, device), f32_on(s1, device),
                             f32_on(s2, device), grid.n, eps_s, eps_r,
                             lam_s, lam_r, params.alpha, "det")
    return res.rho_hat, res.ci_low, res.ci_high


def placement_shards(placement, n_chunks: int) -> list[list[int]]:
    """The chunk partition a placement induces: one shard per device,
    chunks dealt round-robin (shard ``d`` gets every chunk ``c`` with
    ``c % D == d``). A one-device placement degenerates to the
    monolithic single shard. Duck-typed on the ``device_count``
    property, as in the JAX package."""
    d = max(1, int(placement.device_count))
    shards = [[c for c in range(n_chunks) if c % d == i]
              for i in range(d)]
    return [s for s in shards if s]


def release_window(xy, params: ReleaseParams, wkey,
                   shards: Sequence[Sequence[int]] | None = None,
                   *, placement=None, device=None) -> dict:
    """Full window pipeline on ``device``: (pass A → moments →) estimate
    sketch → fold → release. ``shards`` splits every pass's chunk set
    (e.g. ``[[0, 2], [1, 3]]``) and merges the shard sketches — the
    release is bitwise identical for every partition. ``placement``
    (anything with a ``device_count``; mutually exclusive with explicit
    ``shards``) derives the partition through :func:`placement_shards`."""
    device = _device(device)
    xy = np.ascontiguousarray(np.asarray(xy, dtype=np.float32))
    grid = grid_for(params, xy.shape[0])
    if shards is None:
        if placement is not None:
            shards = placement_shards(placement, grid.n_chunks)
        else:
            shards = [list(range(grid.n_chunks))]
    elif placement is not None:
        raise ValueError("pass shards= or placement=, not both")
    moments = None
    if params.needs_moments:
        pass_a = _merged(xy, params, wkey, "pass_a", shards, None, device)
        moments = moments_for_window(pass_a, params, grid, wkey, device)
    est = _merged(xy, params, wkey, "estimate", shards, moments, device)
    return release_from_sketch(est, params, wkey, device)


def _merged(xy, params, wkey, pass_name, shards, moments,
            device) -> SketchState:
    # tree reduction, not a left fold: the shape a mesh of workers
    # produces. merge() is a no-arithmetic dict union, so this is
    # bitwise-identical to any other order.
    return tree_merge([
        sketch_window(xy, params, wkey, pass_name, chunk_ids=ids,
                      moments=moments, device=device)
        for ids in shards])
