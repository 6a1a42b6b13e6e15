"""Monte-Carlo simulator (reference layer L3).

Counterpart of ``dpcorr/sim.py``, for the four estimator families (sign
and sub-Gaussian, NI and INT), the four DGPs and the streaming path. The
reference's hot loops (vert-cor.R:392-419, ver-cor-subG.R:174-198) are a
batched function of per-replication keys: the
replication axis is a leading tensor dimension, blocked into chunks of at
most ``chunk_size`` replications so B × n never has to be resident at
once. Two bodies compute it:

- unfused: :func:`_one_rep`, torch ops on the key-tree, which agrees with
  the JAX package replication by replication, in every family, DGP and
  on the streaming path (:func:`_one_rep_streaming`);
- fused: :func:`sim_detail_fused`, one kernel pass per replication on the
  card (``dpcorr_torch.ops.fused_ni``), statistically equivalent.

:class:`RepBlockPipeline` runs a body in chained blocks with one host sync
per run.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Mapping

import numpy as np
import torch

from dpcorr_torch.models.dgp import DGPS, gen_gaussian
from dpcorr_torch.models.estimators import streaming as st
from dpcorr_torch.models.estimators.common import batch_geometry
from dpcorr_torch.models.estimators.int_sign import (
    ci_int_signflip,
    interval_from_rho,
)
from dpcorr_torch.models.estimators.int_subg import ci_int_subg
from dpcorr_torch.models.estimators.ni_sign import ci_ni_signbatch
from dpcorr_torch.models.estimators.ni_subg import correlation_ni_subg
from dpcorr_torch.ops.fused_ni import fused_ni_sums, ni_result
from dpcorr_torch.utils import rng
from dpcorr_torch.utils.device import f32_on, resolve_device
# re-exported: the grid, HRS and the measuring scripts mark stages as sim's
from dpcorr_torch.utils.profiling import (  # noqa: F401
    HOST_READ,
    stage,
    stage_host_seconds,
)


#: the stages of a fused block, as ``torch.profiler`` ranges (:func:`stage`)
FUSED_STAGES = ("rep_keys", "kernel_seeds", "fused_ni", "ni_result+_metrics",
                "accumulate")
#: the stages of a fused grid bucket (``grid._dispatch``); ``int_ci``, the
#: INT CI with its mixture quantile, lies inside ``ni_result+_metrics``
GRID_STAGES = ("rep_keys", "kernel_seeds", "fused_ni", "ni_result+_metrics",
               "int_ci")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """One design point (vert-cor.R:356-444, ver-cor-subG.R:159-222).

    ``dgp`` is a name from :data:`dpcorr_torch.models.dgp.DGPS` or a
    callable ``f(keys, n, rho, **dgp_args)``; ``dgp_args`` carries its
    keyword arguments (``mu`` and ``sigma`` for the Gaussian).
    ``use_subg`` runs the sub-Gaussian estimator pair, ``subg_variant``
    picks the grid pair (sequential batches, se with the Laplace term,
    ver-cor-subG.R:25-108) or the real-data pair (randomized batches and
    the k ≥ 2 fallback, receiver λ from the sender's noise, sampling-only
    se, δ_clip = 1/n; real-data-sims.R:115-252). ``eta1``/``eta2`` feed
    the λ rules (ver-cor-subG.R:28-31). ``stream_n_chunk`` runs the
    streaming estimators with about that many rows resident per
    replication (BASELINE.md config 5).
    """

    n: int
    rho: float
    eps1: float
    eps2: float
    b: int = 1000
    alpha: float = 0.05
    dgp: str | Callable = "gaussian"
    dgp_args: Any = ()
    use_subg: bool = False
    subg_variant: str = "grid"
    eta1: float = 1.0
    eta2: float = 1.0
    ci_mode: str = "auto"
    normalise: bool = True
    mixquant_mode: str = "det"
    seed: int = rng.MASTER_SEED
    chunk_size: int = 4096  # max replications resident at once
    stream_n_chunk: int | None = None

    def __post_init__(self):
        if self.subg_variant not in ("grid", "real"):
            raise ValueError(f"subg_variant must be 'grid' or 'real', "
                             f"got {self.subg_variant!r}")
        if self.stream_n_chunk and self.use_subg \
                and self.subg_variant == "real":
            # randomized batches need a permutation of all n rows, which
            # cannot be n-blocked
            raise ValueError("subg_variant='real' is not available on the "
                             "streaming path")

        def freeze(v):
            if isinstance(v, Mapping):
                return tuple(sorted((k, freeze(x)) for k, x in v.items()))
            if isinstance(v, (list, tuple)):
                return tuple(freeze(x) for x in v)
            return v

        object.__setattr__(self, "dgp_args", freeze(self.dgp_args))

    def dgp_fn(self) -> Callable:
        if isinstance(self.dgp, str):
            if self.dgp not in DGPS:
                raise ValueError(f"unknown dgp {self.dgp!r}; one of "
                                 f"{sorted(DGPS)} or a callable")
            fn = DGPS[self.dgp]
        else:
            fn = self.dgp
        return functools.partial(fn, **dict(self.dgp_args))


#: detail-table columns, in the reference's order (vert-cor.R:367-385)
DETAIL_FIELDS = (
    "ni_hat", "int_hat", "ni_se2", "int_se2",
    "ni_low", "ni_up", "int_low", "int_up",
    "ni_cover", "int_cover", "ni_ci_len", "int_ci_len",
)


def _metrics(r, rho) -> tuple:
    """(se², cover, ci_len) of a CorrResult at the true ρ."""
    cover = ((rho >= r.ci_low) & (rho <= r.ci_high)).to(torch.float32)
    return (r.rho_hat - rho) ** 2, cover, r.ci_high - r.ci_low


def _metrics_row(ni, it, rho) -> tuple:
    """Per-rep metrics in DETAIL_FIELDS order (vert-cor.R:401-417)."""
    rho = f32_on(rho, ni.rho_hat.device)
    ni_se2, ni_cover, ni_len = _metrics(ni, rho)
    int_se2, int_cover, int_len = _metrics(it, rho)
    return (ni.rho_hat, it.rho_hat, ni_se2, int_se2,
            ni.ci_low, ni.ci_high, it.ci_low, it.ci_high,
            ni_cover, int_cover, ni_len, int_len)


def _one_rep(keys: torch.Tensor, rho, cfg: SimConfig, eps=None,
             k_pad: int | None = None) -> tuple:
    """A batch of replications, generate → NI + INT → metrics, as a
    function of the replication keys ``(C, words)``; returns the 12 (C,)
    fields of :data:`DETAIL_FIELDS`. ``rho`` is a float or a (C,) tensor.

    ``eps``: optional ``(ε₁, ε₂)`` tensors over the replications, in
    place of the config's: the sub-Gaussian estimators then run with
    per-replication batch geometry (padded to ``k_pad``) and the sender
    named ``"x"``, so one call serves design points at different ε. The
    caller guarantees ε₁ ≥ ε₂, so the named sender is the larger-ε rule
    the static path applies."""
    if eps is not None and not cfg.use_subg:
        raise ValueError("per-replication ε is only supported for the "
                         "sub-Gaussian families")
    if eps is not None and cfg.stream_n_chunk:
        # the streaming body's chunk geometry is fixed by the config's ε
        raise ValueError("per-replication ε does not compose with the "
                         "streaming path")
    if cfg.stream_n_chunk:
        ni, it = _one_rep_streaming(keys, rho, cfg)
        return _metrics_row(ni, it, rho)

    xy = cfg.dgp_fn()(rng.stream(keys, "dgp"), cfg.n, rho)
    x, y = xy[..., 0], xy[..., 1]
    if cfg.use_subg:
        real = cfg.subg_variant == "real"
        e1, e2 = (cfg.eps1, cfg.eps2) if eps is None else eps
        ni = correlation_ni_subg(rng.stream(keys, "ni"), x, y, e1, e2,
                                 eta1=cfg.eta1, eta2=cfg.eta2,
                                 alpha=cfg.alpha, randomize_batches=real,
                                 enforce_min_k=real,
                                 dynamic_geometry=eps is not None,
                                 k_pad=k_pad)
        it = ci_int_subg(rng.stream(keys, "int"), x, y, e1, e2,
                         eta1=cfg.eta1, eta2=cfg.eta2, alpha=cfg.alpha,
                         variant=cfg.subg_variant,
                         mixquant_mode=cfg.mixquant_mode,
                         sender="x" if eps is not None else None)
    else:
        ni = ci_ni_signbatch(rng.stream(keys, "ni"), x, y, cfg.eps1,
                             cfg.eps2, alpha=cfg.alpha,
                             normalise=cfg.normalise)
        it = ci_int_signflip(rng.stream(keys, "int"), x, y, cfg.eps1,
                             cfg.eps2, alpha=cfg.alpha, mode=cfg.ci_mode,
                             normalise=cfg.normalise,
                             mixquant_mode=cfg.mixquant_mode)
    return _metrics_row(ni, it, rho)


def _one_rep_streaming(keys: torch.Tensor, rho, cfg: SimConfig):
    """The streaming body: the same generate → estimate pipeline with the
    n axis in ``cfg.stream_n_chunk``-row chunks regenerated from folded
    keys instead of held (BASELINE.md config 5)."""
    m, _ = batch_geometry(cfg.n, cfg.eps1, cfg.eps2)
    n_chunk = st.choose_n_chunk(cfg.n, m, cfg.stream_n_chunk)
    chunk_fn = st.dgp_chunk_fn(cfg.dgp_fn(), rng.stream(keys, "dgp"),
                               n_chunk, rho)
    if cfg.use_subg:
        # one pass: each chunk is generated once for both estimators
        return st.subg_pair_stream(
            rng.stream(keys, "ni"), rng.stream(keys, "int"), chunk_fn,
            cfg.n, cfg.eps1, cfg.eps2, eta1=cfg.eta1, eta2=cfg.eta2,
            alpha=cfg.alpha, mixquant_mode=cfg.mixquant_mode,
            n_chunk=n_chunk)
    # pass A depends only on the data: computed once for both estimators
    # (each still draws its own standardization noise)
    sums = (st.clipped_moment_sums(chunk_fn, cfg.n, n_chunk)
            if cfg.normalise else None)
    ni = st.ci_ni_signbatch_stream(
        rng.stream(keys, "ni"), chunk_fn, cfg.n, cfg.eps1, cfg.eps2,
        alpha=cfg.alpha, normalise=cfg.normalise, n_chunk=n_chunk,
        moment_sums=sums)
    it = st.ci_int_signflip_stream(
        rng.stream(keys, "int"), chunk_fn, cfg.n, cfg.eps1, cfg.eps2,
        alpha=cfg.alpha, mode=cfg.ci_mode, normalise=cfg.normalise,
        mixquant_mode=cfg.mixquant_mode, n_chunk=n_chunk, moment_sums=sums)
    return ni, it


#: replications resident per chunk of the streaming path on the card
#: (n = 10⁶, n_chunk = 65536; measured by ``python -m
#: dpcorr_torch.perf_subg``, PERF.md §5)
STRESS_CHUNK_CARD = 512


def stress_chunk_size(b: int, on_card: bool) -> int:
    """Replications resident at once on the streaming path. The card
    wants wide chunks: a chunk costs the same launches whatever its
    width, and at 512 replications the run peaks at 2.6 GiB (64 → 118,
    128 → 170, 256 → 182, 512 → 190 reps/s on an H100 at n = 10⁶,
    PERF.md §5). On the CPU, one replication at a time (the JAX
    package's measured CPU policy, not measured for the port)."""
    return min(b, STRESS_CHUNK_CARD) if on_card else 1


def chunked(fn: Callable, args, chunk_size: int) -> tuple:
    """``fn`` over the leading replication axis in chunks of at most
    ``chunk_size``; the per-chunk outputs are concatenated. ``args`` is
    one tensor (→ ``fn(x)``) or a tuple of tensors of one length sliced
    together (→ ``fn(*xs)``, e.g. per-replication (key, ρ) pairs for the
    bucketed grid). Outputs do not depend on the chunk width."""
    tup = args if isinstance(args, tuple) else (args,)
    b = tup[0].shape[0]
    parts = [fn(*(a[s:s + chunk_size] for a in tup))
             for s in range(0, b, chunk_size)]
    return tuple(torch.cat(cols) for cols in zip(*parts, strict=True))


def _run_detail_flat(cfg_norho: SimConfig, keys: torch.Tensor,
                     rhos: torch.Tensor) -> tuple:
    """Batched design points: per-replication (key, ρ) pairs flattened
    over (points × replications), the bucketed grid's body (counterpart
    of ``dpcorr.sim._run_detail_flat``). Returns the 12 fields of
    :data:`DETAIL_FIELDS`."""
    return chunked(lambda k, r: _one_rep(k, r, cfg_norho), (keys, rhos),
                   cfg_norho.chunk_size)


def _run_detail_flat_eps(cfg_noeps: SimConfig, keys: torch.Tensor,
                         rhos: torch.Tensor, eps1s: torch.Tensor,
                         eps2s: torch.Tensor,
                         k_pad: int | None = None) -> tuple:
    """ε-merged bucket body: like :func:`_run_detail_flat` with ε per
    replication too, so one call serves every (ρ, ε) design point at a
    given n (``GridConfig.bucket_merge="eps"``; sub-Gaussian families
    only, ε₁ ≥ ε₂, see :func:`_one_rep`). ``k_pad``: the pad bound of the
    per-batch vectors (``common.k_pad_for``)."""
    return chunked(
        lambda k, r, e1, e2: _one_rep(k, r, cfg_noeps, eps=(e1, e2),
                                      k_pad=k_pad),
        (keys, rhos, eps1s, eps2s), cfg_noeps.chunk_size)


def summarize(detail: Mapping[str, torch.Tensor], rho: float) -> dict:
    """Reference summary rows (vert-cor.R:421-443): per method mse, bias,
    var, coverage, ci_length. One device-to-host copy, then f64 (the
    copy in a ``host_read`` range)."""
    with stage(HOST_READ):
        # dpcorr-lint: ignore[sync-in-loop] — after the run, one copy per detail field (ROADMAP perf_opt: one stacked copy)
        host = {k: v.detach().cpu().numpy().astype(np.float64)
                for k, v in detail.items()}
    out = {}
    for meth in ("ni", "int"):
        est = host[f"{meth}_hat"]
        out[meth.upper()] = {
            "mse": float(host[f"{meth}_se2"].mean()),
            "bias": float(est.mean() - rho),
            "var": float(est.var(ddof=1)),
            "coverage": float(host[f"{meth}_cover"].mean()),
            "ci_length": float(host[f"{meth}_ci_len"].mean()),
        }
    return out


@dataclasses.dataclass
class SimResult:
    """``detail``: dict of (B,) tensors (the reference's replicate table);
    ``summary``: {"NI": {...}, "INT": {...}}."""

    detail: dict
    summary: dict
    config: SimConfig

    def summary_rows(self) -> list[dict]:
        """The summary as one flat dict per method, ``{"method": "NI",
        "mse": ..., ...}``, as ``dpcorr.sim.SimResult.summary_rows``
        gives it to the grid driver's tables."""
        return [{"method": m, **v} for m, v in self.summary.items()]


def run_sim_one(cfg: SimConfig, key: torch.Tensor | None = None,
                device=None) -> SimResult:
    """One design point: B replications of (generate → NI + INT →
    metrics) on ``device`` (the card unless the caller names another).
    Replication b uses key ``fold_in(key, b)``, the JAX package's
    addresses."""
    dev = resolve_device(device)
    key = rng.master_key(cfg.seed, dev) if key is None else key.to(dev)
    keys = rng.rep_keys(key, cfg.b)
    raw = chunked(lambda k: _one_rep(k, cfg.rho, cfg), keys, cfg.chunk_size)
    detail = dict(zip(DETAIL_FIELDS, raw, strict=True))
    return SimResult(detail, summarize(detail, cfg.rho), cfg)


def sim_detail_fused(seeds: torch.Tensor, rhos, n: int, eps1: float,
                     eps2: float, mu=(0.0, 0.0), sigma=(1.0, 1.0),
                     alpha: float = 0.05, ci_mode: str = "auto",
                     normalise: bool = True, gauss: str = "boxmuller",
                     uniforms: torch.Tensor | None = None,
                     device=None) -> tuple:
    """Whole-replication fused simulation (counterpart of
    ``sim_detail_pallas``): one kernel pass draws the data and computes
    the NI sums and the INT η̂ on the same draw; the CIs follow as scalar
    torch ops. Returns the 12 fields of :data:`DETAIL_FIELDS`.
    ``seeds``: (B, 2) int32 words; ``rhos``: a float or (B,) tensor;
    ``uniforms``: external uniforms, required when ``device`` is the
    CPU."""
    dev = resolve_device(device)
    seeds = seeds.to(dev, torch.int32).contiguous()
    if uniforms is not None:
        uniforms = uniforms.to(dev, torch.float32).contiguous()
    rhos = f32_on(rhos, dev)
    with stage("fused_ni"):
        out = fused_ni_sums(seeds, rhos, n, eps1, eps2, mu, sigma, normalise,
                            True, gauss, uniforms)
    _, k = batch_geometry(n, eps1, eps2)
    with stage("ni_result+_metrics"):
        ni = ni_result(out[:, 0], out[:, 1], k, alpha)
        rho_hat_int = torch.sin(math.pi * out[:, 2] / 2.0)
        eps_s, eps_r = max(eps1, eps2), min(eps1, eps2)
        with stage("int_ci"):
            it = interval_from_rho(None, rho_hat_int, n, eps_s, eps_r, alpha,
                                   ci_mode)
        return _metrics_row(ni, it, rhos)


def ni_rep_fn(n: int, rho: float, eps1: float, eps2: float,
              alpha: float = 0.05) -> Callable:
    """The north-star replication body (``bench.make_rep_fn``), unfused:
    keys (C, words) → n-point Gaussian pair → NI sign-batch estimate + CI →
    (se², cover, ci_len), each (C,)."""
    rho = float(np.float32(rho))

    def body(keys):
        xy = gen_gaussian(rng.stream(keys, "dgp"), n, rho)
        r = ci_ni_signbatch(rng.stream(keys, "ni"), xy[..., 0], xy[..., 1],
                            eps1, eps2, alpha=alpha)
        return _metrics(r, rho)

    return body


def fused_ni_rep_fn(n: int, rho: float, eps1: float, eps2: float,
                    alpha: float = 0.05) -> Callable:
    """The same body through the fused kernel in its in-kernel Philox
    mode: keys (C, words) → :func:`rng.kernel_seeds` → one launch → (se²,
    cover, ci_len). Card only."""
    rho = float(np.float32(rho))
    _, k = batch_geometry(n, eps1, eps2)

    def body(keys):
        with stage("kernel_seeds"):
            seeds = rng.kernel_seeds(keys).contiguous()
        with stage("fused_ni"):
            out = fused_ni_sums(seeds, rho, n, eps1, eps2)
        with stage("ni_result+_metrics"):
            return _metrics(ni_result(out[:, 0], out[:, 1], k, alpha), rho)

    return body


class _Shard:
    """One device's share of a block: its contiguous replications
    ``[start, start + count)``, its copy of the root key, and its
    preallocated output and accumulator buffers."""

    __slots__ = ("device", "start", "count", "key", "out", "acc")

    def __init__(self, device, start: int, count: int, key, out_len: int):
        self.device = device
        self.start = start
        self.count = count
        self.key = key.to(device)
        self.out = torch.empty(out_len, count, dtype=torch.float32,
                               device=device)
        self.acc = torch.zeros(out_len, dtype=torch.float32, device=device)


class RepBlockPipeline:
    """Chained replication blocks with one host read per :meth:`run`.

    Counterpart of ``dpcorr.sim.RepBlockPipeline``. ``rep_fn(keys (C, words))
    -> tuple[out_len] of (C,)`` is the body; block i runs it over
    ``rep_keys(design_key(key, i), block_reps)`` in chunks of
    ``chunk_size`` (the JAX pipeline's key addresses), and each output is
    summed into its accumulator. What JAX gets from donation, the port
    does in place: the block's output buffer and the accumulators are
    allocated once and overwritten (counted as ``donated_blocks`` in
    ``obs.transfer``); the next block's keys are made on the device; the
    host reads the accumulators once, at the end of :meth:`run`, through
    the plan executor's counted fetch.

    The body is a plan unit (``plan.Executor``): built ahead and warmed
    once on zero keys at the chunk shape with ``aot=True`` (timed into
    ``observer``'s ``dpcorr_compile_seconds``; a fused body launches its
    kernel once there), a lazy unit otherwise. ``aot`` is off by default:
    eager torch has nothing to compile, and the warm run is a block's
    worth of extra work the JAX compile does not cost.

    **Mesh placement** (``placement="mesh"``, over ``devices`` or
    ``parallel.mesh.rep_devices``): ``block_reps`` must split evenly over
    the devices. Each device makes the keys of its contiguous shard of
    the block at their global addresses (``rng.rep_keys_slice``) and
    runs them, in the local run's chunks (the same chunk grid, cut at
    the shard's edges), into its own accumulator. Per-rep outputs
    (:meth:`block_detail`) are bit-equal to the local placement whenever
    the shard size is a multiple of ``chunk_size``; the sums are folded
    on the host in ascending shard order in float64 at the fetch, equal
    to the local sums on one device and within f32 rounding otherwise.

    ``impl``: the PRNG impl the pipeline runs on (counterpart of the JAX
    pipeline's ``impl``; None is the process impl); a root key of another
    width raises. rbg-family keys draw per key (``utils.rng``), so the
    per-rep outputs do not depend on the chunk width as they do under the
    JAX package's ``vmap``.

    Ranges (``utils.profiling``): the constructor's work runs inside a
    ``pipeline_init`` range (the warm run of ``aot=True`` outside it),
    each block's keys inside ``rep_keys``, the accumulation inside
    ``accumulate``, the one read inside the executor's ``host_read``.

    ``profiler``: an optional ``obs.prof.BlockProfiler``, used only under
    ``is not None``: it waits for the accumulators' device at a bounded
    cadence of blocks (``dpcorr_prof_syncs_total``, never a fetch); a
    run without one makes its one fetch and nothing more.
    """

    def __init__(self, rep_fn: Callable, out_len: int, *,
                 key: torch.Tensor, block_reps: int, chunk_size: int,
                 device=None, placement="local", devices=None,
                 counters=None, observer=None, aot: bool = False,
                 profiler=None, impl: str | None = None):
        from dpcorr_torch import plan as plan_mod
        from dpcorr_torch.obs import transfer as transfer_mod

        with stage("pipeline_init"):
            self.profiler = profiler
            #: the PRNG impl of the key-tree below ``key`` (None: the process
            #: impl, ``rng.resolve_impl``); the root key's words must match it
            self.impl = rng.resolve_impl(impl)
            words = torch.as_tensor(key).shape[-1]
            if words != rng.IMPLS[self.impl]:
                raise ValueError(
                    f"the root key has {words} words; {self.impl!r} keys have "
                    f"{rng.IMPLS[self.impl]} (make it with rng.master_key("
                    f"impl={self.impl!r}))")
            self.device = resolve_device(device)
            self.rep_fn = rep_fn
            self.out_len = int(out_len)
            self.block_reps = int(block_reps)
            self.chunk_size = int(chunk_size)
            self._counters = counters if counters is not None \
                else transfer_mod.default_counters()
            self._ex = plan_mod.Executor(
                placement, devices=devices, device=self.device,
                counters=self._counters, observer=observer)
            self.placement = self._ex.placement
            if self.placement.name == "local":
                homes = [self.device]
            elif self.placement.name == "mesh":
                homes = self.placement.devices
                if self.block_reps % len(homes):
                    raise ValueError(
                        f"block_reps={self.block_reps} must split evenly over "
                        f"the {len(homes)}-device mesh: every device keeps an "
                        "equal shard of the block and its own accumulator")
            else:
                raise ValueError(
                    f"RepBlockPipeline supports 'local' and 'mesh' "
                    f"placements, got {self.placement.name!r}")
            per = self.block_reps // len(homes)
            self._shards = [_Shard(dev, s * per, per, key, self.out_len)
                            for s, dev in enumerate(homes)]
            sig = {"kernel": "rep_block", "placement": self.placement.name,
                   "devices": len(homes), "block_reps": self.block_reps,
                   "chunk_size": self.chunk_size, "out_len": self.out_len}
            if not aot:
                self._unit = self._ex.lazy_unit(rep_fn, signature=sig)
        if aot:
            # outside pipeline_init: the warm run opens the body's stages
            warm = torch.zeros(min(self.chunk_size, per), words,
                               dtype=torch.int64, device=homes[0])
            self._unit = self._ex.prepare(
                ("rep_block", self.placement.name, len(homes),
                 self.block_reps, self.chunk_size, self.out_len,
                 id(rep_fn)), lambda: rep_fn, (warm,), signature=sig,
                cache=False)
        #: device-to-host reads made by run(): exactly one per call (also
        #: counted as ``fetches`` in the transfer counters)
        self.fetches = 0

    def _block_keys(self, i: int, sh: _Shard) -> torch.Tensor:
        """The keys of ``sh``'s replications of block ``i``, at their
        addresses in the whole block's ``rep_keys`` stream."""
        with stage("rep_keys"):
            return rng.rep_keys_slice(rng.design_key(sh.key, i), sh.start,
                                      sh.count)

    def _chunks(self, sh: _Shard):
        """``(a, b)`` offsets in the shard of the local run's chunks
        (multiples of ``chunk_size`` over the whole block) cut at the
        shard's edges."""
        lo, hi = sh.start, sh.start + sh.count
        for s in range(lo - lo % self.chunk_size, hi, self.chunk_size):
            yield max(s, lo) - lo, min(s + self.chunk_size, hi) - lo

    def _fill(self, sh: _Shard, keys: torch.Tensor) -> None:
        for a, b in self._chunks(sh):
            outs = self._unit(keys[a:b])
            with stage("accumulate"):
                for row, o in zip(sh.out, outs, strict=True):
                    row[a:a + o.shape[0]].copy_(o)

    def run(self, n_blocks: int, *, start_block: int = 0):
        """Run ``n_blocks`` chained blocks; returns ``(sums, n_reps)``
        with ``sums`` the tuple of accumulator totals as floats."""
        for sh in self._shards:
            sh.acc.zero_()
        prof = self.profiler
        pstate = None if prof is None else prof.run_start(
            block_reps=self.block_reps, n_blocks=int(n_blocks),
            start_block=int(start_block), counters=self._counters)
        keys = [self._block_keys(start_block, sh) for sh in self._shards]
        for i in range(start_block, start_block + int(n_blocks)):
            for sh, k in zip(self._shards, keys, strict=True):
                self._fill(sh, k)
            with stage("accumulate"):
                for sh in self._shards:
                    sh.acc.add_(sh.out.sum(dim=1))
            self._counters.donated_blocks.inc()
            if pstate is not None:
                prof.block_boundary(pstate, i - start_block,
                                    [sh.acc for sh in self._shards])
            keys = [self._block_keys(i + 1, sh) for sh in self._shards]
        host = self._ex.fetch([sh.acc for sh in self._shards])
        self.fetches += 1
        if pstate is not None:
            prof.run_end(pstate)
        if len(host) == 1:
            return (tuple(float(v) for v in host[0]),
                    int(n_blocks) * self.block_reps)
        sums = [0.0] * self.out_len
        for h in host:  # ascending shard order, float64 on the host
            for j in range(self.out_len):
                sums[j] += float(h[j])
        return tuple(sums), int(n_blocks) * self.block_reps

    def block_detail(self, i: int = 0) -> tuple:
        """Un-reduced per-rep outputs of block ``i``, in the run's chunks;
        under a mesh each shard runs on its device and the shards are
        joined in order on the first one."""
        home = self._shards[0].device
        parts = []
        for sh in self._shards:
            keys = self._block_keys(i, sh)
            for a, b in self._chunks(sh):
                parts.append([o.to(home) for o in self._unit(keys[a:b])])
        return tuple(torch.cat(cols) for cols in zip(*parts, strict=True))
