"""Monte-Carlo simulator (reference layer L3), Gaussian sign family.

Counterpart of ``dpcorr/sim.py``. The reference's hot loop
(vert-cor.R:392-419) is a batched function of per-replication keys: the
replication axis is a leading tensor dimension, blocked into chunks of at
most ``chunk_size`` replications so B × n never has to be resident at
once. Two bodies compute it:

- unfused: :func:`_one_rep`, torch ops on the key-tree, which agrees with
  the JAX package replication by replication;
- fused: :func:`sim_detail_fused`, one kernel pass per replication on the
  card (``dpcorr_torch.ops.fused_ni``), statistically equivalent.

:class:`RepBlockPipeline` runs a body in chained blocks with one host sync
per run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import numpy as np
import torch

from dpcorr_torch.models.dgp import gen_gaussian
from dpcorr_torch.models.estimators.common import batch_geometry
from dpcorr_torch.models.estimators.int_sign import (
    ci_int_signflip,
    interval_from_rho,
)
from dpcorr_torch.models.estimators.ni_sign import ci_ni_signbatch
from dpcorr_torch.ops.fused_ni import fused_ni_sums, ni_result
from dpcorr_torch.utils import rng
from dpcorr_torch.utils.device import f32_on, resolve_device


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """One design point of the Gaussian sign family (vert-cor.R:356-444).

    ``dgp_args`` may carry ``mu`` and ``sigma`` for the Gaussian. The
    sub-Gaussian families, other DGPs, the streaming path and the Monte-
    Carlo mixquant are later slices of the port and raise here.
    """

    n: int
    rho: float
    eps1: float
    eps2: float
    b: int = 1000
    alpha: float = 0.05
    dgp: str = "gaussian"
    dgp_args: Any = ()
    use_subg: bool = False
    ci_mode: str = "auto"
    normalise: bool = True
    mixquant_mode: str = "det"
    seed: int = rng.MASTER_SEED
    chunk_size: int = 4096  # max replications resident at once
    stream_n_chunk: int | None = None

    def __post_init__(self):
        if self.use_subg:
            raise NotImplementedError("the sub-Gaussian families are not "
                                      "ported yet")
        if self.stream_n_chunk:
            raise NotImplementedError("the streaming path is not ported yet")
        if self.dgp != "gaussian":
            raise NotImplementedError(f"dgp {self.dgp!r} is not ported yet; "
                                      "only 'gaussian' is")
        if self.mixquant_mode != "det":
            raise NotImplementedError("only mixquant_mode='det' is ported")
        args = dict(self.dgp_args.items() if isinstance(self.dgp_args,
                                                        Mapping)
                    else self.dgp_args)
        if set(args) - {"mu", "sigma"}:
            raise ValueError(f"gaussian dgp_args take mu and sigma, got "
                             f"{sorted(args)}")
        object.__setattr__(self, "dgp_args", tuple(sorted(
            (k, tuple(v)) for k, v in args.items())))

    @property
    def mu(self) -> tuple:
        return dict(self.dgp_args).get("mu", (0.0, 0.0))

    @property
    def sigma(self) -> tuple:
        return dict(self.dgp_args).get("sigma", (1.0, 1.0))


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


def _one_rep(keys: torch.Tensor, rho, cfg: SimConfig) -> tuple:
    """A batch of replications, generate → NI + INT → metrics, as a
    function of the replication keys ``(C, 2)``; returns the 12 (C,)
    fields of :data:`DETAIL_FIELDS`. ``rho`` is a float or a (C,)
    tensor."""
    xy = gen_gaussian(rng.stream(keys, "dgp"), cfg.n, rho, cfg.mu,
                      cfg.sigma)
    x, y = xy[..., 0], xy[..., 1]
    ni = ci_ni_signbatch(rng.stream(keys, "ni"), x, y, cfg.eps1, cfg.eps2,
                         alpha=cfg.alpha, normalise=cfg.normalise)
    it = ci_int_signflip(rng.stream(keys, "int"), x, y, cfg.eps1, cfg.eps2,
                         alpha=cfg.alpha, mode=cfg.ci_mode,
                         normalise=cfg.normalise)
    return _metrics_row(ni, it, rho)


def chunked(fn: Callable, keys: torch.Tensor, chunk_size: int) -> tuple:
    """``fn`` over the leading replication axis of ``keys`` in chunks of
    at most ``chunk_size``; the per-chunk outputs are concatenated.
    Outputs do not depend on the chunk width."""
    b = keys.shape[0]
    parts = [fn(keys[s:s + chunk_size]) for s in range(0, b, chunk_size)]
    return tuple(torch.cat(cols) for cols in zip(*parts, strict=True))


def summarize(detail: Mapping[str, torch.Tensor], rho: float) -> dict:
    """Reference summary rows (vert-cor.R:421-443): per method mse, bias,
    var, coverage, ci_length. One device-to-host copy, then f64."""
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
    out = fused_ni_sums(seeds, rhos, n, eps1, eps2, mu, sigma, normalise,
                        True, gauss, uniforms)
    _, k = batch_geometry(n, eps1, eps2)
    ni = ni_result(out[:, 0], out[:, 1], k, alpha)
    rho_hat_int = torch.sin(math.pi * out[:, 2] / 2.0)
    eps_s, eps_r = max(eps1, eps2), min(eps1, eps2)
    it = interval_from_rho(rho_hat_int, n, eps_s, eps_r, alpha, ci_mode)
    return _metrics_row(ni, it, rhos)


def ni_rep_fn(n: int, rho: float, eps1: float, eps2: float,
              alpha: float = 0.05) -> Callable:
    """The north-star replication body (``bench.make_rep_fn``), unfused:
    keys (C, 2) → n-point Gaussian pair → NI sign-batch estimate + CI →
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
    mode: keys (C, 2) → :func:`rng.kernel_seeds` → one launch → (se²,
    cover, ci_len). Card only."""
    rho = float(np.float32(rho))
    _, k = batch_geometry(n, eps1, eps2)

    def body(keys):
        out = fused_ni_sums(rng.kernel_seeds(keys).contiguous(), rho, n,
                            eps1, eps2)
        return _metrics(ni_result(out[:, 0], out[:, 1], k, alpha), rho)

    return body


class RepBlockPipeline:
    """Chained replication blocks with one host sync per :meth:`run`.

    Counterpart of ``dpcorr.sim.RepBlockPipeline``, local placement only.
    ``rep_fn(keys (C, 2)) -> tuple[out_len] of (C,)`` is the body; block i
    runs it over ``rep_keys(design_key(key, i), block_reps)`` in chunks of
    ``chunk_size`` (the JAX pipeline's key addresses), and each output is
    summed into its accumulator. What JAX got from donation, the port does
    in place: the block's output buffer and the accumulators are allocated
    once and overwritten; the next block's keys are made on the device;
    the host reads the accumulators once, at the end of :meth:`run`.
    """

    def __init__(self, rep_fn: Callable, out_len: int, *,
                 key: torch.Tensor, block_reps: int, chunk_size: int,
                 device=None):
        self.device = resolve_device(device)
        self.rep_fn = rep_fn
        self.out_len = int(out_len)
        self.block_reps = int(block_reps)
        self.chunk_size = int(chunk_size)
        self._key = key.to(self.device)
        self._acc = torch.zeros(self.out_len, dtype=torch.float32,
                                device=self.device)
        self._out = torch.empty(self.out_len, self.block_reps,
                                dtype=torch.float32, device=self.device)
        #: device-to-host reads made by run(): exactly one per call
        self.fetches = 0

    def _block_keys(self, i: int) -> torch.Tensor:
        return rng.rep_keys(rng.design_key(self._key, i), self.block_reps)

    def _fill(self, keys: torch.Tensor) -> None:
        for s in range(0, self.block_reps, self.chunk_size):
            outs = self.rep_fn(keys[s:s + self.chunk_size])
            for row, o in zip(self._out, outs, strict=True):
                row[s:s + o.shape[0]].copy_(o)

    def run(self, n_blocks: int, *, start_block: int = 0):
        """Run ``n_blocks`` chained blocks; returns ``(sums, n_reps)``
        with ``sums`` the tuple of accumulator totals as floats."""
        self._acc.zero_()
        keys = self._block_keys(start_block)
        for i in range(start_block, start_block + int(n_blocks)):
            self._fill(keys)
            self._acc.add_(self._out.sum(dim=1))
            keys = self._block_keys(i + 1)
        sums = self._acc.cpu()  # the one host sync
        self.fetches += 1
        return (tuple(float(v) for v in sums),
                int(n_blocks) * self.block_reps)

    def block_detail(self, i: int = 0) -> tuple:
        """Un-reduced per-rep outputs of block ``i``."""
        return chunked(self.rep_fn, self._block_keys(i), self.chunk_size)
