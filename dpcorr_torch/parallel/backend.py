"""Sharded execution: replications split over the devices of
:func:`~dpcorr_torch.parallel.mesh.rep_devices`.

Counterpart of ``dpcorr/parallel/backend.py``. The JAX package shards the
B replications of a design point (or a grid bucket's flat point ×
replication axis) over its ``rep`` mesh axis with ``shard_map`` and
reduces summaries with ``psum``. Here the axis is padded to a multiple of
the device count (the padding repeats the first elements and is cut
away), split into contiguous shards, and each shard runs the port's own
bucket body, ``sim._run_detail_flat``, on its device. Summaries are f32
partial sums per shard, added in shard order. Replication ``j`` keeps its
key, so the detail is bit-equal to the unsharded path at any width.
The serving layer's flushed lane axis shards the same way
(:func:`make_serve_batch_sharded`).
"""

from __future__ import annotations

import dataclasses

import torch

from dpcorr_torch import sim as sim_mod
from dpcorr_torch.parallel.mesh import rep_devices
from dpcorr_torch.sim import DETAIL_FIELDS, SimConfig
from dpcorr_torch.utils import rng

#: the sums :func:`summary_sums` returns per method, in its order
SUM_NAMES = ("sum_hat", "sum_hat2", "sum_se2", "sum_cover", "sum_len")


def _padded(keys: torch.Tensor, rhos: torch.Tensor, n_shards: int):
    """The axis padded to a multiple of ``n_shards`` by a modulo gather,
    which also covers a pad longer than the axis (a small bucket over
    many devices); with the global index of each element."""
    total = keys.shape[0]
    per = -(-total // n_shards)
    idx = torch.arange(per * n_shards, device=keys.device)
    return keys[idx % total], rhos[idx % total], idx


def _shards(keys: torch.Tensor, rhos: torch.Tensor, devices):
    """(device, keys, ρ, global index) of each contiguous shard of the
    padded axis, placed through ``plan.preshard``."""
    from dpcorr_torch.plan import preshard
    from dpcorr_torch.utils.compile import mesh_shardings

    placed = preshard(_padded(keys, rhos, len(devices)),
                      mesh_shardings(devices)[0])
    yield from zip(devices, *placed, strict=True)


def run_detail_flat_sharded(cfg_norho: SimConfig, keys: torch.Tensor,
                            rhos: torch.Tensor, devices=None,
                            executor=None) -> tuple:
    """Sharded twin of ``sim._run_detail_flat``: the same 12 fields for
    the same per-replication (key, ρ) pairs, bit for bit, with the flat
    axis padded and split over ``devices`` (default: every card, or the
    CPU for keys on the CPU) through a mesh ``plan.Executor``
    (``executor``, when the caller holds one: the grid's). Results come
    back to the keys' device."""
    from dpcorr_torch import plan as plan_mod

    ex = executor if executor is not None else plan_mod.Executor(
        plan_mod.MeshPlacement(devices or rep_devices(device=keys.device)))
    total = keys.shape[0]
    k, r, _ = _padded(keys, rhos, ex.placement.device_count)
    unit = ex.lazy_unit(lambda k, r: sim_mod._run_detail_flat(cfg_norho, k,
                                                              r))
    return tuple(o[:total].to(keys.device)
                 for o in ex.dispatch(unit, (k, r)))


def _prep(cfg: SimConfig, key, devices):
    home = devices[0]
    key = rng.master_key(cfg.seed, home) if key is None else key.to(home)
    keys = rng.rep_keys(key, cfg.b)
    rhos = torch.full((cfg.b,), cfg.rho, dtype=torch.float32, device=home)
    # seed and ρ are per call, not part of the body (sim._run_detail_flat)
    return dataclasses.replace(cfg, rho=0.0, seed=0), keys, rhos


def run_detail_sharded(cfg: SimConfig, key=None, devices=None,
                       device=None) -> sim_mod.SimResult:
    """Full (B, ·) detail of one design point, replications sharded over
    ``devices`` (default ``rep_devices(device=device)``: every card, or
    one CPU entry with ``device="cpu"``); bit-equal to ``run_sim_one``."""
    devices = devices or rep_devices(device=device)
    cfg_norho, keys, rhos = _prep(cfg, key, devices)
    out = run_detail_flat_sharded(cfg_norho, keys, rhos, devices)
    detail = dict(zip(DETAIL_FIELDS, out, strict=True))
    return sim_mod.SimResult(detail, sim_mod.summarize(detail, cfg.rho), cfg)


def summary_sums(cfg: SimConfig, key=None, devices=None,
                 device=None) -> dict:
    """Per method, the f32 sums over the B replications of ρ̂, ρ̂², se²,
    cover and ci_len: each shard's partial sums (padding masked out by
    global index < B), added in shard order on the first device, then
    one host read (the JAX package's per-shard sums and ``psum``)."""
    devices = devices or rep_devices(device=device)
    cfg_norho, keys, rhos = _prep(cfg, key, devices)
    total = None
    for dev, k, r, idx in _shards(keys, rhos, devices):
        named = dict(zip(DETAIL_FIELDS, sim_mod._run_detail_flat(
            cfg_norho, k, r), strict=True))
        w = (idx < cfg.b).to(torch.float32)
        part = []
        for meth in ("ni", "int"):
            est = named[f"{meth}_hat"]
            part += [torch.sum(w * v) for v in (
                est, est * est, named[f"{meth}_se2"],
                named[f"{meth}_cover"], named[f"{meth}_ci_len"])]
        part = torch.stack(part).to(devices[0])
        total = part if total is None else total + part
    host = total.cpu().tolist()
    return {meth: dict(zip(SUM_NAMES, host[5 * j: 5 * j + 5], strict=True))
            for j, meth in enumerate(("ni", "int"))}


def run_summary_sharded(cfg: SimConfig, key=None, devices=None,
                        device=None) -> dict:
    """Summary-only sharded run: the reference's summary rows (mse, bias,
    var, coverage, ci_length per method, vert-cor.R:421-443) from
    :func:`summary_sums`; only those sums leave the devices."""
    b = float(cfg.b)
    out = {}
    for meth, s in summary_sums(cfg, key, devices, device).items():
        mean_hat = s["sum_hat"] / b
        out[meth.upper()] = {
            "mse": s["sum_se2"] / b,
            "bias": mean_hat - cfg.rho,
            # R var(): sample variance, denominator B-1
            "var": (s["sum_hat2"] - b * mean_hat**2) / (b - 1.0),
            "coverage": s["sum_cover"] / b,
            "ci_length": s["sum_len"] / b,
        }
    return out


def make_serve_batch_sharded(single, devices=None, engine: str = "exact"):
    """Sharded twin of the serving layer's batched callable
    (serve.kernels): the flushed lane axis split into contiguous shards,
    one per entry of ``devices`` (default: every card), each shard run by
    ``engine`` (estimators.registry.batch_engine) on its device and the
    results gathered on the lanes' device in lane order. Each engine's
    lane contract holds per shard, so ``exact`` lanes stay bit-equal to
    the direct call on their device."""
    from dpcorr_torch.models.estimators.registry import batch_engine

    from dpcorr_torch.plan import preshard
    from dpcorr_torch.utils.compile import mesh_shardings

    body = batch_engine(single, engine)
    devices = list(devices or rep_devices())

    def run(keys, xs, ys):
        placed = preshard((keys, xs, ys), mesh_shardings(devices)[0])
        parts = [body(k, x, y) for k, x, y in zip(*placed, strict=True)
                 if x.shape[0]]
        return tuple(torch.cat([p[j].to(xs.device) for p in parts])
                     for j in range(3))
    return run
