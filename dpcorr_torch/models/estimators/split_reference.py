"""Two-party factoring of the monolithic estimators.

Counterpart of ``dpcorr/models/estimators/split_reference.py``. In the
paper's deployment the X-party and the Y-party each hold one column and
only DP releases cross between them. Each family is factored into the
pieces that barrier separates:

- :func:`party_release`: the DP release one party builds from its own
  column alone (noisy batch means for the NI families, the
  randomized-response signs or the per-sample local-DP values for the
  INT families);
- :func:`finish`: the finisher combines the peer's release with its own
  column's contribution into (ρ̂, CI);
- :func:`split_estimate`: the two composed in one process, the reference
  the wire protocol (:mod:`dpcorr_torch.protocol`) is held to.

Under the shared-seed ``"replay"`` key layout the factoring is bit-equal
to the port's monolithic estimators (``registry.serving_entry``) on every
device. Every draw keeps its monolithic stream address, and each column
runs through exactly the torch ops, on exactly the shapes, the monolithic
estimator gives it: per-column ``batch_means`` and ``sample_sd`` over
(k,), never a stacked x and y (on the card a reduction over a stacked
tensor may take another order). Every combination keeps the monolithic
association order. The one re-association the wire forces, the INT-sign
core when the y side sends (``((2s−1)·sign(y))·sign(x)`` instead of
``((2s−1)·sign(x))·sign(y)``), multiplies factors in {−1, 0, +1}, so it
is exact.

Key layouts (``utils.rng.party_root``): ``"replay"`` hands both parties
the same key; ``"hardened"`` roots each in its own ``"protocol/x"`` /
``"protocol/y"`` subtree.
"""

from __future__ import annotations

import math

import torch

from dpcorr_torch.models.estimators.common import (
    batch_geometry,
    batch_means,
    sample_sd,
)
from dpcorr_torch.models.estimators.families import FAMILIES
from dpcorr_torch.models.estimators.int_sign import (
    int_constants,
    interval_from_rho,
)
from dpcorr_torch.models.estimators.int_subg import grid_interval
from dpcorr_torch.models.estimators.ni_sign import crit_value, l_clip_for
from dpcorr_torch.models.estimators.registry import place
from dpcorr_torch.ops.lambdas import lambda_int_n, lambda_n
from dpcorr_torch.ops.noise import clip_sym, laplace
from dpcorr_torch.ops.standardize import priv_center
from dpcorr_torch.utils.device import resolve_device
from dpcorr_torch.utils.rng import bernoulli, stream

_HALF_PI = math.pi / 2.0

#: payload-entry kinds a release message may carry, per family: the
#: closed vocabulary the transcript scanner checks against.
RELEASE_KINDS = {
    "ni_sign": {"batch_means": "noisy_sign_batch_means"},
    "ni_subg": {"batch_means": "noisy_clipped_batch_means"},
    "int_sign": {"flipped_signs": "rr_flipped_signs"},
    "int_subg": {"ldp_values": "ldp_clipped_values"},
}

#: the batched finisher's engines (:func:`finish_batch`)
ENGINES = ("exact", "vector")


def split_roles(family: str, eps1: float, eps2: float) -> tuple[str, str]:
    """(releaser, finisher) for one design point, from public parameters.
    NI families: x releases, y finishes. INT families: the larger-ε side
    sends, the monolithic sender rule (vert-cor.R:170-172,
    ver-cor-subG.R:76-81)."""
    if family not in FAMILIES:
        raise ValueError(f"unknown estimator family {family!r}; "
                         f"expected one of {FAMILIES}")
    if family in ("ni_sign", "ni_subg"):
        return "x", "y"
    return ("x", "y") if bool(eps1 >= eps2) else ("y", "x")


def release_schema(family: str, n: int, eps1: float,
                   eps2: float) -> dict[str, dict]:
    """Exact (kind, shape, dtype) of every array the releaser's payload may
    hold, from public parameters only, so the receiver (and the offline
    scan) can refuse a payload shaped like raw data before reading it."""
    kinds = RELEASE_KINDS[family]
    if family in ("ni_sign", "ni_subg"):
        _m, k = batch_geometry(n, eps1, eps2)
        shape = (k,)
    else:
        shape = (n,)
    name = next(iter(kinds))
    return {name: {"kind": kinds[name], "shape": shape,
                   "dtype": "float32"}}


def _own_eps(role: str, eps1: float, eps2: float) -> float:
    return eps1 if role == "x" else eps2


def _ni_sign_release(key, role, col, eps1, eps2, normalise):
    """One side of ``ci_ni_signbatch`` (vert-cor.R:204-233): private
    centering, sign batch means, the per-batch Laplace draws, on the
    monolithic streams ``ni_sign/{std,lap}_{x,y}``."""
    n = col.shape[-1]
    m, k = batch_geometry(n, eps1, eps2)
    eps = _own_eps(role, eps1, eps2)
    if normalise:
        col = priv_center(stream(key, f"ni_sign/std_{role}"), col, eps,
                          l_clip_for(n, col.device))
    bar = batch_means(torch.sign(col), k, m)
    return bar + laplace(stream(key, f"ni_sign/lap_{role}"), (k,),
                         2.0 / (m * eps))


def _ni_subg_release(key, role, col, eps1, eps2):
    """One side of ``correlation_ni_subg`` (grid variant, static
    geometry): clip at λ_n, batch means, per-batch Laplace (streams
    ``ni_subg/lap_{x,y}``)."""
    n = col.shape[-1]
    m, k = batch_geometry(n, eps1, eps2)
    eps = _own_eps(role, eps1, eps2)
    lam = lambda_n(n, 1.0, col.device)
    bar = batch_means(clip_sym(col, lam), k, m)
    return bar + laplace(stream(key, f"ni_subg/lap_{role}"), (k,),
                         2.0 * lam / (m * eps))


def _int_sign_centered(key, role, col, eps1, eps2, normalise):
    if normalise:
        col = priv_center(stream(key, f"int_sign/std_{role}"), col,
                          _own_eps(role, eps1, eps2),
                          l_clip_for(col.shape[-1], col.device))
    return col


def _int_sign_release(key, role, col, eps1, eps2, normalise):
    """The sender half of ``ci_int_signflip`` (vert-cor.R:164-195):
    center its own column, flip its signs by randomized response. The
    values are exactly ±1/±0, so the receiver's product is exact."""
    n = col.shape[-1]
    col = _int_sign_centered(key, role, col, eps1, eps2, normalise)
    _eps_s, _eps_r, p_keep, _c_eta, _scale_z = int_constants(n, eps1, eps2)
    s = bernoulli(stream(stream(key, "int_sign/est"), "int_sign/flips"),
                  p_keep, (n,))
    return (2.0 * s.to(torch.float32) - 1.0) * torch.sign(col)


def _int_subg_release(key, role, col, eps1, eps2):
    """The sender half of ``ci_int_subg`` (grid variant,
    ver-cor-subG.R:87-90): clip at λ_s, one Laplace draw per sample
    (stream ``int_subg/lap_sender``): the local-DP release."""
    n = col.shape[-1]
    eps_s = max(eps1, eps2)
    lam_s, _lam_r = lambda_int_n(n, eta_s=1.0, eta_r=1.0, eps_s=eps_s,
                                 device=col.device)
    sc = clip_sym(col, lam_s)
    return sc + laplace(stream(key, "int_subg/lap_sender"), (n,),
                        2.0 * lam_s / eps_s)


def _release_impl(family, key, role, col, eps1, eps2, normalise):
    if family == "ni_sign":
        return {"batch_means": _ni_sign_release(key, role, col, eps1, eps2,
                                                normalise)}
    if family == "ni_subg":
        return {"batch_means": _ni_subg_release(key, role, col, eps1,
                                                eps2)}
    if family == "int_sign":
        return {"flipped_signs": _int_sign_release(key, role, col, eps1,
                                                   eps2, normalise)}
    return {"ldp_values": _int_subg_release(key, role, col, eps1, eps2)}


def party_release(family: str, key, role: str, col, eps1: float,
                  eps2: float, normalise: bool = True,
                  device=None) -> dict[str, torch.Tensor]:
    """The DP release one party builds from its own column alone, on
    ``device`` (the card unless the caller names another; raises without
    one).

    ``key`` is that party's root (``utils.rng.party_root``), ``role``
    ``"x"`` or ``"y"``. Returns ``{}`` for the INT finisher role, whose ε
    is spent inside :func:`finish` (the receiver's central draw). The
    returned tensors are the only values allowed to leave the party."""
    if role not in ("x", "y"):
        raise ValueError(f"role must be 'x' or 'y', got {role!r}")
    releaser, _ = split_roles(family, eps1, eps2)
    if family in ("int_sign", "int_subg") and role != releaser:
        return {}
    dev = resolve_device(device)
    return _release_impl(family, place(key, dev, torch.int64), role,
                         place(col, dev, torch.float32), float(eps1),
                         float(eps2), bool(normalise))


def _ni_sign_finish(key, role, rel, col, eps1, eps2, alpha, normalise):
    n = col.shape[-1]
    m, k = batch_geometry(n, eps1, eps2)
    own = _ni_sign_release(key, role, col, eps1, eps2, normalise)
    # monolithic order: tj = m·xt·yt (vert-cor.R:233), x's release left
    xt, yt = (own, rel) if role == "x" else (rel, own)
    tj = m * xt * yt
    eta_hat = tj.sum(-1) / k
    rho_hat = torch.sin(math.pi * eta_hat / 2.0)
    half = crit_value(alpha, col.device) * sample_sd(tj) / math.sqrt(k)
    lo = torch.sin(_HALF_PI * torch.clamp_min(eta_hat - half, -1.0))
    hi = torch.sin(_HALF_PI * torch.clamp_max(eta_hat + half, 1.0))
    return rho_hat, lo, hi


def _ni_subg_finish(key, role, rel, col, eps1, eps2, alpha):
    n = col.shape[-1]
    m, k = batch_geometry(n, eps1, eps2)
    own = _ni_subg_release(key, role, col, eps1, eps2)
    xt, yt = (own, rel) if role == "x" else (rel, own)
    rho_hat = (m / k) * (xt * yt).sum(-1)
    tj = m * xt * yt
    se = sample_sd(tj) / torch.sqrt(torch.full((), float(k),
                                               device=col.device))
    crit = crit_value(alpha, col.device)
    lo = torch.clamp_min(rho_hat - crit * se, -1.0)
    hi = torch.clamp_max(rho_hat + crit * se, 1.0)
    return rho_hat, lo, hi


def _int_sign_finish(key, role, rel, col, eps1, eps2, alpha, normalise):
    n = col.shape[-1]
    col = _int_sign_centered(key, role, col, eps1, eps2, normalise)
    eps_s, eps_r, _p_keep, c_eta, scale_z = int_constants(n, eps1, eps2)
    est = stream(key, "int_sign/est")
    # exact ±1/±0 factors: this re-association of the monolithic core
    # ((2S−1)·sign(x))·sign(y) is bit-equal (module docstring)
    core = rel * torch.sign(col)
    z = laplace(stream(est, "int_sign/lap_z"), (), scale_z)
    eta_hat = c_eta * core.sum(-1) + z
    rho_hat = torch.sin(math.pi * eta_hat / 2.0)
    res = interval_from_rho(key, rho_hat, n, eps_s, eps_r, alpha, "auto",
                            "det")
    return res.rho_hat, res.ci_low, res.ci_high


def _int_subg_finish(key, role, rel, col, eps1, eps2, alpha):
    n = col.shape[-1]
    eps_s, eps_r = max(eps1, eps2), min(eps1, eps2)
    _lam_s, lam_r = lambda_int_n(n, eta_s=1.0, eta_r=1.0, eps_s=eps_s,
                                 device=col.device)
    # grid variant: the receiver's own variable is not clipped
    # (ver-cor-subG.R:92); the released factor stays on the left, as in
    # the monolithic (sc + noise)·other
    u = rel * col
    uc = clip_sym(u, lam_r)
    central_scale = 2.0 * lam_r / (n * eps_r)
    rho_hat = uc.mean(-1) + laplace(stream(key, "int_subg/lap_recv"), (),
                                    central_scale)
    sd_uc = sample_sd(uc)
    res = grid_interval(key, rho_hat, sd_uc, n, eps_r, central_scale,
                        alpha, "det")
    return res.rho_hat, res.ci_low, res.ci_high


def _finish_impl(family, key, rel, col, eps1, eps2, alpha, normalise):
    _, finisher = split_roles(family, eps1, eps2)
    if family == "ni_sign":
        return _ni_sign_finish(key, finisher, rel, col, eps1, eps2, alpha,
                               normalise)
    if family == "ni_subg":
        return _ni_subg_finish(key, finisher, rel, col, eps1, eps2, alpha)
    if family == "int_sign":
        return _int_sign_finish(key, finisher, rel, col, eps1, eps2, alpha,
                                normalise)
    return _int_subg_finish(key, finisher, rel, col, eps1, eps2, alpha)


def _release_array(family: str, peer_release: dict):
    name = next(iter(RELEASE_KINDS[family]))
    if set(peer_release) != {name}:
        raise ValueError(f"{family}: expected release payload {{{name!r}}}, "
                         f"got {sorted(peer_release)}")
    return peer_release[name]


def finish(family: str, key, peer_release: dict, col, eps1: float,
           eps2: float, alpha: float = 0.05, normalise: bool = True,
           device=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The finisher's combination: the peer's release plus its own
    column's contribution → (ρ̂, ci_low, ci_high), on ``device`` (the card
    unless the caller names another).

    ``key`` is the finisher's root and ``col`` its raw column, used only
    inside the DP constructions the monolithic estimator applies.
    ``peer_release`` is the decoded wire payload, keyed as
    :func:`release_schema` names it; it is placed on the device as f32,
    its bits unchanged."""
    rel = _release_array(family, peer_release)
    dev = resolve_device(device)
    return _finish_impl(family, place(key, dev, torch.int64),
                        place(rel, dev, torch.float32),
                        place(col, dev, torch.float32), float(eps1),
                        float(eps2), float(alpha), bool(normalise))


_PLANS: dict = {}


def _plan_executor(dev: torch.device):
    """The plan executor federation finishes dispatch through on ``dev``
    (one local-placement ``dpcorr_torch.plan.Executor`` per device, made
    at first use), as ``dpcorr.models.estimators.split_reference``'s
    ``_plan_executor``: units are built once per signature and cached."""
    ex = _PLANS.get(dev)
    if ex is None:
        from dpcorr_torch import plan as plan_mod

        ex = _PLANS.setdefault(dev, plan_mod.Executor("local", device=dev))
    return ex


def _finish_batch_fn(family: str, eps1: float, eps2: float, alpha: float,
                     normalise: bool, engine: str):
    """The round's finish over stacked (keys, releases, columns):
    ``"exact"`` runs the single finish on each cell's fresh copies in
    turn, ``"vector"`` one call over the stacked cells."""
    args = (eps1, eps2, alpha, normalise)
    if engine == "vector":
        return lambda keys, rels, cols: _finish_impl(family, keys, rels,
                                                     cols, *args)

    def exact(keys, rels, cols):
        outs = [_finish_impl(family, k.clone(), r.clone(), c.clone(), *args)
                for k, r, c in zip(keys, rels, cols)]
        return tuple(torch.stack([o[j] for o in outs]) for j in range(3))

    return exact


def finish_batch(family: str, keys, peer_releases, cols, eps1: float,
                 eps2: float, alpha: float = 0.05, normalise: bool = True,
                 engine: str = "exact", device=None,
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The finish of a whole federation round: B cells of one design
    point, each with its own finisher key, peer release and finisher
    column. Returns (ρ̂, ci_low, ci_high), each of shape (B,), on
    ``device``.

    The round is one plan unit (``_plan_executor``), built once per
    (family, ε, α, normalise, engine, shapes) and dispatched on the
    stacked cells. ``"exact"`` runs :func:`finish` on each cell in turn,
    each on fresh copies, so every cell is bit-equal to the independent
    two-party run it replaces on every device (the JAX package's
    ``lax.map``). On the card a batched call is not bit-equal to the
    single call (its reductions over n take another order for B rows
    than for one), so ``"vector"``, one call over the stacked cells, is
    held only within 1e-5 there, as the serving registry's vector engine
    is; it is opt-in and never used where the federation's bit-identity
    applies."""
    if engine not in ENGINES:
        raise ValueError(f"unknown finish engine {engine!r}; "
                         "expected 'exact' or 'vector'")
    rels = [_release_array(family, rel) for rel in peer_releases]
    if not (len(keys) == len(rels) == len(cols)):
        raise ValueError(
            f"batch length mismatch: {len(keys)} keys, {len(rels)} "
            f"releases, {len(cols)} columns")
    dev = resolve_device(device)
    args = (float(eps1), float(eps2), float(alpha), bool(normalise))
    stacked = (torch.stack([place(k, dev, torch.int64) for k in keys]),
               torch.stack([place(r, dev, torch.float32) for r in rels]),
               torch.stack([place(c, dev, torch.float32) for c in cols]))
    ex = _plan_executor(dev)
    unit = ex.prepare(
        ("finish_batch", family, *args, engine,
         tuple(tuple(a.shape) for a in stacked)),
        lambda: _finish_batch_fn(family, *args, engine),
        signature={"kernel": "finish_batch", "family": family,
                   "engine": engine, "b": int(stacked[0].shape[0]),
                   "n": int(stacked[2].shape[-1])})
    # dispatch stays asynchronous: the round's caller reads the results
    # once when it serializes them
    return ex.dispatch(unit, stacked)


def split_estimate(family: str, key_x, key_y, x, y, eps1: float,
                   eps2: float, alpha: float = 0.05, normalise: bool = True,
                   device=None,
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The factored estimator composed in one process, on ``device``: the
    reference the protocol runtime is held to. Pass the same key twice
    for the ``"replay"`` layout (bit-equal to ``serving_entry`` on that
    key)."""
    releaser, finisher = split_roles(family, eps1, eps2)
    rel_key, fin_key = ((key_x, key_y) if releaser == "x"
                        else (key_y, key_x))
    rel_col, fin_col = (x, y) if releaser == "x" else (y, x)
    rel = party_release(family, rel_key, releaser, rel_col, eps1, eps2,
                        normalise, device=device)
    return finish(family, fin_key, rel, fin_col, eps1, eps2, alpha,
                  normalise, device=device)
