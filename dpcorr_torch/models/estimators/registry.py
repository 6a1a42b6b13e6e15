"""One callable per estimator family, for the serving layer.

Counterpart of ``dpcorr/models/estimators/registry.py``. The serving
layer (:mod:`dpcorr_torch.serve`) batches requests from different
clients, so it needs every family behind one signature:

    single(key, x, y) -> (rho_hat, ci_low, ci_high)

:func:`serving_entry` closes over what is fixed per kernel bucket
(family, ε pair, α, normalise). The port's estimators are vectorised
over leading axes, so the same callable takes one request (key
``(words,)``, two words or four, x and y ``(n,)``) or a lane axis (keys
``(b, words)``, x and y ``(b, n)``):
both batch engines of :class:`~dpcorr_torch.serve.kernels.KernelCache`
call it.

Lane contract (``tests/test_torch_serve.py`` on the CPU,
``tests/test_torch_cuda.py`` on the card):

- ``exact`` engine: the single call on each lane in turn, as the JAX
  package's ``lax.map`` does, so every lane is bit-equal to the direct
  single call on the same device by construction. On an NVIDIA H100
  80GB HBM3 at 700 W, 1,152 of 1,152 requests at n = 10⁴ and 19,433
  were bit-equal in each of two runs; the card test
  ``test_serve_exact_lanes_bit_equal_on_the_card`` holds the property.
- ``vector`` engine: one call over the lane axis. On the CPU every lane
  is bit-equal to the direct call at every width (all four families,
  n = 96, widths 2, 5 and 8 in the tests). On the card it is not: torch's
  reductions over n (the private centering's mean, the batch and
  clipped moments) take another order for one row than for many, and
  for 5 rows than for 64. So on the card ρ̂ and the CI ends are held
  within 1e-5 absolute of the direct call, and a lane's answer within
  the same of that lane's at another width (a centered value within an
  ulp of 0 may flip its sign: such lanes are allowed up to 1%); the
  card test ``test_serve_vector_lane_contract_on_the_card`` holds this
  contract. Measured on an NVIDIA H100 80GB HBM3 at 700 W (1,024
  ``ni_sign`` lanes at n = 10⁴, two runs): 578 and 594 lanes
  bit-equal to the direct call, ρ̂ on 727 and 757, the rest within
  1.8e-7 absolute (ρ̂ within 7 ulps); 3 of 5 lanes at width 5 bit-equal
  to the same lanes at width 64, the others within 1.2e-7. None needed
  the 1% allowance. Coalescing therefore moves a vector answer in its
  last bits on the card; the exact engine is the default.
"""

from __future__ import annotations

from typing import Callable

import torch

from dpcorr_torch.models.estimators.families import FAMILIES
from dpcorr_torch.models.estimators.int_sign import ci_int_signflip
from dpcorr_torch.models.estimators.int_subg import ci_int_subg
from dpcorr_torch.models.estimators.ni_sign import ci_ni_signbatch
from dpcorr_torch.models.estimators.ni_subg import correlation_ni_subg
from dpcorr_torch.utils.device import resolve_device


def place(v, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``v`` as a ``dtype`` tensor on a device of ``dev``'s type: a tensor
    already on such a device (a shard on another card) stays there."""
    t = torch.as_tensor(v)
    if t.device.type != dev.type:
        t = t.to(dev)
    return t.to(dtype)


def serving_entry(family: str, eps1: float, eps2: float,
                  alpha: float = 0.05, normalise: bool = True,
                  device=None) -> Callable:
    """The uniform callable for one kernel bucket, on ``device`` (the card
    unless the caller names another; raises without one).

    ``normalise`` applies to the sign families only (private centering
    before the sign transform, vert-cor.R:211-215); the subG families clip
    with data-independent λ_n bounds instead and ignore it.
    """
    if family not in FAMILIES:
        raise ValueError(f"unknown estimator family {family!r}; "
                         f"expected one of {FAMILIES}")
    dev = resolve_device(device)
    if family == "ni_sign":
        def est(k, x, y):
            return ci_ni_signbatch(k, x, y, eps1, eps2, alpha=alpha,
                                   normalise=normalise)
    elif family == "int_sign":
        def est(k, x, y):
            return ci_int_signflip(k, x, y, eps1, eps2, alpha=alpha,
                                   normalise=normalise)
    elif family == "ni_subg":
        def est(k, x, y):
            return correlation_ni_subg(k, x, y, eps1, eps2, alpha=alpha)
    else:  # int_subg
        def est(k, x, y):
            return ci_int_subg(k, x, y, eps1, eps2, alpha=alpha)

    def single(key, x, y):
        r = est(place(key, dev, torch.int64), place(x, dev, torch.float32),
                place(y, dev, torch.float32))
        return r.rho_hat, r.ci_low, r.ci_high
    return single


#: The batch engines of the lane contract above.
ENGINES = ("exact", "vector")


def batch_engine(single: Callable, engine: str = "exact") -> Callable:
    """``single`` over a lane axis: ``run(keys (b, words), xs (b, n),
    ys (b, n)) -> (rho_hat, ci_low, ci_high)``, each ``(b,)``.
    ``"vector"`` is one call over the lanes; ``"exact"`` calls ``single``
    on each lane in turn, each lane a fresh copy, so its memory is laid
    out as a direct caller's would be."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if engine == "vector":
        return single

    def run(keys, xs, ys):
        outs = [single(keys[i], xs[i].clone(), ys[i].clone())
                for i in range(xs.shape[0])]
        return tuple(torch.stack([o[j] for o in outs]) for j in range(3))
    return run
