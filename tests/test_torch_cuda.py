"""The port on the card: the CUDA kernel against its plain version, and
the replication pipeline through both bodies.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from dpcorr_torch import sim
from dpcorr_torch.ops import fused_ni
from dpcorr_torch.utils import rng

EPS_PAIRS = [(1.0, 1.0), (1.5, 0.5)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _uniforms(seed, b, n, eps, compute_int, device):
    rows = fused_ni.n_uniform_rows(n, *eps, compute_int)
    u = np.random.default_rng(seed).uniform(1e-7, 1 - 1e-7, (b, rows, 128))
    return torch.from_numpy(u.astype(np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("eps", EPS_PAIRS)
@pytest.mark.parametrize("normalise", [True, False])
@pytest.mark.parametrize("gauss", ["boxmuller", "ndtri"])
@pytest.mark.parametrize("compute_int", [False, True])
def test_kernel_matches_plain(cuda, compute_int, gauss, normalise, eps):
    """External uniforms: ΣT_j and ΣT_j² within 1e-4 relative and η̂_INT
    within 1e-5 for at least 99% of replications (the rest: a centered
    value at a sign tie under another rounding)."""
    b, n = 128, 10_000
    u = _uniforms(6, b, n, eps, compute_int, cuda)
    rho = torch.full((b,), 0.5, device=cuda)
    seeds = torch.zeros(b, 2, dtype=torch.int32, device=cuda)
    kw = dict(normalise=normalise, compute_int=compute_int, gauss=gauss)
    before = fused_ni.KERNEL_LAUNCHES["fused_ni"]
    got = fused_ni.fused_ni_sums(seeds, rho, n, *eps, uniforms=u, **kw)
    torch.cuda.synchronize()
    assert fused_ni.KERNEL_LAUNCHES["fused_ni"] == before + 1
    want = fused_ni.fused_ni_plain(seeds, rho, u, n=n, eps1=eps[0],
                                   eps2=eps[1], **kw)
    assert torch.isfinite(got).all()
    ok = torch.isclose(got[:, :2], want[:, :2], rtol=1e-4, atol=0.0).all(1)
    ok &= torch.isclose(got[:, 2], want[:, 2], rtol=0.0, atol=1e-5)
    assert ok.float().mean().item() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("compute_int", [False, True])
def test_in_kernel_generator_is_seeded(cuda, compute_int):
    """In-kernel Philox: finite, a function of the seed words only."""
    seeds = rng.kernel_seeds(rng.rep_keys(rng.master_key(device=cuda), 512))
    a = fused_ni.fused_ni_sums(seeds.contiguous(), 0.5, 10_000, 1.0, 1.0,
                               compute_int=compute_int)
    b = fused_ni.fused_ni_sums(seeds.contiguous(), 0.5, 10_000, 1.0, 1.0,
                               compute_int=compute_int)
    c = fused_ni.fused_ni_sums((seeds + 1).contiguous(), 0.5, 10_000, 1.0,
                               1.0, compute_int=compute_int)
    assert torch.isfinite(a).all() and torch.equal(a, b)
    assert not torch.equal(a[:, 0], c[:, 0])


@pytest.mark.cuda
def test_wrapper_checks_its_inputs(cuda):
    seeds = torch.zeros(4, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        fused_ni.fused_ni_sums(seeds.long(), 0.5, 1024, 1.0, 1.0)
    with pytest.raises(ValueError, match="shape"):
        fused_ni.fused_ni_sums(seeds, 0.5, 1024, 1.0, 1.0,
                               uniforms=torch.zeros(4, 3, 128, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        fused_ni.fused_ni_sums(torch.zeros(2, 4, dtype=torch.int32,
                                           device=cuda).t(), 0.5, 1024,
                               1.0, 1.0)
    with pytest.raises(ValueError, match="shared memory"):
        fused_ni.fused_ni_sums(seeds, 0.5, 40_000, 1.0, 1.0)


@pytest.mark.cuda
def test_pipeline_fused_and_unfused_agree(cuda):
    key = rng.master_key(device=cuda)
    stats = []
    for body in (sim.ni_rep_fn(10_000, 0.5, 1.0, 1.0),
                 sim.fused_ni_rep_fn(10_000, 0.5, 1.0, 1.0)):
        pipe = sim.RepBlockPipeline(body, 3, key=key, block_reps=8192,
                                    chunk_size=2048)
        (mse, cover, ci_len), n_reps = pipe.run(1)
        assert pipe.fetches == 1
        assert 0.90 <= cover / n_reps <= 0.99
        stats.append((mse / n_reps, ci_len / n_reps))
    assert abs(stats[1][0] / stats[0][0] - 1) < 0.1
    assert abs(stats[1][1] / stats[0][1] - 1) < 0.05
