"""The fused kernel's in-kernel generator, held by its plain twin.

``fused_ni.philox4x32`` is Philox4x32-10 in int64 tensor ops, checked
against the Random123 known-answer vectors and a scalar reference here.
``fused_ni.philox_uniforms`` lays the kernel's in-kernel draws out in the
external mode's take() order; on the card, external mode on that tensor
gives in-kernel mode's results (tests/test_torch_cuda.py). Here its layout
is checked word by word, and the plain version on it against the JAX
interpret-mode kernel on the same uniforms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpcorr.ops import pallas_ni
from dpcorr_torch.ops import fused_ni

M32 = 0xFFFFFFFF

# Random123's kat_vectors for philox4x32_10: (counter, key, output)
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32, M32, M32, M32), (M32, M32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]

# (n, ε): m' = 8 with no leftover, m = 11 < m' = 16 with leftovers,
# m' = 32 with leftovers, and m' = 8 with leftovers
GEOMETRIES = [(1000, (1.0, 1.0)), (1000, (1.5, 0.5)), (2000, (0.5, 0.5)),
              (1500, (1.0, 1.0))]


def _philox_ref(ctr, key):
    """Scalar Philox4x32-10 in Python integers."""
    c, (k0, k1) = list(ctr), key
    for _ in range(10):
        p0 = 0xD2511F53 * c[0]
        p1 = 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & M32, (p0 >> 32) ^ c[3] ^ k1,
             p0 & M32]
        k0 = (k0 + 0x9E3779B9) & M32
        k1 = (k1 + 0xBB67AE85) & M32
    return c


def _unit(word):
    return float(np.float32((np.float32((word >> 9) & 0x7FFFFF)
                             + np.float32(0.5)) * np.float32(2.0**-23)))


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    got = fused_ni.philox4x32(torch.tensor(ctr, dtype=torch.int64),
                              torch.tensor(key, dtype=torch.int64))
    assert got.tolist() == list(want)
    assert _philox_ref(ctr, key) == list(want)


def test_philox_matches_scalar_reference():
    rng = np.random.default_rng(7)
    ctr = rng.integers(0, 2**32, (256, 4), dtype=np.int64)
    key = rng.integers(0, 2**32, (256, 2), dtype=np.int64)
    got = fused_ni.philox4x32(torch.from_numpy(ctr), torch.from_numpy(key))
    want = [_philox_ref(c, k) for c, k in zip(ctr.tolist(), key.tolist())]
    assert got.tolist() == want


def test_exponent_field_uniform_is_the_23_bit_rule():
    """The kernel's ``unit23``: (b23 | 0x3F800000) as f32, minus
    1 − 2⁻²⁴, equals (b23 + ½)·2⁻²³ bit for bit for every b23."""
    b23 = np.arange(1 << 23, dtype=np.uint32)
    fast = (b23 | np.uint32(0x3F800000)).view(np.float32) - np.float32(
        1.0 - 2.0**-24)
    rule = fused_ni.uniform_from_bits(
        torch.from_numpy((b23.astype(np.int64) << 9))).numpy()
    np.testing.assert_array_equal(fast.view(np.uint32), rule.view(np.uint32))


@pytest.mark.parametrize("n,eps", GEOMETRIES)
def test_observation_positions_cover_the_real_observations(n, eps):
    m, m_pad, k, leftover, rows = fused_ni.layout(n, *eps)
    pos = fused_ni.observation_positions(n, *eps)
    _, w = fused_ni.position_masks(rows, m, m_pad, k, leftover)
    live = torch.nonzero(w.reshape(-1)).reshape(-1)
    assert torch.equal(pos, live)  # increasing, one per observation


@pytest.mark.parametrize("n,eps", GEOMETRIES)
@pytest.mark.parametrize("normalise", [True, False])
@pytest.mark.parametrize("compute_int", [False, True])
def test_philox_uniforms_layout(n, eps, normalise, compute_int):
    """Every word of the counter scheme lands where external mode reads
    it; nothing else is drawn."""
    seeds = torch.tensor([[12345, -678], [-1, 2**31 - 1]], dtype=torch.int32)
    u = fused_ni.philox_uniforms(seeds, n, *eps, compute_int, normalise)
    m, m_pad, k, leftover, rows = fused_ni.layout(n, *eps)
    g_cols = 128 // m_pad
    assert u.shape == (2, fused_ni.n_uniform_rows(n, *eps, compute_int), 128)
    assert u.dtype == torch.float32
    pos = fused_ni.observation_positions(n, *eps).tolist()
    for b, (s0, s1) in enumerate(seeds.tolist()):
        key = (s0 & M32, s1 & M32)
        flat = u[b].reshape(-1).tolist()
        want = {}
        for o in range(n):
            w = _philox_ref((o // 2, 0, 0, 0), key)
            want[pos[o]] = _unit(w[2 * (o % 2)])
            want[rows * 128 + pos[o]] = _unit(w[2 * (o % 2) + 1])
        scal = _philox_ref((0, 3, 0, 0), key) + _philox_ref((1, 3, 0, 0), key)
        row = 2 * rows
        if normalise:
            want[row * 128] = _unit(scal[0])
            want[(row + 1) * 128] = _unit(scal[1])
            row += 8
        for j in range(k):
            w = _philox_ref((j // 2, 2, 0, 0), key)
            at = (row + j // g_cols) * 128 + j % g_cols
            want[at] = _unit(w[2 * (j % 2)])
            want[at + rows * 128] = _unit(w[2 * (j % 2) + 1])
        row += 2 * rows
        if compute_int:
            for i in range(3):
                want[(row + i) * 128] = _unit(scal[2 + i])
            for o in range(n):
                want[(row + 8) * 128 + pos[o]] = _unit(
                    _philox_ref((o // 4, 1, 0, 0), key)[o % 4])
        got = {i: v for i, v in enumerate(flat) if v != 0.5}
        assert got == want  # a 23-bit uniform is never exactly 0.5


@pytest.mark.parametrize("normalise", [True, False])
@pytest.mark.parametrize("compute_int", [False, True])
def test_plain_on_philox_uniforms_matches_interpret_kernel(compute_int,
                                                           normalise):
    """The plain version and the JAX kernel agree on the twin's output
    (m = 11 in lane groups of 16, with leftovers): ΣT_j and ΣT_j² within
    1e-4 relative, η̂_INT within 1e-5, as on any uniforms."""
    n, eps, b = 1000, (1.5, 0.5), 4
    seeds = torch.tensor([[1, 2], [3, 4], [-5, 6], [7, -8]],
                         dtype=torch.int32)
    u = fused_ni.philox_uniforms(seeds, n, *eps, compute_int, normalise)
    rho = np.linspace(-0.5, 0.8, b).astype(np.float32)
    st, st2, eta = pallas_ni._ni_sign_pallas_sums(
        jnp.zeros((b, 2), jnp.int32), jnp.asarray(rho), n, *eps, (0.0, 0.0),
        (1.0, 1.0), normalise, True, compute_int, "boxmuller",
        uniforms=jnp.asarray(u.numpy()))
    got = fused_ni.fused_ni_sums(seeds, torch.from_numpy(rho), n, *eps,
                                 normalise=normalise,
                                 compute_int=compute_int, uniforms=u).numpy()
    np.testing.assert_allclose(got[:, 0], np.asarray(st), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got[:, 1], np.asarray(st2), rtol=1e-4)
    np.testing.assert_allclose(got[:, 2], np.asarray(eta), rtol=0, atol=1e-5)
