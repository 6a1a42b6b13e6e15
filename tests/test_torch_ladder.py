"""K1's stage ladder: the port's plain version against the JAX ladder.

``benchmarks/pallas_bisect.py``'s ``probe_level`` runs here as its own
smoke mode runs it (``DPCORR_BISECT_INTERPRET=1``: Pallas in interpret
mode on the CPU), with its module constants (``N``, ``EPS1``, ``EPS2``)
set per case and the TPU's PRNG calls replaced: ``prng_seed`` by a no-op
and ``prng_random_bits`` by a counter hash of the position and the call,
written in ``jnp`` ops inside the trace (the interpreter's own stand-in
returns zeros). numpy reproduces the same hash, so the port's
``ladder_plain`` reads the bits JAX's kernel read. Nothing of the JAX
package or of ``benchmarks/`` changes.

Tolerances. JAX reports ``sample``, its replication 0's ``acc`` rounded
to 3 decimals, so every bound carries 5e-4 for that rounding. Beyond it:
f32 sums taken in another order, and log/cos/sin of two libraries within
an ulp or two, move a sum by at most a few ulps of each term, so the
bound is 1e-6 × Σ|terms| (L1: the bits as f32; L2: |z1| + |z2|; L3: the
weighted |x| + |y|; L4: the weighted |x_c| + |y_c|, whose sum cancels to
a small number, so the bound is absolute in that scale; L5: the k batch
means, each a count over m). A sign at a tie would move L5 by 1/m: the
cases are checked to have no centered value within 1e-5 of 0.

The orchestrator runs as a process on the CPU (``--device cpu``), and
``_run``'s timeout path kills a sleeping child's process group.
"""

import ctypes
import json
import re
import subprocess
import sys
import time
from contextlib import nullcontext
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from benchmarks import pallas_bisect
from dpcorr_torch import bisect
from dpcorr_torch.ops import fused_ni, ladder
from dpcorr_torch.utils import roofline

#: (N, ε) of the two layouts: m = m' = 8 with no leftovers, and m = 11 in
#: lane groups of m' = 16 with 10 leftovers
LAYOUTS = [(1000, (1.0, 1.0)), (1000, (1.5, 0.5))]
ROUNDING = 5e-4  # the JAX sample's round(·, 3)
REL = 1e-6

_MUL1, _MUL2, _MUL3 = 0x9E3779B1, 0x85EBCA77, 0x2C1B3C6D


def _hash_np(call: int, shape) -> np.ndarray:
    """int32 bits of the stand-in PRNG for its ``call``-th draw."""
    r = np.arange(shape[0], dtype=np.uint32)[:, None]
    c = np.arange(shape[1], dtype=np.uint32)[None, :]
    with np.errstate(over="ignore"):
        h = (r * np.uint32(128) + c) * np.uint32(_MUL1) + np.uint32(
            call * _MUL2 % 2**32)
        h = h ^ (h >> np.uint32(15))
        h = h * np.uint32(_MUL3)
        h = h ^ (h >> np.uint32(12))
    return h.view(np.int32)


def _hash_jnp(call: int, shape):
    r = jax.lax.broadcasted_iota(jnp.uint32, shape, 0)
    c = jax.lax.broadcasted_iota(jnp.uint32, shape, 1)
    h = (r * jnp.uint32(128) + c) * jnp.uint32(_MUL1) + jnp.uint32(
        call * _MUL2 % 2**32)
    h = h ^ (h >> 15)
    h = h * jnp.uint32(_MUL3)
    h = h ^ (h >> 12)
    return jax.lax.bitcast_convert_type(h, jnp.int32)


@pytest.fixture
def jax_probe(monkeypatch):
    """``probe_level`` at (level 1-5, N, ε) on the stand-in PRNG; returns
    JAX's sample and the bits its kernel read, as the port lays them out
    (1, 2·rows + 8, 128)."""
    monkeypatch.setenv("DPCORR_BISECT_INTERPRET", "1")
    calls = []

    def random_bits(shape):
        calls.append(tuple(shape))
        return _hash_jnp(len(calls) - 1, shape)

    monkeypatch.setattr(pltpu, "prng_seed", lambda *a, **k: None)
    monkeypatch.setattr(pltpu, "prng_random_bits", random_bits)

    def run(level, n, eps):
        monkeypatch.setattr(pallas_bisect, "N", n)
        monkeypatch.setattr(pallas_bisect, "EPS1", eps[0])
        monkeypatch.setattr(pallas_bisect, "EPS2", eps[1])
        calls.clear()
        res = pallas_bisect.probe_level(pallas_bisect.LEVELS[level - 1])
        rows = fused_ni.layout(n, *eps)[4]
        assert calls[:2] == [(rows, 128)] * 2
        assert calls[2:] == ([(8, 128)] if level >= 4 else [])
        bits = np.concatenate([_hash_np(0, (rows, 128)),
                               _hash_np(1, (rows, 128)),
                               _hash_np(2, (8, 128))])
        return res, bits[None]

    return run


def _scale(bits: np.ndarray, level: int, n: int, eps) -> tuple:
    """Σ|terms| of the level's sum in f64 on these bits, and the smallest
    |centered value| over the batch elements (the L5 tie margin)."""
    m, m_pad, k, leftover, rows = fused_ni.layout(n, *eps)
    b = bits[0].astype(np.int64)
    b1, b2 = b[:rows], b[rows:2 * rows]
    if level == 1:
        return np.abs(b1).sum() + np.abs(b2).sum(), np.inf
    u1 = (((b1 >> 9) & 0x7FFFFF) + 0.5) * 2.0**-23
    u2 = (((b2 >> 9) & 0x7FFFFF) + 0.5) * 2.0**-23
    r = np.sqrt(-2.0 * np.log(u1))
    z1, z2 = r * np.cos(2 * np.pi * u2), r * np.sin(2 * np.pi * u2)
    if level == 2:
        return np.abs(z1).sum() + np.abs(z2).sum(), np.inf
    pos = np.arange(rows * 128).reshape(rows, 128)
    elem = (pos % m_pad < m) & (pos // m_pad < k)
    w = elem | ((pos >= k * m_pad) & (pos < k * m_pad + leftover))
    x, y = z1, 0.5 * z1 + np.sqrt(0.75) * z2
    if level == 3:
        return np.abs(x[w]).sum() + np.abs(y[w]).sum(), np.inf
    lc = np.sqrt(2.0 * np.log(n))
    ul = (((b[2 * rows:, 0] >> 9) & 0x7FFFFF) + 0.5) * 2.0**-23
    lap = -np.sign(ul - 0.5) * np.log1p(-2.0 * np.abs(ul - 0.5))
    xc = np.clip(x, -lc, lc)
    yc = np.clip(y, -lc, lc)
    xc = xc - (xc[w].sum() / n + lap[0] * 2 * lc / (n * eps[0] / 2))
    yc = yc - (yc[w].sum() / n + lap[1] * 2 * lc / (n * eps[1] / 2))
    margin = min(np.abs(xc[elem]).min(), np.abs(yc[elem]).min())
    if level == 4:
        return np.abs(xc[w]).sum() + np.abs(yc[w]).sum(), margin
    return 2.0 * k, margin


@pytest.mark.parametrize("n,eps", LAYOUTS)
@pytest.mark.parametrize("level", ladder.KERNEL_LEVELS)
def test_plain_matches_jax_probe_level(jax_probe, level, n, eps):
    res, bits = jax_probe(level, n, eps)
    assert res["ok"] and res["finite"]
    got = ladder.ladder_sums(torch.zeros(1, 2, dtype=torch.int32),
                             pallas_bisect.RHO, n, *eps, level,
                             bits=torch.from_numpy(bits))
    assert got.dtype == torch.float32 and got.shape == (1,)
    scale, margin = _scale(bits, level, n, eps)
    assert margin > 1e-5  # no sign tie
    tol = REL * scale + ROUNDING
    assert abs(float(got[0]) - res["sample"]) <= tol, (
        float(got[0]), res["sample"], tol)


def test_philox_bits_are_k1s_draws():
    """In-kernel bits at each position are K1's words for that
    observation where position = observation (m = 8): the uniforms of
    ``philox_bits`` equal ``fused_ni.philox_uniforms`` there, and the
    Laplace rows hold K1's centering words."""
    n, eps = 1000, (1.0, 1.0)
    seeds = torch.tensor([[7, -3], [2**31 - 1, -2**31]], dtype=torch.int32)
    bits = ladder.philox_bits(seeds, n, *eps)
    rows = fused_ni.layout(n, *eps)[4]
    assert bits.shape == (2, ladder.bit_rows(n, *eps), 128)
    assert bits.dtype == torch.int32
    u = fused_ni.philox_uniforms(seeds, n, *eps)
    unit = fused_ni.uniform_from_bits
    flat = bits.reshape(2, -1)
    uf = u.reshape(2, -1)
    plane = rows * 128
    torch.testing.assert_close(unit(flat[:, :n]), uf[:, :n], rtol=0, atol=0)
    torch.testing.assert_close(unit(flat[:, plane:plane + n]),
                               uf[:, plane:plane + n], rtol=0, atol=0)
    for i in range(2):
        assert torch.equal(unit(bits[:, 2 * rows + i, 0]),
                           u[:, 2 * rows + i, 0])
    # the padding positions draw on past n from the same stream
    assert (bits[:, :rows].reshape(2, -1)[:, n:] != 0).all()
    assert (bits[:, 2 * rows:, 1:] == 0).all()


@pytest.mark.parametrize("level", ladder.KERNEL_LEVELS)
def test_plain_is_deterministic_and_finite_on_philox_bits(level):
    seeds = torch.arange(16, dtype=torch.int32).reshape(8, 2)
    bits = ladder.philox_bits(seeds, 1500, 1.0, 1.0)
    a = ladder.ladder_sums(seeds, 0.5, 1500, 1.0, 1.0, level, bits)
    b = ladder.ladder_plain(bits.clone(), 0.5, 1500, 1.0, 1.0, level)
    assert torch.isfinite(a).all() and torch.equal(a, b)
    assert len(set(a.tolist())) == 8  # each replication its own draw
    mag = ladder.ladder_plain(bits, 0.5, 1500, 1.0, 1.0, level,
                              magnitude=True)
    assert (mag >= a.abs()).all() and (mag > 0).all()


def test_wrapper_refuses_what_it_cannot_run():
    seeds = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="pass `bits`"):
        ladder.ladder_sums(seeds, 0.5, 1000, 1.0, 1.0, 3)
    with pytest.raises(ValueError, match="levels 1-5"):
        ladder.ladder_sums(seeds, 0.5, 1000, 1.0, 1.0, 6)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ladder.ladder_sums(seeds.to("meta"), 0.5, 1000, 1.0, 1.0, 1)
    with pytest.raises(ValueError, match="levels 1-5"):
        ladder.ladder_plain(torch.zeros(1, 24, 128, dtype=torch.int32),
                            0.5, 1000, 1.0, 1.0, 0)


def test_plane_bytes_cap_levels_4_and_5_as_k1():
    """L4-L5 keep K1's x and y planes (no flips) where K1's NI variant
    with planes keeps them, and draw each position again above that."""
    for n in (10_000, 28_672):
        assert ladder.plane_bytes(n, 1.0, 1.0, 3) == 0
        c = fused_ni._Consts(n, 1.0, 1.0, (0.0, 0.0), (1.0, 1.0))
        assert ladder.plane_bytes(n, 1.0, 1.0, 4) == c.plane_bytes(False)
    assert ladder.plane_bytes(28_673, 1.0, 1.0, 5) > fused_ni._SMEM_LIMIT
    for n in (1_000, 10_000, 28_672, 28_673, 40_000, 100_000):
        for level in ladder.KERNEL_LEVELS:
            assert ladder.planes_kept(n, 1.0, 1.0, level) == (
                level >= 4 and fused_ni.fits_on_chip(n, 1.0, 1.0, False))
            assert not ladder.planes_kept(n, 1.0, 1.0, level, regen=True)


@pytest.mark.parametrize("n,regen", [(10_000, False), (10_000, True),
                                     (40_000, False), (100_000, False)])
@pytest.mark.parametrize("level", ladder.KERNEL_LEVELS)
def test_launch_takes_every_n(monkeypatch, level, n, regen):
    """``_launch`` refuses no n: it passes the forcing switch on to the
    library, which picks the variant (``launch_one`` in
    csrc/fused_ni_ladder.cu), and counts the launch."""
    calls = []

    class Lib:
        def ladder_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(ladder, "_library", Lib)
    monkeypatch.setitem(ladder.KERNEL_LAUNCHES, "fused_ni_ladder", 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0))
    seeds = torch.zeros(3, 2, dtype=torch.int32)
    out = ladder._launch(seeds, None, 0.5, n, 1.0, 1.0, level, regen)
    assert out.shape == (3,)
    ((*_, lv, external, forced, stream),) = calls
    assert (lv, external, forced) == (level, 0, int(regen))
    assert ladder.KERNEL_LAUNCHES["fused_ni_ladder"] == 1


@pytest.mark.parametrize("level", ("center", "matmul"))
def test_probe_above_the_cap_on_the_cpu(level):
    """The bisect's L4-L5 probes take an n above K1's cap on the planes,
    as ``--n 40000`` asks, and agree with the plain version there."""
    n = 30_000
    assert not fused_ni.fits_on_chip(n, bisect.EPS1, bisect.EPS2, False)
    res = bisect.probe_level(level, n=n, device="cpu")
    assert res["ok"] and res["finite"]
    seeds = bisect._seeds(bisect.PROBE_B_DEFAULT, torch.device("cpu"))
    want = ladder.ladder_plain(
        ladder.philox_bits(seeds, n, bisect.EPS1, bisect.EPS2), bisect.RHO,
        n, bisect.EPS1, bisect.EPS2, bisect.LEVELS.index(level) + 1)
    assert res["sample"] == round(float(want[0]), 3)


def test_params_struct_has_no_padding():
    """Six ints then four floats, as LadderParams in fused_ni_ladder.cu."""
    assert ctypes.sizeof(ladder._Params) == 10 * 4
    src = (ladder.__file__.rsplit("/ops/", 1)[0]
           + "/csrc/fused_ni_ladder.cu")
    text = open(src).read()
    fields = re.search(r"struct LadderParams \{(.*?)\};", text, re.S).group(1)
    names = re.findall(r"\b(\w+)\s*[,;]", fields)
    assert names == [f for f, _ in ladder._Params._fields_]


def test_bisect_mirrors_the_script():
    assert bisect.LEVELS == pallas_bisect.LEVELS
    assert (bisect.EPS1, bisect.EPS2, bisect.RHO) == (
        pallas_bisect.EPS1, pallas_bisect.EPS2, pallas_bisect.RHO)
    assert bisect.HEALTH_TIMEOUT == pallas_bisect.HEALTH_TIMEOUT
    assert bisect.PROBE_TIMEOUT == pallas_bisect.PROBE_TIMEOUT
    assert bisect.default_n() == pallas_bisect.N
    assert bisect.DEFAULT_OUT.parent.name == "_build"


@pytest.mark.parametrize("level", bisect.LEVELS)
def test_probe_level_on_the_cpu(level):
    before = dict(ladder.KERNEL_LAUNCHES)
    res = bisect.probe_level(level, n=1000, device="cpu")
    assert res["level"] == level and res["ok"] and res["finite"]
    assert res["device"] == "cpu" and res["launches"] == 0
    assert "ms" not in res
    assert ("sample" in res) == (bisect.LEVELS.index(level) < 5)
    assert ladder.KERNEL_LAUNCHES == before


def test_orchestrator_runs_every_level_on_the_cpu(tmp_path):
    out = tmp_path / "bisect.json"
    proc = subprocess.run(
        [sys.executable, "-m", "dpcorr_torch.bisect", "--device", "cpu",
         "--n", "1000", "--out", str(out)],
        capture_output=True, text=True, timeout=600, env=bisect._env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(out.read_text())
    assert report["culprit"] is None and not report["wedged"]
    assert report["health"].startswith("HEALTH-OK")
    assert report["config"] == {"n": 1000, "eps1": 1.0, "eps2": 1.0,
                                "device": "cpu"}
    assert [p["level"] for p in report["probes"]] == bisect.LEVELS
    for p in report["probes"]:
        assert p["result"]["ok"] and p["result"]["finite"], p


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_run_kills_the_group_on_timeout():
    """A child that prints, starts a grandchild and sleeps: the timeout
    kills both, keeps what the child printed, and returns rc None."""
    code = ("import subprocess, sys, time; "
            "g = subprocess.Popen([sys.executable, '-c', "
            "'import time; time.sleep(120)']); "
            "print('partial', g.pid, flush=True); time.sleep(120)")
    t0 = time.time()
    rc, so, _, dt = bisect._run([sys.executable, "-c", code], 3.0)
    assert rc is None
    assert time.time() - t0 < 60 and dt >= 3.0
    word, pid = so.split()
    assert word == "partial"
    deadline = time.time() + 10
    while not _gone(int(pid)) and time.time() < deadline:
        time.sleep(0.1)
    assert _gone(int(pid))


def test_health_check_reports_the_device():
    ok, dt, said = bisect.health_check("cpu")
    assert ok and dt > 0
    assert said == "HEALTH-OK 16777216.0 cpu"


def test_ladder_bounds():
    """L6-L7 are K1: their op count is ``fused_pipe_ops``', and L6's bound
    at the main path's shape is K1's 0.3453 ms. Each of L1-L4 adds work
    on every pipe it touches."""
    eps, b = (1.0, 1.0), 1 << 14
    ops = [roofline.ladder_pipe_ops(level, 10_000, eps)
           for level in range(1, 8)]
    assert ops[5] == ops[6] == roofline.fused_pipe_ops(10_000, eps, False)
    t = roofline.least_time_ms(ops[5], b, b * 12)
    assert round(t["int32"], 4) == 0.3453
    for lo, hi in zip(ops[:4], ops[1:4]):
        assert all(hi[p] >= lo[p] for p in lo) and hi != lo
    ext = roofline.ladder_pipe_ops(1, 10_000, eps, philox=False)
    assert ext["int32"] == 0 and ext["f32"] == ops[0]["f32"]
