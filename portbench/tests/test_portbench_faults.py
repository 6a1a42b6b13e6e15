"""A run with its timed path broken underneath comes out not correct.

Each test drives a whole run of a cell (set-up, window, the check
against the reference) past the look for a card, with one fault planted
in the program: a step that returns its state unchanged, half of the
batch left out with the rest standing in for it, one chunk's answers
altered (the first, or the last, which in ``hrs.bootstrap`` is the
partial one), every answer altered where it is produced. The cells run
one chip, so no exchange between chips can be left out. On the CPU the
cells run shrunk (``small.py``); the fused cell, whose kernel runs only
on the card, and the bootstrap's chunk faults run there at their own
size.
"""

import numpy as np
import pytest
import torch

from portbench import core
from portbench.tests.small import small

FAULTS = ("unchanged", "half", "first_chunk", "last_chunk", "altered")
#: the chunk whose answers a chunk fault alters
CHUNK = {"first_chunk": 0, "last_chunk": -1}


def _pipeline_fault(monkeypatch, fault: str, body: str):
    from dpcorr_torch import sim

    pipe = sim.RepBlockPipeline
    fill = pipe._fill
    if fault == "unchanged":  # the block's outputs are never written
        monkeypatch.setattr(pipe, "_fill", lambda self, sh, keys: None)
    elif fault == "half":  # the first half of the chunks stands for all
        def half(self, sh, keys):
            chunks = list(self._chunks(sh))
            keep = chunks[:max(1, len(chunks) // 2)]
            monkeypatch.setattr(self, "_chunks", lambda s: iter(keep),
                                raising=False)
            fill(self, sh, keys)
            done = keep[-1][1]
            for a in range(done, sh.count, done):
                b = min(a + done, sh.count)
                sh.out[:, a:b].copy_(sh.out[:, :b - a])

        monkeypatch.setattr(pipe, "_fill", half)
    elif fault in CHUNK:  # one chunk's CI lengths 1e-3 too long
        def one(self, sh, keys):
            fill(self, sh, keys)
            a, b = list(self._chunks(sh))[CHUNK[fault]]
            sh.out[2, a:b] += 1e-3

        monkeypatch.setattr(pipe, "_fill", one)
    else:  # every CI length 1e-3 too long
        name = {"fused": "fused_ni_rep_fn", "unfused": "ni_rep_fn"}[body]
        make = getattr(sim, name)

        def altered(*a, **k):
            fn = make(*a, **k)
            return lambda keys: (lambda o: (o[0], o[1], o[2] + 1e-3))(
                fn(keys))

        monkeypatch.setattr(sim, name, altered)


def _bootstrap_fault(monkeypatch, fault: str):
    from dpcorr_torch import hrs

    if fault == "unchanged":  # every study draws the same, whatever its seed
        boot = hrs.bootstrap
        monkeypatch.setattr(
            hrs, "bootstrap", lambda cfg, *a, **k: boot(
                hrs.HrsConfig(seed=7, mixquant_mode=cfg.mixquant_mode),
                *a, **k))
    elif fault == "half":
        chunked = hrs.chunked

        def half(fn, args, chunk_size):
            b = args.shape[0]
            cols = chunked(fn, args[:(b + 1) // 2], chunk_size)
            return tuple(torch.cat([c, c])[:b] for c in cols)

        monkeypatch.setattr(hrs, "chunked", half)
    elif fault in CHUNK:  # one chunk's NI estimates 1e-3 off
        def one(fn, args, chunk_size):
            parts = [list(fn(args[s:s + chunk_size]))
                     for s in range(0, args.shape[0], chunk_size)]
            parts[CHUNK[fault]][0] = parts[CHUNK[fault]][0] + 1e-3
            return tuple(torch.cat(cols) for cols in zip(*parts))

        monkeypatch.setattr(hrs, "chunked", one)
    else:
        boot = hrs._boot_reps
        monkeypatch.setattr(
            hrs, "_boot_reps",
            lambda *a, **k: (lambda o: (o[0] + 1e-3,) + o[1:])(boot(*a, **k)))


def _run(workload, device, config=None, cell=None, seconds=0.3):
    return core.execute(workload, 2_200_000_011, seconds, device=device,
                        config=config, cell=cell)


@pytest.mark.parametrize("fault", FAULTS)
def test_unfused_pipeline_fault_is_not_correct(monkeypatch, fault):
    config, cell = small("ni_n10k.unfused")
    _pipeline_fault(monkeypatch, fault, "unfused")
    out = _run("ni_n10k.unfused", "cpu", config, cell)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("fault", FAULTS)
def test_bootstrap_fault_is_not_correct(monkeypatch, fault):
    config, cell = small("hrs.bootstrap")
    _bootstrap_fault(monkeypatch, fault)
    out = _run("hrs.bootstrap", "cpu", config, cell)
    assert not out["correct"], out["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS)
def test_fused_pipeline_fault_is_not_correct_on_the_card(monkeypatch, cuda,
                                                         fault):
    _pipeline_fault(monkeypatch, fault, "fused")
    out = _run("ni_n10k.fused", cuda, seconds=2.0)
    assert not out["correct"], out["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", list(CHUNK))
def test_bootstrap_chunk_fault_is_not_correct_on_the_card(monkeypatch, cuda,
                                                          fault):
    _bootstrap_fault(monkeypatch, fault)
    out = _run("hrs.bootstrap", cuda, seconds=3.0)
    assert not out["correct"], out["check"]


def test_an_unbroken_small_run_is_correct():
    config, cell = small("ni_n10k.unfused")
    out = _run("ni_n10k.unfused", "cpu", config, cell)
    assert out["correct"], out["check"]
    assert np.isfinite(out["check"]["median_gap"]["value"])
