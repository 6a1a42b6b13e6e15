"""The stress-scale study (BASELINE.md config 5) on its normal path,
``sim.run_sim_one`` with ``stream_n_chunk``, against the benchmark's
plain reference of it, and the streaming path's counters.

At n = 4,000 with n_chunk 1,024 the sample is four chunks, the last of
928 rows and a masked tail, as the cell's sixteen of 65,536 end in one
of 16,960. The program sums each statistic per chunk and then over the
chunks, and forms the variances from Σ and Σ²; the reference sums over
the whole sample and takes ``torch.std``. Both are f32 on the same
draws, so each field agrees to a few ulps of its size: 1e-6 absolute
holds the estimates and CI ends (each of order 1, f32's ulp there is
6e-8; the sums' order moves them by up to 2.4e-7 here), and the covers
agree exactly, no CI end lying within that of ρ on these keys.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dpcorr_torch import sim
from dpcorr_torch.models.estimators import streaming as st
from dpcorr_torch.obs.metrics import Registry
from dpcorr_torch.utils import rng

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:  # the benchmark imports from the root
    sys.path.insert(0, str(REPO))

from portbench.drivers import sim_one  # noqa: E402
from portbench.reference import subg_n1e6 as ref  # noqa: E402

SMALL = {"n": 4000, "rho": 0.5, "eps": [1.0, 1.0], "eta": [1.0, 1.0],
         "alpha": 0.05, "dgp": "bounded_factor", "use_subg": True,
         "subg_variant": "grid", "mixquant": "det", "stream_n_chunk": 1024,
         "study_reps": 6}
ATOL = 1e-6


def _program(seed: int, chunk_size: int):
    cfg = sim_one.sim_config(sim, SMALL, on_card=False)
    cfg = dataclasses.replace(cfg, chunk_size=chunk_size)
    return sim.run_sim_one(cfg, key=rng.master_key(seed, "cpu"),
                           device="cpu")


@pytest.mark.parametrize("seed", [2_147_483_659, 7])
def test_run_sim_one_matches_the_plain_reference(seed):
    res = _program(seed, chunk_size=4)  # a partial replication chunk too
    b = SMALL["study_reps"]
    want = ref.outputs(SMALL, [seed] * b, np.arange(b), device="cpu")
    assert tuple(want) == sim.DETAIL_FIELDS
    for f in sim.DETAIL_FIELDS:
        got = res.detail[f].double().numpy()
        np.testing.assert_allclose(got, want[f], rtol=0, atol=ATOL,
                                   err_msg=f)
    for f in ("ni_cover", "int_cover"):
        assert np.array_equal(res.detail[f].numpy(), want[f]), f


def test_the_reference_tells_a_masked_tail_from_an_unmasked_one(
        monkeypatch):
    """The last chunk's rows past n left in the sums move the program off
    the reference: the comparison sees the mask."""
    seed = 11
    want = ref.outputs(SMALL, [seed] * 6, np.arange(6), device="cpu")
    monkeypatch.setattr(st, "_row_mask", lambda c, n_chunk, n, device:
                        torch.ones(n_chunk, dtype=torch.bool, device=device))
    got = _program(seed, chunk_size=6).detail["int_hat"].double().numpy()
    assert np.abs(got - want["int_hat"]).max() > 100 * ATOL


def test_the_counters_count_chunks_and_rows_per_replication_chunk(
        monkeypatch):
    counters = st.StreamCounters(Registry())
    monkeypatch.setattr(st, "_counters", counters)
    _program(3, chunk_size=4)  # 6 replications: chunks of 4 and 2
    # one pass over 4 n-chunks and the sample's 4,000 rows per chunk
    assert counters.snapshot() == {"stream_chunks": 2 * 4,
                                   "stream_rows": 2 * 4000}


def test_the_default_counters_live_in_the_process_registry():
    from dpcorr_torch.obs.metrics import default_registry

    counters = st.default_counters()
    assert counters is st.default_counters()
    assert counters.registry is default_registry()
    before = counters.snapshot()
    _program(5, chunk_size=6)
    after = counters.snapshot()
    assert after["stream_chunks"] - before["stream_chunks"] == 4
    assert after["stream_rows"] - before["stream_rows"] == 4000
