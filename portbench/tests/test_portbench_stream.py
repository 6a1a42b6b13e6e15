"""The stress-scale cell, ``subg.stream_n1e6``: its contract on the CPU at a
shrunk size, planted faults that come out not correct there, and on the
card the control (the plain reference in bf16 in the program's place)
failing a limit at the cell's own size.

    python -m pytest -p no:cacheprovider \
        portbench/tests/test_portbench_stream.py
    python -m pytest -p no:cacheprovider portbench/tests -m cuda
"""

import numpy as np
import pytest

from portbench import core
from portbench.readings import readings

CELL = "subg.stream_n1e6"
SEED = 2_200_000_029


def small() -> tuple[dict, dict]:
    """(config, cell) at a CPU size: n = 4,000 in n-chunks of 1,024 (the
    last one 928 rows and masked, as the cell's last of 65,536 holds
    16,960), studies of 8 replications."""
    cell, config = core.cell_files(CELL)
    return ({**config, "n": 4000, "stream_n_chunk": 1024, "study_reps": 8},
            {**cell, "sample_per_study": 4, "max_studies": 8})


def _run(config, cell, control=False):
    return core.execute(CELL, SEED, 0.2, device="cpu", config=config,
                        cell=cell, control=control)


def test_the_shrunk_cell_keeps_the_contract_and_is_correct():
    config, cell = small()
    out = _run(config, cell, control=True)
    control = out.pop("_control")
    run = out.pop("_run")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert out["correct"] is True, out["check"]
    assert out["check"]["share_over_tau"]["value"] == 0.0
    assert set(out["metrics"]) == {"setup_s", "reps_per_s"}
    assert run["reps"] == 8 * run["studies"]
    assert control["correct"] is False, control


def _fault(monkeypatch, fault: str):
    from dpcorr_torch import sim
    from dpcorr_torch.models.estimators import streaming as st

    if fault == "unchanged":  # every study draws the same, whatever its key
        run = sim.run_sim_one
        monkeypatch.setattr(sim, "run_sim_one", lambda cfg, key=None, **k:
                            run(cfg, key=key * 0, **k))
    elif fault == "last_chunk":  # the last n-chunk left out of the sums
        sums = st._chunk_sums
        monkeypatch.setattr(st, "_chunk_sums", lambda stats, n_chunks, rows:
                            sums(stats, n_chunks - 1, rows))
    else:  # every INT estimate 1e-3 off
        pair = st.subg_pair_stream

        def altered(*a, **k):
            ni, it = pair(*a, **k)
            return ni, it._replace(rho_hat=it.rho_hat + 1e-3)

        monkeypatch.setattr(st, "subg_pair_stream", altered)


@pytest.mark.parametrize("fault", ["unchanged", "last_chunk", "altered"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    config, cell = small()
    _fault(monkeypatch, fault)
    out = _run(config, cell)
    assert not out["correct"], out["check"]
    assert np.isfinite(out["check"]["median_gap"]["value"])


@pytest.mark.cuda
def test_the_bf16_control_fails_a_limit_at_the_cell_size(cuda):
    for r in readings(CELL, (2_147_483_677, 3_000_000_037), 3.0,
                      control=True, device=cuda):
        assert r["correct"], r
        assert not r["control_correct"], r
