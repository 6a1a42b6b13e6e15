"""The control comes out not correct, at each cell's own size, on the card.

The control is the plain reference computed in bf16, the precision below
the configurations' f32, put in the program's place. On three seeds per
cell a short window at the cell's own load is read, and the program's
numbers must pass the cell's limits while the control's fail them.

    python -m pytest -p no:cacheprovider portbench/tests -m cuda
"""

import pytest

from portbench import core
from portbench.readings import readings

SEEDS = (2_147_483_659, 3_000_000_019, 123_456_791)
CELLS = [w["name"] for w in core.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct_and_the_program_is(cuda, workload):
    for r in readings(workload, SEEDS, 3.0, control=True):
        assert r["correct"], r
        assert not r["control_correct"], r
