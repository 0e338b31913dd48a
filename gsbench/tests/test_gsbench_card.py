"""Tests that need a CUDA card: every cell of the benchmark, run once at
its own size for a short window, comes out correct; and the control (the
reference in bfloat16 in the program's place) fails the cell's limits at
the cell's size. Run on the chip:

    python3 -m pytest gsbench/tests/test_gsbench_card.py -q -m card
"""

import pytest

from gsbench import calibrate, run

CELLS = ("garden4m.train", "init262k.train", "garden4m.render")
SEED = 2**31 + 101


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    result, _ = run.run_cell(cell, SEED, 2.0, False, card)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(card, cell):
    limits = run.load("workloads", cell)["limits"]
    rows = calibrate.control_readings(cell, SEED, card)
    for r in rows:
        assert any(r[k] > limits[k] for k in limits), r
