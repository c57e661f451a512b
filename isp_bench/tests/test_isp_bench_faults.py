"""``correct`` comes out false for the control and for each fault a cell can
have (``faults.py``), with the rest of a run driven as on the card (the
harness's look for a card skipped, sizes a CPU test holds). A sound run is
correct."""
import pytest

from isp_bench.tests import helpers
from isp_bench import control, faults

CELLS = ["cam24.best", "cam24.preview", "hdr5.bracket", "cam24.files"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result, _ = helpers.run_cell(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    result, _ = helpers.run_cell(cell, program=control.program)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell,fault", [(cell, f) for cell in CELLS for f in faults.BY_CELL[cell]],
                         ids=lambda v: getattr(v, "__name__", v))
def test_a_fault_is_not_correct(cell, fault):
    # a window long enough that every input is visited: a stale answer is
    # right for the input it was held from
    result, _ = helpers.run_cell(cell, seconds=1.5, program=fault)
    assert not result["correct"], (fault.__name__, result["attempted"], result["checks"])
