"""What decides ``correct`` fails where it should, on the CPU at each
cell's test size: the control (the reference one precision below the
configuration's own in the program's place) fails the cell's limits, and
a run with a fault planted under the timed path comes out not correct,
while sound readings and sound runs pass.  The same readings at the cells'
own sizes come from ``python3 -m portbench.control`` on the card."""
import pytest

from portbench import control, run
from portbench.faults import FAULTS, planted

CELLS = ['nn350.fits', 'e2d4096.fits', 'nn350.analysis', 'nn350.grid']
SEED = 2 ** 31 + 977


@pytest.mark.parametrize('cell', CELLS)
def test_sound_readings_pass_and_the_control_fails(small, cell):
    spec = small(cell)
    assert not control.fails(spec, control.sound(spec, SEED, 'cpu'))
    assert control.fails(spec, control.control(spec, SEED, 'cpu'))


CASES = [(cell, fault) for cell in CELLS for fault in FAULTS
         if not (cell == 'nn350.grid' and fault == 'frozen_step')]


@pytest.mark.parametrize('cell,fault', CASES)
def test_a_planted_fault_makes_the_run_incorrect(small, cell, fault):
    spec = small(cell)
    with planted(fault, spec.traffic['call']):
        result, lines = run.execute(spec, SEED, 0.01, 0, 'cpu')
    assert result['correct'] is False, lines
    assert any(line.endswith('FAILED') for line in lines)


def test_the_grid_has_no_step_to_freeze():
    assert planted('frozen_step', 'truncation_grid') is None
