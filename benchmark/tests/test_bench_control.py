"""On the card, at each cell's own size: the control (the reference in
the next precision below the configuration's, put in the program's
place on the same inputs) fails one of the cell's numbers, while the
program passes them all. Run there with `python -m pytest
benchmark/tests -m cuda`."""

import time

import pytest

from benchmark import harness

CONTROLS = {'serve-traj-ring': ['control'], 'serve-poses-k8': ['control'],
            'train-highres-remat': ['bf16', 'half_batch']}


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(CONTROLS))
def test_the_control_fails_and_the_program_passes(cuda_card, name):
  cell = harness.find_cell(name)
  outcome = harness.driver(cell).run(cell, 4100000001, 4.0, False, 'cuda',
                                     time.perf_counter(), control=True)
  assert all(v <= limit for v, limit in outcome.checks.values())
  readings = outcome.readings['control']
  for control in CONTROLS[name]:
    got = readings if control == 'control' else readings[control]
    assert any(got[n] > cell.limits[n] for n in cell.limits if n in got), (
        control, got)
