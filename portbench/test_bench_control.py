"""On the card: the training cell's control (the plain reference in TF32,
put in the program's place) comes out not correct against the committed
limits, while the program comes out correct, at the cell's own size with
a window of one chunk."""

import time

import pytest

from portbench import check
from portbench import harness


@pytest.mark.chip
def test_control_fails_and_program_passes(cuda):
  spec = harness.load_spec('qrdqn.train.e1024')
  result = harness.execute(spec, 2**31 + 5, 0.0, False, cuda,
                           time.perf_counter(), control=True)
  assert result['correct'], result['checks']
  control = check.decide(result['_control'],
                         {k: spec.limits[k] for k in result['_control']})
  assert not all(ok for *_, ok in control), control
