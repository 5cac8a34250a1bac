"""The port's profiling helpers (ble_tpu_torch/utils/profiling.py) and the
per-stage timer example on the CPU."""

import json
import os

import torch

from ble_tpu_torch.examples import profile_step
from ble_tpu_torch.utils import profiling


def test_step_timer():
  """tests/test_units_and_misc.py:test_step_timer on the port's timer."""
  timer = profiling.StepTimer()
  with timer.phase('a'):
    x = torch.ones((8,)) * 2
  with timer.phase('a', sync=x):
    x + 1
  s = timer.summary()
  assert 'a' in s and s['a'] >= 0.0
  assert 'a:' in timer.report()


def test_step_timer_means_by_phase():
  timer = profiling.StepTimer()
  for name in ('b', 'b', 'c'):
    with timer.phase(name, sync=3.0):
      pass
  s = timer.summary()
  assert set(s) == {'b', 'c'} and all(v >= 0.0 for v in s.values())
  assert timer.report().index('b:') < timer.report().index('c:')


def test_trace_writes_a_chrome_trace(tmp_path):
  with profiling.trace(str(tmp_path / 'run')) as path:
    torch.ones((64,)).cumsum(0).sum()
  assert os.path.dirname(path) == str(tmp_path / 'run')
  with open(path) as f:
    events = json.load(f)['traceEvents']
  assert any('cumsum' in e.get('name', '') for e in events)
  with profiling.trace(None) as nothing:
    torch.ones(2).sum()
  assert nothing is None


def test_profile_step_times_every_stage_on_cpu(capsys):
  per_step = profile_step.main(['--device', 'cpu', '--num_envs', '4',
                                '--steps', '8', '--wind', 'static'])
  assert set(per_step) == {'full step', 'window K=8', 'physics (B1)',
                           'wind column', 'noise', 'gp step (B2)',
                           'features', 'pressure range', 'epilogue'}
  assert all(ms > 0 for ms in per_step.values())
  last = capsys.readouterr().out.splitlines()[-1]
  assert json.loads(last)['ms_per_step'] == per_step
