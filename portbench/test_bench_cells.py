"""Each cell's run on the CPU at a tiny size, the program against the
reference: correct when the program is sound, not correct with a fault
planted underneath the harness. The eval runner, which no cell of
BENCHMARK.json uses while its cell waits (PERF.md), runs here from its
configuration and traffic files under the limits below."""

import json
import os
import time

import pytest
import torch

from portbench import faults as faults_lib
from portbench import harness

# The StationSeeker eval's numbers, on the CPU, where the program's env
# step is the reference's plain one.
EVAL_LIMITS = {'reset_obs': 2.5e-3, 'step_obs': 1e-2, 'step_gp': 0.1,
               'reward': 0.0, 'policy': 0.0}
CELLS = ('seeker.eval', 'qrdqn.train.e1024')
FAULTS = {
    'seeker.eval': ('state_unchanged', 'reward_altered', 'action_altered'),
    'qrdqn.train.e1024': ('state_unchanged', 'reward_altered', 'half_batch',
                          'update_skipped', 'sync_skipped',
                          'q_action_altered'),
}


def _file(*parts):
  with open(os.path.join(harness.HERE, *parts)) as f:
    return json.load(f)


def tiny(name):
  """The cell at a size a test run holds: 2 eval seeds, or 8 envs whose
  replay samples from its sixth step, 8 train steps an env step and a
  target sync every 4, so a run of three crosses one in each chunk."""
  if name == 'seeker.eval':
    spec = harness.Spec(
        workload={'name': name, 'config': 'station_seeker',
                  'traffic': 'big_eval', 'chips': 1},
        config=_file('configs', 'station_seeker.json'),
        traffic=_file('traffic', 'big_eval.json'), limits=EVAL_LIMITS,
        end_to_end=[], per_layer=[])
    spec.traffic.update(num_seeds=2, check_rows=2, reset_chunk=2)
    return spec
  spec = harness.load_spec(name)
  spec.traffic.update(num_envs=8, check_rows=4)
  spec.config['qrdqn'].update(min_replay_history=0, samples_per_insert=32.0,
                              target_update_period=4)
  return spec


def run_cpu(name, faults=()):
  torch.set_num_threads(2)
  try:
    return harness.execute(tiny(name), 2**31 + 77, 0.0, False, 'cpu',
                           time.perf_counter(), faults=faults)
  finally:
    for fault in faults:
      fault.undo()


@pytest.mark.parametrize('name', CELLS)
def test_cell_is_correct_on_the_cpu(name):
  result = run_cpu(name)
  assert result['correct'], result['checks']
  assert result['attempted'] >= 1 and result['failed'] == 0
  assert set(result['checks']) == set(tiny(name).limits)


@pytest.mark.parametrize('name,fault', [(c, f) for c in CELLS
                                        for f in FAULTS[c]])
def test_fault_makes_the_cell_incorrect(name, fault):
  result = run_cpu(name, [faults_lib.FAULTS[fault]])
  assert not result['correct'], result['checks']
