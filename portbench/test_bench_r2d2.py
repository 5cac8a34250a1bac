"""R2D2's training cell, r2d2.train.e1024, on the CPU at a tiny size: run
from a copy of portbench/ and BENCHMARK.json, it is correct, with the
window's run across a target sync armed and its two per-layer metrics
read; with a fault planted in the program it is not correct. On the card
(`-m chip`) the cell at its own size: the control (the plain reference in
TF32 in the program's place) fails the committed limits where the
program passes, and each fault fails."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import check
from portbench import harness

CELL = 'r2d2.train.e1024'
# 8 envs in chunks of 8 env steps whose replay samples from the sixth;
# 8 train steps an env step (8 x 16 / (4 windows x 4 trainable steps)) and
# a target sync every 4, so the window's run starts at its train step 82,
# in the chunk's last env step, and syncs after its second step.
TINY_TRAFFIC = {'num_envs': 8, 'check_rows': 4}
TINY_CONFIG = {'train_chunk_steps': 8}
TINY_R2D2 = {'hidden_units': 32, 'lstm_units': 8, 'num_atoms': 5,
             'batch_size': 4, 'seq_len': 6, 'burn_in': 2,
             'samples_per_insert': 16.0, 'target_update_period': 4,
             'min_replay_history': 0}
SEED = 2**31 + 77
RUN = '''
import json, time
import torch
from portbench import harness
torch.set_num_threads(2)
result = harness.execute(harness.load_spec({cell!r}), {seed}, 0.0, True,
                         'cpu', time.perf_counter())
print(json.dumps({{'harness': harness.__file__, 'correct': result['correct'],
                  'checks': result['checks'],
                  'metrics': sorted(result['metrics'])}}))
'''


def _r2d2():
  from ble_tpu_torch.agents import r2d2
  return r2d2


def _networks():
  from ble_tpu_torch.agents import networks
  return networks.LstmQuantileNetwork


class Planted:
  """A fault in the program: owner().attr rebound to wrapper_of(original)
  for the length of a run (harness.execute's `faults`)."""

  def __init__(self, owner, attr, wrapper_of):
    self.owner, self.attr, self.wrapper_of = owner, attr, wrapper_of
    self._undo = None

  def __call__(self, run=None):
    self._undo = check.rebind(self.owner(), self.attr, self.wrapper_of)

  def undo(self):
    if self._undo is not None:
      self._undo()
      self._undo = None


def _burn_in_dropped(original):
  def sequence_loss(config, network, target_network, batch):
    return original(dataclasses.replace(config, burn_in=0), network,
                    target_network, batch)
  return sequence_loss


def _carry_reset(original):
  """Each step of an unroll from a zero carry, the actor's too."""
  def unroll(self, carry, x):
    outs = [original(self, self.initial_state(x.shape[0], x.device),
                     x[:, t:t + 1]) for t in range(x.shape[1])]
    return outs[-1][0], tuple(torch.cat([o[1][i] for o in outs], dim=1)
                              for i in range(2))
  return unroll


def _sync_skipped(original):
  def train_step(config, state, batch, grad_transform=None):
    return original(dataclasses.replace(config, target_update_period=2**62),
                    state, batch, grad_transform)
  return train_step


def _half_batch(original):
  def sequence_loss(config, network, target_network, batch):
    half = batch['obs'].shape[0] // 2
    return original(config, network, target_network,
                    {k: v[:half] for k, v in batch.items()})
  return sequence_loss


FAULTS = {
    'burn_in_dropped': (_r2d2, 'sequence_loss', _burn_in_dropped,
                        ('loss', 'grad')),
    'carry_reset': (_networks, 'unroll', _carry_reset,
                    ('policy_carry', 'loss')),
    'sync_skipped': (_r2d2, 'train_step', _sync_skipped, ('window_target',)),
    'half_batch': (_r2d2, 'sequence_loss', _half_batch, ('loss',)),
}


def tiny():
  spec = harness.load_spec(CELL)
  spec.traffic.update(TINY_TRAFFIC)
  spec.config.update(TINY_CONFIG)
  spec.config['r2d2'].update(TINY_R2D2)
  return spec


def _failed(result):
  return {name for name, c in result['checks'].items()
          if c['value'] is None or not c['value'] <= c['limit']}


def _run(spec, device, faults=(), control=False):
  try:
    return harness.execute(spec, SEED, 0.0, False, device,
                           time.perf_counter(), faults=faults,
                           control=control)
  finally:
    for fault in faults:
      fault.undo()


def test_cell_runs_correct_from_a_copy(tmp_path):
  root = str(tmp_path)
  bench = os.path.join(root, 'portbench')
  shutil.copytree(harness.HERE, bench,
                  ignore=shutil.ignore_patterns('__pycache__'))
  shutil.copy(os.path.join(harness.ROOT, 'BENCHMARK.json'), root)
  for name, update in (('configs/r2d2.json', TINY_CONFIG),
                       ('traffic/train_e1024.json', TINY_TRAFFIC)):
    with open(os.path.join(bench, name)) as f:
      body = json.load(f)
    body.update(update)
    if name.startswith('configs'):
      body['r2d2'].update(TINY_R2D2)
    with open(os.path.join(bench, name), 'w') as f:
      json.dump(body, f)

  env = dict(os.environ, PYTHONPATH=harness.ROOT)
  out = subprocess.run([sys.executable, '-c', RUN.format(cell=CELL,
                                                         seed=SEED)],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=600)
  assert out.returncode == 0, out.stderr[-4000:]
  result = json.loads(out.stdout.strip().splitlines()[-1])
  assert result['harness'].startswith(root)
  assert result['correct'], result['checks']
  with open(os.path.join(harness.HERE, 'limits', f'{CELL}.json')) as f:
    assert set(result['checks']) == set(json.load(f))
  assert {'window_loss', 'window_target', 'policy_carry'} <= set(
      result['checks'])
  assert {'seq_sample_host_ms.train', 'seq_loss_host_ms.train',
          'learner_host_ms.train'} <= set(result['metrics'])


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_fault_makes_the_cell_incorrect(fault):
  torch.set_num_threads(2)
  owner, attr, wrapper_of, caught = FAULTS[fault]
  result = _run(tiny(), 'cpu', [Planted(owner, attr, wrapper_of)])
  assert not result['correct']
  assert _failed(result) & set(caught), result['checks']


@pytest.mark.chip
def test_control_fails_and_program_passes_on_the_card(cuda):
  spec = harness.load_spec(CELL)
  result = _run(spec, cuda, control=True)
  print(json.dumps({'checks': result['checks'],
                    'control': result['_control']}))
  assert result['correct'], result['checks']
  control = check.decide(result['_control'],
                         {k: spec.limits[k] for k in result['_control']})
  assert not all(ok for *_, ok in control), control


@pytest.mark.chip
@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_fault_fails_on_the_card(cuda, fault):
  owner, attr, wrapper_of, caught = FAULTS[fault]
  result = _run(harness.load_spec(CELL), cuda,
                [Planted(owner, attr, wrapper_of)])
  print(json.dumps({'fault': fault, 'checks': result['checks']}))
  assert not result['correct']
  assert _failed(result) & set(caught), result['checks']
