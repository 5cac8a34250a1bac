"""The training CLI's periodic eval (--eval_every), on the CPU at micro
width: each learning_curve.jsonl record has the JAX package's keys
(ble_tpu/train/train.py:50-57), its TWR and reward equal
eval_lib.evaluate over learner.make_eval_policy with the parameters the
learner had at that eval, and its env_steps and train_steps equal the
training state's. quantile is the feed-forward case, r2d2 threads its
LSTM carry through the policy state, and mlp counts its train steps where
the JAX package writes 0. Every real suite runs 960 steps, so the suite is
stubbed to one seed of a few steps."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from ble_tpu.train import eval_lib as jax_eval_lib
from ble_tpu_torch import config as config_lib
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.train import eval_lib
from ble_tpu_torch.train import learner
from ble_tpu_torch.train import suites
from ble_tpu_torch.train import train as train_cli

SUITE = suites.EvaluationSuite([5], 6)
SETS = {
    'quantile': ['qrdqn.min_replay_history=8', 'qrdqn.num_layers=2',
                 'qrdqn.hidden_units=32', 'qrdqn.num_atoms=11'],
    'r2d2': ['r2d2.min_replay_history=8', 'r2d2.hidden_units=24',
             'r2d2.lstm_units=16', 'r2d2.num_atoms=7', 'r2d2.seq_len=6',
             'r2d2.burn_in=2'],
    'mlp': [],
}


def _jax_record_keys():
  """The keys of the JAX package's record: its own four and those of its
  eval_lib.summarize."""
  summary = jax_eval_lib.summarize([jax_eval_lib.EvaluationResult(
      seed=0, cumulative_reward=0.0, time_within_radius=0.0,
      out_of_power=False, envelope_burst=False, zeropressure=False,
      final_timestep=960)])
  return {'iteration', 'env_steps', 'train_steps', 'wall_s'} | set(summary)


@pytest.mark.parametrize('agent', sorted(SETS))
def test_periodic_eval_records_match_a_reevaluation(agent, tmp_path,
                                                    monkeypatch):
  monkeypatch.setattr(train_cli.suites, 'get_eval_suite', lambda name: SUITE)
  seen = []
  make = train_cli.make_periodic_eval

  def recording(*args, **kwargs):
    callback = make(*args, **kwargs)

    def eval_cb(ts, iteration):
      callback(ts, iteration)
      seen.append((copy.deepcopy(ts.learner.network), ts.env_steps,
                   ts.learner.train_steps))

    return eval_cb

  monkeypatch.setattr(train_cli, 'make_periodic_eval', recording)
  base = str(tmp_path / 'run')
  sets = ['num_envs=4', 'replay.ring_len=64',
          'replay.batch_size=8'] + SETS[agent]
  args = ['--device', 'cpu', '--wind_field', 'static', '--agent', agent,
          '--base_dir', base, '--max_episode_length', '6',
          '--num_iterations', '2', '--eval_every', '1', '--eval_suite',
          'micro_eval']
  for item in sets:
    args += ['--set', item]
  ts = train_cli.main(args)
  with open(os.path.join(base, 'learning_curve.jsonl')) as f:
    records = [json.loads(line) for line in f]
  assert [r['iteration'] for r in records] == [0, 1]
  assert len(seen) == 2 and ts.learner.train_steps > 0

  config = config_lib.apply_overrides(learner.TrainConfig(agent=agent), sets)
  params = env_lib.EnvParams(field_cache=True)
  for record, (network, env_steps, train_steps) in zip(records, seen):
    assert set(record) == _jax_record_keys()
    assert record['env_steps'] == env_steps * config.num_envs
    assert record['train_steps'] == train_steps
    policy = learner.make_eval_policy(config, network)
    fn = eval_lib.build_eval_fn(params, env_lib.make_field_fn('static'),
                                policy.init, policy.step,
                                max_steps=SUITE.max_episode_length,
                                device='cpu')
    want = eval_lib.summarize(eval_lib.evaluate(fn, SUITE.seeds))
    for key in ('mean_twr', 'mean_cumulative_reward', 'num_terminated',
                'num_seeds'):
      assert record[key] == want[key], key
  assert records[1]['env_steps'] == ts.env_steps * config.num_envs
  assert records[1]['train_steps'] == ts.learner.train_steps
  if agent == 'mlp':  # The JAX package writes 0 here.
    assert records[1]['train_steps'] == ts.env_steps > 0


@pytest.mark.parametrize('agent', ['quantile', 'r2d2'])
def test_parametric_eval_fn_matches_eval_fn_with_its_params_bound(agent):
  """build_parametric_eval_fn(params, seeds) against build_eval_fn(seeds)
  over the same policy with the parameters bound, on two seeds of 5
  steps: every result equal, flight paths included, for each of two
  networks given to the one parametric function."""
  field_fn = env_lib.make_field_fn('static')
  params = env_lib.EnvParams(field_cache=True)
  seeds = [2, 7]
  config = config_lib.apply_overrides(learner.TrainConfig(agent=agent),
                                      SETS[agent])
  core = learner.make_agent_core(config)
  init, step = learner.make_parametric_eval_policy(config)[:2]
  parametric = eval_lib.build_parametric_eval_fn(
      params, field_fn, init, step, max_steps=5, record_flight_path=True,
      device='cpu')
  for s in (0, 1):
    net = core.params_of(core.init(torch.Generator().manual_seed(s),
                                   env_lib.OBSERVATION_DIM, 'cpu'))
    bound = eval_lib.build_eval_fn(
        params, field_fn, lambda keys, device: init(net, keys, device),
        lambda *a: step(net, *a), max_steps=5, record_flight_path=True,
        device='cpu')
    got, want = parametric(net, seeds), bound(seeds)
    assert set(got) == set(want)
    for key in want:
      assert torch.equal(got[key], want[key]), key
    assert got['flight_path'].shape == (2, 5, 6)
    assert np.isfinite(got['flight_path'].numpy()).all()
