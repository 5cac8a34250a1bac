"""The port's training harness (ble_tpu_torch/train/train_lib.py), the
train and eval CLIs, the collectors and the `--set` overrides, on the CPU
at a small size."""

import builtins
import glob
import json
import os

import numpy as np
import pytest
import torch

from ble_tpu import config as jax_config
from ble_tpu.train import learner as jax_learner
from ble_tpu_torch import config as config_lib
from ble_tpu_torch.agents import qrdqn
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.metrics import collectors
from ble_tpu_torch.train import eval as eval_cli
from ble_tpu_torch.train import learner
from ble_tpu_torch.train import suites
from ble_tpu_torch.train import train as train_cli
from ble_tpu_torch.train import train_lib

SMALL = ['num_envs=4', 'replay.ring_len=64', 'replay.batch_size=8',
         'qrdqn.min_replay_history=8', 'qrdqn.num_layers=2',
         'qrdqn.hidden_units=32', 'qrdqn.num_atoms=11']


def _config():
  return config_lib.apply_overrides(learner.TrainConfig(), SMALL)


def _assert_trees_equal(got, want, path='state'):
  if isinstance(want, dict):
    assert set(got) == set(want), path
    for k in want:
      _assert_trees_equal(got[k], want[k], f'{path}.{k}')
  elif isinstance(want, (list, tuple)):
    assert len(got) == len(want), path
    for i, (g, w) in enumerate(zip(got, want)):
      _assert_trees_equal(g, w, f'{path}[{i}]')
  elif isinstance(want, torch.Tensor):
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert torch.equal(got.cpu(), want.cpu()), path
  else:
    assert got == want, path


def _run(base_dir, num_iterations, **kw):
  return train_lib.run_training_loop(
      base_dir, env_lib.EnvParams(), env_lib.make_field_fn('static'),
      _config(), num_iterations=num_iterations, episode_length=16,
      chunk_steps=8, collectors=('console', 'pickle'), device='cpu', **kw)


def test_training_loop_checkpoints_and_resumes(tmp_path):
  """2 iterations of 16 steps in chunks of 8 at 4 envs: a checkpoint per
  iteration, the envs truncated at 16 steps and reset; a second call with
  the same num_iterations resumes at iteration 2 (no step taken) with every
  tensor, counter and the generator's state equal to those saved; a third
  call with 3 iterations runs only iteration 2."""
  base = str(tmp_path)
  ts = _run(base, 2)
  assert ts.env_steps == 32 and ts.replay.total == 32
  assert ts.episodes_done == 4  # All 4 truncated at 16 steps, then reset.
  assert ts.learner.train_steps > 0
  ckpts = sorted(os.listdir(os.path.join(base, 'checkpoints')))
  assert ckpts == ['ckpt_00000000.pt', 'ckpt_00000001.pt']
  pickles = glob.glob(os.path.join(base, 'metrics', 'pickle', '*.pkl'))
  assert len(pickles) == 2

  resumed = _run(base, 2)
  _assert_trees_equal(train_lib.train_state_dict(resumed),
                      train_lib.train_state_dict(ts))
  third = _run(base, 3)
  assert third.env_steps == 48 and third.replay.total == 48
  assert third.episodes_done == 8
  assert third.learner.train_steps > ts.learner.train_steps
  # The restored optimizer keeps Adam's step counts on the CPU, where
  # torch reads them without waiting on the card.
  for st in third.learner.optimizer.state.values():
    assert st['step'].device == torch.device('cpu')


def test_checkpoint_keeps_max_to_keep_and_light_restores_params(tmp_path):
  """A light checkpoint holds the learner alone: restore_latest_learner_params
  gives its online network, and restore_latest_checkpoint loads it into a
  fresh state whose replay stays empty. max_to_keep drops the oldest."""
  base = str(tmp_path)
  config = _config()
  params = env_lib.EnvParams()
  field_fn = env_lib.make_field_fn('static')
  ts = learner.init_train_state(0, params, field_fn, config, device='cpu')
  ts, _ = learner.run_episode_chunk(config, params, ts, 10)
  with pytest.raises(ValueError, match='No checkpoint'):
    train_lib.restore_latest_learner_params(base)
  template = learner.init_train_state(1, params, field_fn, config, 'cpu')
  assert train_lib.restore_latest_checkpoint(base, template) == (template, -1)
  for it in range(4):
    train_lib.save_checkpoint(base, ts, it, max_to_keep=2, light=True)
  assert sorted(os.listdir(os.path.join(base, 'checkpoints'))) == [
      'ckpt_00000002.pt', 'ckpt_00000003.pt']
  got, iteration = train_lib.restore_latest_learner_params(base)
  assert iteration == 3
  _assert_trees_equal(got, ts.learner.network.state_dict())
  network = qrdqn.network_from_params(got)
  assert network.num_atoms == 11 and len(network.layers) == 2

  restored, iteration = train_lib.restore_latest_checkpoint(base, template)
  assert iteration == 3
  _assert_trees_equal(train_lib.learner_state_dict(restored.learner),
                      train_lib.learner_state_dict(ts.learner))
  assert restored.replay.total == 0 and restored.env_steps == 0


def test_apply_overrides_matches_jax():
  """Nested overrides of every type, the agents' own configs (qrdqn.*,
  dqn.*, r2d2.*) included, agree with ble_tpu.config's on every field of
  both TrainConfigs, and so do r2d2's train steps an env step; bad paths
  raise."""
  overrides = ['num_envs=16', 'qrdqn.learning_rate=1e-5',
               'replay.prioritized=true', 'use_marco_polo=0',
               'qrdqn.lr_warmup_steps=7', 'samples_per_insert=4',
               'replay.n_step=3', 'dqn.hidden_units=64',
               'dqn.epsilon_train=0.05', 'r2d2.seq_len=12',
               'r2d2.stored_state=true', 'agent=r2d2']
  got = config_lib.apply_overrides(learner.TrainConfig(), overrides)
  want = jax_config.apply_overrides(jax_learner.TrainConfig(), overrides)
  for name in ('num_envs', 'use_marco_polo', 'samples_per_insert',
               'episode_length', 'epsilon_train'):
    assert getattr(got, name) == getattr(want, name), name
  assert got.agent == want.agent == 'r2d2'
  for sub in ('qrdqn', 'dqn', 'r2d2', 'replay'):
    g, w = getattr(got, sub), getattr(want, sub)
    for field in g.__dataclass_fields__:
      assert getattr(g, field) == getattr(w, field), f'{sub}.{field}'
  assert got.grad_steps_per_env_step() == want.grad_steps_per_env_step()
  assert got.replay.prioritized is True and got.use_marco_polo is False
  with pytest.raises(ValueError, match='no field'):
    config_lib.apply_overrides(got, ['qrdqn.nope=1'])
  with pytest.raises(ValueError, match='path=value'):
    config_lib.apply_overrides(got, ['num_envs'])


def test_train_and_eval_clis_run_end_to_end(tmp_path, monkeypatch):
  """train.main on the CPU (static field, 4 envs, 2 iterations of 8
  steps) writes checkpoints; eval.main --agent quantile --checkpoint_dir
  evaluates their greedy policy (micro_eval cut to 8 steps here) and
  writes its results. Another trainable agent, dqn, trains through the
  same CLI in a base_dir of its own (tests/test_torch_agents_cli.py runs
  every agent through both CLIs)."""
  base = str(tmp_path / 'run')
  args = ['--device', 'cpu', '--wind_field', 'static', '--base_dir', base,
          '--num_iterations', '2', '--max_episode_length', '8']
  for item in SMALL:
    args += ['--set', item]
  ts = train_cli.main(args)
  assert ts.env_steps == 16 and ts.obs.device == torch.device('cpu')
  assert len(os.listdir(os.path.join(base, 'checkpoints'))) == 2
  dqn = ['--device', 'cpu', '--wind_field', 'static', '--agent', 'dqn',
         '--base_dir', str(tmp_path / 'dqn'), '--num_iterations', '1',
         '--max_episode_length', '8', '--set', 'num_envs=4',
         '--set', 'replay.ring_len=64', '--set', 'replay.batch_size=8',
         '--set', 'dqn.min_replay_history=8', '--set', 'dqn.num_layers=2',
         '--set', 'dqn.hidden_units=32']
  assert train_cli.main(dqn).learner.train_steps > 0

  monkeypatch.setattr(eval_cli.suites, 'get_eval_suite',
                      lambda name: suites.EvaluationSuite([0, 1], 8))
  out_dir = str(tmp_path / 'eval')
  eval_cli.main(['--agent', 'quantile', '--checkpoint_dir', base,
                 '--suite', 'micro_eval', '--wind_field', 'static',
                 '--device', 'cpu', '--output_dir', out_dir])
  with open(os.path.join(out_dir, 'quantile_micro_eval.json')) as f:
    results = json.load(f)['results']
  assert [r['seed'] for r in results] == [0, 1]
  assert all(r['final_timestep'] == 8 for r in results)
  assert all(0.0 <= r['time_within_radius'] <= 1.0 for r in results)
  with pytest.raises(ValueError, match='checkpoint_dir'):
    eval_cli.make_policy_fns('quantile')


def test_collectors(tmp_path, monkeypatch, capsys):
  """The console collector prints an episode's action shares; the pickle
  collector dumps the episode's statistics; the tensorboard collector
  raises a clear error when the package is missing."""
  dispatcher = collectors.CollectorDispatcher(str(tmp_path), 3,
                                              ['console', 'pickle'])
  dispatcher.pre_training()
  dispatcher.begin_episode()
  for step in range(3):
    dispatcher.step(collectors.StatisticsInstance(
        step=step, action=np.zeros(()), reward=np.ones(()),
        terminal=np.zeros(()), action_histogram=np.array([1, 0, 3])))
  dispatcher.end_episode(collectors.StatisticsInstance(
      step=3, action=np.zeros(()), reward=np.zeros(()),
      terminal=np.zeros(()), action_histogram=np.zeros(3, np.int64)))
  dispatcher.end_training()
  assert 'actions=(0: 0.25, 1: 0.00, 2: 0.75)' in capsys.readouterr().out
  assert os.path.isfile(os.path.join(tmp_path, 'metrics', 'pickle',
                                     'episode_000000.pkl'))
  with pytest.raises(ValueError, match='Unknown collector'):
    collectors.CollectorDispatcher(None, 3, ['nope'])

  real_import = builtins.__import__

  def no_tensorboard(name, globals=None, locals=None, fromlist=(), level=0):
    if 'tensorboard' in name or 'tensorboard' in (fromlist or ()):
      raise ImportError('No module named tensorboard')
    return real_import(name, globals, locals, fromlist, level)

  monkeypatch.setattr(builtins, '__import__', no_tensorboard)
  with pytest.raises(ImportError, match='tensorboard package'):
    collectors.TensorboardCollector(str(tmp_path), 3)
