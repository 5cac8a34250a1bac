"""The port's data-parallel learner (ble_tpu_torch/parallel/distributed.py)
and its CLI (train/distributed_train.py) on the CPU, over gloo: 2 ranks of
8 envs against the single-process 16-env run, the learner's replication,
one collective a train step, the metrics' reduction, a world of one
against run_episode_chunk, the CLI with two ranks, and the all-reduced
QR-DQN step against ble_tpu's shard_map'd pmean step.

The ranks are processes spawned with torch.multiprocessing; their code
lives in tests/torch_dist_workers.py, which imports no JAX."""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from ble_tpu.agents import qrdqn as jax_qrdqn
from ble_tpu_torch import bridge
from ble_tpu_torch.agents import qrdqn
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.parallel import distributed
from ble_tpu_torch.train import distributed_train
from ble_tpu_torch.train import eval as eval_cli
from ble_tpu_torch.train import learner
from ble_tpu_torch.train import suites
from ble_tpu_torch.train import train_lib

import torch_dist_workers as workers

OBS_DIM = 16
JAX_BATCH = 16
JAX_STEPS = 3


def _jax_case():
  """ble_tpu's fresh QR-DQN state, its parameters carried across, and
  JAX_STEPS batches of JAX_BATCH rows (each rank trains on half)."""
  kw = dict(num_layers=2, hidden_units=32, num_atoms=11, learning_rate=1e-3,
            target_update_period=2)
  jcfg, cfg = jax_qrdqn.QrDqnConfig(**kw), qrdqn.QrDqnConfig(**kw)
  jstate = jax_qrdqn.init(jax.random.PRNGKey(0), jcfg, OBS_DIM)
  batches = []
  for i in range(JAX_STEPS):
    rng = np.random.RandomState(20 + i)
    batches.append({
        'obs': rng.randn(JAX_BATCH, OBS_DIM).astype(np.float32),
        'action': rng.randint(0, 3, JAX_BATCH).astype(np.int32),
        'n_step_reward': rng.rand(JAX_BATCH).astype(np.float32) * 3.0,
        'bootstrap_discount': np.where(rng.rand(JAX_BATCH) < 0.3, 0.0,
                                       0.993 ** 5).astype(np.float32),
        'next_obs': rng.randn(JAX_BATCH, OBS_DIM).astype(np.float32),
        'weight': rng.uniform(0.2, 1.0, JAX_BATCH).astype(np.float32)})
  params = bridge.quantile_params_from_flax(jax.tree.map(np.asarray,
                                                         jstate.params))
  return jcfg, jstate, batches, {'config': cfg, 'obs_dim': OBS_DIM,
                                 'params': params, 'batches': batches}


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
  """One spawn of data_parallel_worker over 2 gloo ranks, the
  single-process trajectory run, and the JAX case the ranks trained on."""
  tmp = tmp_path_factory.mktemp('two_ranks')
  jcfg, jstate, batches, case = _jax_case()
  case_path = str(tmp / 'jax_case.pt')
  torch.save(case, case_path)
  with pytest.MonkeyPatch.context() as patch:
    patch.setenv('OMP_NUM_THREADS', '1')
    ranks = workers.spawn(workers.data_parallel_worker, tmp, case_path)
  return {'ranks': ranks, 'single': workers.single_trajectory(),
          'jax': (jcfg, jstate, batches)}


def test_two_ranks_match_one_process_across_a_reset(two_ranks):
  """2 ranks x 8 envs against one process of 16 (greedy actions, MarcoPolo
  off, no learning): observations, pressure, replay rows, cursors and
  every reset's world seeds equal bit for bit after 5 steps, a forced
  selective reset of 2 envs on rank 0 and 1 on rank 1, and 3 more steps
  (ble_tpu's test_distributed_trajectories_match_single_device)."""
  want = two_ranks['single']
  got = [r['trajectory'] for r in two_ranks['ranks']]
  for key in ('obs', 'pressure', 'active', 'episode_step'):
    assert torch.equal(torch.cat([got[0][key], got[1][key]]), want[key]), key
  for key, value in want['replay'].items():
    assert torch.equal(torch.cat([got[0]['replay'][key],
                                 got[1]['replay'][key]]),
                       value), key
  # Every reset's seeds: the initial blocks, then 2 + 1 fresh worlds.
  assert want['seeds'][1] == got[0]['seeds'][1] + got[1]['seeds'][1]
  assert want['seeds'][0] == got[0]['seeds'][0] + got[1]['seeds'][0]
  assert len(want['seeds'][1]) == 3
  for g in got:
    for key in ('total', 'next_world_seed', 'episodes_done', 'env_steps'):
      assert g[key] == want[key], key


def test_metrics_reduce_as_in_jax(two_ranks):
  """The chunks' metrics: action_hist and terminals summed over the ranks
  (equal to the single process's counts), reward, loss and active_frac
  averaged (within float32 rounding of the 16-env means), path dropped;
  every rank holds the same values."""
  single = two_ranks['single']['metrics']
  got = [r['trajectory']['metrics'] for r in two_ranks['ranks']]
  for chunk, want in enumerate(single):
    a, b = got[0][chunk], got[1][chunk]
    assert set(a) == set(want) - {'path'}
    for key in a:
      assert torch.equal(a[key], b[key]), key
    for key in distributed.COUNT_METRICS:
      assert torch.equal(a[key], want[key]), key
    for key in ('reward', 'loss', 'active_frac'):
      np.testing.assert_allclose(a[key].numpy(), want[key].numpy(),
                                 rtol=1e-6, atol=1e-7, err_msg=key)


def test_learner_stays_replicated_with_one_collective_a_train_step(
    two_ranks):
  """With learning on, 10 env steps of 2 x 8 envs: the ranks train, every
  parameter of the online and target networks lies within 1e-6 of the
  ranks' mean (ble_tpu's bound, tests/test_training.py:555-556), and a
  chunk makes one all-reduce a train step plus one a metric."""
  for r in two_ranks['ranks']:
    learning = r['learning']
    assert learning['train_steps'] > 0
    assert learning['deviation'] <= 1e-6
    assert learning['collectives'] == learning['train_steps']
    assert learning['all_reduces'] == (learning['train_steps'] +
                                       len(learning['metric_keys']))
    assert bool(torch.isfinite(learning['loss']).all())


def test_allreduced_train_step_matches_jax_pmean(two_ranks):
  """3 QR-DQN train steps (lr 1e-3, target period 2), each rank on its
  half of each 16-row batch with grad_allreduce, against ble_tpu's
  train_step under jax.shard_map over 2 CPU devices with the gradients
  pmean'd, from the same flax weights: online and target parameters after
  every step within A10's rtol 1e-5 / atol 1e-6, and equal on both
  ranks."""
  jcfg, jstate, batches = two_ranks['jax']
  mesh = Mesh(np.array(jax.devices()[:2]), ('env',))

  def local(state, batch):
    return jax_qrdqn.train_step(
        jcfg, state, batch,
        grad_transform=lambda g: jax.lax.pmean(g, 'env'))[0]

  step = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P(), P('env')),
                               out_specs=P(), check_vma=False))
  ranks = [r['jax_case'] for r in two_ranks['ranks']]
  for i, batch in enumerate(batches):
    jstate = step(jstate, batch)
    for key, tree in (('params', jstate.params),
                      ('target', jstate.target_params)):
      want = bridge.quantile_params_from_flax(jax.tree.map(np.asarray, tree))
      for name, value in want.items():
        got = [r[i][key][name] for r in ranks]
        assert torch.equal(got[0], got[1]), (i, key, name)
        np.testing.assert_allclose(got[0].numpy(), value.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f'{i} {key} {name}')


def test_world_of_one_equals_run_episode_chunk(tmp_path):
  """In a gloo group of one, init_distributed_train_state and
  build_distributed_step give the same learner and envs, bit for bit, as
  init_train_state and run_episode_chunk: the all-reduce is then an
  identity, and rank 0 keeps the seed's loop generator."""
  config = learner.TrainConfig(
      num_envs=4, qrdqn=workers.small_qrdqn(min_replay_history=2),
      replay=workers.replay.ReplayConfig(ring_len=16, batch_size=8))
  params = env_lib.EnvParams()
  field_fn = env_lib.make_field_fn('static')
  want = learner.init_train_state(3, params, field_fn, config, 'cpu')
  want, want_m = learner.run_episode_chunk(config, params, want, 8)
  distributed.init_process_group(
      'cpu', rank=0, world_size=1,
      init_method='file://' + str(tmp_path / 'rendezvous'))
  try:
    assert distributed.world() == (0, 1)
    got = distributed.init_distributed_train_state(3, config, params,
                                                   field_fn, 'cpu')
    step = distributed.build_distributed_step(config, params, 8)
    got, got_m = step(got)
  finally:
    torch.distributed.destroy_process_group()
  assert got.learner.train_steps == want.learner.train_steps > 0
  assert step.allreduce.collectives == got.learner.train_steps
  for module in ('network', 'target_network'):
    a = getattr(got.learner, module).state_dict()
    b = getattr(want.learner, module).state_dict()
    for name in b:
      assert torch.equal(a[name], b[name]), (module, name)
  assert torch.equal(got.obs, want.obs)
  assert torch.equal(got.replay.obs, want.replay.obs)
  assert got.next_world_seed == want.next_world_seed
  for key in got_m:
    assert torch.equal(got_m[key], want_m[key]), key


def test_shard_bounds_and_local_config():
  assert distributed.shard_bounds(16, 1, 2) == (8, 16)
  assert distributed.shard_bounds(1024, 0, 1) == (0, 1024)
  with pytest.raises(ValueError, match='divide'):
    distributed.shard_bounds(10, 0, 4)
  config = learner.TrainConfig(num_envs=1024)
  assert distributed.local_config(config, 4).num_envs == 256
  assert distributed.loop_seed(5, 0) == 5
  assert distributed.loop_seed(5, 1) != 5
  assert distributed.world() == (0, 1)


COMMON = ['num_envs=8', 'replay.ring_len=64', 'replay.batch_size=8']
# Each agent at a small size; r2d2 (per-env LSTM lanes, sequence replay)
# needs its first trainable window, mlp trains online every step.
SMALL = {
    'quantile': ['qrdqn.min_replay_history=8', 'qrdqn.num_layers=2',
                 'qrdqn.hidden_units=32', 'qrdqn.num_atoms=11'],
    'mlp': [],
    'r2d2': ['r2d2.min_replay_history=8', 'r2d2.hidden_units=24',
             'r2d2.lstm_units=16', 'r2d2.num_atoms=7', 'r2d2.seq_len=6',
             'r2d2.burn_in=2'],
}


@pytest.mark.parametrize('agent', sorted(SMALL))
def test_cli_two_ranks_checkpoint_and_eval(agent, tmp_path, monkeypatch):
  """distributed_train.main with --device cpu --n_devices 2: one chunk of
  12 env steps over 2 gloo ranks of 4 envs; rank 0 checkpoints under
  base_dir and rank 1 under base_dir/rank_1, both trained, with the same
  online and target networks; the eval CLI evaluates rank 0's
  checkpoint."""
  monkeypatch.setenv('OMP_NUM_THREADS', '1')
  base = str(tmp_path / 'run')
  argv = ['--device', 'cpu', '--n_devices', '2', '--wind_field', 'static',
          '--num_env_steps', '12', '--chunk_steps', '12', '--base_dir', base]
  for item in COMMON + [f'agent={agent}'] + SMALL[agent]:
    argv += ['--set', item]
  assert distributed_train.main(argv) is None
  ckpts = [os.path.join(base, 'checkpoints', 'ckpt_00000001.pt'),
           os.path.join(base, 'rank_1', 'checkpoints', 'ckpt_00000001.pt')]
  states = [torch.load(p, weights_only=True)['train_state'] for p in ckpts]
  for s in states:
    assert s['env_steps'] == 12 and s['obs'].shape == (4, 1099)
    assert s['learner']['train_steps'] > 0
  assert not torch.equal(states[0]['obs'], states[1]['obs'])
  for module in ('network', 'target_network'):
    if module not in states[0]['learner']:
      continue
    a, b = (s['learner'][module] for s in states)
    for name in a:
      np.testing.assert_allclose(a[name].numpy(), b[name].numpy(),
                                 atol=1e-6, err_msg=f'{module} {name}')

  monkeypatch.setattr(eval_cli.suites, 'get_eval_suite',
                      lambda name: suites.EvaluationSuite([0, 1], 8))
  out_dir = str(tmp_path / 'eval')
  eval_cli.main(['--agent', agent, '--checkpoint_dir', base,
                 '--suite', 'micro_eval', '--wind_field', 'static',
                 '--device', 'cpu', '--output_dir', out_dir])
  _, iteration = train_lib.restore_latest_learner_params(base)
  assert iteration == 1
  assert os.path.isfile(os.path.join(out_dir, f'{agent}_micro_eval.json'))


def test_cli_raises_without_a_card_and_checks_its_flags(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA'):
    distributed_train.main(['--num_env_steps', '1'])
  with pytest.raises(ValueError, match='multihost'):
    distributed_train.main(['--device', 'cpu', '--multihost'])
