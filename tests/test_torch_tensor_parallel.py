"""The port's tensor-parallel demo (ble_tpu_torch/parallel/tensor_parallel.py)
on a 1 x 2 (env, model) mesh over 2 gloo ranks on the CPU: the layers'
shards, falling losses, and the losses of ble_tpu's build_tp_train_step on
a 1 x 2 mesh of CPU devices from the same converted weights and batch."""

import jax
import numpy as np
import pytest
import torch

from ble_tpu.agents import qrdqn as jax_qrdqn
from ble_tpu.parallel import tensor_parallel as jax_tp
from ble_tpu_torch import bridge
from ble_tpu_torch.agents import networks
from ble_tpu_torch.agents import qrdqn
from ble_tpu_torch.parallel import tensor_parallel

import torch_dist_workers as workers

OBS_DIM = 32
HIDDEN = 64
KW = dict(num_layers=4, hidden_units=HIDDEN, num_atoms=11,
          learning_rate=1e-3)


def _batch():
  """tests/test_tensor_parallel.py's batch."""
  rng = np.random.RandomState(0)
  return {'obs': rng.randn(16, OBS_DIM).astype(np.float32),
          'action': rng.randint(0, 3, 16).astype(np.int32),
          'n_step_reward': rng.rand(16).astype(np.float32),
          'bootstrap_discount': np.zeros((16,), np.float32),
          'next_obs': rng.randn(16, OBS_DIM).astype(np.float32),
          'weight': np.ones((16,), np.float32)}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  """ble_tpu's 10 steps on its 1 x 2 mesh, and the port's on 2 gloo ranks
  from the same weights (the JAX init carried across)."""
  tmp = tmp_path_factory.mktemp('tp')
  jcfg = jax_qrdqn.QrDqnConfig(**KW)
  mesh = jax_tp.make_2d_mesh(1, 2)
  init_fn, step_fn = jax_tp.build_tp_train_step(mesh, jcfg, OBS_DIM)
  state = init_fn(jax.random.PRNGKey(0))
  params = bridge.quantile_params_from_flax(jax.tree.map(np.asarray,
                                                         state.params))
  batch = _batch()
  jax_losses = []
  for _ in range(10):
    state, metrics = step_fn(state, batch)
    jax_losses.append(float(metrics['loss']))
  case = str(tmp / 'case.pt')
  torch.save({'config': qrdqn.QrDqnConfig(**KW), 'obs_dim': OBS_DIM,
              'params': params, 'batch': batch}, case)
  with pytest.MonkeyPatch.context() as patch:
    patch.setenv('OMP_NUM_THREADS', '1')
    ranks = workers.spawn(workers.tensor_parallel_worker, tmp, case)
  return jax_losses, ranks


def test_even_layers_shard_over_model_and_losses_fall(runs):
  """Column-parallel even layers hold half their output rows a rank,
  row-parallel odd layers half their input columns; 10 steps give finite,
  falling losses, the same on both ranks."""
  _, ranks = runs
  shapes = ranks[0]['shapes']
  assert shapes['layers.0.weight'] == (HIDDEN // 2, OBS_DIM)
  assert shapes['layers.0.bias'] == (HIDDEN // 2,)
  assert shapes['layers.1.weight'] == (HIDDEN, HIDDEN // 2)
  assert shapes['layers.1.bias'] == (HIDDEN,)
  assert shapes['layers.3.weight'] == (3 * 11, HIDDEN // 2)
  losses = ranks[0]['losses']
  assert ranks[1]['losses'] == losses
  assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_losses_match_jax_tensor_parallel(runs):
  """The port's 10 losses within 1e-4 relative of ble_tpu's
  build_tp_train_step from the same weights and batch."""
  jax_losses, ranks = runs
  np.testing.assert_allclose(ranks[0]['losses'], jax_losses, rtol=1e-4)


def test_param_specs_alternate_column_and_row():
  network = networks.QuantileNetwork(8, num_layers=3, hidden_units=16,
                                     num_atoms=5)
  plan = tensor_parallel.param_specs(network)
  assert [type(plan[f'layers.{i}']).__name__ for i in range(3)] == [
      'ColwiseParallel', 'RowwiseParallel', 'ColwiseParallel']
