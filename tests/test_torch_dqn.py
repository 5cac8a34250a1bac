"""The port's DQN learner (ble_tpu_torch/agents/dqn.py) against
ble_tpu.agents.dqn on the same parameters and batches: the MSE TD loss,
its metrics and gradients, Adam steps at the constant rate with the target
sync, greedy and epsilon-greedy actions, the quarantine departure, and the
registered DQNAgent. Parameters cross with bridge.mlp_params_from_flax."""

import functools

import jax
import numpy as np
import pytest
import torch

from ble_tpu.agents import dqn as jax_dqn
from ble_tpu.agents import quantile_agent as jax_quantile_agent
from ble_tpu_torch import bridge
from ble_tpu_torch.agents import base
from ble_tpu_torch.agents import dqn
from ble_tpu_torch.agents import qrdqn

OBS_DIM = 16
BATCH = 8
TOL = dict(rtol=1e-5, atol=1e-6)


def _configs(**kw):
  small = dict(num_layers=3, hidden_units=32, min_replay_history=8)
  small.update(kw)
  return jax_dqn.DqnConfig(**small), dqn.DqnConfig(**small)


def _params(tree):
  return bridge.mlp_params_from_flax(jax.tree.map(np.asarray, tree))


def _learners(jcfg, cfg, obs_dim=OBS_DIM, seed=0):
  """ble_tpu's fresh DQN learner and the port's with the same weights."""
  jstate = jax_dqn.init(jax.random.PRNGKey(seed), jcfg, obs_dim)
  state = dqn.init(torch.Generator().manual_seed(0), cfg, obs_dim, 'cpu')
  qrdqn.load_params(state, _params(jstate.params))
  return jstate, state


def _batch(seed=0, batch=BATCH, obs_dim=OBS_DIM):
  rng = np.random.RandomState(seed)
  return {
      'obs': rng.randn(batch, obs_dim).astype(np.float32),
      'action': rng.randint(0, 3, batch).astype(np.int32),
      'n_step_reward': rng.rand(batch).astype(np.float32) * 3.0,
      'bootstrap_discount': np.where(rng.rand(batch) < 0.3, 0.0,
                                     0.993 ** 5).astype(np.float32),
      'next_obs': rng.randn(batch, obs_dim).astype(np.float32),
      'weight': rng.uniform(0.2, 1.0, batch).astype(np.float32),
  }


def _torch_batch(batch):
  return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jax_grads(jcfg, jstate, batch):
  return jax.grad(lambda p: jax_dqn.mse_loss(
      jcfg, p, jstate.target_params, batch), has_aux=True)(jstate.params)


def _port_grads(cfg, state, batch):
  state.network.zero_grad(set_to_none=True)
  loss, metrics = dqn.mse_loss(cfg, state.network, state.target_network,
                               _torch_batch(batch))
  loss.backward()
  return {name: p.grad.clone() for name, p in
          state.network.named_parameters()}, loss.detach(), metrics


def _assert_params_close(module_params, flax_params, **tol):
  want = _params(flax_params)
  got = dict(module_params)
  assert set(got) == set(want)
  for name in want:
    np.testing.assert_allclose(got[name].detach().numpy(),
                               want[name].numpy(), err_msg=name, **tol)


def test_mse_loss_metrics_and_grads_match_jax():
  """Loss, mean_q, per_sample_loss and every gradient within rtol 1e-5 /
  atol 1e-6 of ble_tpu's, with a target network apart from the online
  one, terminal bootstraps and importance weights."""
  jcfg, cfg = _configs()
  jstate, state = _learners(jcfg, cfg)
  jstate = jstate.replace(target_params=jax.tree.map(
      lambda p: p * 0.9, jstate.target_params))
  state.target_network.load_state_dict(_params(jstate.target_params))
  batch = _batch()
  jgrads, jmetrics = _jax_grads(jcfg, jstate, batch)
  grads, loss, metrics = _port_grads(cfg, state, batch)
  np.testing.assert_allclose(float(loss), float(jmetrics['loss']), **TOL)
  for key in ('loss', 'mean_q', 'per_sample_loss'):
    np.testing.assert_allclose(metrics[key].detach().numpy(),
                               np.asarray(jmetrics[key]), err_msg=key, **TOL)
  assert not metrics['per_sample_loss'].requires_grad
  _assert_params_close(grads, jgrads, **TOL)


def test_quarantined_sample_keeps_loss_and_gradient_finite():
  """Sample 1 has a NaN observation and sample 3 a NaN n-step reward, both
  at weight 0 (replay's quarantine). In ble_tpu the LOSS itself is NaN
  (per_sample * w with NaN x 0, dqn.py:83), and so is the gradient. The
  port's loss and gradient are finite and equal ble_tpu's on the same
  batch with those samples' inputs zeroed (rtol 1e-5 / atol 1e-6); its
  per_sample_loss is NaN at 1 and 3, as ble_tpu's, and ble_tpu's
  elsewhere."""
  jcfg, cfg = _configs()
  jstate, state = _learners(jcfg, cfg)
  batch = _batch(seed=1)
  batch['weight'] = np.array([1, 0, 1, 0, 1, 1, 1, 1], np.float32)
  batch['obs'][1, 0] = np.nan
  batch['n_step_reward'][3] = np.nan
  jgrads, jmetrics = _jax_grads(jcfg, jstate, batch)
  assert np.isnan(float(jmetrics['loss']))
  assert not all(np.isfinite(g).all() for g in
                 jax.tree.leaves(jax.tree.map(np.asarray, jgrads)))

  grads, loss, metrics = _port_grads(cfg, state, batch)
  assert bool(torch.isfinite(loss))
  assert all(bool(torch.isfinite(g).all()) for g in grads.values())
  zeroed = {k: v.copy() for k, v in batch.items()}
  for i in (1, 3):
    for key in ('obs', 'next_obs', 'n_step_reward', 'bootstrap_discount'):
      zeroed[key][i] = 0.0
  want, want_metrics = _jax_grads(jcfg, jstate, zeroed)
  np.testing.assert_allclose(float(loss), float(want_metrics['loss']), **TOL)
  _assert_params_close(grads, want, **TOL)
  bad = np.array([False, True, False, True, False, False, False, False])
  jpsl = np.asarray(jmetrics['per_sample_loss'])
  psl = metrics['per_sample_loss'].numpy()
  np.testing.assert_array_equal(~np.isfinite(jpsl), bad)
  np.testing.assert_array_equal(~np.isfinite(psl), bad)
  np.testing.assert_allclose(psl[~bad], jpsl[~bad], **TOL)


def test_train_steps_with_target_sync_match_jax():
  """5 train steps at lr 1e-3 with target_update_period 2: online and
  target parameters after each step within rtol 1e-5 / atol 1e-6 of
  ble_tpu's train_step (optax.adam at the constant rate, eps 2e-5), a new
  batch each step."""
  jcfg, cfg = _configs(learning_rate=1e-3, target_update_period=2)
  jstate, state = _learners(jcfg, cfg)
  jstep = jax.jit(functools.partial(jax_dqn.train_step, jcfg))
  for i in range(5):
    batch = _batch(seed=10 + i)
    jstate, jmetrics = jstep(jstate, batch)
    state, metrics = dqn.train_step(cfg, state, _torch_batch(batch))
    assert state.train_steps == int(jstate.train_steps) == i + 1
    np.testing.assert_allclose(float(metrics['loss']),
                               float(jmetrics['loss']), rtol=1e-5)
    _assert_params_close(state.network.named_parameters(), jstate.params,
                         **TOL)
    _assert_params_close(state.target_network.named_parameters(),
                         jstate.target_params, **TOL)
    synced = all(torch.equal(a, b) for a, b in zip(
        state.network.parameters(), state.target_network.parameters()))
    assert synced == ((i + 1) % 2 == 0)


def test_select_action_matches_jax_and_explores_from_the_generator():
  """Greedy actions of the same parameters on 64 observations equal
  ble_tpu's; at epsilon 1 the actions are uniform draws from the
  generator (the same seed, the same actions)."""
  jcfg, cfg = _configs()
  jstate, state = _learners(jcfg, cfg, obs_dim=1099, seed=3)
  obs = np.random.RandomState(4).rand(64, 1099).astype(np.float32)
  want = np.asarray(jax_dqn.select_action(jcfg, jstate.params, obs, None))
  got = dqn.select_action(cfg, state.network, torch.from_numpy(obs))
  assert got.dtype == torch.int32
  np.testing.assert_array_equal(got.numpy(), want)
  assert len(set(want.tolist())) > 1
  big = torch.from_numpy(np.random.RandomState(5).rand(3000, 1099)
                         .astype(np.float32))
  a = dqn.select_action(cfg, state.network, big,
                        torch.Generator().manual_seed(2), 1.0)
  b = dqn.select_action(cfg, state.network, big,
                        torch.Generator().manual_seed(2), 1.0)
  assert torch.equal(a, b)
  assert bool((torch.bincount(a.long(), minlength=3) > 900).all())


def test_dqn_learner_reduces_loss():
  """60 steps at lr 1e-3 on one batch take the loss below 0.9 of its
  start (the port of tests/test_training.py's QR-DQN check for DQN)."""
  _, cfg = _configs(learning_rate=1e-3)
  state = dqn.init(torch.Generator().manual_seed(0), cfg, 8, 'cpu')
  batch = _torch_batch(_batch(seed=6, batch=32, obs_dim=8))
  losses = []
  for _ in range(60):
    state, metrics = dqn.train_step(cfg, state, batch)
    losses.append(float(metrics['loss']))
  assert losses[-1] < losses[0] * 0.9
  assert state.train_steps == 60


def test_dqn_agent_acts_like_jax():
  """The registered DQNAgent with ble_tpu's DQNAgent's parameters gives
  ble_tpu's actions over an episode of 5 observations; its network is the
  default 8 x 600 MLP."""
  jagent = jax_quantile_agent.DQNAgent(3, (1099,), seed=0)
  # ble_tpu's DQNAgent draws its parameters from PRNGKey(seed).
  params = _params(jax_dqn.init(jax.random.PRNGKey(0), jax_dqn.DqnConfig(),
                                1099).params)
  agent = base.create_agent('dqn', num_actions=3, observation_shape=(1099,),
                            params=params, device='cpu')
  assert len(agent.network.layers) == 8
  assert agent.network.layers[0].out_features == 600
  obs = np.random.RandomState(7).rand(5, 1099).astype(np.float32)
  got = [agent.begin_episode(obs[0])] + [agent.step(0.0, o) for o in obs[1:]]
  want = [jagent.begin_episode(obs[0])] + [jagent.step(0.0, o)
                                           for o in obs[1:]]
  assert got == want
  with pytest.raises(ValueError, match='Unknown'):
    base.create_agent('sarsa', num_actions=3, observation_shape=(1099,))
