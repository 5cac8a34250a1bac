"""The port's QR-DQN learner (ble_tpu_torch/agents/qrdqn.py) against
ble_tpu.agents.qrdqn on the same parameters and batches: the loss, its
metrics and gradients, Adam steps with the target sync, the learning-rate
schedule against optax, and greedy actions. Parameters cross with
bridge.quantile_params_from_flax."""

import functools

import jax
import numpy as np
import optax
import pytest
import torch

from ble_tpu.agents import qrdqn as jax_qrdqn
from ble_tpu_torch import bridge
from ble_tpu_torch.agents import qrdqn

OBS_DIM = 16
BATCH = 8


def _configs(**kw):
  small = dict(num_layers=2, hidden_units=32, num_atoms=11,
               min_replay_history=8)
  small.update(kw)
  return jax_qrdqn.QrDqnConfig(**small), qrdqn.QrDqnConfig(**small)


def _learners(jcfg, cfg, obs_dim=OBS_DIM, seed=0):
  """ble_tpu's fresh LearnerState and the port's with the same weights."""
  jstate = jax_qrdqn.init(jax.random.PRNGKey(seed), jcfg, obs_dim)
  state = qrdqn.init(torch.Generator().manual_seed(0), cfg, obs_dim, 'cpu')
  qrdqn.load_params(state, bridge.quantile_params_from_flax(
      jax.tree.map(np.asarray, jstate.params)))
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
  return jax.grad(lambda p: jax_qrdqn.quantile_loss(
      jcfg, p, jstate.target_params, batch), has_aux=True)(jstate.params)


def _port_grads(cfg, state, batch):
  state.network.zero_grad(set_to_none=True)
  loss, metrics = qrdqn.quantile_loss(cfg, state.network,
                                      state.target_network,
                                      _torch_batch(batch))
  loss.backward()
  return {name: p.grad.clone() for name, p in
          state.network.named_parameters()}, loss.detach(), metrics


def _assert_params_close(module_params, flax_params, **tol):
  want = bridge.quantile_params_from_flax(jax.tree.map(np.asarray,
                                                       flax_params))
  got = dict(module_params)
  assert set(got) == set(want)
  for name in want:
    np.testing.assert_allclose(got[name].detach().numpy(),
                               want[name].numpy(), err_msg=name, **tol)


def test_quantile_loss_metrics_and_grads_match_jax():
  """Loss, mean_q, valid_frac, per_sample_loss and every gradient within
  rtol 1e-5 / atol 1e-6 of ble_tpu's, on a batch with terminal
  bootstraps and importance weights."""
  jcfg, cfg = _configs()
  jstate, state = _learners(jcfg, cfg)
  # A target network apart from the online one, as after training.
  jstate = jstate.replace(target_params=jax.tree.map(
      lambda p: p * 0.9, jstate.target_params))
  state.target_network.load_state_dict(bridge.quantile_params_from_flax(
      jax.tree.map(np.asarray, jstate.target_params)))
  batch = _batch()
  jgrads, jmetrics = _jax_grads(jcfg, jstate, batch)
  grads, loss, metrics = _port_grads(cfg, state, batch)
  tol = dict(rtol=1e-5, atol=1e-6)
  np.testing.assert_allclose(float(loss), float(jmetrics['loss']), **tol)
  for key in ('loss', 'mean_q', 'valid_frac', 'per_sample_loss'):
    np.testing.assert_allclose(metrics[key].detach().numpy(),
                               np.asarray(jmetrics[key]), err_msg=key, **tol)
  assert not metrics['per_sample_loss'].requires_grad
  _assert_params_close(grads, jgrads, **tol)


def test_quarantined_nan_sample_keeps_the_gradient_finite():
  """Sample 1 has a NaN observation and sample 3 a NaN n-step reward, both
  at weight 0 (replay's quarantine). ble_tpu's loss is finite but its
  gradient is not; the port's loss equals ble_tpu's, and its gradient is
  finite and equals ble_tpu's on the same batch with those samples' inputs
  zeroed."""
  jcfg, cfg = _configs()
  jstate, state = _learners(jcfg, cfg)
  batch = _batch(seed=1)
  batch['weight'] = np.array([1, 0, 1, 0, 1, 1, 1, 1], np.float32)
  batch['obs'][1, 0] = np.nan
  batch['n_step_reward'][3] = np.nan
  jgrads, jmetrics = _jax_grads(jcfg, jstate, batch)
  assert np.isfinite(float(jmetrics['loss']))
  assert not all(np.isfinite(g).all() for g in
                 jax.tree.leaves(jax.tree.map(np.asarray, jgrads)))

  grads, loss, _ = _port_grads(cfg, state, batch)
  np.testing.assert_allclose(float(loss), float(jmetrics['loss']),
                             rtol=1e-5, atol=1e-6)
  assert all(bool(torch.isfinite(g).all()) for g in grads.values())

  zeroed = {k: v.copy() for k, v in batch.items()}
  for i in (1, 3):
    for key in ('obs', 'next_obs', 'n_step_reward', 'bootstrap_discount'):
      zeroed[key][i] = 0.0
  want, _ = _jax_grads(jcfg, jstate, zeroed)
  _assert_params_close(grads, want, rtol=1e-5, atol=1e-6)


def test_quarantine_keeps_the_reference_per_sample_losses_and_priorities():
  """Samples 1 and 3 are quarantined (weight 0 and a NaN), sample 5 has
  weight 0 with finite values (an incoherent window). per_sample_loss is
  non-finite at 1 and 3 in both packages and within rtol 1e-5 / atol 1e-6
  of ble_tpu's elsewhere, sample 5 included; the priorities that
  update_priorities writes from it agree to the same tolerance, 1.0 at the
  quarantined samples."""
  from ble_tpu.agents import replay as jax_replay
  from ble_tpu_torch.agents import replay
  jcfg, cfg = _configs()
  jstate, state = _learners(jcfg, cfg)
  batch = _batch(seed=2)
  batch['weight'] = np.array([1, 0, 1, 0, 1, 0, 1, 1], np.float32)
  batch['obs'][1, 0] = np.nan
  batch['n_step_reward'][3] = np.nan
  _, jmetrics = _jax_grads(jcfg, jstate, batch)
  _, _, metrics = _port_grads(cfg, state, batch)
  want = np.asarray(jmetrics['per_sample_loss'])
  got = metrics['per_sample_loss'].numpy()
  bad = np.array([False, True, False, True, False, False, False, False])
  np.testing.assert_array_equal(~np.isfinite(want), bad)
  np.testing.assert_array_equal(~np.isfinite(got), bad)
  np.testing.assert_allclose(got[~bad], want[~bad], rtol=1e-5, atol=1e-6)

  rcfg = dict(ring_len=8, n_step=3, batch_size=BATCH, prioritized=True)
  jrcfg, rcfg = (jax_replay.ReplayConfig(**rcfg),
                 replay.ReplayConfig(**rcfg))
  env_idx = np.arange(BATCH) % 2
  slot = np.arange(BATCH) // 2
  jring = jax_replay.update_priorities(
      jax_replay.init(2, OBS_DIM, jrcfg), jrcfg, env_idx, slot, want)
  ring = replay.update_priorities(
      replay.init(2, OBS_DIM, rcfg, 'cpu'), rcfg,
      torch.from_numpy(env_idx).long(), torch.from_numpy(slot).long(),
      metrics['per_sample_loss'])
  np.testing.assert_allclose(ring.priority.numpy(),
                             np.asarray(jring.priority), rtol=1e-5, atol=1e-6)
  assert float(ring.priority[1, 0]) == 1.0 == float(ring.priority[1, 1])


def test_train_steps_with_target_sync_match_jax():
  """5 train steps at lr 1e-3 with target_update_period 2: online and
  target parameters after each step within rtol 1e-5 / atol 1e-6 of
  ble_tpu's train_step (optax Adam, eps 2e-5), a new batch each step."""
  jcfg, cfg = _configs(learning_rate=1e-3, target_update_period=2)
  jstate, state = _learners(jcfg, cfg)
  jstep = jax.jit(functools.partial(jax_qrdqn.train_step, jcfg))
  for i in range(5):
    batch = _batch(seed=10 + i)
    jstate, jmetrics = jstep(jstate, batch)
    state, metrics = qrdqn.train_step(cfg, state, _torch_batch(batch))
    assert state.train_steps == int(jstate.train_steps) == i + 1
    np.testing.assert_allclose(float(metrics['loss']),
                               float(jmetrics['loss']), rtol=1e-5)
    _assert_params_close(state.network.named_parameters(), jstate.params,
                         rtol=1e-5, atol=1e-6)
    _assert_params_close(state.target_network.named_parameters(),
                         jstate.target_params, rtol=1e-5, atol=1e-6)
    synced = all(torch.equal(a, b) for a, b in zip(
        state.network.parameters(), state.target_network.parameters()))
    assert synced == ((i + 1) % 2 == 0)


@pytest.mark.parametrize('warmup,decay,final', [
    (3, 10, 0.1), (0, 0, 1.0), (5, 0, 0.5), (0, 12, 0.0), (4, 4, 0.2)])
def test_learning_rate_schedule_matches_optax(warmup, decay, final):
  """learning_rate_at(count) is the rate of ble_tpu's make_optimizer at the
  update after `count` updates, counts 0-20: optax's
  warmup_cosine_decay_schedule read before the increment, or the constant
  rate; rtol 1e-6 (optax evaluates in float32)."""
  _, cfg = _configs(learning_rate=1.0, lr_warmup_steps=warmup,
                    lr_decay_steps=decay, lr_final_scale=final)
  if warmup or decay:
    schedule = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=1.0, warmup_steps=max(warmup, 1),
        decay_steps=max(decay, warmup + 1), end_value=final)
    want = [float(schedule(c)) for c in range(21)]
  else:
    want = [1.0] * 21
  got = [qrdqn.learning_rate_at(cfg, c) for c in range(21)]
  np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
  if (warmup, decay, final) == (3, 10, 0.1):
    np.testing.assert_allclose(got[:5], [0, 1 / 3, 2 / 3, 1, 0.955],
                               atol=1e-3)


def test_scheduled_adam_steps_match_optax():
  """Adam under the warmup schedule: the first update has rate 0, so the
  parameters after one step are the initial ones in both packages; after
  four steps they agree within rtol 1e-5 / atol 1e-6."""
  jcfg, cfg = _configs(learning_rate=1e-3, lr_warmup_steps=2,
                       lr_decay_steps=6, lr_final_scale=0.1)
  jstate, state = _learners(jcfg, cfg)
  initial = {k: v.clone() for k, v in state.network.state_dict().items()}
  jstep = jax.jit(functools.partial(jax_qrdqn.train_step, jcfg))
  for i in range(4):
    batch = _batch(seed=20 + i)
    jstate, _ = jstep(jstate, batch)
    state, _ = qrdqn.train_step(cfg, state, _torch_batch(batch))
    if i == 0:
      for k, v in state.network.state_dict().items():
        assert torch.equal(v, initial[k]), k
  _assert_params_close(state.network.named_parameters(), jstate.params,
                       rtol=1e-5, atol=1e-6)


def test_greedy_select_action_matches_jax():
  """Greedy actions of the same parameters on 64 observations: equal."""
  jcfg, cfg = _configs()
  jstate, state = _learners(jcfg, cfg, obs_dim=1099, seed=3)
  obs = np.random.RandomState(4).rand(64, 1099).astype(np.float32)
  want = np.asarray(jax_qrdqn.select_action(jcfg, jstate.params, obs, None))
  got = qrdqn.select_action(cfg, state.network, torch.from_numpy(obs))
  assert got.dtype == torch.int32
  np.testing.assert_array_equal(got.numpy(), want)
  assert len(set(want.tolist())) > 1


def test_epsilon_greedy_draws_from_the_generator():
  """epsilon 1 gives uniform random actions from the generator (the same
  seed, the same actions; every action about a third of 3000), epsilon 0
  the greedy ones."""
  _, cfg = _configs()
  state = qrdqn.init(torch.Generator().manual_seed(0), cfg, OBS_DIM, 'cpu')
  obs = torch.randn((3000, OBS_DIM), generator=torch.Generator().manual_seed(1))
  greedy = qrdqn.select_action(cfg, state.network, obs)
  a = qrdqn.select_action(cfg, state.network, obs,
                          torch.Generator().manual_seed(2), epsilon=1.0)
  b = qrdqn.select_action(cfg, state.network, obs,
                          torch.Generator().manual_seed(2), epsilon=1.0)
  assert torch.equal(a, b)
  counts = torch.bincount(a.long(), minlength=3)
  assert bool((counts > 900).all()), counts
  assert torch.equal(qrdqn.select_action(
      cfg, state.network, obs, torch.Generator(), epsilon=0.0), greedy)


def test_qrdqn_learner_reduces_loss():
  """tests/test_training.py::test_qrdqn_learner_reduces_loss on the port:
  60 steps at lr 1e-3 on one batch take the loss below 0.9 of its start."""
  _, cfg = _configs(learning_rate=1e-3)
  state = qrdqn.init(torch.Generator().manual_seed(0), cfg, 8, 'cpu')
  rng = np.random.RandomState(0)
  batch = {
      'obs': torch.from_numpy(rng.randn(32, 8).astype(np.float32)),
      'action': torch.from_numpy(rng.randint(0, 3, 32)),
      'n_step_reward': torch.from_numpy(rng.rand(32).astype(np.float32)),
      'bootstrap_discount': torch.zeros((32,)),
      'next_obs': torch.from_numpy(rng.randn(32, 8).astype(np.float32)),
      'weight': torch.ones((32,)),
  }
  losses = []
  for _ in range(60):
    state, metrics = qrdqn.train_step(cfg, state, batch)
    losses.append(float(metrics['loss']))
  assert losses[-1] < losses[0] * 0.9
  assert state.train_steps == 60
