"""The port's recurrent learner (ble_tpu_torch/agents/r2d2.py and
networks.LstmQuantileNetwork) against ble_tpu.agents.r2d2 on the same
parameters and windows: the network's unroll against flax's step by step,
sequence_loss with burn-in (loss, metrics, gradients), the eta priority
mix, stored-state starts, Adam steps with the target sync, the actor's
select and reset, and the quarantine departure. Parameters cross with
bridge.lstm_quantile_params_from_flax; forward within 1e-5, loss, metrics
and gradients within rtol 1e-5 / atol 1e-6."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ble_tpu.agents import networks as jax_networks
from ble_tpu.agents import r2d2 as jax_r2d2
from ble_tpu_torch import bridge
from ble_tpu_torch.agents import networks
from ble_tpu_torch.agents import qrdqn
from ble_tpu_torch.agents import r2d2

OBS_DIM = 5
B, L = 8, 6
TOL = dict(rtol=1e-5, atol=1e-6)
SMALL = dict(hidden_units=24, lstm_units=16, num_atoms=7, seq_len=L,
             burn_in=2)


def _configs(**kw):
  kw = dict(SMALL, **kw)
  return jax_r2d2.R2d2Config(**kw), r2d2.R2d2Config(**kw)


def _params(tree, torso_layers=2):
  return bridge.lstm_quantile_params_from_flax(
      jax.tree.map(np.asarray, tree), torso_layers)


def _learners(jcfg, cfg, seed=0):
  jstate = jax_r2d2.init(jax.random.PRNGKey(seed), jcfg, OBS_DIM)
  state = r2d2.init(torch.Generator().manual_seed(0), cfg, OBS_DIM, 'cpu')
  qrdqn.load_params(state, _params(jstate.params))
  return jstate, state


def _batch(seed=0, stored=False):
  rng = np.random.RandomState(seed)
  batch = {
      'obs': rng.randn(B, L + 1, OBS_DIM).astype(np.float32),
      'action': rng.randint(0, 3, (B, L + 1)).astype(np.int32),
      'reward': rng.rand(B, L + 1).astype(np.float32),
      'terminal': rng.rand(B, L + 1) < 0.1,
      'step_weight': (rng.rand(B, L) < 0.8).astype(np.float32),
  }
  if stored:
    batch['start_state'] = rng.randn(B, 2 * SMALL['lstm_units']).astype(
        np.float32)
  return batch


def _torch_batch(batch):
  return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jax_grads(jcfg, jstate, batch):
  return jax.grad(lambda p: jax_r2d2.sequence_loss(
      jcfg, p, jstate.target_params, batch), has_aux=True)(jstate.params)


def _port_grads(cfg, state, batch):
  state.network.zero_grad(set_to_none=True)
  loss, metrics = r2d2.sequence_loss(cfg, state.network, state.target_network,
                                     _torch_batch(batch))
  loss.backward()
  return ({name: p.grad.clone() for name, p in
           state.network.named_parameters() if p.requires_grad},
          loss.detach(), metrics)


def _assert_params_close(got, flax_params, **tol):
  """Every trained tensor of `got` (name -> tensor) against flax's; the
  frozen input-side LSTM bias is zero."""
  want = _params(flax_params)
  got = dict(got)
  if 'lstm.bias_ih_l0' in got:
    assert not bool(got.pop('lstm.bias_ih_l0').any())
  want.pop('lstm.bias_ih_l0')
  assert set(got) == set(want)
  for name in want:
    np.testing.assert_allclose(got[name].detach().numpy(),
                               want[name].numpy(), err_msg=name, **tol)


@pytest.mark.parametrize('duelling', [True, False])
def test_unroll_matches_flax_step_by_step(duelling):
  """The network over a (4, 6) window from a random carry: logits, q and
  the final carry (c, h) within 1e-5 of flax's LstmQuantileNetwork applied
  step by step; forward() is one such step."""
  net = jax_networks.LstmQuantileNetwork(hidden_units=24, lstm_units=16,
                                         num_atoms=7, duelling=duelling)
  rng = np.random.RandomState(0)
  carry = tuple(rng.randn(4, 16).astype(np.float32) for _ in range(2))
  params = net.init(jax.random.PRNGKey(1), carry, jnp.zeros((4, OBS_DIM)))
  # Biases away from their zero init, so the bias layout is tested too.
  params = jax.tree.map(lambda p: p + 0.1 * jax.random.normal(
      jax.random.PRNGKey(2), p.shape), params)
  module = networks.lstm_network_from_params(_params(params))
  assert module.duelling == duelling and module.lstm_units == 16
  xs = rng.randn(4, 6, OBS_DIM).astype(np.float32)
  jc, logits, qs = carry, [], []
  for t in range(6):
    jc, (q, lg) = net.apply(params, jc, xs[:, t])
    logits.append(lg)
    qs.append(q)
  tcarry = tuple(map(torch.from_numpy, carry))
  with torch.no_grad():
    (c, h), (q, lg) = module.unroll(tcarry, torch.from_numpy(xs))
    _, (q0, lg0) = module(tcarry, torch.from_numpy(xs[:, 0]))
  tol = dict(rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(lg.numpy(), np.stack(logits, 1), **tol)
  np.testing.assert_allclose(q.numpy(), np.stack(qs, 1), **tol)
  np.testing.assert_allclose(c.numpy(), np.asarray(jc[0]), **tol)
  np.testing.assert_allclose(h.numpy(), np.asarray(jc[1]), **tol)
  np.testing.assert_allclose(lg0.numpy(), np.asarray(logits[0]), **tol)


def test_init_draws_flax_distributions():
  """At full width the port's init has flax's scales: dense kernels
  uniform within sqrt(sqrt(3) / fan_in), the LSTM's input kernels a
  truncated normal of std 1/sqrt(fan_in), each gate's recurrent kernel
  orthogonal, biases zero, the input-side LSTM bias frozen."""
  net = r2d2.make_network(r2d2.R2d2Config(), 1099,
                          torch.Generator().manual_seed(0))
  w0 = net.torso[0].weight.detach()
  assert float(w0.abs().max()) <= (3 ** 0.5 / 1099) ** 0.5
  assert float(w0.abs().max()) > 0.9 * (3 ** 0.5 / 1099) ** 0.5
  wih = net.lstm.weight_ih_l0.detach()
  np.testing.assert_allclose(float(wih.std()), (1 / 600) ** 0.5, rtol=0.05)
  assert float(wih.abs().max()) <= 2 * (1 / 600) ** 0.5 / .8796256 + 1e-6
  for gate in range(4):
    w = net.lstm.weight_hh_l0[gate * 256:(gate + 1) * 256].detach()
    np.testing.assert_allclose((w @ w.T).numpy(), np.eye(256), atol=1e-4)
  assert not net.lstm.bias_ih_l0.requires_grad
  assert not bool(net.lstm.bias_hh_l0.any())
  assert len(net.head) == 3 and net.head[2].out_features == 153


@pytest.mark.parametrize('stored', [False, True])
def test_sequence_loss_metrics_and_grads_match_jax(stored):
  """sequence_loss with burn-in 2 over an 8 x 6 window batch with
  terminals and step weights, from zeros or (stored-state replay) from
  start_state: loss, mean_q, valid_frac, per_sample_loss and every
  gradient within rtol 1e-5 / atol 1e-6 of ble_tpu's, with a target
  network apart from the online one."""
  jcfg, cfg = _configs(stored_state=stored)
  jstate, state = _learners(jcfg, cfg)
  jstate = jstate.replace(target_params=jax.tree.map(
      lambda p: p * 0.9, jstate.target_params))
  state.target_network.load_state_dict(_params(jstate.target_params))
  batch = _batch(stored=stored)
  jgrads, jmetrics = _jax_grads(jcfg, jstate, batch)
  grads, loss, metrics = _port_grads(cfg, state, batch)
  np.testing.assert_allclose(float(loss), float(jmetrics['loss']), **TOL)
  for key in ('loss', 'mean_q', 'valid_frac', 'per_sample_loss'):
    np.testing.assert_allclose(metrics[key].detach().numpy(),
                               np.asarray(jmetrics[key]), err_msg=key, **TOL)
  _assert_params_close(grads, jgrads, **TOL)
  assert float(loss) > 0


def test_sequence_priority_eta_mix():
  """tests/test_training.py::test_r2d2_sequence_priority_eta_mix on the
  port: per-sequence priorities are eta max + (1 - eta) mean of the
  per-step losses; max >= mean, and the mix interpolates (rtol 2e-4)."""
  batch = _torch_batch(_batch(seed=1))
  batch['step_weight'] = torch.ones((B, L))

  def priorities(eta):
    cfg = r2d2.R2d2Config(**dict(SMALL, priority_eta=eta))
    state = r2d2.init(torch.Generator().manual_seed(0), cfg, OBS_DIM, 'cpu')
    _, metrics = r2d2.sequence_loss(cfg, state.network, state.target_network,
                                    batch)
    return metrics['per_sample_loss'].numpy()

  p_mean, p_max, p_mix = priorities(0.0), priorities(1.0), priorities(0.9)
  assert (p_max >= p_mean - 1e-6).all()
  assert (p_max > p_mean + 1e-6).any()
  np.testing.assert_allclose(p_mix, 0.9 * p_max + 0.1 * p_mean, rtol=2e-4)


def test_train_steps_with_target_sync_match_jax():
  """5 train steps at lr 1e-3 with target_update_period 2: online and
  target parameters after each step within rtol 1e-5 / atol 1e-6 of
  ble_tpu's train_step (optax.adam, lax.cond sync), a new batch each
  step; the frozen input-side LSTM bias stays 0."""
  jcfg, cfg = _configs(learning_rate=1e-3, target_update_period=2)
  jstate, state = _learners(jcfg, cfg)
  jstep = jax.jit(functools.partial(jax_r2d2.train_step, jcfg))
  for i in range(5):
    batch = _batch(seed=10 + i)
    jstate, jmetrics = jstep(jstate, batch)
    state, metrics = r2d2.train_step(cfg, state, _torch_batch(batch))
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


def test_r2d2_sequence_loss_reduces():
  """tests/test_training.py::test_r2d2_sequence_loss_reduces on the port:
  50 steps at lr 1e-3 on one batch take the loss below 0.9 of its start;
  the burn-in steps are out of the mask (valid_frac 4/6)."""
  cfg = r2d2.R2d2Config(**dict(SMALL, learning_rate=1e-3,
                               target_update_period=1000))
  state = r2d2.init(torch.Generator().manual_seed(0), cfg, OBS_DIM, 'cpu')
  batch = _torch_batch(_batch(seed=0))
  batch['terminal'] = torch.zeros((B, L + 1), dtype=torch.bool)
  batch['step_weight'] = torch.ones((B, L))
  losses = []
  for _ in range(50):
    state, metrics = r2d2.train_step(cfg, state, batch)
    losses.append(float(metrics['loss']))
  assert losses[-1] < losses[0] * 0.9, (losses[0], losses[-1])
  assert float(metrics['valid_frac']) == pytest.approx(4.0 / 6.0)


def test_actor_select_and_reset_match_jax():
  """Three greedy actor steps over 6 envs from the zero carry: ble_tpu's
  actions and carries (1e-5); actor_reset zeroes exactly the masked
  lanes; carry_to_vec and vec_to_carry invert each other."""
  jcfg, cfg = _configs()
  jstate, state = _learners(jcfg, cfg, seed=4)
  rng = np.random.RandomState(5)
  jcarry = jax_r2d2.actor_init(jcfg, 6)
  carry = r2d2.actor_init(state.network, 6, 'cpu')
  for _ in range(3):
    obs = rng.randn(6, OBS_DIM).astype(np.float32)
    jcarry, jact = jax_r2d2.actor_select(jcfg, jstate.params, jcarry, obs,
                                         None)
    carry, act = r2d2.actor_select(cfg, state.network, carry,
                                   torch.from_numpy(obs))
    assert act.dtype == torch.int32
    np.testing.assert_array_equal(act.numpy(), np.asarray(jact))
    for got, want in zip(carry, jcarry):
      np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                 atol=1e-5)
  mask = np.array([True, False, False, True, False, False])
  reset = r2d2.actor_reset(carry, torch.from_numpy(mask))
  jreset = jax_r2d2.actor_reset(jcarry, jnp.asarray(mask))
  for got, want, before in zip(reset, jreset, carry):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert not bool(got[mask].any())
    assert torch.equal(got[~mask], before[~mask])
  vec = r2d2.carry_to_vec(carry)
  assert tuple(vec.shape) == (6, 32)
  assert all(torch.equal(a, b) for a, b in zip(r2d2.vec_to_carry(vec), carry))


def test_quarantined_window_keeps_loss_and_gradient_finite():
  """A NaN observation at step 3 of window 2 and a NaN reward at step 4 of
  window 5, both where sample_sequence's step weights are 0, with later
  steps of those windows at weight > 0. In ble_tpu the NaN observation
  passes through the LSTM carry into window 2's later steps, so the loss,
  the gradient and window 2's priority are NaN; the NaN reward reaches
  only its own step, at weight 0, so window 5's priority stays finite.
  The port's loss and gradient are finite and equal ble_tpu's on the same
  batch with the NaN values zeroed (rtol 1e-5 / atol 1e-6); its
  priorities are NaN at window 2 alone, as ble_tpu's, and ble_tpu's
  elsewhere."""
  jcfg, cfg = _configs()
  jstate, state = _learners(jcfg, cfg, seed=6)
  batch = _batch(seed=7)
  batch['step_weight'][:] = 1.0
  batch['terminal'][:] = False
  batch['obs'][2, 3, 1] = np.nan
  batch['step_weight'][2, 2:4] = 0.0
  batch['reward'][5, 4] = np.nan
  batch['step_weight'][5, 4] = 0.0
  jgrads, jmetrics = _jax_grads(jcfg, jstate, batch)
  assert np.isnan(float(jmetrics['loss']))
  assert not all(np.isfinite(g).all() for g in
                 jax.tree.leaves(jax.tree.map(np.asarray, jgrads)))

  grads, loss, metrics = _port_grads(cfg, state, batch)
  assert bool(torch.isfinite(loss))
  assert all(bool(torch.isfinite(g).all()) for g in grads.values())
  zeroed = {k: v.copy() for k, v in batch.items()}
  zeroed['obs'][2, 3] = 0.0
  zeroed['reward'][5, 4] = 0.0
  want, want_metrics = _jax_grads(jcfg, jstate, zeroed)
  np.testing.assert_allclose(float(loss), float(want_metrics['loss']), **TOL)
  _assert_params_close(grads, want, **TOL)
  bad = np.zeros(B, bool)
  bad[2] = True
  jpsl = np.asarray(jmetrics['per_sample_loss'])
  psl = metrics['per_sample_loss'].numpy()
  np.testing.assert_array_equal(~np.isfinite(jpsl), bad)
  np.testing.assert_array_equal(~np.isfinite(psl), bad)
  np.testing.assert_allclose(psl[~bad], jpsl[~bad], **TOL)
