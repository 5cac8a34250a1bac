"""The port's recurrent learner (ble_tpu_torch/agents/r2d2.py,
networks.LstmQuantileNetwork and replay's sequence sample) against the
benchmark's plain reference (portbench/reference/r2d2.py: the LSTM cell
written out, no port code and no JAX) on seeded random weights at a small
size: an unroll, one actor step from a non-zero carry, the sequence
sample from draws, sequence_loss and its gradient with burn-in, and three
Adam steps across a target sync. Floats within rtol 1e-5 / atol 1e-6,
the windows exact."""

import ast
import os

import pytest
import torch

from ble_tpu_torch.agents import r2d2
from ble_tpu_torch.agents import replay
from portbench.reference import r2d2 as ref

OBS_DIM, B, L, BURN_IN = 16, 4, 6, 2
SMALL = dict(num_atoms=5, torso_layers=2, hidden_units=24, lstm_units=8,
             seq_len=L, burn_in=BURN_IN, learning_rate=1e-3,
             target_update_period=2)
TOL = dict(rtol=1e-5, atol=1e-6)
FROZEN = 'lstm.bias_ih_l0'


def _config(**kw):
  return r2d2.R2d2Config(**dict(SMALL, **kw))


def _network(config, seed=0):
  """The port's network with every parameter drawn from the seed, biases
  included (the input-side LSTM bias stays a frozen zero)."""
  net = r2d2.make_network(config, OBS_DIM)
  gen = torch.Generator().manual_seed(seed)
  with torch.no_grad():
    for name, p in net.named_parameters():
      if name != FROZEN:
        p.copy_(0.3 * torch.randn(p.shape, generator=gen))
  return net


def _params(net):
  """The reference's network holding the port network's parameters."""
  return ref.from_leaves(
      [p.detach().clone() for n, p in net.named_parameters()
       if n != FROZEN],
      len(net.torso))


def _cfg(config):
  return {k: getattr(config, k) for k in (
      'num_actions', 'gamma', 'kappa', 'burn_in', 'learning_rate',
      'adam_eps', 'target_update_period')}


def _batch(seed, bad=False):
  gen = torch.Generator().manual_seed(seed)
  batch = {
      'obs': torch.randn((B, L + 1, OBS_DIM), generator=gen),
      'action': torch.randint(0, 3, (B, L + 1), generator=gen,
                              dtype=torch.int32),
      'reward': torch.rand((B, L + 1), generator=gen),
      'terminal': torch.rand((B, L + 1), generator=gen) < 0.15,
      'step_weight': (torch.rand((B, L), generator=gen) < 0.8).to(
          torch.float32),
  }
  if bad:  # Non-finite inputs, which both sides zero.
    batch['obs'][1, 3, 2] = float('nan')
    batch['reward'][2, 4] = float('inf')
  return batch


@pytest.mark.parametrize('duelling', [True, False])
def test_unroll_matches_the_reference(duelling):
  config = _config(duelling=duelling)
  net = _network(config)
  obs = _batch(0)['obs']
  gen = torch.Generator().manual_seed(5)
  carry = tuple(torch.randn((B, config.lstm_units), generator=gen)
                for _ in range(2))
  with torch.no_grad():
    (c, h), (q, logits) = net.unroll(carry, obs)
  (rc, rh), quantiles, values = ref.unroll(_params(net), obs, carry,
                                           config.num_actions)
  torch.testing.assert_close(logits, quantiles, **TOL)
  torch.testing.assert_close(q, values, **TOL)
  torch.testing.assert_close(c, rc, **TOL)
  torch.testing.assert_close(h, rh, **TOL)


@pytest.mark.parametrize('duelling', [True, False])
def test_actor_step_from_a_carry_matches_the_reference(duelling):
  config = _config(duelling=duelling)
  net = _network(config, seed=1)
  gen = torch.Generator().manual_seed(7)
  obs = torch.randn((B, OBS_DIM), generator=gen)
  carry = tuple(torch.randn((B, config.lstm_units), generator=gen)
                for _ in range(2))
  (c, h), actions = r2d2.actor_select(config, net, carry, obs)
  (rc, rh), _, q = ref.step(_params(net), obs, carry, config.num_actions)
  torch.testing.assert_close(c, rc, **TOL)
  torch.testing.assert_close(h, rh, **TOL)
  assert torch.equal(actions.to(torch.int64), q.argmax(dim=-1))


def _ring(steps, ring_len=16, envs=3, nan_at=None):
  """A replay ring after `steps` lockstep adds: env 0's episode ends at
  step 4 (frozen two steps, writing invalid slots, then a new episode),
  env 1 runs on, env 2 is truncated every 5 steps."""
  config = replay.ReplayConfig(ring_len=ring_len, n_step=1, batch_size=8)
  state = replay.init(envs, OBS_DIM, config, 'cpu')
  gen = torch.Generator().manual_seed(3)
  ep = torch.zeros(envs, dtype=torch.int32)
  for t in range(steps):
    phase = t % 7
    active = torch.tensor([phase < 5, True, True])
    terminal = torch.tensor([phase == 4, False, False])
    obs = torch.randn((envs, OBS_DIM), generator=gen)
    if nan_at == t:
      obs[1, 0] = float('nan')
    replay.add(state, config, obs,
               torch.randint(0, 3, (envs,), generator=gen, dtype=torch.int32),
               torch.rand((envs,), generator=gen), terminal, active,
               torch.where(active, ep, 0))
    ep = torch.where(active, ep + 1, 0)
    ep[0] = 0 if phase >= 4 else ep[0]
    ep[2] = 0 if t % 5 == 4 else ep[2]
  return state, config


@pytest.mark.parametrize('steps,nan_at', [(9, None), (23, None), (40, 30)],
                         ids=['unwritten', 'wrapped', 'non_finite'])
def test_sequence_sample_matches_the_reference(steps, nan_at):
  state, config = _ring(steps, nan_at=nan_at)
  gen = torch.Generator().manual_seed(11)
  draws = replay.draw_sequence(state, config, gen)
  got = replay.sample_sequence_from_draws(state, config, L, **draws)
  ring = {k: getattr(state, k)[draws['env_idx']] for k in (
      'obs', 'action', 'reward', 'terminal', 'valid', 'episode_step')}
  want = ref.sequence_sample(ring, draws, state.total, config.ring_len, L)
  assert set(want) < set(got)
  for k, v in want.items():
    assert torch.equal(got[k].to(v.dtype), v) or (
        k == 'obs' and torch.equal(got[k].nan_to_num(), v.nan_to_num())), k
  assert 0 < float(want['step_weight'].sum()) < want['step_weight'].numel()


@pytest.mark.parametrize('burn_in,bad', [(0, False), (BURN_IN, False),
                                         (BURN_IN, True)],
                         ids=['no_burn_in', 'burn_in', 'non_finite'])
def test_sequence_loss_and_gradient_match_the_reference(burn_in, bad):
  config = _config(burn_in=burn_in)
  net, target = _network(config, seed=2), _network(config, seed=3)
  batch = _batch(4, bad=bad)
  loss, _ = r2d2.sequence_loss(config, net, target, batch)
  loss.backward()
  params = _params(net)
  flat = [t.clone().requires_grad_(True) for t in ref.leaves(params)]
  want = ref.sequence_loss(ref.from_leaves(flat, 2), _params(target), batch,
                           _cfg(config))
  grads = torch.autograd.grad(want, flat)
  torch.testing.assert_close(loss.detach(), want.detach(), **TOL)
  got = [p.grad for n, p in net.named_parameters() if n != FROZEN]
  assert net.lstm.bias_ih_l0.grad is None
  for g, w in zip(got, grads):
    torch.testing.assert_close(g, w, **TOL)
  assert float(loss.detach()) > 0


@pytest.mark.parametrize('duelling', [True, False])
def test_train_steps_across_a_target_sync_match_the_reference(duelling):
  config = _config(duelling=duelling)
  state = r2d2.init(torch.Generator().manual_seed(0), config, OBS_DIM, 'cpu')
  start = _params(state.network)
  batches = [_batch(10 + k) for k in range(3)]
  losses = []
  for batch in batches:
    state, metrics = r2d2.train_step(config, state, batch)
    losses.append(float(metrics['loss']))
  assert state.train_steps == 3
  want_losses, _, after, target = ref.train(start, batches, _cfg(config))
  torch.testing.assert_close(torch.tensor(losses), torch.tensor(want_losses),
                             **TOL)
  got = [p.detach() for n, p in state.network.named_parameters()
         if n != FROZEN]
  got_target = [p for n, p in state.target_network.named_parameters()
                if n != FROZEN]
  for g, g_t, w, w_t, s in zip(got, got_target, after, target,
                               ref.leaves(start)):
    torch.testing.assert_close(g - s, w - s, **TOL)
    # The sync after step 2 holds the online network of step 2, not 3.
    torch.testing.assert_close(g_t - s, w_t - s, **TOL)
  assert not torch.equal(got[0], got_target[0])


def test_reference_imports_nothing_of_the_port_or_jax():
  path = os.path.join(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))), 'portbench', 'reference', 'r2d2.py')
  with open(path) as f:
    tree = ast.parse(f.read())
  tops = set()
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      tops |= {a.name.split('.')[0] for a in node.names}
    elif isinstance(node, ast.ImportFrom):
      tops.add(node.module.split('.')[0])
  assert tops == {'torch'}
  # The cell is written out: no nn.LSTM / nn.LSTMCell (cuDNN on the card).
  assert not any(isinstance(n, ast.Attribute)
                 and n.attr.startswith('LSTM') for n in ast.walk(tree))
