"""The train step's CUDA graphs: replay.sample's `_SampleGraph` and
qrdqn.train_step's `_TrainGraph`.

Everywhere the graphs cannot serve (the CPU, a `grad_transform`, a
prioritized ring, dqn and r2d2), learner.learn runs the eager path and
gives its numbers bit for bit, and the tracer's counters say so. On the
card, the graphed train steps are held against the eager path from the
same state. The tests marked `chip` need a card and skip without one; run
them on the card from the repository's root with

  python -m pytest --noconftest -p no:cacheprovider -m chip \\
      tests/test_torch_train_graph.py -q

(`--noconftest`: tests/conftest.py imports JAX, which this file does not
need.)
"""

import contextlib
import copy
import dataclasses

import pytest
import torch

from ble_tpu_torch.agents import dqn
from ble_tpu_torch.agents import qrdqn
from ble_tpu_torch.agents import r2d2
from ble_tpu_torch.agents import replay
from ble_tpu_torch.train import learner
from ble_tpu_torch.utils import profiling

_GRAPH_COUNTERS = ('replay.graph_captures', 'replay.graph_replays',
                   'qrdqn.graph_captures', 'qrdqn.graph_replays')
# chip_smoke.py's limits for one train step on the card against the CPU
# (TRAIN_PARAM_RTOL, TRAIN_UPDATE_RTOL), applied here to a graphed step
# against the eager one from the same state.
_PARAM_RTOL, _UPDATE_RTOL = 1e-5, 1e-3


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card')
  return torch.device('cuda')


def _config(agent='quantile', num_envs=4, prioritized=False, small=True,
            **qrdqn_kw):
  """A TrainConfig whose learn() takes num_envs * 8 / batch_size train
  steps; at small widths unless `small` is False."""
  widths = dict(num_layers=2, hidden_units=32, num_atoms=11) if small else {}
  cfg = learner.TrainConfig(
      agent=agent, num_envs=num_envs,
      replay=replay.ReplayConfig(ring_len=64, batch_size=8 if small else 32,
                                 prioritized=prioritized),
      qrdqn=qrdqn.QrDqnConfig(**widths, **qrdqn_kw))
  if small:
    cfg = dataclasses.replace(
        cfg, dqn=dqn.DqnConfig(num_layers=2, hidden_units=32),
        r2d2=r2d2.R2d2Config(hidden_units=32, lstm_units=16, num_atoms=11,
                             seq_len=6, burn_in=2))
  return cfg


def _ring(config, obs_dim, device, steps=40, seed=0):
  """A ring after `steps` lockstep adds of random transitions, with
  episodes ending at random (a terminal in about one step of 20)."""
  g = torch.Generator().manual_seed(seed)
  n = config.num_envs
  ring = replay.init(n, obs_dim, config.replay, device)
  episode_step = torch.zeros((n,), dtype=torch.int32)
  for _ in range(steps):
    terminal = torch.rand((n,), generator=g) < 0.05
    step = (torch.randn((n, obs_dim), generator=g),
            torch.randint(0, 3, (n,), generator=g, dtype=torch.int32),
            torch.rand((n,), generator=g), terminal,
            torch.ones((n,), dtype=torch.bool), episode_step)
    replay.add(ring, config.replay, *(x.to(device) for x in step))
    episode_step = torch.where(terminal, 0, episode_step + 1)
  return ring


def _eager_learn(config, core, state, ring, generator, grad_transform=None):
  """learner.learn as the eager path runs it: sample_from_draws (or the
  sequence sample) on draw's numbers, and for QR-DQN train_step's eager
  body, quantile_loss and optimizer_step. Returns the mean loss, summed
  in learn's order."""
  total = None
  n = config.grad_steps_per_env_step()
  for _ in range(n):
    if core.sample_kind == 'sequence':
      batch = replay.sample_sequence_from_draws(
          ring, config.replay, core.seq_len,
          **replay.draw_sequence(ring, config.replay, generator))
    else:
      batch = replay.sample_from_draws(
          ring, config.replay, **replay.draw(ring, config.replay, generator))
    if core.name == 'quantile':
      loss, metrics = qrdqn.quantile_loss(config.qrdqn, state.network,
                                          state.target_network, batch)
      qrdqn.optimizer_step(
          state, loss, qrdqn.learning_rate_at(config.qrdqn,
                                              state.train_steps),
          config.qrdqn.target_update_period, grad_transform)
      metrics['loss'] = loss.detach()
    else:
      state, metrics = core.train_step(state, batch, grad_transform)
    if config.replay.prioritized:
      replay.update_priorities(ring, config.replay, batch['env_idx'],
                               batch['slot'], metrics['per_sample_loss'])
    total = (metrics['loss'].clone() if total is None
             else total + metrics['loss'])
  return total / n


def _pair(config, device, obs_dim=12, seed=0):
  """The same learner, ring and generator twice over."""
  core = learner.make_agent_core(config)
  state = core.init(torch.Generator().manual_seed(seed), obs_dim, device)
  ring = _ring(config, obs_dim, device, seed=seed)
  make = lambda: (copy.deepcopy(state), copy.deepcopy(ring),
                  torch.Generator(device).manual_seed(seed + 1))
  return core, make(), make()


def _moments(state, key):
  return [state.optimizer.state[p][key] for p in state.network.parameters()
          if p.requires_grad]


def _assert_same_bits(a, b):
  assert a.network.state_dict().keys() == b.network.state_dict().keys()
  for x, y in zip(a.network.state_dict().values(),
                  b.network.state_dict().values()):
    assert torch.equal(x, y)
  for x, y in zip(a.target_network.parameters(),
                  b.target_network.parameters()):
    assert torch.equal(x, y)
  for key in ('exp_avg', 'exp_avg_sq'):
    for x, y in zip(_moments(a, key), _moments(b, key)):
      assert torch.equal(x, y)
  assert a.train_steps == b.train_steps


@contextlib.contextmanager
def _counting():
  """The tracer on, from a fresh start; yields the dict that gets its
  counters at the end."""
  out = {}
  profiling.enable()
  profiling.take()
  try:
    yield out
    out.update(profiling.take()['counters'])
  finally:
    profiling.disable()


def _learn_both(config, device, grad_transform=None, calls=2):
  """learner.learn `calls` times, tracer on, against the eager path from
  the same start: (counters, means, eager means, the two learners, rings
  and generators)."""
  core, (state, ring, gen), (e_state, e_ring, e_gen) = _pair(config, device)
  with _counting() as counters:
    means = [learner.learn(config, core, state, ring, gen,
                           grad_transform)[1] for _ in range(calls)]
  eager = [_eager_learn(config, core, e_state, e_ring, e_gen, grad_transform)
           for _ in range(calls)]
  return counters, means, eager, (state, e_state), (ring, e_ring), (gen,
                                                                    e_gen)


# Where the graphs cannot serve: (agent, prioritized, grad_transform).
_EAGER_CASES = {
    'quantile': ('quantile', False, False),
    'quantile_grad_transform': ('quantile', False, True),
    'quantile_prioritized': ('quantile', True, False),
    'dqn': ('dqn', False, False),
    'r2d2': ('r2d2', False, False),
}


def _scale_grads(grads):
  """A grad_transform that changes the step, as an all-reduce's mean over
  ranks would: the eager path must apply it."""
  for g in grads:
    g.mul_(0.5)


def _check_eager_case(case, device):
  agent, prioritized, with_transform = _EAGER_CASES[case]
  config = _config(agent, prioritized=prioritized)
  transform = _scale_grads if with_transform else None
  counters, means, eager, (state, e_state), (ring, e_ring), (gen, e_gen) = (
      _learn_both(config, device, transform))
  for m, e in zip(means, eager):
    assert torch.equal(m, e)
  _assert_same_bits(state, e_state)
  assert torch.equal(ring.priority, e_ring.priority)
  assert torch.equal(gen.get_state(), e_gen.get_state())
  assert counters.get('qrdqn.graph_replays', 0) == 0
  assert counters.get('qrdqn.graph_captures', 0) == 0
  return config, counters


@pytest.mark.parametrize('case', sorted(_EAGER_CASES))
def test_graphs_stay_off_on_the_cpu_and_learn_is_the_eager_path(case):
  """On the CPU no graph is made: learn()'s means, the networks, Adam's
  moments, the ring's priorities and the generator equal the eager
  path's bit for bit, and the counters count each QR-DQN train step as
  eager with its reason (grad_transform before the device); dqn and r2d2
  never reach QR-DQN's train step."""
  config, counters = _check_eager_case(case, 'cpu')
  steps = 2 * config.grad_steps_per_env_step()
  assert all(counters.get(k, 0) == 0 for k in _GRAPH_COUNTERS)
  agent, _, with_transform = _EAGER_CASES[case]
  if agent != 'quantile':
    assert not any(k.startswith('qrdqn.graph') for k in counters)
    return
  reason = 'grad_transform' if with_transform else 'device'
  assert counters['qrdqn.graph_eager'] == steps
  assert counters[f'qrdqn.graph_eager.{reason}'] == steps


def test_sample_graph_serves_only_a_uniform_ring_on_the_card():
  """replay._sample_graph declines a ring on the CPU and a prioritized
  ring."""
  config = _config()
  ring = _ring(config, 12, 'cpu')
  gen = torch.Generator().manual_seed(0)
  assert replay._sample_graph(ring, config.replay, gen) is None
  prioritized = _config(prioritized=True)
  assert replay._sample_graph(_ring(prioritized, 12, 'cpu'),
                              prioritized.replay, gen) is None


# ------------------------------------------------------------- the card --

@pytest.mark.chip
@pytest.mark.parametrize('case', sorted(set(_EAGER_CASES) - {'quantile'}))
def test_card_graphs_stay_off_where_they_cannot_serve(card, case):
  """On the card, with a grad_transform, a prioritized ring, dqn or r2d2,
  QR-DQN's train graph is never made and learn() is the eager path bit
  for bit. A uniform ring's sample graph serves any agent's n-step sample
  (its batch is the eager one, bit for bit); r2d2's sequence sample and a
  prioritized ring stay eager."""
  config, counters = _check_eager_case(case, card)
  agent, prioritized, _ = _EAGER_CASES[case]
  if prioritized or agent == 'r2d2':
    assert counters.get('replay.graph_replays', 0) == 0
  else:
    assert counters['replay.graph_replays'] == (
        2 * config.grad_steps_per_env_step())


def _eager_twin_step(config, state, batch):
  """The eager path's train step (train_step's eager body) on a copy of
  `state`: (the copy, its loss)."""
  twin = copy.deepcopy(state)
  loss, _ = qrdqn.quantile_loss(config, twin.network, twin.target_network,
                                batch)
  qrdqn.optimizer_step(twin, loss,
                       qrdqn.learning_rate_at(config, twin.train_steps),
                       config.target_update_period)
  return twin, loss.detach()


def _assert_same_step(state, loss, twin, twin_loss, start):
  """A train step against the eager twin's from the same state (`start`,
  the parameters before): the loss, the gradients and Adam's moments bit
  for bit; the parameters (largest gap over the largest value), their
  change (gap norm over the twin's change norm) and the target network to
  chip_smoke's limits; train_steps equal."""
  assert torch.equal(loss, twin_loss)
  with torch.no_grad():
    for p, e, s in zip(state.network.parameters(), twin.network.parameters(),
                       start):
      assert torch.equal(p.grad, e.grad)
      assert (p - e).abs().max() <= _PARAM_RTOL * e.abs().max()
      change = (e.double() - s).norm()
      assert (p.double() - e.double()).norm() <= _UPDATE_RTOL * change
    for p, e in zip(state.target_network.parameters(),
                    twin.target_network.parameters()):
      assert (p - e).abs().max() <= _PARAM_RTOL * e.abs().max()
  for key in ('exp_avg', 'exp_avg_sq'):
    for m, e in zip(_moments(state, key), _moments(twin, key)):
      assert torch.equal(m, e)
  assert state.train_steps == twin.train_steps


def _held_train_step(config, e_ring, e_gen):
  """qrdqn.train_step checked at every call against the eager path: the
  batch bit for bit against an eager sample of the twin ring and
  generator, and the step against an eager step from the same state
  (_assert_same_step). Keeps each step's loss."""
  original = qrdqn.train_step
  losses = []

  def train_step(cfg, state, batch, grad_transform=None):
    want = replay.sample_from_draws(
        e_ring, config.replay, **replay.draw(e_ring, config.replay, e_gen))
    assert all(torch.equal(batch[k], want[k]) for k in want)
    start = [p.detach().double().clone() for p in state.network.parameters()]
    twin, twin_loss = _eager_twin_step(cfg, state, want)
    state, metrics = original(cfg, state, batch, grad_transform)
    _assert_same_step(state, metrics['loss'], twin, twin_loss, start)
    losses.append(metrics['loss'].clone())
    return state, metrics
  return train_step, losses


@pytest.mark.chip
def test_card_graphs_match_the_eager_path(card, monkeypatch):
  """250 train steps through learn() at the benchmark's widths (8 x 600,
  51 atoms, batch 32, 1099 features) under a warmup and cosine schedule,
  across two target syncs, each held against the eager path's step from
  the same state: batch, loss, gradients and Adam's moments bit for bit;
  parameters, change and target network to chip_smoke's one-step limits,
  since the graphed Adam is torch's capturable one, which orders the
  update's float32 arithmetic otherwise than the eager one. learn()'s mean is the mean of the steps' losses,
  bit for bit; one capture of each graph, then replays."""
  config = _config(num_envs=500, small=False, lr_warmup_steps=20,
                   lr_decay_steps=400)
  core, (state, ring, gen), (_, e_ring, e_gen) = _pair(config, card,
                                                        obs_dim=1099)
  train_step, losses = _held_train_step(config, e_ring, e_gen)
  monkeypatch.setattr(qrdqn, 'train_step', train_step)
  with _counting() as counters:
    means = [learner.learn(config, core, state, ring, gen)[1]
             for _ in range(2)]
  n = config.grad_steps_per_env_step()
  assert n == 125 and state.train_steps == 2 * n
  for k, mean in enumerate(means):
    total = losses[k * n].clone()
    for loss in losses[k * n + 1:(k + 1) * n]:
      total = total + loss
    assert torch.equal(mean, total / n)
  assert torch.equal(gen.get_state(), e_gen.get_state())
  assert counters['replay.graph_captures'] == 1
  assert counters['replay.graph_replays'] == 2 * n
  assert counters['qrdqn.graph_captures'] == 1
  assert counters['qrdqn.graph_replays'] == 2 * n - 1
  assert counters['qrdqn.graph_eager'] == counters[
      'qrdqn.graph_eager.warmup'] == 1


@pytest.mark.chip
def test_card_graph_takes_batches_drawn_outside_it(card):
  """The benchmark check's pattern: between sample-graph batches, batches
  from an eager draw and sample_from_draws go into the graphed train
  step, which copies them into its inputs. Each step is held against the
  eager path's as in test_card_graphs_match_the_eager_path, and the
  generators' next draws agree. The graph is captured once, at the first
  sample-graph batch after Adam's first step: steps 0 (Adam's first), 1
  and 2 (batches from outside, no graph yet) run eager."""
  config = _config(num_envs=16, small=False)
  _, (state, ring, gen), (_, e_ring, e_gen) = _pair(config, card,
                                                    obs_dim=1099)
  train_step, _ = _held_train_step(config, e_ring, e_gen)
  with _counting() as counters:
    for step in range(24):
      if step % 4 in (1, 2):
        batch = replay.sample_from_draws(
            ring, config.replay, **replay.draw(ring, config.replay, gen))
        assert not isinstance(batch, replay.GraphBatch)
      else:
        batch = replay.sample(ring, config.replay, gen)
      train_step(config.qrdqn, state, batch)
  assert torch.equal(replay.draw(ring, config.replay, gen)['env_idx'],
                     replay.draw(e_ring, config.replay, e_gen)['env_idx'])
  assert counters['qrdqn.graph_captures'] == 1
  assert counters['qrdqn.graph_replays'] == 21
  assert counters['qrdqn.graph_eager.warmup'] == 1
  assert counters['qrdqn.graph_eager.batch'] == 2
