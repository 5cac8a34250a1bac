"""The slice as a whole on the CPU: the trainable agents dqn, mlp, r2d2 and
finetune_perciatelli through the port's actor-learner
(ble_tpu_torch/train/learner.py) against ble_tpu's learner.env_step on
ble_tpu-drawn worlds; tests/test_training.py's agent-generic and r2d2
harness tests re-run on the port; and both CLIs with every agent."""

import dataclasses
import functools
import json
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ble_tpu.agents import dqn as jax_dqn
from ble_tpu.agents import marco_polo as jax_mp
from ble_tpu.agents import qrdqn as jax_qrdqn
from ble_tpu.agents import r2d2 as jax_r2d2
from ble_tpu.agents import replay as jax_replay
from ble_tpu.env import env as jax_env
from ble_tpu.env import wind_gp as jax_gp
from ble_tpu.train import learner as jax_learner
from ble_tpu_torch import bridge
from ble_tpu_torch import config as config_lib
from ble_tpu_torch.agents import dqn
from ble_tpu_torch.agents import qrdqn
from ble_tpu_torch.agents import r2d2
from ble_tpu_torch.agents import replay
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.env import wind_gp
from ble_tpu_torch.train import eval as eval_cli
from ble_tpu_torch.train import learner
from ble_tpu_torch.train import suites
from ble_tpu_torch.train import train as train_cli
from ble_tpu_torch.train import train_lib

E = 8
STEPS = 20
QRDQN = dict(num_layers=2, hidden_units=32, num_atoms=11)
DQN = dict(num_layers=2, hidden_units=32)
R2D2 = dict(hidden_units=24, lstm_units=16, num_atoms=7, seq_len=6,
            burn_in=2)


def _np_dict(obj):
  out = {}
  for f in dataclasses.fields(obj):
    v = getattr(obj, f.name)
    out[f.name] = (_np_dict(v) if dataclasses.is_dataclass(v) else
                   None if v is None else np.array(v))
  return out


def _configs(agent, num_envs, min_history, **kw):
  """ble_tpu's and the port's TrainConfig for `agent` at narrow widths."""
  out = []
  for pkg, q, d, r, rep in (
      (jax_learner, jax_qrdqn, jax_dqn, jax_r2d2, jax_replay),
      (learner, qrdqn, dqn, r2d2, replay)):
    out.append(pkg.TrainConfig(
        agent=agent, num_envs=num_envs,
        qrdqn=q.QrDqnConfig(min_replay_history=min_history, **QRDQN),
        dqn=d.DqnConfig(min_replay_history=min_history, **DQN),
        r2d2=r.R2d2Config(min_replay_history=min_history, **R2D2),
        replay=rep.ReplayConfig(ring_len=32, batch_size=8), **kw))
  return out


@pytest.fixture(scope='module')
def worlds():
  """tests/test_torch_learner.py's worlds: E static-field worlds drawn by
  ble_tpu's reset from PRNGKey(0..E-1) (float32 grid, slab cache on)."""
  params = jax_env.EnvParams(wind_field_f32=True, field_cache=True)
  keys = jnp.stack([jax.random.PRNGKey(s) for s in range(E)])
  reset = jax.jit(jax.vmap(functools.partial(
      jax_env.reset, params=params,
      field_fn=jax_env.make_field_fn('static'))))
  states, obs = reset(keys)
  return params, states, obs


def _load_jax_params(agent, ts, jparams):
  """The port's learner set to ble_tpu's parameters."""
  tree = jax.tree.map(np.asarray, jparams)
  if agent == 'mlp':
    ts.learner.network.load_state_dict(bridge.mlp_params_from_flax(tree))
  elif agent == 'dqn':
    qrdqn.load_params(ts.learner, bridge.mlp_params_from_flax(tree))
  elif agent == 'r2d2':
    qrdqn.load_params(ts.learner, bridge.lstm_quantile_params_from_flax(tree))
  else:
    qrdqn.load_params(ts.learner, bridge.quantile_params_from_flax(tree))


@pytest.mark.parametrize('agent', ['dqn', 'mlp', 'r2d2',
                                   'finetune_perciatelli'])
def test_env_step_matches_jax_learner(worlds, agent, tmp_path, monkeypatch):
  """The slice as a whole for each agent: 20 greedy env_steps on the 8
  worlds (epsilon 0, MarcoPolo off; replay agents with learning off, the
  online mlp learning every step), run_episode_chunk's cadence, against
  ble_tpu's learner.env_step with the same parameters (finetune from the
  same flax blob in $BLE_TPU_MODELS, both packages' finetune init). The
  actions (read from the replay ring), terminals, valid flags, episode
  steps and cursor are equal, rewards within 1e-3 (the golden per-step
  bound), as tests/test_torch_learner.py holds quantile. The mlp network
  after its 20 SGD steps is within 1e-5 of ble_tpu's; r2d2's actor carry
  moved and its lanes agree within 1e-3 on every world but world 5
  (ROADMAP C: world 5's balloon sits at buoyant equilibrium, so its
  observations differ beyond 1e-3)."""
  jparams_env, jstates, jobs = worlds
  jcfg, cfg = _configs(agent, E, 10**6, use_marco_polo=False,
                       epsilon_train=0.0)
  jcore = jax_learner.make_agent_core(jcfg)
  obs_dim = jobs.shape[-1]
  if agent == 'finetune_perciatelli':
    blob = jax_qrdqn.init(jax.random.PRNGKey(1), jcfg.qrdqn, obs_dim).params
    (tmp_path / 'perciatelli44.msgpack').write_bytes(
        flax.serialization.msgpack_serialize(jax.tree.map(np.asarray, blob)))
    monkeypatch.setenv('BLE_TPU_MODELS', str(tmp_path))
  jlearner = jcore.init(jax.random.PRNGKey(1), obs_dim)
  jts = jax_learner.TrainState(
      env_state=jstates, obs=jobs, active=jnp.ones((E,), bool),
      episode_step=jnp.zeros((E,), jnp.int32),
      episode_return=jnp.zeros((E,), jnp.float32),
      mp=jax.vmap(jax_mp.begin_episode)(jax.random.split(
          jax.random.PRNGKey(2), E)),
      learner=jlearner,
      actor=jcore.actor_init(E) if jcore.actor_init is not None else (),
      replay=jax_replay.init(E, obs_dim, jcfg.replay,
                             actor_state_dim=jcore.actor_state_dim),
      key=jax.random.PRNGKey(3), env_steps=jnp.int32(0),
      episodes_done=jnp.int32(0))
  params = env_lib.EnvParams(wind_field_f32=True, field_cache=True)
  ts = learner.train_state_from_envs(
      cfg, bridge.from_dict(env_lib.EnvState, _np_dict(jstates)),
      torch.from_numpy(np.array(jobs)))
  if agent == 'finetune_perciatelli':
    want = bridge.quantile_params_from_flax(jax.tree.map(np.asarray, blob))
    got = ts.learner.network.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
  else:
    _load_jax_params(agent, ts, jlearner.params)

  jstep = jax.jit(functools.partial(jax_learner.env_step, jcfg,
                                    jparams_env))
  jts = jts.replace(env_state=jts.env_state.replace(
      gp=jax.vmap(jax_gp.refresh)(jts.env_state.gp)))
  ts.env_state = dataclasses.replace(
      ts.env_state, gp=wind_gp.refresh(ts.env_state.gp))
  for t in range(STEPS):
    if t % params.field_cache_every == 0:
      jts = jts.replace(env_state=jax_env.refresh_field_cache(jts.env_state))
    jts, jmetrics = jstep(jts)
    ts, metrics = learner.env_step(cfg, params, ts, global_step=t)
    np.testing.assert_allclose(float(metrics['reward']),
                               float(jmetrics['reward']), atol=1e-3)
    assert int(metrics['terminals']) == int(jmetrics['terminals'])
  jrep = jts.replay
  assert ts.replay.total == int(jrep.total) == STEPS
  for name in ('action', 'terminal', 'valid', 'episode_step'):
    np.testing.assert_array_equal(getattr(ts.replay, name).numpy(),
                                  np.asarray(getattr(jrep, name)),
                                  err_msg=name)
  assert len(set(ts.replay.action[:, :STEPS].flatten().tolist())) > 1
  np.testing.assert_array_equal(ts.active.numpy(), np.asarray(jts.active))
  if agent == 'mlp':
    assert ts.learner.train_steps == STEPS
    want = bridge.mlp_params_from_flax(jax.tree.map(
        np.asarray, jts.learner.params))
    for k, v in ts.learner.network.state_dict().items():
      np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5,
                                 atol=1e-5, err_msg=k)
    start = bridge.mlp_params_from_flax(jax.tree.map(np.asarray,
                                                     jlearner.params))
    assert not torch.equal(ts.learner.network.layers[0].weight,
                           start['layers.0.weight'])
  else:
    assert ts.learner.train_steps == int(jts.learner.train_steps) == 0
  if agent == 'r2d2':
    others = np.arange(E) != 5
    for got, want in zip(ts.actor, jts.actor):
      assert float(got.abs().sum()) > 0
      np.testing.assert_allclose(got.numpy()[others],
                                 np.asarray(want)[others], atol=1e-3)


def _harness_config(agent, **kw):
  kw.setdefault('replay', replay.ReplayConfig(ring_len=64, batch_size=8))
  kw.setdefault('samples_per_insert', 8.0)
  return learner.TrainConfig(
      agent=agent, num_envs=4,
      dqn=dqn.DqnConfig(min_replay_history=8, **DQN),
      r2d2=r2d2.R2d2Config(min_replay_history=8, **R2D2), **kw)


@pytest.mark.parametrize('agent', ['dqn', 'mlp'])
def test_agent_generic_harness(agent):
  """tests/test_training.py::test_agent_generic_harness on the port: dqn
  and mlp train end to end through run_episode_chunk (4 envs, 12 steps,
  MarcoPolo on): rewards and losses finite, dqn's train steps taken as
  ble_tpu's formula says, mlp's network moved by its 12 SGD steps, the
  action histogram counting every live env each step, env 0's path."""
  config = _harness_config(agent)
  params = env_lib.EnvParams()
  ts = learner.init_train_state(0, params, env_lib.make_field_fn('static'),
                                config, device='cpu')
  before = ts.learner.network.layers[0].weight.detach().clone()
  ts, metrics = learner.run_episode_chunk(config, params, ts, 12)
  assert ts.env_steps == 12 and ts.replay.total == 12
  assert bool(torch.isfinite(metrics['reward']).all())
  assert bool(torch.isfinite(metrics['loss']).all())
  if agent == 'dqn':
    first = config.dqn.min_replay_history // 4 + config.replay.n_step
    assert ts.learner.train_steps == config.grad_steps_per_env_step() * (
        12 - first) > 0
  else:
    assert ts.learner.train_steps == 12
    assert bool(torch.isfinite(ts.learner.network.layers[0].weight).all())
    assert not torch.equal(ts.learner.network.layers[0].weight, before)
    assert float(metrics['loss'][0]) == 0.0 and bool(
        (metrics['loss'][1:] > 0).all())
  assert tuple(metrics['action_hist'].shape) == (12, 3)
  assert int(metrics['action_hist'].sum()) == 12 * 4
  assert tuple(metrics['path'].shape) == (12, 4)


def test_mlp_selective_reset_drops_pending_lanes():
  """selective_reset runs the online agent's on_reset: the pending SARSA
  lanes of the reset envs are invalid, the others keep theirs."""
  config = _harness_config('mlp')
  params = env_lib.EnvParams()
  field_fn = env_lib.make_field_fn('static')
  ts = learner.init_train_state(0, params, field_fn, config, device='cpu')
  ts, _ = learner.run_episode_chunk(config, params, ts, 3)
  assert bool(ts.learner.p_valid.all())
  ts.active = torch.tensor([False, True, False, True])
  ts, _ = learner.selective_reset(ts, params, field_fn, config)
  assert ts.learner.p_valid.tolist() == [False, True, False, True]


def test_r2d2_harness_end_to_end():
  """tests/test_training.py::test_r2d2_harness_end_to_end on the port: r2d2
  trains through the generic harness with a per-env LSTM carry (4 envs,
  12 steps, batch 4): its train steps, finite losses, a carry that moved;
  a selective reset zeroes the carry lanes of the reset envs only."""
  config = _harness_config(
      'r2d2', replay=replay.ReplayConfig(ring_len=64, batch_size=4))
  params = env_lib.EnvParams()
  field_fn = env_lib.make_field_fn('static')
  ts = learner.init_train_state(0, params, field_fn, config, device='cpu')
  assert all(tuple(c.shape) == (4, 16) for c in ts.actor)
  assert ts.replay.actor_state is None
  ts, metrics = learner.run_episode_chunk(config, params, ts, 12)
  assert ts.env_steps == 12
  first = config.r2d2.min_replay_history // 4 + config.replay.n_step
  # 4 envs x SPI 8 / (batch 4 x 4 trainable steps a window).
  assert config.grad_steps_per_env_step() == 2
  assert ts.learner.train_steps == 2 * (12 - first) > 0
  assert bool(torch.isfinite(metrics['loss']).all())
  assert float(ts.actor[1].abs().sum()) > 0.0
  ts.active = torch.tensor([False, True, False, True])
  ts2, _ = learner.selective_reset(ts, params, field_fn, config)
  h = ts2.actor[1]
  assert not bool(h[0].any()) and not bool(h[2].any())
  assert bool(h[1].any()) and torch.equal(h[1], ts.actor[1][1])


def test_r2d2_stored_state_harness_smoke():
  """tests/test_training.py::test_r2d2_stored_state_harness_smoke on the
  port: with stored-state replay the chunk writes the actor's carries into
  the ring, trains, and the unroll consumes them (on one sampled batch the
  loss from the stored carries differs from the zero-start loss)."""
  config = _harness_config('r2d2', samples_per_insert=6.0)
  config = dataclasses.replace(config, r2d2=dataclasses.replace(
      config.r2d2, stored_state=True))
  params = env_lib.EnvParams()
  ts = learner.init_train_state(0, params, env_lib.make_field_fn('static'),
                                config, device='cpu')
  assert tuple(ts.replay.actor_state.shape) == (4, 64, 32)
  ts, metrics = learner.run_episode_chunk(config, params, ts, 12)
  assert ts.learner.train_steps > 0
  assert bool(torch.isfinite(metrics['loss']).all())
  assert float(ts.replay.actor_state.abs().sum()) > 0.0
  batch = replay.sample_sequence(ts.replay, config.replay,
                                 torch.Generator().manual_seed(5),
                                 config.r2d2.seq_len)
  stored, _ = r2d2.sequence_loss(config.r2d2, ts.learner.network,
                                 ts.learner.target_network, batch)
  batch.pop('start_state')
  zero, _ = r2d2.sequence_loss(config.r2d2, ts.learner.network,
                               ts.learner.target_network, batch)
  assert abs(float(stored.detach()) - float(zero.detach())) > 1e-8


def test_r2d2_eval_policy_carries_its_state():
  """make_eval_policy for r2d2 starts each env from the zero carry and
  threads it: two steps give the actions and carry of the network stepped
  by hand, and the second step's actions differ from a fresh carry's on
  some observation."""
  config = _harness_config('r2d2')
  net = r2d2.make_network(config.r2d2, 1099, torch.Generator().manual_seed(0))
  policy_init, policy_step, policy_draw = learner.make_eval_policy(config,
                                                                   net)
  assert policy_draw is None
  state = policy_init(torch.zeros((64, 2), dtype=torch.int64), 'cpu')
  assert all(tuple(c.shape) == (64, 16) and not bool(c.any()) for c in state)
  obs = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 1099)
                         .astype(np.float32))
  state, a0 = policy_step(state, obs[0], None)
  state, a1 = policy_step(state, obs[1], None)
  with torch.no_grad():
    carry, (q0, _) = net(net.initial_state(64), obs[0])
    carry, (q1, _) = net(carry, obs[1])
    _, (q_fresh, _) = net(net.initial_state(64), obs[1])
  assert torch.equal(a0, q0.argmax(-1).to(torch.int32))
  assert torch.equal(a1, q1.argmax(-1).to(torch.int32))
  assert all(torch.equal(a, b) for a, b in zip(state, carry))
  assert not torch.equal(q1, q_fresh)


def _assert_trees_equal(got, want):
  """Nested dicts, lists and tuples of tensors and plain values, equal leaf
  for leaf."""
  if isinstance(want, dict):
    assert set(got) == set(want)
    for k in want:
      _assert_trees_equal(got[k], want[k])
  elif isinstance(want, (list, tuple)):
    assert len(got) == len(want)
    for g, w in zip(got, want):
      _assert_trees_equal(g, w)
  elif isinstance(want, torch.Tensor):
    assert got.dtype == want.dtype and torch.equal(got, want)
  else:
    assert got == want


SMALL_SETS = {
    'dqn': ['dqn.min_replay_history=8', 'dqn.num_layers=2',
            'dqn.hidden_units=32'],
    'mlp': [],
    'r2d2': ['r2d2.min_replay_history=8', 'r2d2.hidden_units=24',
             'r2d2.lstm_units=16', 'r2d2.num_atoms=7', 'r2d2.seq_len=6',
             'r2d2.burn_in=2'],
    'finetune_perciatelli': ['qrdqn.min_replay_history=8',
                             'qrdqn.num_layers=2', 'qrdqn.hidden_units=32',
                             'qrdqn.num_atoms=11'],
}


@pytest.mark.parametrize('agent', sorted(SMALL_SETS))
def test_train_and_eval_clis_with_each_agent(agent, tmp_path, monkeypatch):
  """`train --agent X` on the CPU (static field, 4 envs, one iteration of
  8 steps) trains and checkpoints; run again with one more iteration it
  resumes from the full checkpoint (the learner state round-trips:
  network, optimizer or SGD lanes, train_steps, r2d2's carry); `eval
  --agent X --checkpoint_dir` evaluates the checkpoint's greedy policy
  (the suite cut to 8 steps here) and writes its results."""
  monkeypatch.setenv('BLE_TPU_MODELS', str(tmp_path / 'no_blob'))
  base = str(tmp_path / 'run')
  sets = ['num_envs=4', 'replay.ring_len=64',
          'replay.batch_size=8'] + SMALL_SETS[agent]
  args = ['--device', 'cpu', '--wind_field', 'static', '--agent', agent,
          '--base_dir', base, '--max_episode_length', '8']
  for item in sets:
    args += ['--set', item]
  ts = train_cli.main(args + ['--num_iterations', '1'])
  assert ts.env_steps == 8 and ts.learner.train_steps > 0
  saved = train_lib.train_state_dict(ts)
  config = config_lib.apply_overrides(learner.TrainConfig(agent=agent), sets)
  restored, it = train_lib.restore_latest_checkpoint(
      base, learner.train_state_from_envs(config, ts.env_state, ts.obs,
                                          seed=3))
  assert it == 0
  got = train_lib.train_state_dict(restored)
  for key in ('learner', 'actor', 'replay', 'env_steps'):
    _assert_trees_equal(got[key], saved[key])
  ts2 = train_cli.main(args + ['--num_iterations', '2'])
  assert ts2.env_steps == 16 and ts2.replay.total == 16
  assert ts2.learner.train_steps > ts.learner.train_steps

  monkeypatch.setattr(eval_cli.suites, 'get_eval_suite',
                      lambda name: suites.EvaluationSuite([0, 1], 8))
  out_dir = str(tmp_path / 'eval')
  eval_cli.main(['--agent', agent, '--checkpoint_dir', base,
                 '--suite', 'micro_eval', '--wind_field', 'static',
                 '--device', 'cpu', '--output_dir', out_dir])
  with open(os.path.join(out_dir, f'{agent}_micro_eval.json')) as f:
    results = json.load(f)['results']
  assert [r['seed'] for r in results] == [0, 1]
  assert all(r['final_timestep'] == 8 for r in results)
  with pytest.raises(ValueError, match='checkpoint_dir'):
    eval_cli.make_policy_fns(agent if agent != 'finetune_perciatelli'
                             else 'dqn', device='cpu')


def test_eval_cli_perciatelli_agents_from_a_blob(tmp_path, monkeypatch):
  """`eval --agent perciatelli44` and `--agent finetune_perciatelli` with
  no checkpoint evaluate the blob in $BLE_TPU_MODELS; without a blob both
  raise FileNotFoundError, as ble_tpu's eval does."""
  jparams = jax_qrdqn.init(jax.random.PRNGKey(0),
                           jax_qrdqn.QrDqnConfig(**QRDQN), 1099).params
  (tmp_path / 'perciatelli44.msgpack').write_bytes(
      flax.serialization.msgpack_serialize(jax.tree.map(np.asarray, jparams)))
  monkeypatch.setenv('BLE_TPU_MODELS', str(tmp_path))
  monkeypatch.setattr(eval_cli.suites, 'get_eval_suite',
                      lambda name: suites.EvaluationSuite([0], 4))
  for agent in ('perciatelli44', 'finetune_perciatelli'):
    eval_cli.main(['--agent', agent, '--suite', 'micro_eval',
                   '--wind_field', 'static', '--device', 'cpu',
                   '--output_dir', str(tmp_path / 'eval')])
    assert os.path.exists(tmp_path / 'eval' / f'{agent}_micro_eval.json')
  monkeypatch.setenv('BLE_TPU_MODELS', str(tmp_path / 'empty'))
  for agent in ('perciatelli44', 'finetune_perciatelli'):
    with pytest.raises(FileNotFoundError):
      eval_cli.make_policy_fns(agent, device='cpu')
