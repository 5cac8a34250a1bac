"""The port's actor-learner (ble_tpu_torch/train/learner.py) on the CPU:
the slice as a whole against ble_tpu's learner.env_step on ble_tpu-drawn
worlds with the same carried-across network, a run_episode_chunk smoke run
with learning on, and selective_reset."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ble_tpu.agents import marco_polo as jax_mp
from ble_tpu.agents import qrdqn as jax_qrdqn
from ble_tpu.agents import replay as jax_replay
from ble_tpu.env import env as jax_env
from ble_tpu.env import wind_gp as jax_gp
from ble_tpu.train import learner as jax_learner
from ble_tpu_torch import bridge
from ble_tpu_torch.agents import qrdqn
from ble_tpu_torch.agents import replay
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.env import wind_gp
from ble_tpu_torch.train import learner

E = 8
STEPS = 20


def _np_dict(obj):
  out = {}
  for f in dataclasses.fields(obj):
    v = getattr(obj, f.name)
    out[f.name] = (_np_dict(v) if dataclasses.is_dataclass(v) else
                   None if v is None else np.array(v))
  return out


def _to_port(jstate) -> env_lib.EnvState:
  return bridge.from_dict(env_lib.EnvState, _np_dict(jstate))


def _small_qrdqn(pkg, **kw):
  kw.setdefault('min_replay_history', 8)
  return pkg.QrDqnConfig(num_layers=2, hidden_units=32, num_atoms=11, **kw)


@pytest.fixture(scope='module')
def worlds():
  """tests/test_torch_env.py's worlds: E static-field worlds drawn by
  ble_tpu's reset from PRNGKey(0..E-1) (float32 grid, slab cache on);
  jitted, which compiles faster than the vmap runs op by op."""
  params = jax_env.EnvParams(wind_field_f32=True, field_cache=True)
  keys = jnp.stack([jax.random.PRNGKey(s) for s in range(E)])
  reset = jax.jit(jax.vmap(functools.partial(
      jax_env.reset, params=params,
      field_fn=jax_env.make_field_fn('static'))))
  states, obs = reset(keys)
  return params, states, obs


def test_env_step_matches_jax_learner(worlds):
  """The slice as a whole: 20 greedy env_steps on the 8 worlds with the
  same 2 x 32 network, MarcoPolo off and learning off (min_replay_history
  beyond the run), run_episode_chunk's cadence (exact GP refresh at step 0,
  slab re-centred every 8 steps), against ble_tpu's learner.env_step.
  The actions (read from the replay ring), terminals, valid flags, episode
  steps and cursor are equal; rewards within 1e-3 (the golden per-step
  bound, tests/test_golden_trajectory.py:47); the stored observations'
  sums within the golden obs_sum bound of 1.0 and each feature within
  1e-3 on every world but world 5 (ROADMAP C: world 5's balloon sits at
  buoyant equilibrium)."""
  jparams, jstates, jobs = worlds
  rkw = dict(ring_len=32, batch_size=8)
  jcfg = jax_learner.TrainConfig(
      num_envs=E, use_marco_polo=False,
      qrdqn=_small_qrdqn(jax_qrdqn, min_replay_history=10**6),
      replay=jax_replay.ReplayConfig(**rkw))
  cfg = learner.TrainConfig(
      num_envs=E, use_marco_polo=False,
      qrdqn=_small_qrdqn(qrdqn, min_replay_history=10**6),
      replay=replay.ReplayConfig(**rkw))
  jlearner = jax_qrdqn.init(jax.random.PRNGKey(1), jcfg.qrdqn,
                            jobs.shape[-1])
  jts = jax_learner.TrainState(
      env_state=jstates, obs=jobs, active=jnp.ones((E,), bool),
      episode_step=jnp.zeros((E,), jnp.int32),
      episode_return=jnp.zeros((E,), jnp.float32),
      mp=jax.vmap(jax_mp.begin_episode)(jax.random.split(
          jax.random.PRNGKey(2), E)),
      learner=jlearner, actor=(),
      replay=jax_replay.init(E, jobs.shape[-1], jcfg.replay),
      key=jax.random.PRNGKey(3), env_steps=jnp.int32(0),
      episodes_done=jnp.int32(0))
  params = env_lib.EnvParams(wind_field_f32=True, field_cache=True)
  ts = learner.train_state_from_envs(cfg, _to_port(jstates),
                                     torch.from_numpy(np.array(jobs)))
  qrdqn.load_params(ts.learner, bridge.quantile_params_from_flax(
      jax.tree.map(np.asarray, jlearner.params)))

  jstep = jax.jit(functools.partial(jax_learner.env_step, jcfg, jparams))
  jts = jts.replace(env_state=jts.env_state.replace(
      gp=jax.vmap(jax_gp.refresh)(jts.env_state.gp)))
  ts.env_state = dataclasses.replace(
      ts.env_state, gp=wind_gp.refresh(ts.env_state.gp))
  others = np.arange(E) != 5
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
  assert ts.env_steps == int(jts.env_steps) == STEPS
  assert ts.learner.train_steps == int(jts.learner.train_steps) == 0
  for name in ('action', 'terminal', 'valid', 'episode_step'):
    np.testing.assert_array_equal(getattr(ts.replay, name).numpy(),
                                  np.asarray(getattr(jrep, name)),
                                  err_msg=name)
  assert len(set(ts.replay.action[:, :STEPS].flatten().tolist())) > 1
  np.testing.assert_allclose(ts.replay.reward.numpy(), np.asarray(jrep.reward),
                             atol=1e-3)
  got_obs = ts.replay.obs[:, :STEPS].numpy()
  want_obs = np.asarray(jrep.obs)[:, :STEPS]
  np.testing.assert_allclose(got_obs.sum(-1), want_obs.sum(-1), atol=1.0)
  np.testing.assert_allclose(got_obs[others], want_obs[others], atol=1e-3)
  np.testing.assert_array_equal(ts.active.numpy(), np.asarray(jts.active))
  np.testing.assert_array_equal(ts.episode_step.numpy(),
                                np.asarray(jts.episode_step))


def _smoke_config(**kw):
  return learner.TrainConfig(
      num_envs=4, samples_per_insert=8.0, qrdqn=_small_qrdqn(qrdqn),
      replay=replay.ReplayConfig(ring_len=64, batch_size=8), **kw)


def test_actor_learner_smoke():
  """tests/test_training.py::test_actor_learner_smoke on the port: 4 envs,
  12 steps, ring 64, batch 8, MarcoPolo on. The learner trains
  grad_steps_per_env_step() steps at each env step where replay can sample
  (ble_tpu's formula), replay.total is 12, rewards and losses finite, the
  metrics come stacked over the steps."""
  config = _smoke_config()
  params = env_lib.EnvParams()
  ts = learner.init_train_state(0, params, env_lib.make_field_fn('static'),
                                config, device='cpu')
  ts, metrics = learner.run_episode_chunk(config, params, ts, 12)
  assert ts.env_steps == 12 and ts.replay.total == 12
  assert tuple(metrics['reward'].shape) == (12,)
  assert tuple(metrics['action_hist'].shape) == (12, 3)
  assert tuple(metrics['path'].shape) == (12, 4)
  assert bool(torch.isfinite(metrics['reward']).all())
  assert bool(torch.isfinite(metrics['loss']).all())
  # ble_tpu: can_sample once total > min_history // E + n_step.
  first = config.qrdqn.min_replay_history // 4 + config.replay.n_step
  trained = sum(1 for total in range(1, 13) if total > first)
  assert config.grad_steps_per_env_step() == 4
  assert ts.learner.train_steps == trained * 4 > 0
  assert bool((metrics['loss'][:first] == 0).all())
  assert bool((metrics['loss'][first:] > 0).all())
  assert int(metrics['action_hist'].sum()) == 12 * 4


def test_selective_reset_resets_only_inactive_envs():
  """tests/test_training.py::test_selective_reset_resets_only_inactive_envs
  on the port: envs 0 and 2 forced inactive restart from fresh worlds (the
  next seeds of the counter); envs 1 and 3 continue untouched."""
  config = _smoke_config()
  params = env_lib.EnvParams()
  field_fn = env_lib.make_field_fn('static')
  ts = learner.init_train_state(0, params, field_fn, config, device='cpu')
  ts, _ = learner.run_episode_chunk(config, params, ts, 5)
  ts.active = torch.tensor([False, True, False, True])
  ts.episode_return = torch.tensor([3.0, 1.0, 2.0, 1.0])
  old_steps = ts.episode_step.clone()
  old_x = ts.env_state.balloon.x_m.clone()
  old_seed = ts.next_world_seed
  assert old_seed == learner.first_world_seed(0) + 4
  ts2, stats = learner.selective_reset(ts, params, field_fn, config)
  steps = ts2.episode_step
  x = ts2.env_state.balloon.x_m
  assert int(steps[0]) == 0 and int(steps[2]) == 0
  assert int(steps[1]) == int(old_steps[1]) and int(steps[3]) == int(
      old_steps[3])
  assert float(x[1]) == float(old_x[1]) and float(x[3]) == float(old_x[3])
  assert float(x[0]) != float(old_x[0]) or float(x[2]) != float(old_x[2])
  assert bool(ts2.active.all())
  assert ts2.episodes_done == 2 and ts2.next_world_seed == old_seed + 2
  assert stats['completed'].tolist() == [True, False, True, False]
  assert stats['returns'].tolist() == [3.0, 1.0, 2.0, 1.0]
  assert ts2.episode_return.tolist() == [0.0, 1.0, 0.0, 1.0]
  # The reset envs hold the worlds of the next two seeds, as env.reset
  # gives them.
  fresh, fresh_obs = env_lib.reset(params, [old_seed, old_seed + 1],
                                   field_fn, 'cpu')
  assert torch.equal(ts2.env_state.balloon.x_m[[0, 2]], fresh.balloon.x_m)
  assert torch.equal(ts2.obs[[0, 2]], fresh_obs)
  assert torch.equal(ts2.env_state.gp.kinv[[0, 2]], fresh.gp.kinv)
  # No inactive env: nothing changes.
  ts3, _ = learner.selective_reset(ts2, params, field_fn, config)
  assert ts3 is ts2


def test_unported_agents_raise_and_unknown_agents_are_rejected():
  """No trainable agent is left unported: make_agent_core serves every name
  of TRAINABLE_AGENTS, ble_tpu's list, with ble_tpu's replay use, sample
  kind, exploration default and train steps an env step (256 for the
  feedforward agents, 16 for r2d2's windows); an unknown name raises."""
  assert learner.TRAINABLE_AGENTS == jax_learner.TRAINABLE_AGENTS
  for agent in learner.TRAINABLE_AGENTS:
    core = learner.make_agent_core(learner.TrainConfig(agent=agent))
    want = jax_learner.make_agent_core(jax_learner.TrainConfig(agent=agent))
    assert core.name == want.name == agent
    assert core.uses_replay == want.uses_replay
    assert core.sample_kind == want.sample_kind
    assert core.seq_len == want.seq_len
    assert core.epsilon_train == want.epsilon_train
    assert core.min_replay_history == want.min_replay_history
    assert (learner.TrainConfig(agent=agent).grad_steps_per_env_step() ==
            jax_learner.TrainConfig(agent=agent).grad_steps_per_env_step())
  with pytest.raises(ValueError, match='Unknown'):
    learner.make_agent_core(learner.TrainConfig(agent='sarsa'))
  assert learner.TrainConfig().grad_steps_per_env_step() == 256
  assert jax_learner.TrainConfig().grad_steps_per_env_step() == 256
  assert learner.TrainConfig(agent='r2d2').grad_steps_per_env_step() == 16
