"""The port's window route, env.rollout_window, on the CPU: against K of its
own step_batched calls, chained against one long window, and against
ble_tpu's rollout_window on worlds that ble_tpu draws and hands across."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ble_tpu.env import env as jax_env
from ble_tpu_torch import bridge
from ble_tpu_torch.env import env as env_lib

E = 8
K = 8
# The limits of tests/test_rollout_window.py:53-66 for the window against
# sequential steps: observations 2e-4 and kinv 5e-3 (the GP kernel sums in
# another order than the per-step observe on a TPU); the rest equal.
OBS_ATOL = 2e-4
KINV_ATOL = 5e-3


def _reset(field_cache):
  params = env_lib.EnvParams(field_cache=field_cache)
  state, obs = env_lib.reset(params, list(range(E)),
                             env_lib.make_field_fn('static'), 'cpu')
  return params, state, obs


def _actions(seed, k=K):
  return torch.from_numpy(
      np.random.RandomState(seed).randint(0, 3, (k, E)).astype(np.int32))


def _sequential(params, state, actions):
  outs = []
  for a in actions:
    outs.append(env_lib.step_batched(params, state, a, refresh='never'))
    state = outs[-1].state
  stack = lambda key: torch.stack([getattr(o, key) for o in outs])
  info = {k: torch.stack([o.info[k] for o in outs]) for k in outs[0].info}
  return env_lib.StepOutput(state, stack('observation'), stack('reward'),
                            stack('done'), info)


def _assert_window_matches(got, want):
  assert got.observation.shape == (K, E, env_lib.OBSERVATION_DIM)
  assert set(got.info) == set(want.info)
  for key in want.info:
    assert torch.equal(got.info[key], want.info[key]), key
  assert torch.equal(got.reward, want.reward)
  assert torch.equal(got.done, want.done)
  g, w = got.state, want.state
  for name in ('x_m', 'y_m', 'pressure_pa', 'time_s', 'status',
               'battery_charge_j'):
    assert torch.equal(getattr(g.balloon, name), getattr(w.balloon, name)), \
        name
  for name in ('wind_u', 'wind_v', 'sunrise_s', 'sunset_s', 'steps'):
    assert torch.equal(getattr(g, name), getattr(w, name)), name
  np.testing.assert_allclose(got.observation.numpy(),
                             want.observation.numpy(), atol=OBS_ATOL)
  np.testing.assert_allclose(g.gp.kinv.numpy(), w.gp.kinv.numpy(),
                             atol=KINV_ATOL)
  assert torch.equal(g.gp.active, w.gp.active)
  assert torch.equal(g.gp.count, w.gp.count)


@pytest.mark.parametrize('field_cache', [False, True])
def test_window_matches_sequential_steps(field_cache):
  """(a) rollout_window at K = 8 against 8 step_batched calls from the same
  state, the slab re-centred once before both with the cache on."""
  params, state, _ = _reset(field_cache)
  if field_cache:
    state = env_lib.refresh_field_cache(state)
  actions = _actions(5)
  got = env_lib.rollout_window(params, state, actions)
  want = _sequential(params, state, actions)
  _assert_window_matches(got, want)
  assert ('slab_oob' in got.info) == field_cache


def test_window_leaves_its_input_state_unchanged():
  """The bench times several runs from one initial state: the window must
  not write into the state it was given."""
  params, state, _ = _reset(True)
  before = env_lib.tree_map(torch.clone, state)
  env_lib.rollout_window(params, state, _actions(1))
  env_lib.step_batched(params, state, _actions(1)[0])
  same = []
  env_lib.tree_map(lambda a, b: same.append(torch.equal(a, b)), state, before)
  assert len(same) > 30 and all(same)


def test_chained_windows_match_one_long_window():
  """(b) two chained 4-step windows against one 8-step window."""
  params, state, _ = _reset(True)
  state = env_lib.refresh_field_cache(state)
  actions = _actions(3)
  full = env_lib.rollout_window(params, state, actions)
  first = env_lib.rollout_window(params, state, actions[:4])
  second = env_lib.rollout_window(params, first.state, actions[4:])
  assert torch.equal(torch.cat([first.reward, second.reward]), full.reward)
  assert torch.equal(torch.cat([first.done, second.done]), full.done)
  assert torch.equal(second.state.balloon.x_m, full.state.balloon.x_m)
  np.testing.assert_allclose(
      torch.cat([first.observation, second.observation]).numpy(),
      full.observation.numpy(), atol=1e-5)
  np.testing.assert_allclose(second.state.gp.kinv.numpy(),
                             full.state.gp.kinv.numpy(), atol=KINV_ATOL)


def _np_dict(obj):
  out = {}
  for f in dataclasses.fields(obj):
    v = getattr(obj, f.name)
    out[f.name] = (_np_dict(v) if dataclasses.is_dataclass(v) else
                   None if v is None else np.array(v))
  return out


# The world whose first step sits on the buoyant-equilibrium knife edge
# (tests/test_torch_gym_env.py:KNIFE_EDGE_WORLD): rho V - M flips sign on
# an ulp of float32 summation order, so its balloon pressure reads several
# Pa from ble_tpu's after step 0 and its observations follow the other
# pressure.
KNIFE_EDGE_WORLD = 5


@pytest.fixture(scope='module')
def jax_window():
  """ble_tpu's side, compiled once: E static-field worlds drawn by its
  reset from PRNGKey(0..E-1) (float32 grid, slab cache on, slab
  re-centred), and its rollout_window(physics='xla') over K steps of the
  actions."""
  params = jax_env.EnvParams(wind_field_f32=True, field_cache=True)
  keys = jnp.stack([jax.random.PRNGKey(s) for s in range(E)])
  states, _ = jax.jit(jax.vmap(functools.partial(
      jax_env.reset, params=params,
      field_fn=jax_env.make_field_fn('static'))))(keys)
  states = jax_env.refresh_field_cache(states)
  actions = np.random.RandomState(0).randint(0, 3, (K, E)).astype(np.int32)
  out = jax.jit(functools.partial(jax_env.rollout_window, params,
                                  physics='xla'))(states,
                                                  jnp.asarray(actions))
  return states, actions, jax.tree.map(np.asarray, out)


def test_window_matches_jax_rollout_window(jax_window):
  """(c) the port's rollout_window against ble_tpu's on the same worlds
  and actions, K = 8, at the limits of
  tests/test_torch_env.py:test_slice_closed_loop_station_seeker and the
  single-step route's end-to-end test: rewards within 1e-3 and done flags
  equal on every world and step; balloon pressure within 1 Pa on every
  world and step but KNIFE_EDGE_WORLD's first (under 10 Pa); observations
  within 1e-3 on every other world."""
  jstates, actions, want = jax_window
  state = bridge.from_dict(env_lib.EnvState, _np_dict(jstates))
  params = env_lib.EnvParams(wind_field_f32=True, field_cache=True)
  got = env_lib.rollout_window(params, state, torch.from_numpy(actions))

  assert set(got.info) - set(want.info) == {'slab_oob'}
  assert not got.info['slab_oob'].any()
  np.testing.assert_allclose(got.reward.numpy(), want.reward, atol=1e-3)
  np.testing.assert_array_equal(got.done.numpy(), want.done)
  pressure = got.info['pressure_pa'].numpy()
  want_pressure = want.info['pressure_pa']
  held = np.ones((K, E), bool)
  held[0, KNIFE_EDGE_WORLD] = False
  np.testing.assert_allclose(pressure[held], want_pressure[held], atol=1.0)
  np.testing.assert_allclose(pressure, want_pressure, atol=10.0)
  others = np.arange(E) != KNIFE_EDGE_WORLD
  np.testing.assert_allclose(got.observation.numpy()[:, others],
                             want.observation[:, others], atol=1e-3)
  np.testing.assert_array_equal(got.state.gp.count.numpy(),
                                want.state.gp.count)
  np.testing.assert_array_equal(got.state.steps.numpy(), want.state.steps)
