"""The port's random-walk and random agents (ble_tpu_torch/agents/
random_walk.py) against ble_tpu.agents.random_walk on the same inputs:
select_action on the same targets and observations, inside and outside the
100 Pa hysteresis band; step's target drift from the same keys (the
port's normals from utils/prng.py); init's targets from the same keys; and
the host agents' actions from the same seed."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ble_tpu.agents import base as jax_base
from ble_tpu.agents import random_walk as jax_rw
from ble_tpu_torch.agents import base
from ble_tpu_torch.agents import random_walk
from ble_tpu_torch.utils import constants
from ble_tpu_torch.utils import prng

OBS_DIM = 1099
P_MIN = constants.PERCIATELLI_PRESSURE_RANGE_MIN
P_MAX = constants.PERCIATELLI_PRESSURE_RANGE_MAX


def _obs(rng, pressures):
  """(E, 1099) float32 observations: uniform features, feature 0 the
  rescaled balloon pressure."""
  obs = rng.uniform(0.0, 1.0, (len(pressures), OBS_DIM)).astype(np.float32)
  obs[:, 0] = (np.asarray(pressures) - P_MIN) / (P_MAX - P_MIN)
  return obs


def _jax_select(targets, elapsed, obs):
  state = jax_rw.RandomWalkState(target_pressure=jnp.asarray(targets),
                                 time_elapsed_s=jnp.asarray(elapsed))
  return np.asarray(jax.vmap(jax_rw.select_action)(state, jnp.asarray(obs)))


def test_select_action_matches_jax_around_the_hysteresis_band():
  """Pressures at offsets from the target on both sides of +-100 Pa, and
  far outside it: UP, STAY and DOWN exactly as ble_tpu picks them."""
  rng = np.random.RandomState(0)
  offsets = np.array([-400.0, -101.0, -99.0, -50.0, 0.0, 50.0, 99.0, 101.0,
                      400.0] * 8, np.float32)
  targets = rng.uniform(6500.0, 11400.0, offsets.shape).astype(np.float32)
  elapsed = np.zeros_like(targets)
  obs = _obs(rng, targets + offsets)
  want = _jax_select(targets, elapsed, obs)
  state = random_walk.RandomWalkState(
      target_pressure=torch.from_numpy(targets),
      time_elapsed_s=torch.from_numpy(elapsed))
  got = random_walk.select_action(state, torch.from_numpy(obs))
  assert got.dtype == torch.int32
  np.testing.assert_array_equal(got.numpy(), want)
  assert set(want.tolist()) == {0, 1, 2}


def test_step_drift_matches_jax_with_the_same_draw():
  """Eight steps over 64 envs from the same keys: the port's step is given
  random_walk.draw of each step's keys, ble_tpu's step draws
  jax.random.normal from those keys. Targets within 1e-3 Pa (the normals
  sit within a few float32 ulp), elapsed time and actions equal."""
  rng = np.random.RandomState(1)
  n = 64
  keys = jax.random.split(jax.random.PRNGKey(0), n)
  tkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
  state = random_walk.init(tkeys, 'cpu')
  jstate = jax.vmap(jax_rw.init)(keys)
  jstep = jax.vmap(jax_rw.step)
  for t in range(8):
    step_keys = jax.vmap(lambda k: jax.random.fold_in(k, t))(keys)
    obs = _obs(rng, rng.uniform(6000.0, 12000.0, n))
    z = random_walk.draw(prng.fold_in(tkeys, t))
    state, actions = random_walk.step(state, torch.from_numpy(obs), z)
    jstate, jactions = jstep(jstate, jnp.asarray(obs), step_keys)
    np.testing.assert_allclose(state.target_pressure.numpy(),
                               np.asarray(jstate.target_pressure), atol=1e-3,
                               err_msg=f'step {t}')
    np.testing.assert_array_equal(state.time_elapsed_s.numpy(),
                                  np.asarray(jstate.time_elapsed_s))
    np.testing.assert_array_equal(actions.numpy(), np.asarray(jactions))
  assert float(state.time_elapsed_s[0]) == 8 * 180.0


def test_init_range_matches_jax():
  """Fresh targets of both packages from the same 4096 keys: equal bits
  (a uniform draw is bit-exact), inside [6500, 11400), reaching within
  100 Pa of each end, mean within 80 Pa of the middle."""
  n = 4096
  keys = jax.random.split(jax.random.PRNGKey(0), n)
  got = random_walk.init(torch.from_numpy(np.asarray(keys).astype(np.int64)),
                         'cpu')
  want = jax.vmap(jax_rw.init)(keys)
  np.testing.assert_array_equal(got.target_pressure.numpy(),
                                np.asarray(want.target_pressure))
  assert bool((got.time_elapsed_s == 0).all())
  np.testing.assert_array_equal(np.asarray(want.time_elapsed_s), 0.0)
  targets = got.target_pressure.numpy()
  assert targets.min() >= 6500.0 and targets.max() < 11400.0
  assert targets.min() < 6600.0 and targets.max() > 11300.0
  assert abs(targets.mean() - 8950.0) < 80.0
  walk = random_walk.init_from_generator(n, torch.Generator().manual_seed(0))
  walk_targets = walk.target_pressure.numpy()
  assert walk_targets.min() >= 6500.0 and walk_targets.max() < 11400.0
  assert abs(walk_targets.mean() - 8950.0) < 80.0


def test_random_agents_act_like_jax():
  """Host agents of one seed act alike in both packages: the random
  agent's 100 actions are equal (its keys split as
  ble_tpu/agents/base.py:100-121 splits them) and span {0, 1, 2}; the
  random-walk agent's actions are equal and its clock advances one agent
  step a step in both."""
  rng = np.random.RandomState(2)
  obs = _obs(rng, [9000.0])[0]
  actions = {}
  for name, pkg in (('port', base), ('jax', jax_base)):
    kw = {'device': 'cpu'} if pkg is base else {}
    agent = pkg.create_agent('random', num_actions=3,
                             observation_shape=(OBS_DIM,), seed=0, **kw)
    seen = [agent.begin_episode(obs)] + [agent.step(0.0, obs)
                                         for _ in range(99)]
    walker = pkg.create_agent('random_walk', num_actions=3,
                              observation_shape=(OBS_DIM,), seed=0, **kw)
    walk = [walker.begin_episode(obs)] + [walker.step(0.0, obs)
                                          for _ in range(3)]
    assert set(walk) <= {0, 1, 2}
    actions[name] = (seen, walk)
    elapsed = np.asarray(walker._state.time_elapsed_s)
    np.testing.assert_array_equal(elapsed.reshape(-1), [3 * 180.0])
  assert actions['port'] == actions['jax']
  assert set(actions['port'][0]) == {0, 1, 2}
