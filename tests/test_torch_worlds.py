"""Seed-to-world parity on the CPU: the port draws each seed's world, the
fallback decoder's weights and the eval policies' randomness as ble_tpu
does, from the same integer seed, with no world handed across.

ble_tpu's side comes from two compiled programs, made once for the module
(`jax_side`): its reset, jax.vmap(reset_from_field) on the decoded or
static grids, and its build_eval_fn from those states over 30 steps with
the agent as a traced parameter (one program for StationSeeker, random
and random_walk).

The module also holds `torch_jax_worlds.json`, ble_tpu's values for a few
seeds that chip_smoke.py's phase `worlds` checks the port against on a
machine with no JAX. `python tests/test_torch_worlds.py` rewrites it;
test_fixture_is_current recomputes it and requires equality.
"""

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from ble_tpu.agents import random_walk as jax_rw
from ble_tpu.agents import station_seeker as jax_seeker
from ble_tpu.env import atmosphere as jax_atmosphere
from ble_tpu.env import env as jax_env
from ble_tpu.env import wind_field as jax_wind_field
from ble_tpu.generative import vae as jax_vae
from ble_tpu.models import loader as jax_loader
from ble_tpu.train import eval_lib as jax_eval_lib
from ble_tpu.utils import sampling as jax_sampling
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.env import gym_env
from ble_tpu_torch.models import loader
from ble_tpu_torch.train import eval as eval_cli
from ble_tpu_torch.train import eval_lib
from ble_tpu_torch.train import learner
from ble_tpu_torch.train import suites

FIXTURE = os.path.join(os.path.dirname(__file__), 'torch_jax_worlds.json')
SEEDS = chip_smoke.WORLDS_SEEDS  # 0-7.
STEPS = chip_smoke.WORLDS_STEPS  # 30.
AGENTS = ('station_seeker', 'random', 'random_walk')
GYM_SEEDS = (0, 1, 7, 1234)


def _ints(a):
  return np.asarray(a).astype(np.int64).tolist()


def _floats(a):
  return np.asarray(a, np.float32).astype(np.float64).tolist()


def _policy_init(agent, key):
  """random_walk's state for every agent; the others leave it unused."""
  del agent
  return jax_rw.init(key)


def _policy_step(agent, state, obs, key):
  """The action of AGENTS[agent] as ble_tpu/train/eval.py's policies draw
  it from `key`: StationSeeker's pick, randint(key, (), 0, 3), or the
  random walk's step."""
  walked, walk_action = jax_rw.step(state, obs, key)
  actions = jnp.stack([jax_seeker.pick_action(obs).astype(jnp.int32),
                       jax.random.randint(key, (), 0, 3),
                       jnp.asarray(walk_action, jnp.int32)])
  state = jax.tree.map(lambda a, b: jnp.where(agent == 2, a, b), walked,
                       state)
  return state, actions[agent]


def compute_jax_side():
  """ble_tpu's reset of seeds 0-7 on the static and the generative field
  (its fallback decoder, f32 decodes kept), the gym's arena keys reset on
  the static field, and its eval of each agent from those states."""
  params = jax_env.EnvParams()
  reset = jax.jit(jax.vmap(
      lambda key, field: jax_env.reset_from_field(key, params, field)))
  keys = jnp.stack([jax_eval_lib.seed_to_key(s) for s in SEEDS])
  decoder = jax_loader.load_offlineskies22()
  forecast = jax.vmap(lambda k: jax.random.split(
      jax.random.split(k, 7)[6])[1])(keys)
  # Both grids as committed float32 arrays of one shape, so the reset
  # compiles once.
  static = np.asarray(jax_wind_field.simple_static_field(), np.float32)
  fields = {'static': jnp.asarray(np.broadcast_to(
                static, (len(SEEDS),) + static.shape)),
            'generative': jnp.asarray(np.asarray(jax.jit(jax.vmap(
                lambda k: jax_vae.sample_field(decoder, k)))(forecast)))}
  resets = {kind: reset(keys, field) for kind, field in fields.items()}

  # ble_tpu's BalloonEnv: seed(s) sets PRNGKey(s); each reset takes
  # rng, arena = split(rng) and resets from arena
  # (ble_tpu/env/gym_env.py:61-75). Two resets a seed.
  arenas = []
  for seed in GYM_SEEDS:
    rng = jax.random.PRNGKey(seed)
    for _ in range(2):
      rng, arena = jax.random.split(rng)
      arenas.append(arena)
  assert len(arenas) == len(SEEDS)
  _, gym_obs = reset(jnp.stack(arenas), fields['static'])

  run = jax_eval_lib.build_eval_fn(params, None, _policy_init, _policy_step,
                                   max_steps=STEPS, from_states=True,
                                   _parametric=True)
  seeds = jnp.asarray(SEEDS, jnp.int32)
  evals = {(agent, 'static'): run(jnp.int32(i), seeds, *resets['static'])
           for i, agent in enumerate(AGENTS)}
  evals['station_seeker', 'generative'] = run(jnp.int32(0), seeds,
                                               *resets['generative'])
  return {'fields': jax.tree.map(np.asarray, fields),
          'resets': jax.tree.map(np.asarray, resets),
          'gym_obs': np.asarray(gym_obs).reshape(len(GYM_SEEDS), 2, -1),
          'evals': jax.tree.map(np.asarray, evals), 'decoder': decoder}


@pytest.fixture(scope='module')
def jax_side():
  return compute_jax_side()


def _jax_initial_conditions(key):
  """ble_tpu's initial conditions of one reset key, split as
  ble_tpu/env/env.py:reset_from_field splits it."""
  (atmo_key, time_key, offset_key, loc_key, pressure_key, ir_key,
   wind_key) = jax.random.split(key, 7)
  atmosphere = jax_atmosphere.reset(atmo_key)
  x_m, y_m = jax_sampling.sample_initial_offset(offset_key)
  lat, lng = jax_sampling.sample_location(loc_key)
  seeds, offsets = jax_wind_field.reset_noise(jax.random.split(wind_key)[0])
  return {
      'atmosphere_alpha': jax.random.uniform(atmo_key),
      'time_s': jax_sampling.sample_time(time_key),
      'x_m': x_m, 'y_m': y_m, 'center_lat_rad': lat, 'center_lng_rad': lng,
      'pressure_pa': jax_sampling.sample_pressure(pressure_key, atmosphere),
      'upwelling_ir': jax_sampling.sample_upwelling_infrared(ir_key),
      'noise_seeds': seeds, 'noise_offsets': offsets,
  }


def _parity_noise_key(seed):
  """The noise key ble_tpu/env/parity_reset.py:60-83 draws for `seed`."""
  rng = jax.random.PRNGKey(seed)
  _, arena = jax.random.split(rng)
  arena = jax.random.split(arena, 3)[0]
  arena = jax.random.split(arena, 6)[0]
  wind_field_key = jax.random.split(arena, 2)[1]
  return jax.random.split(wind_field_key, num=2)[0]


def jax_worlds(side) -> dict:
  """ble_tpu's values behind chip_smoke.port_worlds, in its layout, from
  the module's compiled programs (`side`) and a few small draws."""
  strata = suites._strata_seeds()
  firsts = {name: seeds[0] for name, seeds in strata.items()}
  ic_seeds = sorted(set(range(10)) | set(firsts.values()))
  keys = jnp.stack([jax_eval_lib.seed_to_key(s) for s in ic_seeds])
  ics = jax.jit(jax.vmap(_jax_initial_conditions))(keys)
  with jax.enable_x64(True):
    seed = learner.first_world_seed(0) + 5
    wide_key = jax.random.PRNGKey(seed)
    wide = {'seed': seed, 'key': _ints(jax.random.key_data(wide_key)),
            'reset_key': _ints(jax.random.key_data(
                jax.random.split(wide_key)[1]))}

  latents = jax.vmap(lambda k: jax.random.normal(jax.random.split(
      jax.random.split(k, 7)[6])[1], (64,)))(keys[:4])

  decoder = {}
  params = side['decoder']['params']
  for name in sorted(params):
    kernel = np.asarray(params[name]['kernel'], np.float64)
    decoder[name] = {'shape': list(kernel.shape),
                     'sum': float(kernel.sum()),
                     'sum_sq': float((kernel * kernel).sum()),
                     'first': _floats(kernel.reshape(-1)[:16]),
                     'bias_abs_sum': float(np.abs(
                         np.asarray(params[name]['bias'])).sum())}

  def random_actions(seed):
    """ble_tpu's random agent in build_eval_fn: the first action from
    akey, then one from each step key (eval_lib.py:136-139,182)."""
    key = jax_eval_lib.seed_to_key(seed)
    _, akey = jax.random.split(jax.random.fold_in(key, 1))
    step_keys = jax.random.split(jax.random.fold_in(key, 2),
                                 chip_smoke.WORLDS_ACTION_STEPS)
    draw = lambda k: jax.random.randint(k, (), 0, 3)
    return jnp.concatenate([draw(akey)[None],
                            jax.vmap(draw)(step_keys[:-1])])

  seeds, offsets, perms = jax_wind_field.reset_noise_exact(
      _parity_noise_key(0))
  perms = np.ascontiguousarray(np.asarray(perms, np.int32))
  result = side['evals']['station_seeker', 'generative']
  return {
      'ic_seeds': ic_seeds,
      'strata_first': firsts,
      'reset_keys': _ints(keys),
      'initial_conditions': {
          k: (_ints(v) if k in ('time_s', 'noise_seeds') else _floats(v))
          for k, v in ics.items()},
      'wide': wide,
      'latents': _floats(latents),
      'decoder': decoder,
      'random_actions': [_ints(random_actions(s))
                         for s in chip_smoke.WORLDS_SEEDS],
      'station_seeker': {
          'cumulative_reward': _floats(result['cumulative_reward']),
          'time_within_radius': _floats(result['time_within_radius']),
          'final_timestep': _ints(result['final_timestep'])},
      'parity_reset_0': {
          'noise_seeds': _ints(seeds), 'noise_offsets': _floats(offsets),
          'perms_sha256': hashlib.sha256(perms.tobytes()).hexdigest()},
  }


@pytest.fixture(scope='module')
def fixture():
  with open(FIXTURE) as f:
    return json.load(f)


def test_fixture_is_current(jax_side, fixture):
  """The committed fixture is what ble_tpu computes now, exactly."""
  assert jax_worlds(jax_side) == fixture


def test_port_matches_the_fixture(fixture):
  """chip_smoke's phase `worlds` on the CPU: the port's keys, initial
  conditions, latents, fallback decoder, random actions and parity reset
  against ble_tpu's, to chip_smoke.compare_worlds' tolerances (integers
  exact)."""
  got = chip_smoke.port_worlds(fixture, 'cpu')
  assert chip_smoke.compare_worlds(got, fixture) == []


@pytest.mark.parametrize('kind', ['static', 'generative'])
def test_reset_by_seed_matches_jax(jax_side, kind):
  """env.reset(seeds 0-7) against jax.vmap(env.reset)(seed_to_key(seeds)),
  each package on its own fallback decoder: time_s and noise seeds equal,
  the other initial conditions within 1e-5 relative, decoded fields
  within 1e-4 m/s, observations within 1e-3."""
  if kind == 'static':
    field_fn = env_lib.make_field_fn('static')
  else:
    field_fn = env_lib.make_field_fn(
        'generative', loader.load_offlineskies22(device='cpu'))
    keys = env_lib.forecast_keys(env_lib.seed_keys(SEEDS))
    np.testing.assert_allclose(field_fn(keys, 'cpu').numpy(),
                               jax_side['fields']['generative'], atol=1e-4)
  jstate, jobs = jax_side['resets'][kind]
  state, obs = env_lib.reset(env_lib.EnvParams(), SEEDS, field_fn, 'cpu')
  np.testing.assert_array_equal(state.balloon.time_s.numpy(),
                                jstate.balloon.time_s)
  np.testing.assert_array_equal(state.wind.noise_seeds.numpy(),
                                jstate.wind.noise_seeds)
  for name in ('x_m', 'y_m', 'center_lat_rad', 'center_lng_rad',
               'pressure_pa', 'upwelling_infrared_w_m2'):
    np.testing.assert_allclose(getattr(state.balloon, name).numpy(),
                               getattr(jstate.balloon, name), rtol=1e-5,
                               err_msg=name)
  np.testing.assert_allclose(state.wind.noise_offsets.numpy(),
                             jstate.wind.noise_offsets, rtol=1e-5)
  np.testing.assert_allclose(state.atmosphere.lapse_rates.numpy(),
                             jstate.atmosphere.lapse_rates, rtol=1e-5)
  np.testing.assert_allclose(obs.numpy(), jobs, atol=1e-3)


def test_fallback_decoder_matches_jax(jax_side):
  """The loader's fallback is init_decoder_params(PRNGKey(0)): every
  weight within 1e-6 relative (its normals sit within a few ulp), every
  bias zero."""
  got = loader.fallback_decoder_params()
  params = jax_side['decoder']['params']
  for i in range(4):
    kernel = np.asarray(params[f'Dense_{i}']['kernel'])
    weight = got[f'layers.{i}.weight'].numpy()
    np.testing.assert_allclose(weight, kernel.T, rtol=1e-6, atol=0.0)
    assert not got[f'layers.{i}.bias'].any()


@pytest.mark.parametrize('agent', AGENTS)
def test_eval_by_seed_matches_jax(jax_side, agent):
  """build_eval_fn(seeds 0-7) over 30 steps on the static field, resetting
  its own worlds, against ble_tpu's build_eval_fn from ble_tpu's reset of
  the same seeds: final timesteps and time within radius equal,
  cumulative rewards within 30 x 1e-3 (the golden per-step reward
  bound)."""
  want = jax_side['evals'][agent, 'static']
  init, step, draw = eval_cli.make_policy_fns(agent, device='cpu')
  fn = eval_lib.build_eval_fn(env_lib.EnvParams(),
                              env_lib.make_field_fn('static'), init, step,
                              max_steps=STEPS, device='cpu',
                              policy_draw=draw)
  got = {k: v.numpy() for k, v in fn(SEEDS).items()}
  np.testing.assert_array_equal(got['final_timestep'],
                                want['final_timestep'])
  np.testing.assert_array_equal(got['time_within_radius'],
                                want['time_within_radius'])
  np.testing.assert_allclose(got['cumulative_reward'],
                             want['cumulative_reward'], atol=STEPS * 1e-3)


def test_gym_first_two_resets_match_jax(jax_side):
  """BalloonEnv(seed=s)'s first two resets (static field), for 4 seeds,
  against ble_tpu's BalloonEnv's, whose keys jax_side replays through
  ble_tpu's reset: observations within 1e-3. reset(seed=s) then reset()
  on one env is what a fresh BalloonEnv(seed=s) gives."""
  gym = gym_env.BalloonEnv(wind_field='static', seed=0, device='cpu')
  for i, seed in enumerate(GYM_SEEDS):
    first, _ = gym.reset(seed=seed)
    second, _ = gym.reset()
    np.testing.assert_allclose(first, jax_side['gym_obs'][i, 0], atol=1e-3,
                               err_msg=str(seed))
    np.testing.assert_allclose(second, jax_side['gym_obs'][i, 1],
                               atol=1e-3, err_msg=str(seed))


if __name__ == '__main__':
  with open(FIXTURE, 'w') as f:
    json.dump(jax_worlds(compute_jax_side()), f, indent=1)
    f.write('\n')
  print(f'wrote {FIXTURE}')
