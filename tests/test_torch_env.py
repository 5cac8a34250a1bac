"""The PyTorch port's environment and the slice as a whole against the JAX
package, on the CPU: worlds drawn by ble_tpu are handed across through the
bridge, so a departure here is the step's, not the reset's (the port's
own reset by seed is held in tests/test_torch_worlds.py)."""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ble_tpu.agents import station_seeker as jax_seeker
from ble_tpu.env import env as jax_env
from ble_tpu.env import features as jax_features
from ble_tpu.env import wind_gp as jax_gp
from ble_tpu.train import eval_lib as jax_eval_lib
from ble_tpu_torch import bridge
from ble_tpu_torch.agents import station_seeker
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.env import features
from ble_tpu_torch.env import wind_field
from ble_tpu_torch.env import wind_gp
from ble_tpu_torch.train import eval_lib

E = 8
_GOLDEN = os.path.join(os.path.dirname(__file__), 'golden_trajectory.json')


def _np_dict(obj):
  out = {}
  for f in dataclasses.fields(obj):
    v = getattr(obj, f.name)
    out[f.name] = (_np_dict(v) if dataclasses.is_dataclass(v) else
                   None if v is None else np.array(v))
  return out


def _to_port(jstate) -> env_lib.EnvState:
  return bridge.from_dict(env_lib.EnvState, _np_dict(jstate))


@pytest.fixture(scope='module')
def worlds():
  """E static-field worlds drawn by ble_tpu's reset from PRNGKey(0..E-1)
  (float32 grid, slab cache on); world 0 is the golden trajectory's."""
  params = jax_env.EnvParams(wind_field_f32=True, field_cache=True)
  keys = jnp.stack([jax.random.PRNGKey(s) for s in range(E)])
  reset = jax.vmap(functools.partial(
      jax_env.reset, params=params, field_fn=jax_env.make_field_fn('static')))
  states, obs = reset(keys)
  return params, states, obs


def test_bridge_round_trip_is_bit_exact(worlds):
  """ble_tpu's EnvState -> port EnvState -> nested numpy dict gives back
  every leaf bit for bit, the bf16 grid included, and the wind field's
  noise_perms (the OpenSimplex tables of the parity mode) None on the fast
  path both packages run."""
  _, jstates, _ = worlds
  want = _np_dict(jstates)
  got = bridge.to_dict(_to_port(jstates))
  assert set(want['wind']) == set(got['wind'])
  assert want['wind']['noise_perms'] is None

  def compare(g, w, path):
    if isinstance(w, dict):
      assert set(g) == set(w), path
      for k in w:
        compare(g[k], w[k], f'{path}.{k}')
    elif w is None:
      assert g is None, path
    else:
      assert g.dtype == w.dtype, path
      np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                    err_msg=path)

  compare(got, want, 'state')
  bf16 = jax.tree.map(lambda x: x[:1], jstates).wind.field.astype(jnp.bfloat16)
  back = bridge.numpy_from_tensor(bridge.tensor_from_numpy(np.asarray(bf16)))
  np.testing.assert_array_equal(back.view(np.uint16),
                                np.asarray(bf16).view(np.uint16))


def test_golden_trajectory(worlds):
  """tests/golden_trajectory.json (30 steps, seed-0 world, default bf16
  grid without the slab cache) at the tolerances of
  tests/test_golden_trajectory.py:39-48."""
  with open(_GOLDEN) as f:
    golden = json.load(f)
  assert golden['seed'] == 0 and golden['field'] == 'static'
  _, jstates, _ = worlds
  state = _to_port(jax.tree.map(lambda x: x[:1], jstates))
  # The static field's values (0, +-10 m/s) are exact in bf16, so the
  # world is the one ble_tpu draws with its default parameters.
  state = dataclasses.replace(state, wind=dataclasses.replace(
      state.wind, field=state.wind.field.to(torch.bfloat16), slab=None,
      slab_x0=None, slab_y0=None))
  params = env_lib.EnvParams()
  actions = [1, 2, 2, 0, 1, 0, 2, 1, 0, 1] * 3
  rows = iter(golden['rows'])
  expected = next(rows)
  for i, a in enumerate(actions):
    state, obs, reward, done, info = env_lib.step_batched(
        params, state, torch.tensor([a], dtype=torch.int32))
    if i + 1 == expected['step']:
      assert abs(float(info['x_km']) - expected['x_km']) < 0.05
      assert abs(float(info['y_km']) - expected['y_km']) < 0.05
      assert abs(float(info['pressure_pa']) - expected['pressure_pa']) < 2.0
      assert abs(float(info['superpressure_pa']) -
                 expected['superpressure_pa']) < 2.0
      assert abs(float(info['battery_soc']) - expected['battery_soc']) < 1e-3
      assert abs(float(reward) - expected['reward']) < 1e-3
      assert abs(float(obs.sum()) - expected['obs_sum']) < 1.0
      expected = next(rows, None)
      if expected is None:
        break
  assert expected is None


def test_init_state_and_features_match_jax(worlds):
  """init_state on ble_tpu's initial conditions, and get_features on
  ble_tpu's state, against ble_tpu."""
  jparams, jstates, jobs = worlds
  params = env_lib.EnvParams(wind_field_f32=True, field_cache=True)
  state = _to_port(jstates)
  b = state.balloon
  wind = dataclasses.replace(state.wind)
  got_state, got_obs = env_lib.init_state(
      params, state.atmosphere, b.time_s, b.x_m, b.y_m, b.center_lat_rad,
      b.center_lng_rad, b.pressure_pa, b.upwelling_infrared_w_m2, wind)
  for name in ('pressure_pa', 'internal_temperature_k', 'mols_air',
               'superpressure_pa', 'envelope_volume_m3'):
    np.testing.assert_allclose(getattr(got_state.balloon, name).numpy(),
                               getattr(b, name).numpy(), rtol=1e-5,
                               err_msg=name)
  np.testing.assert_array_equal(got_state.sunrise_s.numpy(),
                                state.sunrise_s.numpy())
  np.testing.assert_array_equal(got_state.sunset_s.numpy(),
                                state.sunset_s.numpy())
  np.testing.assert_allclose(got_state.wind_u.numpy(), state.wind_u.numpy(),
                             atol=2e-5)
  # Feature vectors: per-env sums within the golden obs_sum bound
  # (tests/test_golden_trajectory.py:47); elementwise within 1e-3, where
  # arccos near +-1 amplifies float32 rounding of the cosine.
  jnp_obs = np.asarray(jobs)
  np.testing.assert_allclose(got_obs.sum(-1).numpy(), jnp_obs.sum(-1),
                             atol=1.0)
  np.testing.assert_allclose(got_obs.numpy(), jnp_obs, atol=1e-3)

  want = jax.vmap(functools.partial(jax_features.get_features,
                                    jparams.balloon))(
      jstates.balloon, jstates.gp, jstates.wind, jstates.atmosphere,
      jstates.sunrise_s, jstates.sunset_s)
  got = features.get_features(params.balloon, b, state.gp, state.wind,
                              state.atmosphere, state.sunrise_s,
                              state.sunset_s)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
  parsed = features.parse(got)
  assert parsed.winds.shape == (E, 361, 3)
  assert torch.equal(parsed.last_command,
                     torch.from_numpy(np.asarray(
                         jax_features.parse(want).last_command)).to(
                             parsed.last_command.dtype))


def test_wind_column_features_matches_jax(worlds):
  """wind_column_features on ble_tpu's worlds against
  jax.vmap(ble_tpu wind_column_features), at the features' 1e-3 of
  test_init_state_and_features_match_jax."""
  jparams, jstates, _ = worlds
  params = env_lib.EnvParams(wind_field_f32=True, field_cache=True)
  state = _to_port(jstates)
  want = jax.vmap(functools.partial(jax_features.wind_column_features,
                                    jparams.balloon))(
      jstates.balloon, jstates.gp, jstates.wind, jstates.atmosphere)
  got = features.wind_column_features(params.balloon, state.balloon,
                                      state.gp, state.wind, state.atmosphere)
  assert got.shape == (E, 361, 3) and got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
  assert not features.wind_is_valid(got).all()  # Some levels unreachable.


def test_get_features_is_its_old_composition_bit_for_bit(worlds):
  """get_features, now ambient_features beside wind_column_features, gives
  the bits of the composition it had before: one GP column query, the
  forecast at the levels from one effective_column, and
  get_features_precomputed; its column block is wind_column_features'."""
  _, jstates, _ = worlds
  params = env_lib.EnvParams(wind_field_f32=True, field_cache=True)
  state = _to_port(jstates)
  b = state.balloon
  levels = features.pressure_levels()
  means, deviations = wind_gp.query_column(
      state.gp, b.x_m, b.y_m, b.time_elapsed_s.to(torch.float32), levels)
  forecast = wind_field.column_at_levels(wind_field.effective_column(
      state.wind, b.x_m, b.y_m, b.time_elapsed_s), levels)
  before = features.get_features_precomputed(
      params.balloon, b, state.atmosphere, state.sunrise_s, state.sunset_s,
      means, deviations, forecast)
  got = features.get_features(params.balloon, b, state.gp, state.wind,
                              state.atmosphere, state.sunrise_s,
                              state.sunset_s)
  assert torch.equal(got, before)
  column = features.wind_column_features(params.balloon, b, state.gp,
                                         state.wind, state.atmosphere)
  assert torch.equal(got[:, 16:], column.reshape(E, -1))


def test_slice_closed_loop_station_seeker(worlds):
  """The slice as a whole: E ble_tpu worlds, 30 closed-loop StationSeeker
  steps in both packages with eval_lib's cadence (exact GP refresh at step
  0, slab re-centred every 8 steps). Actions must be equal, rewards within
  1e-3 and observation sums within the golden obs_sum bound of 1.0
  (tests/test_golden_trajectory.py:46-47)."""
  jparams, jstate, jobs = worlds
  params = env_lib.EnvParams(wind_field_f32=True, field_cache=True)
  state = _to_port(jstate)
  obs = torch.from_numpy(np.array(jobs))

  jstep = jax.jit(lambda s, a: jax_env.step_batched(jparams, s, a,
                                                    refresh='never'))
  jrefresh_gp = jax.jit(lambda s: s.replace(gp=jax.vmap(jax_gp.refresh)(s.gp)))
  jrefresh_slab = jax.jit(jax_env.refresh_field_cache)
  jpick = jax.jit(jax_seeker.pick_action)

  jaction = jpick(jobs)
  action = station_seeker.pick_action(obs)
  np.testing.assert_array_equal(action.numpy(), np.asarray(jaction))
  for t in range(30):
    if t % wind_gp.REFRESH_PERIOD == 0:
      jstate = jrefresh_gp(jstate)
      state = dataclasses.replace(state, gp=wind_gp.refresh(state.gp))
    if t % params.field_cache_every == 0:
      jstate = jrefresh_slab(jstate)
      state = env_lib.refresh_field_cache(state)
    jout = jstep(jstate, jaction)
    out = env_lib.step_batched(params, state, action, refresh='never')
    np.testing.assert_allclose(out.reward.numpy(), np.asarray(jout.reward),
                               atol=1e-3, err_msg=f'step {t}')
    np.testing.assert_allclose(out.observation.sum(-1).numpy(),
                               np.asarray(jout.observation).sum(-1),
                               atol=1.0, err_msg=f'step {t}')
    jstate, state = jout.state, out.state
    jaction = jpick(jout.observation)
    action = station_seeker.pick_action(out.observation)
    np.testing.assert_array_equal(action.numpy(), np.asarray(jaction),
                                  err_msg=f'action after step {t}')


@pytest.mark.slow
def test_tiny_eval_twr_matches_jax():
  """ROADMAP A8's gate: tiny_eval's 10 seeds x 960 StationSeeker steps on
  ble_tpu-drawn static-field worlds (float32 grid, slab cache on) through
  both packages' eval harnesses: per-seed time within radius and final
  timestep equal."""
  params = jax_env.EnvParams(wind_field_f32=True, field_cache=True)
  field_fn = jax_env.make_field_fn('static')
  seeds = list(range(10))
  keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
  states, obs = jax.vmap(functools.partial(jax_env.reset, params=params,
                                           field_fn=field_fn))(keys)
  jfn = jax_eval_lib.build_eval_fn(
      params, field_fn, lambda key: (),
      lambda st, o, key: (st, jax_seeker.pick_action(o)), max_steps=960,
      from_states=True)
  want = jax.tree.map(np.asarray, jfn(jnp.asarray(seeds), states, obs))
  fn = eval_lib.build_eval_fn(
      env_lib.EnvParams(wind_field_f32=True, field_cache=True),
      env_lib.make_field_fn('static'), lambda n, g: (),
      lambda st, o, g: (st, station_seeker.pick_action(o)), max_steps=960,
      from_states=True, device='cpu')
  got = fn(seeds, _to_port(states), torch.from_numpy(np.array(obs)))
  np.testing.assert_array_equal(got['final_timestep'].numpy(),
                                want['final_timestep'])
  np.testing.assert_array_equal(got['time_within_radius'].numpy(),
                                want['time_within_radius'])
