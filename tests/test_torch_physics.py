"""The PyTorch port's balloon physics against the JAX package, on the CPU.

Inputs come from a numpy seed (and JAX's own stable init, so both sides
start from identical states); every tolerance names its source.
"""

import dataclasses
import datetime
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ble_tpu.env import atmosphere as jax_atmosphere
from ble_tpu.env import balloon as jax_balloon
from ble_tpu.env import safety as jax_safety
from ble_tpu.env import solar as jax_solar
from ble_tpu.env import stable_init as jax_stable_init
from ble_tpu.ops import pallas_physics
from ble_tpu.ops import pmath as jax_pmath
from ble_tpu.utils import constants as jax_constants
from ble_tpu.utils import time_lib as jax_time_lib
from ble_tpu_torch import bridge
from ble_tpu_torch.env import atmosphere
from ble_tpu_torch.env import balloon
from ble_tpu_torch.env import safety
from ble_tpu_torch.env import solar
from ble_tpu_torch.ops import physics
from ble_tpu_torch.ops import pmath
from ble_tpu_torch.utils import spherical
from ble_tpu_torch.utils import time_lib

_DIR = os.path.dirname(__file__)
E = 8

# Fused-vs-XLA physics tolerances of tests/test_pallas_physics.py:52-60
# (physical, not bitwise: the two sides fuse multiply-adds differently).
_ATOL = {'pressure_pa': 2.0, 'superpressure_pa': 2.0,
         'battery_charge_j': 500.0, 'x_m': 2.0, 'y_m': 2.0,
         'envelope_volume_m3': 0.5, 'mols_air': 1.0}


def _np_dict(obj):
  """A flax struct dataclass as a nested dict of numpy arrays."""
  out = {}
  for f in dataclasses.fields(obj):
    v = getattr(obj, f.name)
    out[f.name] = (_np_dict(v) if dataclasses.is_dataclass(v) else
                   None if v is None else np.asarray(v))
  return out


def _random_world(seed, n=E):
  """(jax BalloonState batch after the stable init, jax atmosphere batch)."""
  rng = np.random.RandomState(seed)
  atmo = jax_atmosphere.make(jnp.asarray(rng.uniform(size=n), jnp.float32))
  f32 = lambda a: jnp.asarray(a, jnp.float32)
  i32 = lambda a: jnp.asarray(a, jnp.int32)
  t0 = i32(rng.randint(1293840000, 1419984000, size=n))
  lat = f32(np.radians(rng.uniform(-10, 10, n)))
  lng = f32(np.radians(rng.uniform(-175, 175, n)))
  sunrise, sunset = jax.vmap(jax_solar.next_sunrise_sunset)(lat, lng, t0)
  state = jax_balloon.BalloonState(
      center_lat_rad=lat, center_lng_rad=lng,
      x_m=f32(rng.uniform(-150e3, 150e3, n)),
      y_m=f32(rng.uniform(-150e3, 150e3, n)),
      pressure_pa=f32(rng.uniform(6500, 11000, n)), time_s=t0,
      time_elapsed_s=i32(np.zeros(n)), ambient_temperature_k=f32(
          np.full(n, 206.0)), internal_temperature_k=f32(np.full(n, 206.0)),
      mols_air=f32(np.zeros(n)), envelope_volume_m3=f32(np.full(n, 1804.0)),
      superpressure_pa=f32(np.zeros(n)), acs_power_w=f32(np.zeros(n)),
      acs_mass_flow_kg_s=f32(np.zeros(n)), solar_charging_w=f32(np.zeros(n)),
      power_load_w=f32(np.zeros(n)),
      battery_charge_j=f32(rng.uniform(0.3, 1.0, n) * 3058.56 * 3600.0),
      last_command=i32(np.ones(n)), status=i32(np.zeros(n)),
      upwelling_infrared_w_m2=f32(rng.uniform(225, 315, n)),
      power_safety=jax_safety.PowerSafetyState(
          navigation_is_paused=jnp.zeros(n, jnp.bool_),
          sunrise_with_hysteresis_s=sunrise + 1800, sunset_s=sunset),
      envelope_safety_state=i32(np.zeros(n)),
      altitude_safety_state=i32(np.zeros(n)))
  params = jax_balloon.BalloonParams()
  state = jax.vmap(lambda s, a: jax_stable_init.cold_start_to_stable_params(
      params, s, a))(state, atmo)
  return state, atmo


def _to_port(state, atmo):
  return (bridge.from_dict(balloon.BalloonState, _np_dict(state)),
          bridge.from_dict(atmosphere.AtmosphereParams, _np_dict(atmo)))


def _assert_balloon_close(got, want, rtol=5e-4):
  for name in balloon.SUBSTEP_F32_FIELDS:
    np.testing.assert_allclose(getattr(got, name).numpy(),
                               np.asarray(getattr(want, name)), rtol=rtol,
                               atol=_ATOL.get(name, 1e-2), err_msg=name)
  for name in balloon.SUBSTEP_I32_FIELDS + (
      'last_command', 'envelope_safety_state', 'altitude_safety_state'):
    np.testing.assert_array_equal(getattr(got, name).numpy(),
                                  np.asarray(getattr(want, name)),
                                  err_msg=name)


@pytest.fixture(scope='module')
def world():
  return _random_world(0)


def test_datetime_from_unix_seconds_matches_jax():
  """Equal datetimes, UTC, for timestamps before 1970, across 2038's int32
  edge and beyond it, and the inverse of unix_seconds_from_datetime."""
  for s in (0, 1, -1, -86_400 * 365 - 7, 1_293_840_000, 2**31 - 1, 2**31,
            4_102_444_800, 253_402_300_799):
    got = time_lib.datetime_from_unix_seconds(s)
    assert got == jax_time_lib.datetime_from_unix_seconds(s)
    assert got.tzinfo == datetime.timezone.utc
    assert time_lib.unix_seconds_from_datetime(got) == s


def test_time_lib_and_pmath_match_jax():
  rng = np.random.RandomState(1)
  t = rng.randint(0, 2**31 - 1, size=4096).astype(np.int32)
  for got, want in zip(time_lib.civil_from_unix_seconds(torch.from_numpy(t)),
                       jax_time_lib.civil_from_unix_seconds(jnp.asarray(t))):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  for got, want in zip(time_lib.days_from_j2000(torch.from_numpy(t)),
                       jax_time_lib.days_from_j2000(jnp.asarray(t))):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  x = rng.uniform(-3, 3, size=4096).astype(np.float32)
  y = rng.uniform(-3, 3, size=4096).astype(np.float32)
  tx, ty = torch.from_numpy(x), torch.from_numpy(y)
  # Float32 polynomial evaluations: a few ulp apart at most.
  for got, want in ((pmath.atan2(ty, tx), jax_pmath.atan2(y, x)),
                    (pmath.asin(tx / 3), jax_pmath.asin(x / 3)),
                    (pmath.acos(tx / 3), jax_pmath.acos(x / 3)),
                    (pmath.tan(tx), jax_pmath.tan(x)),
                    (pmath.fmod(tx * 500, 7.0), jax_pmath.fmod(x * 500, 7.0)),
                    (pmath.powf(tx.abs(), 0.37), jax_pmath.powf(np.abs(x),
                                                                0.37))):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_solar_and_sunrise_match_jax(world):
  state, _ = world
  lat = torch.from_numpy(np.asarray(state.center_lat_rad))
  lng = torch.from_numpy(np.asarray(state.center_lng_rad))
  t0 = torch.from_numpy(np.asarray(state.time_s))
  got = solar.solar_calculator(lat, lng, t0)
  want = jax_solar.solar_calculator(state.center_lat_rad,
                                    state.center_lng_rad, state.time_s)
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-3)
  rise, sset = solar.next_sunrise_sunset(lat, lng, t0)
  jrise, jset = jax.vmap(jax_solar.next_sunrise_sunset)(
      state.center_lat_rad, state.center_lng_rad, state.time_s)
  # Crossings are refined to seconds inside a 180 s bracket; float32
  # rounding may move the rounded second by one.
  np.testing.assert_allclose(rise.numpy(), np.asarray(jrise), atol=1)
  np.testing.assert_allclose(sset.numpy(), np.asarray(jset), atol=1)


def test_simulate_step_matches_jax_random_batch(world):
  state, atmo = world
  params = jax_balloon.BalloonParams()
  rng = np.random.RandomState(2)
  jstep = jax.jit(jax.vmap(lambda a, b, u, v, act: jax_balloon.simulate_step(
      params, a, b, u, v, act)))
  got, tatmo = _to_port(state, atmo)
  want = state
  for _ in range(5):
    wu = rng.normal(0, 8, E).astype(np.float32)
    wv = rng.normal(0, 8, E).astype(np.float32)
    act = rng.randint(0, 3, E).astype(np.int32)
    want = jstep(atmo, want, jnp.asarray(wu), jnp.asarray(wv),
                 jnp.asarray(act))
    got = balloon.simulate_step(balloon.BalloonParams(), tatmo, got,
                                torch.from_numpy(wu), torch.from_numpy(wv),
                                torch.from_numpy(act))
    _assert_balloon_close(got, want)


def test_fused_cpu_matches_pallas_interpret(world):
  """ops.physics on CPU tensors (the plain version) against the Pallas
  kernel in interpret mode, at the 3 substeps test_pallas_physics.py:25-41
  uses to keep the interpreter tractable."""
  state, atmo = world
  n = 4
  state = jax.tree.map(lambda x: x[:n], state)
  atmo = jax.tree.map(lambda x: x[:n], atmo)
  wu = np.asarray([5.0, -3.0, 0.0, 10.0], np.float32)
  wv = np.asarray([1.0, 2.0, -4.0, 0.0], np.float32)
  act = np.asarray([0, 1, 2, 0], np.int32)
  want = pallas_physics.simulate_step_fused(
      jax_balloon.BalloonParams(), atmo, state, jnp.asarray(wu),
      jnp.asarray(wv), jnp.asarray(act), time_delta_s=30, stride_s=10,
      interpret=True)
  tstate, tatmo = _to_port(state, atmo)
  got = physics.simulate_step_fused(
      balloon.BalloonParams(), tatmo, tstate, torch.from_numpy(wu),
      torch.from_numpy(wv), torch.from_numpy(act), time_delta_s=30,
      stride_s=10)
  _assert_balloon_close(got, want)


def test_golden_reference_physics():
  """The 60-step upstream-reference fixture, at the tolerances of
  tests/test_golden_trajectory.py:118-126."""
  with open(os.path.join(_DIR, 'golden_reference_physics.json')) as f:
    g = json.load(f)
  jatmo = jax_atmosphere.reset(jax.random.PRNGKey(g['atmosphere_key_seed']))
  atmo = bridge.from_dict(atmosphere.AtmosphereParams,
                          {k: v[None] for k, v in _np_dict(jatmo).items()})
  start, init = g['start'], g['init_after_stable']
  f32 = lambda v: torch.tensor([v], dtype=torch.float32)
  i32 = lambda v: torch.tensor([v], dtype=torch.int32)
  lat = f32(np.radians(start['lat_deg']))
  lng = f32(np.radians(start['lng_deg']))
  t0 = i32(start['unix_s'])
  sunrise, sunset = solar.next_sunrise_sunset(lat, lng, t0)
  state = balloon.BalloonState(
      center_lat_rad=lat, center_lng_rad=lng, x_m=f32(start['x_km'] * 1000.0),
      y_m=f32(start['y_km'] * 1000.0), pressure_pa=f32(start['pressure_pa']),
      time_s=t0, time_elapsed_s=i32(0),
      ambient_temperature_k=f32(init['ambient_temperature']),
      internal_temperature_k=f32(init['internal_temperature']),
      mols_air=f32(init['mols_air']),
      envelope_volume_m3=f32(init['envelope_volume']),
      superpressure_pa=f32(init['superpressure']), acs_power_w=f32(0.0),
      acs_mass_flow_kg_s=f32(0.0), solar_charging_w=f32(0.0),
      power_load_w=f32(0.0),
      battery_charge_j=f32(init['battery_charge_wh'] *
                           jax_constants.WATT_HOURS_TO_JOULES),
      last_command=i32(safety.STAY), status=i32(balloon.STATUS_OK),
      upwelling_infrared_w_m2=f32(start['upwelling_ir']),
      power_safety=safety.PowerSafetyState(
          navigation_is_paused=torch.tensor([False]),
          sunrise_with_hysteresis_s=sunrise + safety.POWER_SUNRISE_HYSTERESIS_S,
          sunset_s=sunset),
      envelope_safety_state=i32(0), altitude_safety_state=i32(0))
  wind_u, wind_v = f32(g['wind']['u']), f32(g['wind']['v'])
  rows = iter(g['rows'])
  expected = next(rows)
  for i, a in enumerate(g['actions']):
    state = physics.simulate_step_fused(balloon.BalloonParams(), atmo, state,
                                        wind_u, wind_v, i32(a))
    if i + 1 == expected['step']:
      assert abs(float(state.x_m) - expected['x_m']) < 5.0
      assert abs(float(state.y_m) - expected['y_m']) < 5.0
      assert abs(float(state.pressure_pa) - expected['pressure_pa']) < 1.0
      assert abs(float(state.superpressure_pa) -
                 expected['superpressure_pa']) < 2.0
      assert abs(float(state.mols_air) - expected['mols_air']) < 0.2
      assert abs(float(state.battery_charge_j) -
                 expected['battery_charge_j']) < 2500.0
      assert int(state.status) == expected['status']
      expected = next(rows, None)
      if expected is None:
        break
  assert expected is None


def test_terminal_balloons_freeze(world):
  state, atmo = world
  tstate, tatmo = _to_port(state, atmo)
  status = tstate.status.clone()
  status[0] = balloon.STATUS_BURST
  tstate = dataclasses.replace(tstate, status=status)
  out = physics.simulate_step_fused(
      balloon.BalloonParams(), tatmo, tstate, torch.full((E,), 5.0),
      torch.zeros(E), torch.ones(E, dtype=torch.int32))
  for name in balloon.SUBSTEP_F32_FIELDS + balloon.SUBSTEP_I32_FIELDS:
    assert torch.equal(getattr(out, name)[0], getattr(tstate, name)[0]), name
  assert torch.equal(out.last_command[0], tstate.last_command[0])
  assert float(out.x_m[1]) != float(tstate.x_m[1])  # Advected.
  assert int(out.time_elapsed_s[1]) == 180


def test_layer_seam_state_stays_finite():
  """The 17 km layer-seam regression state of
  tests/test_pallas_physics.py::test_layer_seam_state_stays_finite."""
  with open(os.path.join(_DIR, 'layer_seam_state.json')) as f:
    d = json.load(f)
  n = 8
  rep = lambda v: np.repeat(np.asarray(v)[None], n, axis=0)
  b = {k: rep(np.float32(v) if isinstance(v, float) else np.int32(v))
       for k, v in d['balloon'].items()}
  b['power_safety'] = {
      'navigation_is_paused': rep(d['power_safety']['navigation_is_paused']),
      'sunrise_with_hysteresis_s': rep(np.int32(
          d['power_safety']['sunrise_with_hysteresis_s'])),
      'sunset_s': rep(np.int32(d['power_safety']['sunset_s']))}
  state = bridge.from_dict(balloon.BalloonState, b)
  atmo = bridge.from_dict(atmosphere.AtmosphereParams,
                          {k: rep(np.asarray(v, np.float32))
                           for k, v in d['atmosphere'].items()})
  for _ in range(10):
    state = physics.simulate_step_fused(
        balloon.BalloonParams(), atmo, state,
        torch.full((n,), d['wind_u']), torch.full((n,), d['wind_v']),
        torch.zeros(n, dtype=torch.int32))
  for name in balloon.SUBSTEP_F32_FIELDS:
    assert bool(torch.isfinite(getattr(state, name)).all()), name


def test_solar_track_plain_is_what_each_substep_reads(world, monkeypatch):
  """The plain version of the physics kernel's first phase against the
  sun that balloon.run_substeps's own substeps see: at each of 18
  substeps, for every balloon still OK there, the elevation, flux and the
  elevation-only terms of the attenuation and panel power, bit for bit, on
  the 8 drawn worlds. Two balloons, with 10 kJ left at night, run out of
  power mid-step; their later substeps are not compared."""
  state, atmo = world
  tstate, tatmo = _to_port(state, atmo)
  battery = tstate.battery_charge_j.clone()
  battery[[4, 6]] = 10000.0
  tstate = dataclasses.replace(tstate, battery_charge_j=battery)
  rng = np.random.RandomState(2)
  wu = torch.from_numpy(rng.normal(0, 8, E).astype(np.float32))
  wv = torch.from_numpy(rng.normal(0, 8, E).astype(np.float32))
  params = balloon.BalloonParams()
  b, act = balloon.apply_safety(params, tatmo, tstate,
                                torch.zeros(E, dtype=torch.int32))
  seen = []
  substep_math = balloon.substep_math

  def recording(params, atmosphere, v, *args):
    seen.append(dict(v))
    return substep_math(params, atmosphere, v, *args)

  monkeypatch.setattr(balloon, 'substep_math', recording)
  out = balloon.run_substeps(params, tatmo, b, wu, wv, act, 18, 10)
  elapsed = out.time_elapsed_s - b.time_elapsed_s
  assert out.status[4] != balloon.STATUS_OK and 0 < elapsed[4] < 180
  assert out.status[6] != balloon.STATUS_OK and 0 < elapsed[6] < 180

  track = physics.solar_track_plain(b, wu, wv, 18, 10)
  assert track.shape == (E, 18, 5)
  for s, v in enumerate(seen):
    ok = v['status'] == balloon.STATUS_OK
    lat, lng = spherical.latlng_from_offset(
        v['center_lat_rad'], v['center_lng_rad'], v['x_m'], v['y_m'])
    el, _, flux = solar.solar_calculator(lat, lng, v['time_s'])
    want = torch.stack([el, flux, solar.elevation_sine_term(el),
                        *solar.panel_terms(el)], dim=-1)
    assert torch.equal(track[:, s][ok], want[ok]), s
  assert int((track[:, :, 0] > solar.MIN_SOLAR_EL_DEG).sum()) > 0


@pytest.mark.parametrize('n_sms', [114, 132])
@pytest.mark.parametrize('n_envs', [1, 7, 131, 132, 133, 1000, 4096])
def test_env_split_covers_every_env_once(n_envs, n_sms):
  """B1's CTAs of G envs: every env in exactly one CTA, no CTA empty,
  G <= 32, one env a CTA while the envs do not fill the card, and below
  32 the least G that keeps to one CTA a SM."""
  g = physics.env_split(n_envs, n_sms)
  assert 1 <= g <= physics.MAX_ENVS_PER_CTA
  ctas = -(-n_envs // g)
  covered = np.zeros(n_envs, np.int64)
  for b in range(ctas):
    begin, end = b * g, min(n_envs, b * g + g)
    assert begin < end
    covered[begin:end] += 1
  np.testing.assert_array_equal(covered, 1)
  if n_envs <= n_sms:
    assert g == 1
  if g < physics.MAX_ENVS_PER_CTA:
    assert ctas <= n_sms
  if g > 1:
    assert -(-n_envs // (g - 1)) > n_sms
