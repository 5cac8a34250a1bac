"""Every seed of every eval suite gets the JAX package's initial
conditions in the port, on the CPU: the 13,005 distinct seeds of
train/suites.py (up to 23,485) drawn through the port's
sampling.sample_initial_conditions(env.seed_keys(seeds)) and its noise
reset, and through ble_tpu's seven-way split of env.reset_from_field.

Integers and uniforms (time_s, the noise seeds and offsets, the
atmosphere's alpha) are equal; draws through normals, beta rejection
loops and float32 math within 1e-5 relative, the tolerance of
tests/test_torch_worlds.py::test_reset_by_seed_matches_jax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ble_tpu.env import atmosphere as jax_atmosphere
from ble_tpu.env import wind_field as jax_wind_field
from ble_tpu.train import eval_lib as jax_eval_lib
from ble_tpu.utils import sampling as jax_sampling
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.env import wind_field
from ble_tpu_torch.train import suites
from ble_tpu_torch.utils import sampling

NAMES = ('atmosphere_alpha', 'time_s', 'x_m', 'y_m', 'center_lat_rad',
         'center_lng_rad', 'pressure_pa', 'upwelling_ir', 'noise_seeds',
         'noise_offsets')
EXACT = ('time_s', 'noise_seeds', 'atmosphere_alpha', 'noise_offsets')
RTOL = 1e-5


def _suite_seeds():
  seeds = set()
  for name in suites.available_suites():
    seeds |= set(suites.get_eval_suite(name).seeds)
  return sorted(seeds)


def _jax_initial_conditions(seed):
  """ble_tpu's initial conditions of one integer seed: seed_to_key, then
  the split of ble_tpu/env/env.py:reset_from_field."""
  key = jax_eval_lib.seed_to_key(seed)
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


@pytest.fixture(scope='module')
def draws():
  seeds = _suite_seeds()
  want = jax.jit(jax.vmap(_jax_initial_conditions))(
      jnp.asarray(seeds, jnp.int32))
  got = sampling.sample_initial_conditions(env_lib.seed_keys(seeds))
  got['noise_seeds'], got['noise_offsets'] = wind_field.reset_noise(
      got.pop('noise_keys'))
  return seeds, {k: got[k].numpy() for k in got}, jax.tree.map(np.asarray,
                                                              want)


def test_the_suites_hold_every_seed_drawn(draws):
  seeds, got, want = draws
  assert len(seeds) == 13_005 and seeds[0] == 0 and seeds[-1] == 23_485
  assert set(got) == set(want) == set(NAMES)
  for name, value in got.items():
    assert value.shape == want[name].shape, name


@pytest.mark.parametrize('name', NAMES)
def test_every_suite_seed_draws_the_jax_initial_conditions(draws, name):
  seeds, got, want = draws
  if name in EXACT:
    bad = np.flatnonzero((got[name] != want[name]).reshape(len(seeds), -1)
                         .any(axis=1))
    assert bad.size == 0, [seeds[i] for i in bad[:10]]
  else:
    np.testing.assert_allclose(got[name], want[name], rtol=RTOL, atol=0.0,
                               err_msg=name)
