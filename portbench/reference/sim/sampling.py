"""Initial-condition samplers over a batch of jax.random keys (the port of
ble_tpu/utils/sampling.py; reference utils/sampling.py).

Each sampler takes keys (E, 2) (utils/prng.py) and draws what its JAX
counterpart draws from each key, so a key gives the same initial
conditions in both packages. The draws run on the CPU; callers move the
results to their device.
"""

import datetime as dt
import math

import torch

from portbench.reference.sim import atmosphere as atmosphere_lib
from portbench.reference.sim import safety
from portbench.reference.sim import prng
from portbench.reference.sim import time_lib

MIN_ALLOWABLE_UPWELLING_IR = 225.0
MIN_PRESSURE_PA = 6500.0

_TIME_BEGIN_S = time_lib.unix_seconds_from_datetime(
    dt.datetime(2011, 1, 1, tzinfo=dt.timezone.utc))
_TIME_END_S = time_lib.unix_seconds_from_datetime(
    dt.datetime(2014, 12, 31, tzinfo=dt.timezone.utc))


def sample_location(keys):
  """(lat_rad, lng_rad): lat in +-10 deg, lng in +-175 deg
  (ble_tpu/utils/sampling.py:26-32)."""
  ks = prng.split(keys)
  lat_deg = prng.uniform(ks[:, 0], (), -10.0, 10.0)
  lng_deg = prng.uniform(ks[:, 1], (), -175.0, 175.0)
  return torch.deg2rad(lat_deg), torch.deg2rad(lng_deg)


def sample_time(keys):
  """Uniform int32 unix seconds in [2011-01-01, 2014-12-31): a
  jax.random.choice in the default int dtype (ble_tpu/utils/sampling.py:
  35-48)."""
  offset = prng.choice(keys, _TIME_END_S - _TIME_BEGIN_S)
  return (_TIME_BEGIN_S + offset.to(torch.int64)).to(torch.int32)


def sample_pressure(keys, atmosphere: atmosphere_lib.AtmosphereParams):
  """Uniform pressure in [6500, p(50 kft)] of each env's atmosphere
  (ble_tpu/utils/sampling.py:51-61)."""
  max_pressure, _, _ = atmosphere_lib.at_height(atmosphere,
                                                safety.ALTITUDE_MIN_M)
  return prng.uniform(keys, (), MIN_PRESSURE_PA, max_pressure)


def sample_upwelling_infrared(keys, num_tries: int = 16):
  """LogitNormal(2, 315)-scaled upwelling IR, rejecting values below
  225 W/m^2: the first acceptable of `num_tries` candidates
  (ble_tpu/utils/sampling.py:64-76)."""
  z = prng.fma32(prng.normal(keys, (num_tries,)), 315.0, 2.0)
  candidates = 315.0 * torch.sigmoid(z)
  ok = candidates >= MIN_ALLOWABLE_UPWELLING_IR
  first = ok.to(torch.uint8).argmax(dim=-1, keepdim=True)
  pick = torch.gather(candidates, -1, first)[:, 0]
  return torch.where(ok.any(dim=-1), pick,
                     torch.full_like(pick, MIN_ALLOWABLE_UPWELLING_IR))


def sample_initial_offset(keys):
  """(x_m, y_m): Beta(1.2, 2)-distributed radius within 200 km, uniform
  angle (ble_tpu/utils/sampling.py:79-86; reference
  balloon_arena.py:242-250)."""
  ks = prng.split(keys)
  radius_m = prng.beta(ks[:, 0], 1.2, 2.0) * 200_000.0
  theta = prng.uniform(ks[:, 1], (), 0.0, 2.0 * math.pi)
  return torch.cos(theta) * radius_m, torch.sin(theta) * radius_m


def sample_initial_conditions(keys):
  """Every env's initial conditions from its reset key, as
  ble_tpu/env/env.py:reset_from_field splits it (7 ways: atmosphere, time,
  offset, location, pressure, upwelling IR, wind).

  Returns a dict of CPU tensors with a leading env axis: atmosphere_alpha,
  time_s, x_m, y_m, center_lat_rad, center_lng_rad, pressure_pa,
  upwelling_ir, and noise_keys (E, 2), from which wind_field.make_state
  draws the noise (wind_field.reset_noise).
  """
  ks = prng.split(keys, 7)
  alpha = prng.uniform(ks[:, 0])
  x_m, y_m = sample_initial_offset(ks[:, 2])
  lat, lng = sample_location(ks[:, 3])
  return {
      'atmosphere_alpha': alpha,
      'time_s': sample_time(ks[:, 1]),
      'x_m': x_m,
      'y_m': y_m,
      'center_lat_rad': lat,
      'center_lng_rad': lng,
      'pressure_pa': sample_pressure(ks[:, 4], atmosphere_lib.make(alpha)),
      'upwelling_ir': sample_upwelling_infrared(ks[:, 5]),
      'noise_keys': prng.split(ks[:, 6])[:, 0],
  }
