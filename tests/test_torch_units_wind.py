"""The port's host-side units (ble_tpu_torch/utils/units.py) held to the
assertions of tests/test_units_and_misc.py, and its wind utilities
(utils/wind.py) against ble_tpu.utils.wind on random columns and fields."""

import datetime as dt

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ble_tpu.utils import wind as jax_wind
from ble_tpu_torch.utils import units
from ble_tpu_torch.utils import wind


def test_units_algebra():
  d = units.Distance(km=3.0)
  assert d.meters == 3000.0
  assert abs(units.Distance(feet=50000.0).meters - 15240.0) < 1e-6
  v = units.Velocity(mps=10.0)
  assert (v * dt.timedelta(seconds=30)).meters == 300.0
  p = units.Power(watts=100.0)
  e = p * dt.timedelta(hours=2)
  assert abs(e.watt_hours - 200.0) < 1e-9
  assert (e / units.Energy(watt_hours=100.0)) == 2.0
  assert units.relative_distance(units.Distance(m=3.0),
                                 units.Distance(m=4.0)).meters == 5.0
  t = units.datetime(2013, 1, 1)
  assert t.tzinfo is not None
  assert units.timedelta_to_hours(dt.timedelta(hours=3)) == 3.0


def test_units_conversions_and_errors():
  assert units.Distance(m=1500.0).km == 1.5
  assert units.Velocity(kmph=36.0).mps == pytest.approx(10.0)
  assert (units.Distance(km=1.0) / dt.timedelta(seconds=100)).mps == 10.0
  assert units.Energy(joules=7200.0).watt_hours == 2.0
  assert (units.Energy(watt_hours=1.0) / dt.timedelta(hours=1)).watts == (
      pytest.approx(1.0))
  assert units.Distance(m=1.0) < units.Distance(m=2.0)
  assert units.Power(watts=3.0) / units.Power(watts=1.5) == 2.0
  assert len({units.Distance(m=1.0), units.Distance(meters=1.0)}) == 1
  for make in (lambda: units.Distance(), lambda: units.Distance(m=1, km=1),
               lambda: units.Velocity(), lambda: units.Energy()):
    with pytest.raises(ValueError, match='exactly one'):
      make()


def test_station_keeping_winds():
  """tests/test_units_and_misc.py's three columns."""
  angles = torch.linspace(0, 2 * np.pi, 9)[:-1]
  assert bool(wind.is_station_keeping_winds(10 * torch.cos(angles),
                                            10 * torch.sin(angles)))
  assert not bool(wind.is_station_keeping_winds(torch.full((8,), 10.0),
                                                torch.full((8,), 1.0)))
  u2 = torch.tensor([10.0, -10.0, 10.0, -10.0])
  assert not bool(wind.is_station_keeping_winds(u2, torch.zeros(4)))


def test_station_keeping_winds_match_jax_over_a_batch():
  """256 random 9-level columns, a third of them blowing within a half
  plane, with exact-zero and near-zero (below and above the 1e-6
  threshold) winds at random levels: the same verdicts as ble_tpu's, and
  both verdicts occur."""
  rng = np.random.RandomState(0)
  n, levels = 256, 9
  speed = rng.uniform(0.5, 20.0, (n, levels))
  angle = rng.uniform(-np.pi, np.pi, (n, levels))
  half = rng.rand(n) < 1 / 3
  angle[half] = rng.uniform(0.0, 0.9 * np.pi, (half.sum(), levels))
  zero = rng.rand(n, levels) < 0.15
  tiny = rng.rand(n, levels) < 0.1
  speed[zero] = 0.0
  speed[tiny] = rng.choice([3e-7, 5e-6], tiny.sum())
  u = (speed * np.cos(angle)).astype(np.float32)
  v = (speed * np.sin(angle)).astype(np.float32)
  got = wind.is_station_keeping_winds(torch.from_numpy(u),
                                      torch.from_numpy(v)).numpy()
  want = np.asarray(jax_wind.is_station_keeping_winds(jnp.asarray(u),
                                                      jnp.asarray(v)))
  np.testing.assert_array_equal(got, want)
  assert got.any() and not got.all()


def test_mean_wind_speed_matches_jax():
  """Over a batch of 2 random (21, 21, 10, 9, 2) grids, within 1e-5 of
  ble_tpu's (float32 means of 39,690 speeds, summed in another order);
  a constant (3, 4) field reads 5."""
  rng = np.random.RandomState(1)
  field = rng.randn(2, 21, 21, 10, 9, 2).astype(np.float32) * 10.0
  got = wind.mean_wind_speed(torch.from_numpy(field)).numpy()
  want = np.asarray(jax_wind.mean_wind_speed(jnp.asarray(field)))
  assert got.shape == want.shape == (2,)
  np.testing.assert_allclose(got, want, rtol=1e-5)
  const = torch.zeros((21, 21, 10, 9, 2))
  const[..., 0], const[..., 1] = 3.0, 4.0
  assert abs(float(wind.mean_wind_speed(const)) - 5.0) < 1e-5
