"""US Standard Atmosphere 1976 with a randomized lapse-rate blend
(reference standard_atmosphere.py; the port of ble_tpu/env/atmosphere.py).

`AtmosphereParams` leaves carry a trailing layer axis after the env axis:
lapse_rates (E, 7), temperature/pressure transitions (E, 8). `at_pressure`
and `at_height` select the layer with a monotone-mask count and gather it.
"""

import dataclasses

import torch

from portbench.reference.sim import pmath
from portbench.reference.sim import constants
from portbench.reference.sim import prng

HEIGHT_TRANSITIONS = (
    -610.0, 17000.0, 21000.0, 32000.0, 47000.0, 51000.0, 71000.0, 85000.0)
LAPSE_RATES_LOW = (-0.007, 0.006, 0.001, 0.0028, 0.0, -0.0028, -0.002)
LAPSE_RATES_HIGH = (-0.0058, 0.005, 0.001, 0.0028, 0.0, -0.0028, -0.002)
BASE_TEMPERATURE = 300.0  # [K]
BASE_PRESSURE = 108870.8213  # [Pa]

_R = constants.DRY_AIR_SPECIFIC_GAS_CONSTANT
_G = constants.GRAVITY


@dataclasses.dataclass
class AtmosphereParams:
  lapse_rates: torch.Tensor  # (..., 7)
  temperature_transitions: torch.Tensor  # (..., 8)
  pressure_transitions: torch.Tensor  # (..., 8)


def reset(keys) -> AtmosphereParams:
  """One atmosphere a key of keys (E, 2), on the CPU
  (ble_tpu/env/atmosphere.py:41-44; standard_atmosphere.py:76-87)."""
  return make(prng.uniform(keys))


def make(alpha) -> AtmosphereParams:
  """The profile for lapse-rate blend coefficients `alpha` in [0, 1]."""
  alpha = torch.as_tensor(alpha, dtype=torch.float32)
  dev = alpha.device
  low = torch.tensor(LAPSE_RATES_LOW, dtype=torch.float32, device=dev)
  high = torch.tensor(LAPSE_RATES_HIGH, dtype=torch.float32, device=dev)
  alpha = alpha[..., None]
  lapse = (1.0 - alpha) * low + alpha * high  # (..., 7)

  heights = torch.tensor(HEIGHT_TRANSITIONS, dtype=torch.float32, device=dev)
  dh = heights[1:] - heights[:-1]

  temps = torch.cat(
      [torch.full(lapse.shape[:-1] + (1,), BASE_TEMPERATURE, device=dev),
       BASE_TEMPERATURE + torch.cumsum(lapse * dh, dim=-1)], dim=-1)

  is_iso = lapse == 0.0
  safe_lapse = torch.where(is_iso, torch.ones_like(lapse), lapse)
  ratio_linear = pmath.powf(temps[..., 1:] / temps[..., :-1],
                            -_G / (_R * safe_lapse))
  ratio_iso = torch.exp(-_G * dh / (_R * temps[..., 1:]))
  ratios = torch.where(is_iso, ratio_iso, ratio_linear)
  pressures = BASE_PRESSURE * torch.cat(
      [torch.ones(lapse.shape[:-1] + (1,), device=dev),
       torch.cumprod(ratios, dim=-1)], dim=-1)
  return AtmosphereParams(lapse_rates=lapse, temperature_transitions=temps,
                          pressure_transitions=pressures)


def _select_layer(mask_upper):
  """Index of the first True entry of a mask monotone along its last axis."""
  n = mask_upper.shape[-1]
  return n - mask_upper.to(torch.int64).sum(dim=-1)


def _gather_layer(table, idx):
  """table[..., idx] as a one-hot masked sum, broadcasting table batch dims
  against idx; an index past the table's end gives 0, as in the JAX
  package."""
  onehot = torch.arange(table.shape[-1], device=idx.device) == idx[..., None]
  return torch.where(onehot, table, torch.zeros_like(table)).sum(dim=-1)


def _heights(like):
  return torch.tensor(HEIGHT_TRANSITIONS, dtype=torch.float32,
                      device=like.device)


def at_pressure(params: AtmosphereParams, pressure):
  """(height_m, temperature_K, density) at an ambient pressure.

  `pressure` may carry extra axes that broadcast against the params'
  batch axes (standard_atmosphere.py:122-154)."""
  pt = params.pressure_transitions
  idx = _select_layer(pressure[..., None] > pt[..., 1:])

  p0 = _gather_layer(pt, idx)
  t0 = _gather_layer(params.temperature_transitions, idx)
  l0 = _gather_layer(params.lapse_rates, idx)
  h0 = _heights(pressure)[idx]

  is_iso = l0 == 0.0
  safe_l = torch.where(is_iso, torch.ones_like(l0), l0)
  height_iso = (-_R * t0 / _G) * torch.log(pressure / p0) + h0
  height_lin = (pmath.powf(pressure / p0, -_R * safe_l / _G) - 1.0) * t0 / \
      safe_l + h0
  height = torch.where(is_iso, height_iso, height_lin)

  temperature = t0 + l0 * (height - h0)
  density = pressure / (_R * temperature)
  return height, temperature, density


def at_height(params: AtmosphereParams, height_m):
  """(pressure_Pa, temperature_K, density) at a geopotential height
  (standard_atmosphere.py:89-120). `height_m` may be a Python float."""
  pt = params.pressure_transitions
  height_m = torch.as_tensor(height_m, dtype=torch.float32, device=pt.device)
  height_m = height_m.expand(
      torch.broadcast_shapes(height_m.shape, pt.shape[:-1]))
  heights = _heights(pt)
  idx = _select_layer(height_m[..., None] < heights[1:])

  p0 = _gather_layer(pt, idx)
  t0 = _gather_layer(params.temperature_transitions, idx)
  l0 = _gather_layer(params.lapse_rates, idx)
  h0 = heights[idx]

  temperature = t0 + l0 * (height_m - h0)
  is_iso = l0 == 0.0
  safe_l = torch.where(is_iso, torch.ones_like(l0), l0)
  pressure_iso = p0 * torch.exp(-_G * (height_m - h0) / (_R * temperature))
  pressure_lin = p0 * pmath.powf(temperature / t0, -_G / (_R * safe_l))
  pressure = torch.where(is_iso, pressure_iso, pressure_lin)

  density = pressure / (_R * temperature)
  return pressure, temperature, density
