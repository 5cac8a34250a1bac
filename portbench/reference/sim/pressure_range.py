"""Accessible pressure range given the superpressure safety buffers (the
port of ble_tpu/env/pressure_range.py; reference
env/balloon/pressure_range_builder.py:68-275). The scan over a 20-level
pressure column becomes mask/argmax arithmetic over the whole column."""

import dataclasses

import torch

from portbench.reference.sim import atmosphere as atmosphere_lib
from portbench.reference.sim import safety
from portbench.reference.sim import stable_init
from portbench.reference.sim import constants

NUM_LEVELS = 20
SEARCH_RANGE_MIN_PA = 1000.0


def _take(x, idx):
  return torch.gather(x, -1, idx[..., None])[..., 0]


def _first_true(mask):
  """argmax of a bool mask along the last axis (first True, or 0)."""
  return mask.to(torch.uint8).argmax(dim=-1)


def _interp_with_extrapolation(x, xp, fp):
  """Linear interpolation with extrapolation; xp sorted along its last axis."""
  count = (xp <= x[..., None]).sum(dim=-1)
  idx = torch.clamp(count - 1, 0, xp.shape[-1] - 2)
  x0, x1 = _take(xp, idx), _take(xp, idx + 1)
  f0, f1 = _take(fp, idx), _take(fp, idx + 1)
  return f0 + (x - x0) * (f1 - f0) / (x1 - x0)


def _threshold_crossing(p1, sp1, p2, sp2, min_sp, max_sp):
  """Pressure where superpressure crosses the violated safety threshold
  (_compute_safe_pressure, pressure_range_builder.py:68-102)."""
  crosses_min = (sp1 < min_sp) != (sp2 < min_sp)
  y_star = torch.where(crosses_min, min_sp, max_sp)
  denom = torch.where(sp2 == sp1, torch.ones_like(sp1), sp2 - sp1)
  alpha = torch.abs((y_star - sp1) / denom)
  return alpha * (p2 - p1) + p1


def get_pressure_range(pressure_levels, sp_levels, sp_min_significant,
                       min_pressure_significant, min_sp, max_sp):
  """(min_pressure, max_pressure) with safe superpressure; see
  ble_tpu/env/pressure_range.py:get_pressure_range."""
  def in_range(sp):
    return (sp >= min_sp) & (sp <= max_sp)

  n = pressure_levels.shape[-1]

  considered_up = pressure_levels >= min_pressure_significant[..., None]
  safe_up = considered_up & in_range(sp_levels)
  any_safe_up = safe_up.any(dim=-1)
  j_up = _first_true(safe_up)
  i0_up = _first_true(considered_up)
  has_prev_level = j_up > i0_up
  prev_idx = torch.clamp_min(j_up - 1, 0)
  prev_p = torch.where(has_prev_level, _take(pressure_levels, prev_idx),
                       min_pressure_significant)
  prev_sp = torch.where(has_prev_level, _take(sp_levels, prev_idx),
                        sp_min_significant)
  cur_p = _take(pressure_levels, j_up)
  cur_sp = _take(sp_levels, j_up)
  min_pressure = _threshold_crossing(prev_p, prev_sp, cur_p, cur_sp, min_sp,
                                     max_sp)
  min_pressure = torch.where(in_range(sp_min_significant),
                             min_pressure_significant, min_pressure)
  min_pressure = torch.where(any_safe_up | in_range(sp_min_significant),
                             min_pressure, pressure_levels[..., -1])

  max_pressure_significant = pressure_levels[..., -1]
  sp_max_significant = sp_levels[..., -1]
  safe_dn = in_range(sp_levels)
  j_dn = (n - 1) - _first_true(torch.flip(safe_dn, dims=(-1,)))
  any_safe_dn = safe_dn.any(dim=-1)
  has_next_level = j_dn < (n - 1)
  next_idx = torch.clamp_max(j_dn + 1, n - 1)
  next_p = torch.where(has_next_level, _take(pressure_levels, next_idx),
                       max_pressure_significant)
  next_sp = torch.where(has_next_level, _take(sp_levels, next_idx),
                        sp_max_significant)
  cur_p_dn = _take(pressure_levels, j_dn)
  cur_sp_dn = _take(sp_levels, j_dn)
  max_pressure = _threshold_crossing(cur_p_dn, cur_sp_dn, next_p, next_sp,
                                     min_sp, max_sp)
  max_pressure = torch.where(in_range(sp_max_significant),
                             max_pressure_significant, max_pressure)
  max_pressure = torch.where(any_safe_dn | in_range(sp_max_significant),
                             max_pressure, pressure_levels[..., 0])
  return min_pressure, max_pressure


def _expand(atmosphere: atmosphere_lib.AtmosphereParams):
  """Inserts a level axis before the layer axis of the atmosphere leaves."""
  return atmosphere_lib.AtmosphereParams(
      **{f.name: getattr(atmosphere, f.name)[..., None, :]
         for f in dataclasses.fields(atmosphere_lib.AtmosphereParams)})


def compute_pressure_range(params, atmosphere: atmosphere_lib.AtmosphereParams,
                           solar_elevation_deg, solar_flux,
                           upwelling_infrared):
  """(min_pressure, max_pressure) per balloon (reference
  get_pressure_range, pressure_range_builder.py:203-275)."""
  min_sp = safety.ENVELOPE_BUFFER
  max_sp = params.envelope_max_superpressure - safety.ENVELOPE_BUFFER

  search_max, _, _ = atmosphere_lib.at_height(atmosphere,
                                              safety.ALTITUDE_MIN_M)
  frac = torch.linspace(0.0, 1.0, NUM_LEVELS, device=search_max.device)
  pressure_levels = (SEARCH_RANGE_MIN_PA +
                     frac * (search_max[..., None] - SEARCH_RANGE_MIN_PA))
  atmo_levels = _expand(atmosphere)
  _, column_temps, _ = atmosphere_lib.at_pressure(atmo_levels,
                                                  pressure_levels)

  total_empty_mass = (params.payload_mass + params.envelope_mass +
                      params.mols_lift_gas * constants.HE_MOLAR_MASS)
  max_altitude_p_over_t = (
      total_empty_mass * constants.UNIVERSAL_GAS_CONSTANT /
      (constants.DRY_AIR_MOLAR_MASS * params.envelope_volume_base))
  p_over_t = pressure_levels / column_temps
  x = torch.full_like(search_max, max_altitude_p_over_t)
  min_pressure_significant = _interp_with_extrapolation(x, p_over_t,
                                                        pressure_levels)

  all_pressures = torch.cat(
      [pressure_levels, min_pressure_significant[..., None]], dim=-1)
  b = lambda v: v[..., None] if isinstance(v, torch.Tensor) else v
  stable = stable_init.calculate_stable_params_for_pressure(
      all_pressures, b(params.envelope_volume_base),
      b(params.envelope_volume_dv_pressure), b(params.envelope_mass),
      b(params.payload_mass), b(params.mols_lift_gas), b(solar_elevation_deg),
      b(solar_flux), b(upwelling_infrared), atmo_levels)
  sp_all = stable.superpressure
  return get_pressure_range(pressure_levels, sp_all[..., :NUM_LEVELS],
                            sp_all[..., NUM_LEVELS], min_pressure_significant,
                            min_sp, max_sp)
