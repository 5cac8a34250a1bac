"""Stable balloon initialization: closed-form mols_air + Newton temperature
(reference env/balloon/stable_init.py; the port of ble_tpu/env/stable_init.py).
The 10 Newton iterations run as a fixed loop with guarded updates, over
any batch shape (envs, or envs x pressure levels)."""

import dataclasses

import torch

from portbench.reference.sim import atmosphere as atmosphere_lib
from portbench.reference.sim import balloon as balloon_lib
from portbench.reference.sim import solar
from portbench.reference.sim import thermal
from portbench.reference.sim import constants


@dataclasses.dataclass
class StableParams:
  ambient_temperature: torch.Tensor
  internal_temperature: torch.Tensor
  mols_air: torch.Tensor
  envelope_volume: torch.Tensor
  superpressure: torch.Tensor


def calculate_stable_params_for_pressure(
    pressure, envelope_volume_base, envelope_volume_dv_pressure,
    envelope_mass, payload_mass, mols_lift_gas, solar_elevation_deg,
    solar_flux, upwelling_infrared,
    atmosphere: atmosphere_lib.AtmosphereParams,
    num_newton_iterations: int = 10) -> StableParams:
  """Equilibrium (T_amb, T_int, mols_air, volume, superpressure) at
  `pressure` (stable_init.py:40-129)."""
  _, ambient_temperature, _ = atmosphere_lib.at_pressure(atmosphere, pressure)

  mols_air = (
      (pressure * constants.DRY_AIR_MOLAR_MASS * envelope_volume_base /
       (constants.UNIVERSAL_GAS_CONSTANT * ambient_temperature) -
       envelope_mass - payload_mass -
       constants.HE_MOLAR_MASS * mols_lift_gas) /
      constants.DRY_AIR_MOLAR_MASS)
  mols_air = torch.clamp_min(mols_air, 0.0)

  delta_temp = 0.01
  internal_temperature = torch.full_like(pressure, 206.0)

  def d_temp(t):
    return thermal.d_balloon_temperature_dt(
        envelope_volume_base, envelope_mass, t, ambient_temperature, pressure,
        solar_elevation_deg, solar_flux, upwelling_infrared)

  for _ in range(num_newton_iterations):
    d1 = d_temp(internal_temperature - delta_temp / 2)
    d2 = d_temp(internal_temperature + delta_temp / 2)
    dd = (d2 - d1) / delta_temp
    mean_d = (d1 + d2) / 2.0
    safe_dd = torch.where(dd == 0, torch.ones_like(dd), dd)
    update = torch.where(torch.abs(dd) > 0.0, mean_d / safe_dd,
                         torch.zeros_like(dd))
    internal_temperature = internal_temperature - update

  envelope_volume, superpressure = (
      balloon_lib.calculate_superpressure_and_volume(
          mols_lift_gas, mols_air, internal_temperature, pressure,
          envelope_volume_base, envelope_volume_dv_pressure))
  return StableParams(ambient_temperature=ambient_temperature,
                      internal_temperature=internal_temperature,
                      mols_air=mols_air, envelope_volume=envelope_volume,
                      superpressure=superpressure)


def cold_start_to_stable_params(
    params: balloon_lib.BalloonParams, state: balloon_lib.BalloonState,
    atmosphere: atmosphere_lib.AtmosphereParams) -> balloon_lib.BalloonState:
  """`state` with equilibrium thermo fields (stable_init.py:132-157)."""
  lat, lng = balloon_lib.latlng(state)
  el_deg, _, flux = solar.solar_calculator(lat, lng, state.time_s)
  stable = calculate_stable_params_for_pressure(
      state.pressure_pa, params.envelope_volume_base,
      params.envelope_volume_dv_pressure, params.envelope_mass,
      params.payload_mass, params.mols_lift_gas, el_deg, flux,
      state.upwelling_infrared_w_m2, atmosphere)
  return dataclasses.replace(
      state,
      ambient_temperature_k=stable.ambient_temperature,
      internal_temperature_k=stable.internal_temperature,
      mols_air=stable.mols_air,
      envelope_volume_m3=stable.envelope_volume,
      superpressure_pa=stable.superpressure)
