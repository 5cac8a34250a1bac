"""Stratospheric superpressure balloon dynamics, batched over envs
(reference env/balloon/balloon.py; the port of ble_tpu/env/balloon.py).

`simulate_step` applies the safety-layer action remap once, then runs the
18 10-second physics substeps; balloons whose status is terminal freeze.
This is the plain version of the fused physics kernel in ops/physics.py.
"""

import dataclasses
import math

import numpy as np
import torch

from portbench.reference.sim import acs
from portbench.reference.sim import atmosphere as atmosphere_lib
from portbench.reference.sim import safety
from portbench.reference.sim import solar
from portbench.reference.sim import thermal
from portbench.reference.sim import pmath
from portbench.reference.sim import constants
from portbench.reference.sim import spherical

# Balloon status codes (reference balloon.py:66-70).
STATUS_OK = 0
STATUS_OUT_OF_POWER = 1
STATUS_BURST = 2
STATUS_ZEROPRESSURE = 3


def _f32(x: float) -> float:
  return float(np.float32(x))


@dataclasses.dataclass
class BalloonParams:
  """Flight-vehicle constants (reference balloon.py:155-172), float32
  values. Fleet-uniform Python floats by default; a field may be an (E,)
  tensor on the plain path, which the fused kernel refuses."""
  envelope_volume_base: float = _f32(1804.0)  # [m^3]
  envelope_volume_dv_pressure: float = _f32(0.0199)  # [m^3/Pa]
  envelope_mass: float = _f32(68.5)  # [kg]
  envelope_max_superpressure: float = _f32(2380.0)  # [Pa]
  envelope_cod: float = _f32(0.25)
  payload_mass: float = _f32(92.5)  # [kg]
  nighttime_power_load_w: float = _f32(183.7)
  daytime_power_load_w: float = _f32(120.4)
  acs_valve_hole_diameter_m: float = _f32(0.04)
  battery_capacity_j: float = _f32(3058.56 * constants.WATT_HOURS_TO_JOULES)
  mols_lift_gas: float = _f32(6830.0)
  power_safety_layer_enabled: bool = True


@dataclasses.dataclass
class BalloonState:
  """Dynamic balloon state (reference balloon.py:74-208); every leaf (E,)."""
  center_lat_rad: torch.Tensor
  center_lng_rad: torch.Tensor
  x_m: torch.Tensor
  y_m: torch.Tensor
  pressure_pa: torch.Tensor
  time_s: torch.Tensor  # int32 unix seconds (absolute)
  time_elapsed_s: torch.Tensor  # int32 seconds since episode start
  ambient_temperature_k: torch.Tensor
  internal_temperature_k: torch.Tensor
  mols_air: torch.Tensor
  envelope_volume_m3: torch.Tensor
  superpressure_pa: torch.Tensor
  acs_power_w: torch.Tensor
  acs_mass_flow_kg_s: torch.Tensor
  solar_charging_w: torch.Tensor
  power_load_w: torch.Tensor
  battery_charge_j: torch.Tensor
  last_command: torch.Tensor  # int32 safety.DOWN/STAY/UP
  status: torch.Tensor  # int32 STATUS_*
  upwelling_infrared_w_m2: torch.Tensor
  power_safety: safety.PowerSafetyState
  envelope_safety_state: torch.Tensor  # int32
  altitude_safety_state: torch.Tensor  # int32


def latlng(state: BalloonState):
  return spherical.latlng_from_offset(state.center_lat_rad,
                                      state.center_lng_rad, state.x_m,
                                      state.y_m)


def battery_soc(params: BalloonParams, state: BalloonState):
  return state.battery_charge_j / params.battery_capacity_j


def pressure_ratio(state: BalloonState):
  sp = torch.clamp_min(state.superpressure_pa, 0.0)
  return (state.pressure_pa + sp) / state.pressure_pa


def excess_energy(params: BalloonParams, state: BalloonState):
  """Solar power exceeds the load with a full battery (balloon.py:231-238)."""
  lat, lng = latlng(state)
  el_deg, _, _ = solar.solar_calculator(lat, lng, state.time_s)
  power = solar.solar_power(el_deg, state.pressure_pa)
  return (power > params.daytime_power_load_w) & (
      battery_soc(params, state) > 0.99)


def navigation_is_paused(state: BalloonState):
  return (state.power_safety.navigation_is_paused
          | safety.envelope_nav_is_paused(state.envelope_safety_state)
          | safety.altitude_nav_is_paused(state.altitude_safety_state))


def calculate_superpressure_and_volume(mols_lift_gas, mols_air,
                                       internal_temperature, pressure,
                                       envelope_volume_base,
                                       envelope_volume_dv_pressure):
  """(envelope_volume, superpressure), branchless (balloon.py:552-609)."""
  unconstrained_volume = (
      (mols_lift_gas + mols_air) * constants.UNIVERSAL_GAS_CONSTANT *
      internal_temperature / pressure)
  inflated = unconstrained_volume > envelope_volume_base
  b = -(envelope_volume_base - envelope_volume_dv_pressure * pressure)
  c = -(envelope_volume_dv_pressure * unconstrained_volume * pressure)
  vol_inflated = 0.5 * (-b + torch.sqrt(b * b - 4 * c))
  sp_inflated = pressure * unconstrained_volume / vol_inflated - pressure
  envelope_volume = torch.where(inflated, vol_inflated, unconstrained_volume)
  superpressure = torch.where(inflated, sp_inflated,
                              torch.zeros_like(sp_inflated))
  return envelope_volume, superpressure


# The dynamic fields one substep reads and writes, in the packing order of
# the fused kernel's (16, E) float32 and (3, E) int32 inputs.
SUBSTEP_F32_FIELDS = (
    'x_m', 'y_m', 'pressure_pa', 'ambient_temperature_k',
    'internal_temperature_k', 'mols_air', 'envelope_volume_m3',
    'superpressure_pa', 'acs_power_w', 'acs_mass_flow_kg_s',
    'solar_charging_w', 'power_load_w', 'battery_charge_j',
    'upwelling_infrared_w_m2', 'center_lat_rad', 'center_lng_rad')
SUBSTEP_I32_FIELDS = ('time_s', 'time_elapsed_s', 'status')
# Fields a substep only reads.
READ_ONLY_FIELDS = ('center_lat_rad', 'center_lng_rad', 'upwelling_infrared_w_m2')


def substep_math(params: BalloonParams, atmosphere, v: dict, wind_u, wind_v,
                 action, stride_s: int) -> dict:
  """One physics substep (reference _simulate_step_internal,
  balloon.py:356-549) on a dict of (E,) tensors. All reads come from the
  incoming dict (the reference's apply-at-end state_changes semantics)."""
  dt = float(stride_s)

  # Step 1: advection.
  new_x = v['x_m'] + wind_u * dt
  new_y = v['y_m'] + wind_v * dt

  # Step 2: buoyancy -> dh/dt -> dp/dt, with the closed-form hydrostatic
  # dp/dh = -g p / (R T) (singularity-free at atmosphere layer seams).
  rho_air = (v['pressure_pa'] * constants.DRY_AIR_MOLAR_MASS) / (
      constants.UNIVERSAL_GAS_CONSTANT * v['ambient_temperature_k'])
  drag = params.envelope_cod * pmath.powf(v['envelope_volume_m3'], 2.0 / 3.0)
  total_flight_system_mass = (
      constants.HE_MOLAR_MASS * params.mols_lift_gas +
      constants.DRY_AIR_MOLAR_MASS * v['mols_air'] + params.envelope_mass +
      params.payload_mass)
  buoyant = rho_air * v['envelope_volume_m3'] >= total_flight_system_mass
  direction = torch.where(buoyant, 1.0, -1.0)
  dh_dt = direction * torch.sqrt(
      torch.abs(2 * (rho_air * v['envelope_volume_m3'] -
                     total_flight_system_mass) * constants.GRAVITY /
                (rho_air * drag)))
  _, new_ambient_temp, _ = atmosphere_lib.at_pressure(atmosphere,
                                                      v['pressure_pa'])
  dp_dh = -(constants.GRAVITY * v['pressure_pa'] /
            (constants.DRY_AIR_SPECIFIC_GAS_CONSTANT * new_ambient_temp))
  dp_dt = dp_dh * dh_dt
  new_pressure = v['pressure_pa'] + dp_dt * dt

  # Step 3: ambient + internal temperature.
  lat, lng = spherical.latlng_from_offset(v['center_lat_rad'],
                                          v['center_lng_rad'], v['x_m'],
                                          v['y_m'])
  solar_elevation, _, solar_flux = solar.solar_calculator(lat, lng,
                                                          v['time_s'])
  d_internal_temp = thermal.d_balloon_temperature_dt(
      v['envelope_volume_m3'], params.envelope_mass,
      v['internal_temperature_k'], v['ambient_temperature_k'],
      v['pressure_pa'], solar_elevation, solar_flux,
      v['upwelling_infrared_w_m2'])
  new_internal_temp = v['internal_temperature_k'] + d_internal_temp * dt

  # Step 4: superpressure & volume.
  new_volume, new_superpressure = calculate_superpressure_and_volume(
      params.mols_lift_gas, v['mols_air'], v['internal_temperature_k'],
      v['pressure_pa'], params.envelope_volume_base,
      params.envelope_volume_dv_pressure)

  # Step 5: ACS.
  sp_pos = torch.clamp_min(v['superpressure_pa'], 0.0)
  pr = (v['pressure_pa'] + sp_pos) / v['pressure_pa']
  valve_area = math.pi * params.acs_valve_hole_diameter_m ** 2 / 4.0
  default_valve_hole_cd = 0.62
  gas_density = (v['superpressure_pa'] + v['pressure_pa']) * (
      constants.DRY_AIR_MOLAR_MASS /
      (constants.UNIVERSAL_GAS_CONSTANT * v['internal_temperature_k']))
  up_mass_flow = -default_valve_hole_cd * valve_area * torch.sqrt(
      2.0 * sp_pos * gas_density)
  down_power = acs.get_most_efficient_power(pr)
  down_eff = acs.get_fan_efficiency(pr, down_power)
  down_mass_flow = acs.get_mass_flow(down_power, down_eff)

  zero = torch.zeros_like(down_power)
  new_acs_power = torch.where(action == safety.DOWN, down_power, zero)
  new_acs_mass_flow = torch.where(
      action == safety.UP, up_mass_flow,
      torch.where(action == safety.DOWN, down_mass_flow, zero))
  new_mols_air = torch.clamp_min(
      v['mols_air'] +
      (new_acs_mass_flow / constants.DRY_AIR_MOLAR_MASS) * dt, 0.0)

  # Step 6: power & battery.
  is_day = solar_elevation > solar.MIN_SOLAR_EL_DEG
  new_solar_charging = torch.where(
      is_day, solar.solar_power(solar_elevation, v['pressure_pa']), zero)
  new_power_load = torch.where(is_day, params.daytime_power_load_w,
                               params.nighttime_power_load_w) + new_acs_power
  new_battery = torch.clamp(
      v['battery_charge_j'] + (new_solar_charging - new_power_load) * dt,
      0.0, params.battery_capacity_j)

  # OUT_OF_POWER overrides BURST/ZEROPRESSURE in the same substep.
  new_status = torch.full_like(v['status'], STATUS_OK)
  new_status = torch.where(new_superpressure > params.envelope_max_superpressure,
                           STATUS_BURST, new_status)
  new_status = torch.where(new_superpressure <= 0.0, STATUS_ZEROPRESSURE,
                           new_status)
  new_status = torch.where(new_battery <= 0.0, STATUS_OUT_OF_POWER,
                           new_status)

  return {
      'x_m': new_x,
      'y_m': new_y,
      'pressure_pa': new_pressure,
      'ambient_temperature_k': new_ambient_temp,
      'internal_temperature_k': new_internal_temp,
      'mols_air': new_mols_air,
      'envelope_volume_m3': new_volume,
      'superpressure_pa': new_superpressure,
      'acs_power_w': new_acs_power,
      'acs_mass_flow_kg_s': new_acs_mass_flow,
      'solar_charging_w': new_solar_charging,
      'power_load_w': new_power_load,
      'battery_charge_j': new_battery,
      'time_s': v['time_s'] + stride_s,
      'time_elapsed_s': v['time_elapsed_s'] + stride_s,
      'status': new_status,
  }


def effective_action(params: BalloonParams,
                     atmosphere: atmosphere_lib.AtmosphereParams,
                     state: BalloonState, action):
  """The three safety layers in reference order (power -> envelope ->
  altitude; balloon.py:304-313). Returns (power, envelope, altitude safety
  states, effective action)."""
  power_state = state.power_safety
  act = action
  if params.power_safety_layer_enabled:
    power_state, act = safety.power_safety(
        power_state, act, state.time_s, params.nighttime_power_load_w,
        state.battery_charge_j, params.battery_capacity_j)
  envelope_state, act = safety.envelope_safety(
      state.envelope_safety_state, act, state.superpressure_pa,
      params.envelope_max_superpressure)
  altitude_state, act = safety.altitude_safety(
      state.altitude_safety_state, act, atmosphere, state.pressure_pa)
  return power_state, envelope_state, altitude_state, act


def apply_safety(params: BalloonParams,
                 atmosphere: atmosphere_lib.AtmosphereParams,
                 state: BalloonState, action):
  """The once-per-step part of `simulate_step`: records the command and
  the new safety states for balloons still OK. Returns (state, effective
  action)."""
  action = action.to(torch.int32)
  power_state, envelope_state, altitude_state, act = effective_action(
      params, atmosphere, state, action)
  was_ok = state.status == STATUS_OK
  keep = lambda new, old: torch.where(was_ok, new, old)
  old_power = state.power_safety
  state = dataclasses.replace(
      state,
      last_command=keep(action, state.last_command),
      power_safety=safety.PowerSafetyState(
          navigation_is_paused=keep(power_state.navigation_is_paused,
                                    old_power.navigation_is_paused),
          sunrise_with_hysteresis_s=keep(
              power_state.sunrise_with_hysteresis_s,
              old_power.sunrise_with_hysteresis_s),
          sunset_s=keep(power_state.sunset_s, old_power.sunset_s)),
      envelope_safety_state=keep(envelope_state.to(torch.int32),
                                 state.envelope_safety_state),
      altitude_safety_state=keep(altitude_state.to(torch.int32),
                                 state.altitude_safety_state))
  return state, act.to(torch.int32)


def run_substeps(params: BalloonParams,
                 atmosphere: atmosphere_lib.AtmosphereParams,
                 state: BalloonState, wind_u, wind_v, act,
                 num_substeps: int, stride_s: int) -> BalloonState:
  """`num_substeps` substeps with terminal balloons frozen: the plain
  version of the fused physics kernel."""
  names = SUBSTEP_F32_FIELDS + SUBSTEP_I32_FIELDS
  v = {name: getattr(state, name) for name in names}
  for _ in range(num_substeps):
    active = v['status'] == STATUS_OK
    nv = substep_math(params, atmosphere, v, wind_u, wind_v, act, stride_s)
    v = {k: (torch.where(active, nv[k], v[k]) if k in nv else v[k])
         for k in names}
  return dataclasses.replace(
      state, **{k: v[k] for k in names if k not in READ_ONLY_FIELDS})


def simulate_step(params: BalloonParams,
                  atmosphere: atmosphere_lib.AtmosphereParams,
                  state: BalloonState, wind_u, wind_v, action,
                  time_delta_s: int = constants.AGENT_TIME_STEP_SECONDS,
                  stride_s: int = constants.PHYSICS_STRIDE_SECONDS
                  ) -> BalloonState:
  """Advances every balloon by one agent step (balloon.py:263-328);
  stepping a terminal balloon is a no-op."""
  if time_delta_s % stride_s:
    raise ValueError('time_delta_s must be a multiple of stride_s')
  state, act = apply_safety(params, atmosphere, state, action)
  return run_substeps(params, atmosphere, state, wind_u, wind_v, act,
                      time_delta_s // stride_s, stride_s)
