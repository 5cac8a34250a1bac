"""Radiative/convective thermal model of the PE01 balloon film
(reference env/balloon/thermal.py; the port of ble_tpu/env/thermal.py)."""

import math

from portbench.reference.sim import solar
from portbench.reference.sim import pmath
from portbench.reference.sim import constants

_SOLAR_VIEW_FACTOR = 0.25
_EARTH_VIEW_FACTOR = 0.4605

_PE01_REFLECTIVITY = 0.0291
_PE01_ABSORPTIVITY_SOLAR = 0.01435
_PE01_ABSORPTIVITY_IR_BASE = 0.04587
_PE01_ABSORPTIVITY_IR_D_TEMPERATURE = 0.000232  # [1/K]
_PE01_ABSORPTIVITY_IR_REF_TEMPERATURE = 210.0  # [K]
_PE01_FILM_SPECIFIC_HEAT = 1500.0  # [J/(kg.K)]

_STEFAN_BOLTZMAN = 5.6704e-8  # [W/(m^2.K^4)]


def black_body_temperature_to_flux(temperature_k):
  t2 = temperature_k * temperature_k
  return _STEFAN_BOLTZMAN * t2 * t2


def black_body_flux_to_temperature(flux):
  return pmath.powf(flux / _STEFAN_BOLTZMAN, 0.25)


def absorptivity_ir(object_temperature_k):
  return (_PE01_ABSORPTIVITY_IR_BASE + _PE01_ABSORPTIVITY_IR_D_TEMPERATURE *
          (object_temperature_k - _PE01_ABSORPTIVITY_IR_REF_TEMPERATURE))


def total_absorptivity(absorptivity, reflectivity):
  transmisivity = 1.0 - absorptivity - reflectivity
  return absorptivity * (1.0 + transmisivity / (1.0 - reflectivity))


def convective_heat_air_factor(balloon_radius, balloon_temperature_k,
                               ambient_temperature_k, pressure_altitude_pa):
  """Nusselt-number convective transfer factor (thermal.py:150-172)."""
  viscosity = 1.458e-6 * pmath.powf(ambient_temperature_k, 1.5) / (
      ambient_temperature_k + 110.4)
  conductivity = 0.0241 * pmath.powf(ambient_temperature_k / 273.15, 0.9)
  prandtl = 0.804 - 3.25e-4 * ambient_temperature_k
  air_density = (
      pressure_altitude_pa * constants.DRY_AIR_MOLAR_MASS /
      (constants.UNIVERSAL_GAS_CONSTANT * ambient_temperature_k))

  diam = 2 * balloon_radius
  grashof = (constants.GRAVITY * (air_density * air_density) *
             (diam * diam * diam) /
             (ambient_temperature_k * pmath.ipow(viscosity, 2))) * (
                 ambient_temperature_k - balloon_temperature_k).abs()
  rayleigh = prandtl * grashof
  nusselt = (2 + 0.457 * pmath.powf(rayleigh, 0.25) +
             pmath.powf(1 + 2.69e-8 * rayleigh, 1.0 / 12.0))
  k_heat_transfer = nusselt * conductivity / (2 * balloon_radius)
  return k_heat_transfer * (ambient_temperature_k - balloon_temperature_k)


def d_balloon_temperature_dt(balloon_volume, balloon_mass,
                             balloon_temperature_k, ambient_temperature_k,
                             pressure_altitude_pa, solar_elevation_deg,
                             solar_flux, earth_flux):
  """dT/dt of the balloon film [K/s] (thermal.py:175-230)."""
  balloon_radius = pmath.powf(3 * balloon_volume / (4 * math.pi), 1.0 / 3.0)
  balloon_area = 4 * math.pi * balloon_radius * balloon_radius

  atm_attenuation = solar.solar_atmospheric_attenuation(
      solar_elevation_deg, pressure_altitude_pa)
  q_solar = (
      solar_flux * atm_attenuation * _SOLAR_VIEW_FACTOR * balloon_area *
      total_absorptivity(_PE01_ABSORPTIVITY_SOLAR, _PE01_REFLECTIVITY))

  q_earth = (
      earth_flux * _EARTH_VIEW_FACTOR * balloon_area * total_absorptivity(
          absorptivity_ir(black_body_flux_to_temperature(earth_flux)),
          _PE01_REFLECTIVITY))

  q_emitted = (
      black_body_temperature_to_flux(balloon_temperature_k) * balloon_area *
      total_absorptivity(absorptivity_ir(balloon_temperature_k),
                         _PE01_REFLECTIVITY))

  q_convective = balloon_area * convective_heat_air_factor(
      balloon_radius, balloon_temperature_k, ambient_temperature_k,
      pressure_altitude_pa)

  return (q_solar + q_earth + q_convective - q_emitted) / (
      _PE01_FILM_SPECIFIC_HEAT * balloon_mass)
