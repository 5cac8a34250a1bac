"""Solar elevation/azimuth/flux, panel power and sunrise/sunset
(reference env/balloon/solar.py; the port of ble_tpu/env/solar.py).

`next_sunrise_sunset` evaluates the next ~24 h of solar elevations at
3-minute resolution as one (E, 482) tensor op, finds the first crossings
of MIN_SOLAR_EL_DEG and refines each with a linear root and one secant
step.
"""

import math

import torch

from portbench.reference.sim import pmath
from portbench.reference.sim import time_lib

MIN_SOLAR_EL_DEG = -4.242
SEARCH_STEP_SECONDS = 180

_BALLOON_RADIUS = 8.69275
_BALLOON_HEIGHT = 10.41603
_SHADOW_EL_DEG_3_3 = math.degrees(
    math.atan2(math.sqrt(3.3 * (_BALLOON_HEIGHT + 3.3)), _BALLOON_RADIUS))
_SHADOW_EL_DEG_2_7 = math.degrees(
    math.atan2(math.sqrt(2.7 * (_BALLOON_HEIGHT + 2.7)), _BALLOON_RADIUS))
_SHADOW_FACTOR = 0.4392

_DEG = math.pi / 180.0
_RAD = 180.0 / math.pi


def solar_calculator(lat_rad, lng_rad, time_s):
  """Solar (elevation_deg, azimuth_deg, flux_w_m2); inputs broadcast and
  `time_s` is int32 unix seconds (solar.py:43-174)."""
  jd_j2000, fraction_of_day = time_lib.days_from_j2000(time_s)
  julian_century = jd_j2000 / 36525.0

  geometric_mean_long_sun = (
      280.46646 + julian_century * (36000.76983 + julian_century * 0.0003032)
  ) * _DEG
  sin2l0 = torch.sin(2.0 * geometric_mean_long_sun)
  cos2l0 = torch.cos(2.0 * geometric_mean_long_sun)
  sin4l0 = torch.sin(4.0 * geometric_mean_long_sun)

  geometric_mean_anomaly_sun = (
      357.52911 + julian_century * (35999.05029 - 0.0001537 * julian_century)
  ) * _DEG
  sinm0 = torch.sin(geometric_mean_anomaly_sun)
  sin2m0 = torch.sin(2.0 * geometric_mean_anomaly_sun)
  sin3m0 = torch.sin(3.0 * geometric_mean_anomaly_sun)

  mean_obliquity_of_ecliptic = (23.0 + (26.0 + (
      (21.448 - julian_century *
       (46.815 + julian_century *
        (0.00059 - julian_century * 0.001813)))) / 60.0) / 60.0) * _DEG

  obliquity_correction = mean_obliquity_of_ecliptic + (0.00256 * torch.cos(
      (125.04 - 1934.136 * julian_century) * _DEG)) * _DEG

  var_y = pmath.ipow(pmath.tan(obliquity_correction / 2.0), 2)

  eccentricity_earth = 0.016708634 - julian_century * (
      0.000042037 + 0.0000001267 * julian_century)

  equation_of_time = (4.0 *
                      (var_y * sin2l0 - 2.0 * eccentricity_earth * sinm0 +
                       4.0 * eccentricity_earth * var_y * sinm0 * cos2l0 -
                       0.5 * var_y * var_y * sin4l0 -
                       1.25 * eccentricity_earth * eccentricity_earth * sin2m0))

  hour_angle_arg = pmath.fmod(
      1440.0 * fraction_of_day + equation_of_time * _RAD +
      4.0 * (lng_rad * _RAD), 1440.0)
  hour_angle = (hour_angle_arg * _DEG) / 4.0
  hour_angle = torch.where(hour_angle < 0, hour_angle + math.pi,
                           hour_angle - math.pi)

  eq_of_center_sun = (sinm0 *
                      (1.914602 - julian_century *
                       (0.004817 + 0.000014 * julian_century)) +
                      sin2m0 *
                      (0.019993 - 0.000101 * julian_century) +
                      sin3m0 * 0.000289) * _DEG
  true_long_sun = geometric_mean_long_sun + eq_of_center_sun
  apparent_long_sun = true_long_sun - (
      0.00569 - 0.00478 * torch.sin(
          (125.04 - 1934.136 * julian_century) * _DEG)) * _DEG
  declination_sun = pmath.asin(
      torch.sin(obliquity_correction) * torch.sin(apparent_long_sun))

  cos_zenith = (torch.sin(lat_rad) * torch.sin(declination_sun) +
                torch.cos(lat_rad) * torch.cos(declination_sun) *
                torch.cos(hour_angle))
  zenith_angle = pmath.acos(torch.clamp(cos_zenith, -1.0, 1.0))

  el_uncorrected_deg = 90.0 - zenith_angle * _RAD

  # Atmospheric refraction, 4-branch piecewise (solar.py:143-157).
  tan_seu = pmath.tan(el_uncorrected_deg * _DEG)
  small = torch.where(tan_seu < 0, torch.full_like(tan_seu, -1e-8),
                      torch.full_like(tan_seu, 1e-8))
  safe_tan = torch.where(torch.abs(tan_seu) < 1e-8, small, tan_seu)
  refr_high = (58.1 / safe_tan - 0.07 / pmath.ipow(safe_tan, 3) +
               0.000086 / pmath.ipow(safe_tan, 5))
  refr_mid = (1735.0 + el_uncorrected_deg *
              (-518.2 + el_uncorrected_deg *
               (103.4 + el_uncorrected_deg *
                (-12.79 + el_uncorrected_deg * 0.711))))
  refr_low = -20.772 / safe_tan
  atmospheric_refraction = torch.where(
      el_uncorrected_deg > 85.0, torch.zeros_like(refr_high),
      torch.where(el_uncorrected_deg > 5.0, refr_high,
                  torch.where(el_uncorrected_deg > -0.575, refr_mid,
                              refr_low)))

  el_deg = el_uncorrected_deg + atmospheric_refraction / 3600.0

  sin_zenith = torch.sin(zenith_angle)
  denom = torch.cos(lat_rad) * torch.where(
      sin_zenith < 1e-8, torch.full_like(sin_zenith, 1e-8), sin_zenith)
  cos_az = ((torch.sin(lat_rad) * torch.cos(zenith_angle) -
             torch.sin(declination_sun)) / denom)
  az_unwrapped = pmath.acos(torch.clamp(cos_az, -1.0, 1.0))
  az_deg = torch.where(hour_angle > 0, az_unwrapped * _RAD + 180.0,
                       180.0 - az_unwrapped * _RAD)

  flux = 1366.0 * (1 + 0.5 * (
      pmath.ipow((1 + eccentricity_earth) / (1 - eccentricity_earth), 2) - 1
  ) * torch.cos(geometric_mean_anomaly_sun))

  return el_deg, az_deg, flux


def elevation_sine_term(el_deg):
  """614 sin(el): the term of the attenuation's air mass that depends on
  the elevation alone."""
  return 614.0 * torch.sin(el_deg * _DEG)


def panel_terms(el_deg):
  """The two terms of the panel power that depend on the elevation alone:
  4 cos(el - 35) and 2 cos(el - 65), each times its panel's shadow."""
  return (4 * torch.cos((el_deg - 35) * _DEG) *
          balloon_shadow(el_deg, _SHADOW_EL_DEG_3_3),
          2 * torch.cos((el_deg - 65) * _DEG) *
          balloon_shadow(el_deg, _SHADOW_EL_DEG_2_7))


def solar_atmospheric_attenuation(el_deg, pressure_pa):
  """Attenuation factor in [0, 1] (solar.py:177-209)."""
  tmp_sin_elev = elevation_sine_term(el_deg)
  airmass = (0.34764 * (pressure_pa / 101325.0) *
             (torch.sqrt(1229.0 + tmp_sin_elev * tmp_sin_elev) - tmp_sin_elev))
  attenuation = 0.5 * (torch.exp(-0.65 * airmass) +
                       torch.exp(-0.95 * airmass))
  return torch.where(el_deg < MIN_SOLAR_EL_DEG,
                     torch.zeros_like(attenuation), attenuation)


def balloon_shadow(el_deg, shadow_el_deg: float):
  return torch.where(el_deg >= shadow_el_deg,
                     torch.full_like(el_deg, _SHADOW_FACTOR),
                     torch.ones_like(el_deg))


def solar_power(el_deg, pressure_pa):
  """Panel power [W]: 4x210W @35deg + 2x210W @65deg (solar.py:515-536)."""
  attenuation = solar_atmospheric_attenuation(el_deg, pressure_pa)
  panel35, panel65 = panel_terms(el_deg)
  return 210.0 * attenuation * (panel35 + panel65)


def next_sunrise_sunset(lat_rad, lng_rad, time_s, num_steps: int = 482):
  """Next sunrise and sunset (int32 unix seconds) strictly after `time_s`,
  for (E,) inputs. Falls back to time_s + 24 h where no crossing exists
  within the window (polar day/night)."""
  time_s = time_s.to(torch.int32)
  offsets = torch.arange(1, num_steps + 1, dtype=torch.int32,
                         device=time_s.device) * SEARCH_STEP_SECONDS
  grid_t = time_s[..., None] + offsets  # (..., num_steps)
  el, _, _ = solar_calculator(lat_rad[..., None], lng_rad[..., None], grid_t)
  is_day = el >= MIN_SOLAR_EL_DEG

  el_now, _, _ = solar_calculator(lat_rad, lng_rad, time_s)
  day_now = el_now >= MIN_SOLAR_EL_DEG

  prev_day = torch.cat([day_now[..., None], is_day[..., :-1]], dim=-1)
  rise_cross = is_day & ~prev_day
  set_cross = ~is_day & prev_day
  el_prev = torch.cat([el_now[..., None], el[..., :-1]], dim=-1)

  def first_time(cross):
    any_cross = cross.any(dim=-1)
    idx = cross.to(torch.uint8).argmax(dim=-1)[..., None]
    # Interpolate in OFFSET space: absolute unix times overflow f32.
    t1_off = ((idx[..., 0] + 1) * SEARCH_STEP_SECONDS).to(torch.float32)
    t0_off = t1_off - SEARCH_STEP_SECONDS
    e1 = torch.gather(el, -1, idx)[..., 0]
    e0 = torch.gather(el_prev, -1, idx)[..., 0]
    diff = e1 - e0
    denom = torch.where(torch.abs(diff) < 1e-9, torch.full_like(diff, 1e-9),
                        diff)
    lin_off = t0_off + (MIN_SOLAR_EL_DEG - e0) / denom * (t1_off - t0_off)
    t_lin = time_s + torch.round(lin_off).to(torch.int32)
    e_lin, _, _ = solar_calculator(lat_rad, lng_rad, t_lin)
    diff2 = e1 - e_lin
    denom2 = torch.where(torch.abs(diff2) < 1e-9,
                         torch.full_like(diff2, 1e-9), diff2)
    ref_off = lin_off + ((MIN_SOLAR_EL_DEG - e_lin) / denom2 *
                         (t1_off - lin_off))
    ref_off = torch.minimum(torch.maximum(ref_off, t0_off), t1_off)
    t = time_s + torch.round(ref_off).to(torch.int32)
    return torch.where(any_cross, t, time_s + 86400)

  return first_time(rise_cross), first_time(set_cross)
