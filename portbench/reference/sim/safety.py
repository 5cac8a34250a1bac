"""The three safety layers as small integer state lattices (reference
power_safety.py, envelope_safety.py, altitude_safety.py; the port of
ble_tpu/env/safety.py). Transition tables encode the reference's
first-match `transitions` semantics."""

import dataclasses

import torch

from portbench.reference.sim import atmosphere as atmosphere_lib
from portbench.reference.sim import constants

# Actions (reference env/balloon/control.py:21-25).
DOWN, STAY, UP = 0, 1, 2

# --- Envelope safety (envelope_safety.py:40-157) ---
ENVELOPE_CRITICAL_BUFFER = 150.0  # [Pa]
ENVELOPE_BUFFER = 250.0  # [Pa]
ENVELOPE_RESTART_HYSTERESIS = 50.0  # [Pa]

# States: 0 NOMINAL, 1 LOW_CRITICAL, 2 LOW, 3 HIGH, 4 HIGH_CRITICAL.
# Rows: superpressure region; columns: previous state.
ENVELOPE_TABLE = (
    (1, 1, 1, 1, 1),
    (2, 2, 2, 2, 2),
    (0, 2, 2, 0, 0),
    (0, 0, 0, 0, 0),
    (0, 0, 0, 3, 3),
    (3, 3, 3, 3, 3),
    (4, 4, 4, 4, 4),
)


def envelope_safety(envelope_state, action, superpressure,
                    max_superpressure):
  """Returns (new_state, effective_action)."""
  thresholds = (
      ENVELOPE_CRITICAL_BUFFER,
      ENVELOPE_BUFFER,
      ENVELOPE_BUFFER + ENVELOPE_RESTART_HYSTERESIS,
      max_superpressure - ENVELOPE_BUFFER - ENVELOPE_RESTART_HYSTERESIS,
      max_superpressure - ENVELOPE_BUFFER,
      max_superpressure - ENVELOPE_CRITICAL_BUFFER)
  region = sum((superpressure >= t).to(torch.int64) for t in thresholds)
  table = torch.tensor(ENVELOPE_TABLE, dtype=torch.int32,
                       device=superpressure.device)
  new_state = table[region, envelope_state.to(torch.int64)]

  critical = (new_state == 1) | (new_state == 4)
  blocked = (new_state == 2) | (new_state == 3)
  effective = torch.where(
      critical, torch.full_like(action, UP),
      torch.where(blocked & (action == DOWN), torch.full_like(action, STAY),
                  action))
  return new_state, effective


def envelope_nav_is_paused(envelope_state):
  return envelope_state != 0


# --- Altitude safety (altitude_safety.py:35-112) ---
ALTITUDE_MIN_M = 50_000.0 * constants.METERS_PER_FOOT
ALTITUDE_BUFFER_M = 500.0 * constants.METERS_PER_FOOT
ALTITUDE_HYSTERESIS_M = 500.0 * constants.METERS_PER_FOOT

# States: 0 NOMINAL, 1 LOW, 2 VERY_LOW. Rows: altitude region.
ALTITUDE_TABLE = (
    (2, 2, 2),
    (1, 1, 1),
    (0, 1, 1),
    (0, 0, 0),
)


def altitude_safety(altitude_state, action, atmosphere_params, pressure):
  """Returns (new_state, effective_action)."""
  altitude_m, _, _ = atmosphere_lib.at_pressure(atmosphere_params, pressure)
  region = ((altitude_m >= ALTITUDE_MIN_M).to(torch.int64) +
            (altitude_m >= ALTITUDE_MIN_M + ALTITUDE_BUFFER_M).to(torch.int64)
            + (altitude_m >= ALTITUDE_MIN_M + ALTITUDE_BUFFER_M +
               ALTITUDE_HYSTERESIS_M).to(torch.int64))
  table = torch.tensor(ALTITUDE_TABLE, dtype=torch.int32,
                       device=pressure.device)
  new_state = table[region, altitude_state.to(torch.int64)]
  effective = torch.where(
      new_state == 2, torch.full_like(action, UP),
      torch.where((new_state == 1) & (action == DOWN),
                  torch.full_like(action, STAY), action))
  return new_state, effective


def altitude_nav_is_paused(altitude_state):
  return altitude_state != 0


# --- Power safety (power_safety.py:26-127) ---
POWER_SOC_MIN = 0.025
POWER_SOC_RESTART = 0.05
POWER_SUNRISE_HYSTERESIS_S = 30 * 60


@dataclasses.dataclass
class PowerSafetyState:
  navigation_is_paused: torch.Tensor  # bool (E,)
  sunrise_with_hysteresis_s: torch.Tensor  # int32 unix seconds (E,)
  sunset_s: torch.Tensor  # int32 unix seconds (E,)


def advance_past(anchor_s, time_s):
  """Adds whole days to `anchor_s` until it is >= time_s
  (power_safety.py:83-86)."""
  delta = time_s - anchor_s
  k = torch.where(delta > 0, (delta + 86399) // 86400,
                  torch.zeros_like(delta))
  return anchor_s + k * 86400


def power_safety(state: PowerSafetyState, action, time_s,
                 nighttime_power_load_w, battery_charge_j,
                 battery_capacity_j):
  """Returns (new PowerSafetyState, effective_action)."""
  sunrise = advance_past(state.sunrise_with_hysteresis_s, time_s)
  sunset = advance_past(state.sunset_s, time_s)

  paused_action = torch.where(action == DOWN, torch.full_like(action, STAY),
                              action)
  soc = battery_charge_j / battery_capacity_j

  is_daytime = sunset < sunrise
  day_paused = state.navigation_is_paused & (soc < POWER_SOC_RESTART)

  time_to_sunrise_s = (sunrise - time_s).to(torch.float32)
  floating_charge_j = nighttime_power_load_w * time_to_sunrise_s
  expected_soc = (battery_charge_j - floating_charge_j) / battery_capacity_j
  night_paused = state.navigation_is_paused | (expected_soc < POWER_SOC_MIN)

  new_paused = torch.where(is_daytime, day_paused, night_paused)
  effective = torch.where(new_paused, paused_action, action)
  return PowerSafetyState(navigation_is_paused=new_paused,
                          sunrise_with_hysteresis_s=sunrise,
                          sunset_s=sunset), effective
