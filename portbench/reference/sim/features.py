"""Perciatelli features, batched over envs (the port of
ble_tpu/env/features.py; reference env/features.py:163-581).

The 1099-d vector is 16 ambient features and 3 x 361 balloon-centered
wind levels. The 361-level centering is an index gather with an
unreachable/(0, 1, 1) mask.
"""

import dataclasses
import math

import torch

from portbench.reference.sim import balloon as balloon_lib
from portbench.reference.sim import power_table
from portbench.reference.sim import pressure_range
from portbench.reference.sim import safety
from portbench.reference.sim import solar
from portbench.reference.sim import wind_field as wind_field_lib
from portbench.reference.sim import wind_gp
from portbench.reference.sim import constants
from portbench.reference.sim import transforms

NUM_PRESSURE_LEVELS = 181
NUM_FEATURES = 3 * (NUM_PRESSURE_LEVELS * 2 - 1) + 16  # = 1099
TOLERANCE_M = 1e-5  # reference features.py:53
_LEVEL_DELTA = (constants.PERCIATELLI_PRESSURE_RANGE_MAX -
                constants.PERCIATELLI_PRESSURE_RANGE_MIN) / (
                    NUM_PRESSURE_LEVELS - 1)


def pressure_levels(device=None):
  """The 181 feature pressure levels, 5000..14000 Pa."""
  return torch.linspace(constants.PERCIATELLI_PRESSURE_RANGE_MIN,
                        constants.PERCIATELLI_PRESSURE_RANGE_MAX,
                        NUM_PRESSURE_LEVELS, dtype=torch.float32,
                        device=device)


def nearest_pressure_level(pressure):
  """Quantized level index in [0, 180] (features.py:357-380)."""
  p = torch.clamp(pressure, constants.PERCIATELLI_PRESSURE_RANGE_MIN,
                  constants.PERCIATELLI_PRESSURE_RANGE_MAX)
  rescaled = (p - constants.PERCIATELLI_PRESSURE_RANGE_MIN) / _LEVEL_DELTA
  return torch.round(rescaled).to(torch.int64)


def compute_sunrise_cycle(time_s, sunrise_s, sunset_s):
  """Normalized solar cycle in [0, 2pi] (features.py:72-103)."""
  t = time_s.to(torch.float32)
  sunrise = sunrise_s.to(torch.float32)
  sunset = sunset_s.to(torch.float32)
  day = 86400.0
  is_daytime = sunset < sunrise
  prev_sunrise = sunrise - day
  prev_sunset = sunset - day
  day_cycle = math.pi * (t - prev_sunrise) / (sunset - prev_sunrise)
  night_cycle = math.pi + math.pi * (t - prev_sunset) / (sunrise - prev_sunset)
  return torch.where(is_daytime, day_cycle, night_cycle)


def ambient_features(params: balloon_lib.BalloonParams,
                     state: balloon_lib.BalloonState, sunrise_s, sunset_s):
  """The 16 ambient features (features.py:382-455) -> (E, 16)."""
  soc = balloon_lib.battery_soc(params, state)
  pr = balloon_lib.pressure_ratio(state)
  lat, lng = balloon_lib.latlng(state)
  solar_angle, _, _ = solar.solar_calculator(lat, lng, state.time_s)
  cycle = compute_sunrise_cycle(state.time_s, sunrise_s, sunset_s)
  distance_m = torch.sqrt(state.x_m * state.x_m + state.y_m * state.y_m)
  heading = torch.atan2(-state.x_m / 1000.0, -state.y_m / 1000.0)
  power_to_use = power_table.lookup(pr, soc)
  nav_paused = balloon_lib.navigation_is_paused(state)
  excess = balloon_lib.excess_energy(params, state)
  f32 = lambda b: b.to(torch.float32)
  return torch.stack([
      transforms.linear_rescale_with_saturation(
          state.pressure_pa, constants.PERCIATELLI_PRESSURE_RANGE_MIN,
          constants.PERCIATELLI_PRESSURE_RANGE_MAX),
      soc,
      transforms.linear_rescale_with_saturation(solar_angle, -90.0, 90.0),
      torch.sin(cycle),
      torch.cos(cycle),
      torch.sin(heading),
      torch.cos(heading),
      transforms.squash_to_unit_interval(distance_m / 1000.0, 250.0),
      f32(state.last_command == safety.UP),
      f32(state.last_command == safety.STAY),
      f32(state.last_command == safety.DOWN),
      f32(nav_paused),
      f32(~nav_paused),
      f32(excess),
      transforms.linear_rescale_with_saturation(power_to_use, 100.0, 300.0),
      pr,
  ], dim=-1)


def wind_column_features_precomputed(params, state: balloon_lib.BalloonState,
                                     atmosphere, error_means, deviations,
                                     forecast_uv):
  """The 3 x 361 balloon-centered wind features (features.py:457-581) ->
  (E, 361, 3) [uncertainty, angle_error, magnitude], from the GP posterior
  (error_means (E, 181, 2), deviations (E, 181)) and the forecast at the
  levels (E, 181, 2)."""
  means = error_means + forecast_uv
  magnitudes = torch.sqrt((means * means).sum(dim=-1))
  unit_winds = means / (magnitudes + TOLERANCE_M)[..., None]

  distance_m = torch.sqrt(state.x_m * state.x_m + state.y_m * state.y_m)
  station_dir = -torch.stack([state.x_m, state.y_m], dim=-1) / (
      distance_m + TOLERANCE_M)[:, None]
  cos_err = torch.clamp(unit_winds[..., 0] * station_dir[:, 0:1] +
                        unit_winds[..., 1] * station_dir[:, 1:2], -1.0, 1.0)
  angle_errors = torch.acos(cos_err)
  angle_errors = torch.where(magnitudes < TOLERANCE_M,
                             torch.full_like(angle_errors, math.pi),
                             angle_errors)
  angle_errors = torch.where(distance_m[:, None] < TOLERANCE_M,
                             torch.zeros_like(angle_errors), angle_errors)
  angle_feats = angle_errors / math.pi
  magnitude_feats = transforms.squash_to_unit_interval(magnitudes, 30.0)

  lat, lng = balloon_lib.latlng(state)
  el_deg, _, flux = solar.solar_calculator(lat, lng, state.time_s)
  min_p, max_p = pressure_range.compute_pressure_range(
      params, atmosphere, el_deg, flux, state.upwelling_infrared_w_m2)
  levels = pressure_levels(state.x_m.device)
  reachable = (levels >= min_p[:, None]) & (levels <= max_p[:, None])

  level_data = torch.stack([deviations, angle_feats, magnitude_feats],
                           dim=-1)  # (E, 181, 3)

  # Output j reads source level l = j - 180 + balloon_level.
  balloon_level = nearest_pressure_level(state.pressure_pa)
  out_idx = torch.arange(2 * NUM_PRESSURE_LEVELS - 1, device=levels.device)
  src = out_idx[None, :] - (NUM_PRESSURE_LEVELS - 1) + balloon_level[:, None]
  in_bounds = (src >= 0) & (src < NUM_PRESSURE_LEVELS)
  src_c = torch.clamp(src, 0, NUM_PRESSURE_LEVELS - 1)
  gathered = torch.gather(level_data, 1, src_c[..., None].expand(-1, -1, 3))
  valid = in_bounds & torch.gather(reachable, 1, src_c)
  unreachable_row = torch.tensor([0.0, 1.0, 1.0], device=levels.device)
  return torch.where(valid[..., None], gathered, unreachable_row)


def get_features_precomputed(params, state: balloon_lib.BalloonState,
                             atmosphere, sunrise_s, sunset_s, error_means,
                             deviations, forecast_uv):
  """The (E, 1099) feature vectors with the GP posterior and the level
  forecast supplied by the caller."""
  ambient = ambient_features(params, state, sunrise_s, sunset_s)
  column = wind_column_features_precomputed(params, state, atmosphere,
                                            error_means, deviations,
                                            forecast_uv)
  return torch.cat([ambient, column.reshape(column.shape[0], -1)], dim=-1)


def wind_column_features(params, state: balloon_lib.BalloonState,
                         gp_state: wind_gp.WindGPState,
                         wind: wind_field_lib.WindFieldState, atmosphere):
  """The 3 x 361 balloon-centered wind features (features.py:457-581)
  with the GP queried and the forecast read here (ble_tpu/env/features.py:
  wind_column_features over a batch) -> (E, 361, 3): the GP posterior at
  the 181 levels by wind_gp.query_column (on the card the column-query
  kernel, ops/gp_query.py), the forecast at the levels from one
  effective_column."""
  levels = pressure_levels(state.x_m.device)
  elapsed = state.time_elapsed_s.to(torch.float32)
  error_means, deviations = wind_gp.query_column(gp_state, state.x_m,
                                                 state.y_m, elapsed, levels)
  column = wind_field_lib.effective_column(wind, state.x_m, state.y_m,
                                           state.time_elapsed_s)
  forecast = wind_field_lib.column_at_levels(column, levels)
  return wind_column_features_precomputed(params, state, atmosphere,
                                          error_means, deviations, forecast)


def get_features(params, state: balloon_lib.BalloonState,
                 gp_state: wind_gp.WindGPState,
                 wind: wind_field_lib.WindFieldState, atmosphere, sunrise_s,
                 sunset_s):
  """The (E, 1099) feature vectors (features.py:308-330), querying the GP
  and the forecast at the levels here (wind_column_features)."""
  ambient = ambient_features(params, state, sunrise_s, sunset_s)
  column = wind_column_features(params, state, gp_state, wind, atmosphere)
  return torch.cat([ambient, column.reshape(column.shape[0], -1)], dim=-1)


@dataclasses.dataclass
class NamedFeatures:
  """Parsed feature vector (reference NamedPerciatelliFeatures,
  features.py:163-256)."""
  balloon_pressure: torch.Tensor
  battery_charge: torch.Tensor
  solar_elevation: torch.Tensor
  sin_solar_cycle: torch.Tensor
  cos_solar_cycle: torch.Tensor
  sin_heading_to_station: torch.Tensor
  cos_heading_to_station: torch.Tensor
  distance_to_station: torch.Tensor
  last_command: torch.Tensor
  navigation_paused: torch.Tensor
  has_excess_energy: torch.Tensor
  descent_cost: torch.Tensor
  internal_pressure_ratio: torch.Tensor
  winds: torch.Tensor  # (..., 361, 3): uncertainty, bearing, magnitude.


def parse(features) -> NamedFeatures:
  """Parses (..., 1099) feature vectors."""
  ambient = features[..., :16]
  winds = features[..., 16:].reshape(features.shape[:-1] + (361, 3))
  last_idx = ambient[..., 8:11].argmax(dim=-1)
  # Feature order up/stay/down -> command codes (features.py:206-215).
  codes = torch.tensor([safety.UP, safety.STAY, safety.DOWN],
                       device=features.device)
  return NamedFeatures(
      balloon_pressure=transforms.undo_linear_rescale_with_extrapolation(
          ambient[..., 0], constants.PERCIATELLI_PRESSURE_RANGE_MIN,
          constants.PERCIATELLI_PRESSURE_RANGE_MAX),
      battery_charge=ambient[..., 1],
      solar_elevation=ambient[..., 2],
      sin_solar_cycle=ambient[..., 3],
      cos_solar_cycle=ambient[..., 4],
      sin_heading_to_station=ambient[..., 5],
      cos_heading_to_station=ambient[..., 6],
      distance_to_station=ambient[..., 7],
      last_command=codes[last_idx],
      navigation_paused=ambient[..., 11],
      has_excess_energy=ambient[..., 13],
      descent_cost=ambient[..., 14],
      internal_pressure_ratio=ambient[..., 15],
      winds=winds)


def wind_is_valid(winds):
  """(..., 361) validity mask: invalid levels are exactly (0, 1, 1)."""
  return ~((winds[..., 2] == 1.0) & (winds[..., 1] == 1.0) &
           (winds[..., 0] == 0.0))
