"""StationSeeker, plain: the rule-based station-keeping controller's
altitude scores and action over a batch of observations (upstream
agents/station_seeker_agent.py, Bellemare et al. 2020 parameters)."""

import math

import torch

from portbench.reference.sim import features as features_lib
from portbench.reference.sim import safety
from portbench.reference.sim import transforms

HALF_RADIUS = 35.0
MAGNITUDE_WEIGHT = 0.07  # k_1
CLOSE_BEARING_WEIGHT = 0.6
FAR_BEARING_WEIGHT = 0.45
CLOSE_BEARING = 250.0
FAR_BEARING = 500.0
DEFAULT_SCORE = 0.5  # g_unknown
HYSTERESIS_K2 = 0.05
HYSTERESIS_K3 = 0.001
CONFIDENCE_EPSILON = 0.01

_MIDPOINT = 180  # Center of the 361-level balloon-centered column.


def scores(observation):
  """(..., 1099) features -> (..., 361) altitude scores; invalid levels 0."""
  parsed = features_lib.parse(observation)
  winds = parsed.winds
  valid = features_lib.wind_is_valid(winds)

  uncertainty = winds[..., 0]
  bearing_rad = winds[..., 1] * math.pi
  magnitude = transforms.undo_squash_to_unit_interval(
      torch.clamp_max(winds[..., 2], 1.0 - 1e-6), 30.0)
  distance = transforms.undo_squash_to_unit_interval(
      torch.clamp_max(parsed.distance_to_station, 1.0 - 1e-6), 250.0)

  coeff = torch.clamp((distance - CLOSE_BEARING) /
                      (FAR_BEARING - CLOSE_BEARING), 0.0, 1.0)
  bearing_weight = CLOSE_BEARING_WEIGHT + coeff * (FAR_BEARING_WEIGHT -
                                                   CLOSE_BEARING_WEIGHT)
  alpha_delta = torch.exp(-distance / HALF_RADIUS)

  magnitude_term = torch.exp(-MAGNITUDE_WEIGHT * magnitude)
  bearing_term = torch.exp(-bearing_weight[..., None] * bearing_rad)
  wind_score = ((1.0 - alpha_delta[..., None]) * bearing_term +
                alpha_delta[..., None] * magnitude_term)

  level = torch.arange(2 * features_lib.NUM_PRESSURE_LEVELS - 1,
                       device=observation.device)
  level_distance = torch.abs(level - _MIDPOINT).to(torch.float32)
  hysteresis = HYSTERESIS_K2 * torch.exp(-HYSTERESIS_K3 * level_distance)

  score = ((1.0 - uncertainty + CONFIDENCE_EPSILON) * wind_score +
           uncertainty * DEFAULT_SCORE + hysteresis)
  return torch.where(valid, score, torch.zeros_like(score))


def pick_action(observation):
  """Best-level argmax -> UP/DOWN/STAY, int32 (..,)."""
  best = scores(observation).argmax(dim=-1)
  up = torch.full_like(best, safety.UP)
  down = torch.full_like(best, safety.DOWN)
  stay = torch.full_like(best, safety.STAY)
  return torch.where(best < _MIDPOINT, up,
                     torch.where(best > _MIDPOINT, down, stay)).to(torch.int32)


def action_gap(observation, actions):
  """How far the best score among the levels that `actions` (..,) head
  for lies below the best score of all levels: 0 where an action is one
  the scores choose, > 0 where another action scores better."""
  s = scores(observation)
  level = torch.arange(s.shape[-1], device=s.device)
  heads = torch.where(level < _MIDPOINT, safety.UP,
                      torch.where(level > _MIDPOINT, safety.DOWN,
                                  safety.STAY))
  mine = heads == actions.to(heads.dtype)[..., None]
  best_mine = torch.where(mine, s, torch.full_like(s, -math.inf)).amax(-1)
  return s.amax(-1) - best_mine
