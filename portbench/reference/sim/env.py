"""The balloon environment's batched reset and step, plain (the port's
env/env.py without its kernel routes): `reset_from_field` builds fresh
episodes from reset keys and decoded grids, `step_batched` is one agent
step for every env with one effective column a step and the fused GP
observe + query.
"""

import dataclasses
from typing import NamedTuple

import torch

from portbench.reference.sim import atmosphere as atmosphere_lib
from portbench.reference.sim import balloon as balloon_lib
from portbench.reference.sim import features as features_lib
from portbench.reference.sim import safety
from portbench.reference.sim import solar
from portbench.reference.sim import stable_init
from portbench.reference.sim import wind_field as wind_field_lib
from portbench.reference.sim import wind_gp
from portbench.reference.sim import gp_window
from portbench.reference.sim import physics
from portbench.reference.sim import constants
from portbench.reference.sim import prng
from portbench.reference.sim import sampling
from portbench.reference.sim import transforms

NUM_ACTIONS = 3
OBSERVATION_DIM = features_lib.NUM_FEATURES


@dataclasses.dataclass
class EnvParams:
  """Environment configuration (reference BalloonEnv gin params)."""
  balloon: balloon_lib.BalloonParams = dataclasses.field(
      default_factory=balloon_lib.BalloonParams)
  station_keeping_radius_km: float = 50.0
  reward_dropoff: float = 0.4
  reward_halflife_km: float = 100.0
  # Store the forecast grid in float32 instead of bf16.
  wind_field_f32: bool = False
  # Windowed field-slab cache (wind_field.refresh_slab): per-step queries
  # read a (4, 4) lat/lng window instead of the full 21x21 grid. Exact while
  # the balloon moves less than one 50 km grid cell between re-centres:
  # with `field_cache_every=8` agent steps that is sustained wind below
  # ~34.7 m/s. step_batched keeps that cadence from the caller's
  # global_step; the eval, the learner and the bench pass their step index.
  field_cache: bool = False
  field_cache_every: int = 8


@dataclasses.dataclass
class EnvState:
  balloon: balloon_lib.BalloonState
  atmosphere: atmosphere_lib.AtmosphereParams
  wind: wind_field_lib.WindFieldState
  gp: wind_gp.WindGPState
  sunrise_s: torch.Tensor  # (E,) int32 next sunrise at the balloon.
  sunset_s: torch.Tensor  # (E,) int32 next sunset.
  # Ground-truth wind at the balloon: the last measurement and the next
  # step's advection wind.
  wind_u: torch.Tensor
  wind_v: torch.Tensor
  steps: torch.Tensor  # (E,) int32 agent steps taken this episode.


class StepOutput(NamedTuple):
  state: EnvState
  observation: torch.Tensor
  reward: torch.Tensor
  done: torch.Tensor
  info: dict


def tree_map(fn, *trees):
  """`fn` applied leaf by leaf to dataclass trees of one structure (an
  EnvState or any part of it); None leaves stay None."""
  first = trees[0]
  if dataclasses.is_dataclass(first):
    return dataclasses.replace(first, **{
        f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
        for f in dataclasses.fields(first)})
  if first is None:
    return None
  return fn(*trees)


def reward_function(params: EnvParams, state: balloon_lib.BalloonState,
                    excess):
  """Perciatelli reward (reference balloon_env.py:44-102)."""
  distance_km = torch.sqrt(state.x_m * state.x_m +
                           state.y_m * state.y_m) / 1000.0
  radius = params.station_keeping_radius_km
  outside = params.reward_dropoff * torch.exp(
      -0.69314718056 / params.reward_halflife_km * (distance_km - radius))
  reward = torch.where(distance_km <= radius, torch.ones_like(outside),
                       outside)
  scale = transforms.linear_rescale_with_saturation(state.acs_power_w, 100.0,
                                                    300.0)
  multiplier = 0.95 - 0.3 * scale
  apply_penalty = (state.last_command == safety.DOWN) & ~excess
  return torch.where(apply_penalty, reward * multiplier, reward)


def _wind_and_forecast(state_wind, balloon):
  """The step's one field contraction: (column (E, 10, 2), forecast at the
  balloon (E, 2), noise u, noise v)."""
  col = wind_field_lib.effective_column(state_wind, balloon.x_m, balloon.y_m,
                                        balloon.time_elapsed_s)
  forecast = wind_field_lib.column_at_pressure(col, balloon.pressure_pa)
  noise_u, noise_v = wind_field_lib.get_noise(
      state_wind, balloon.x_m, balloon.y_m, balloon.pressure_pa,
      balloon.time_elapsed_s)
  return col, forecast, noise_u, noise_v


def _observe_and_features(params: EnvParams, state: EnvState, col, noise_u,
                          noise_v, enabled):
  """GP observe + query of this step's measurement (error = truth -
  forecast = the noise) and the feature vectors."""
  b = state.balloon
  elapsed = b.time_elapsed_s.to(torch.float32)
  gp, error_means, deviations = gp_window.step(
      state.gp, b.x_m, b.y_m, b.pressure_pa, elapsed, noise_u, noise_v,
      enabled)
  state = dataclasses.replace(state, gp=gp)
  levels = features_lib.pressure_levels(b.x_m.device)
  forecast_levels = wind_field_lib.column_at_levels(col, levels)
  obs = features_lib.get_features_precomputed(
      params.balloon, b, state.atmosphere, state.sunrise_s, state.sunset_s,
      error_means, deviations, forecast_levels)
  return state, obs


def seed_keys(seeds) -> torch.Tensor:
  """The reset keys (E, 2) of integer seeds: split(PRNGKey(seed))[1], the
  JAX package's eval_lib.seed_to_key (the reference's env.seed then
  reset, balloon_env.py:253,213), which is also the gym env's first reset
  key. 64-bit seeds keep both halves."""
  return prng.split(prng.keys(seeds))[:, 1]


def forecast_keys(keys) -> torch.Tensor:
  """The forecast-grid keys (E, 2) of reset keys: split(split(key, 7)[6])[1]
  (ble_tpu/env/env.py:155-156)."""
  return prng.split(prng.split(keys, 7)[:, 6])[:, 1]


def reset_from_field(keys, params: EnvParams, field, device=None):
  """Fresh episodes from reset keys (E, 2) with the forecast grid already
  decoded (ble_tpu/env/env.py:reset_from_field over a leading key axis):
  each env's initial conditions drawn from its key as the JAX package
  draws them (its 7-way split), on the host, then moved to `device` once,
  so a key gives the same world as in the JAX package, and the same bits
  on the card and on the CPU.

  Args:
    keys: (E, 2) int64 keys (utils/prng.py).
    params: EnvParams.
    field: (21, 21, 10, 9, 2) forecast grid shared by every env, or
      (E, 21, 21, 10, 9, 2) per-env grids.
    device: torch device.

  Returns:
    (EnvState, observation (E, 1099)).
  """
  ic = sampling.sample_initial_conditions(keys)
  atmosphere = tree_map(lambda x: x.to(device),
                        atmosphere_lib.make(ic['atmosphere_alpha']))
  noise_keys = ic.pop('noise_keys')
  ic = {k: v.to(device) for k, v in ic.items()}
  return init_state(params, atmosphere, ic['time_s'], ic['x_m'], ic['y_m'],
                    ic['center_lat_rad'], ic['center_lng_rad'],
                    ic['pressure_pa'], ic['upwelling_ir'],
                    make_wind(params, field, noise_keys, ic['x_m'],
                              ic['y_m']))


def make_wind(params: EnvParams, field, noise_keys, x_m, y_m,
              exact_noise: bool = False) -> wind_field_lib.WindFieldState:
  """The WindFieldState of fresh episodes (wind_field.make_state from the
  noise keys (E, 2)): the grid(s) in the configured dtype, one per env, on
  x_m's device, with the slab cache centred on (x_m, y_m) when it is
  on."""
  dtype = torch.float32 if params.wind_field_f32 else \
      wind_field_lib.FIELD_DTYPE
  wind = wind_field_lib.make_state(
      torch.as_tensor(field, device=x_m.device), noise_keys, exact_noise,
      dtype)
  if params.field_cache:
    wind = wind_field_lib.refresh_slab(wind, x_m, y_m)
  return wind


def init_state(params: EnvParams, atmosphere, t0, x_m, y_m, center_lat,
               center_lng, pressure, upwelling_ir,
               wind: wind_field_lib.WindFieldState):
  """The initial EnvState from initial conditions, all (E,) tensors
  (reference balloon_arena.py:161-182,259-268): the stable init, the
  sunrise/sunset search and the first observation."""
  n = x_m.shape[0]
  dev = x_m.device
  full = lambda v, dtype=torch.float32: torch.full((n,), v, dtype=dtype,
                                                   device=dev)
  i32 = lambda v: full(v, torch.int32)
  balloon = balloon_lib.BalloonState(
      center_lat_rad=center_lat, center_lng_rad=center_lng, x_m=x_m, y_m=y_m,
      pressure_pa=pressure, time_s=t0.to(torch.int32),
      time_elapsed_s=i32(0), ambient_temperature_k=full(206.0),
      internal_temperature_k=full(206.0), mols_air=full(0.0),
      envelope_volume_m3=full(1804.0), superpressure_pa=full(0.0),
      acs_power_w=full(0.0), acs_mass_flow_kg_s=full(0.0),
      solar_charging_w=full(0.0), power_load_w=full(0.0),
      battery_charge_j=full(2905.6 * constants.WATT_HOURS_TO_JOULES),
      last_command=i32(safety.STAY), status=i32(balloon_lib.STATUS_OK),
      upwelling_infrared_w_m2=upwelling_ir,
      power_safety=safety.PowerSafetyState(
          navigation_is_paused=torch.zeros((n,), dtype=torch.bool,
                                           device=dev),
          sunrise_with_hysteresis_s=i32(0), sunset_s=i32(0)),
      envelope_safety_state=i32(0), altitude_safety_state=i32(0))
  balloon = stable_init.cold_start_to_stable_params(params.balloon, balloon,
                                                    atmosphere)
  lat, lng = balloon_lib.latlng(balloon)
  sunrise, sunset = solar.next_sunrise_sunset(lat, lng, balloon.time_s)
  balloon = dataclasses.replace(balloon, power_safety=safety.PowerSafetyState(
      navigation_is_paused=balloon.power_safety.navigation_is_paused,
      sunrise_with_hysteresis_s=sunrise + safety.POWER_SUNRISE_HYSTERESIS_S,
      sunset_s=sunset))

  col, forecast, noise_u, noise_v = _wind_and_forecast(wind, balloon)
  state = EnvState(balloon=balloon, atmosphere=atmosphere, wind=wind,
                   gp=wind_gp.init(n, dev), sunrise_s=sunrise,
                   sunset_s=sunset, wind_u=forecast[:, 0] + noise_u,
                   wind_v=forecast[:, 1] + noise_v, steps=i32(0))
  enabled = torch.ones((n,), dtype=torch.bool, device=dev)
  return _observe_and_features(params, state, col, noise_u, noise_v, enabled)


def refresh_field_cache(state: EnvState) -> EnvState:
  """Re-centers every env's field slab on its balloon."""
  return dataclasses.replace(state, wind=wind_field_lib.refresh_slab(
      state.wind, state.balloon.x_m, state.balloon.y_m))


def step_batched(params: EnvParams, state: EnvState, actions,
                 global_step=None, refresh: str = 'auto') -> StepOutput:
  """One agent step for every env (reference balloon_env.py:157-190 +
  balloon_arena.py:184-202).

  global_step: the caller's step counter (a host int or a 0-d tensor),
  driving the slab's re-centre cadence with the cache on: it re-centres
  when global_step % params.field_cache_every == 0. None with the cache on
  re-centres every step (exact, but a grid gather a step).
  refresh: 'auto' (the cadence above), or 'never' for callers that
  re-centre (refresh_field_cache) themselves, as rollout_window's do.
  """
  if state.wind.slab is not None and refresh != 'never':
    if global_step is None or int(global_step) % params.field_cache_every == 0:
      state = refresh_field_cache(state)
  was_ok = state.balloon.status == balloon_lib.STATUS_OK
  balloon = physics.simulate_step_fused(
      params.balloon, state.atmosphere, state.balloon, state.wind_u,
      state.wind_v, actions.to(torch.int32))

  # Ground truth = forecast + noise at the same point, so the GP error
  # (truth - forecast) is exactly the noise.
  col, forecast, noise_u, noise_v = _wind_and_forecast(state.wind, balloon)
  state = dataclasses.replace(
      state, balloon=balloon,
      wind_u=forecast[:, 0] + noise_u, wind_v=forecast[:, 1] + noise_v,
      sunrise_s=safety.advance_past(state.sunrise_s, balloon.time_s),
      sunset_s=safety.advance_past(state.sunset_s, balloon.time_s),
      steps=state.steps + 1)
  # Terminal balloons freeze; their exact-duplicate measurements stay out
  # of the GP. The step where a balloon becomes terminal still observes.
  state, obs = _observe_and_features(params, state, col, noise_u, noise_v,
                                     was_ok)

  return StepOutput(state, obs, *step_outcome(params, state.balloon,
                                               state.wind))


def step_outcome(params: EnvParams, balloon: balloon_lib.BalloonState,
                 wind):
  """(reward, done, info) of balloons just stepped, whose leaves lead with
  (E,) or (K, E). With the slab cache on, info's slab_oob holds each
  position against the slab of `wind`."""
  excess = balloon_lib.excess_energy(params.balloon, balloon)
  reward = reward_function(params, balloon, excess)
  info = {
      'out_of_power': balloon.status == balloon_lib.STATUS_OUT_OF_POWER,
      'envelope_burst': balloon.status == balloon_lib.STATUS_BURST,
      'zeropressure': balloon.status == balloon_lib.STATUS_ZEROPRESSURE,
      'time_elapsed_s': balloon.time_elapsed_s,
      'x_km': balloon.x_m / 1000.0,
      'y_km': balloon.y_m / 1000.0,
      'pressure_pa': balloon.pressure_pa,
      'superpressure_pa': balloon.superpressure_pa,
      'battery_soc': balloon_lib.battery_soc(params.balloon, balloon),
  }
  if params.field_cache:
    info['slab_oob'] = wind_field_lib.slab_oob(wind, balloon.x_m,
                                               balloon.y_m)
  done = balloon.status != balloon_lib.STATUS_OK
  return reward, done, info
