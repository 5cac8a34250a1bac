"""The balloon environment as batched reset/step functions on tensors (the
port of ble_tpu/env/env.py; reference env/balloon_env.py and
balloon_arena.py).

Every EnvState leaf leads with the env axis. Two step routes, as in
ble_tpu:
- `step` is ble_tpu's single-env `step` (`_post_physics`) over a batch:
  ground truth and forecast looked up on their own, the GP observe
  (wind_gp.observe) and the 181-level column query inside the features
  (wind_gp.query_column) as separate kernels. The gym env runs it.
- `step_batched` mirrors ble_tpu's `_post_physics_batched`: one
  effective_column per env serves both the balloon-pressure wind lookup and
  the 181-level feature forecast, and the GP observe + query runs as one
  `ops.gp_window.step`. The eval harness runs it.
`rollout_window` stages K open-loop `step_batched` steps: the physics and
winds step by step, the GP for all K steps in one `ops.gp_window.window`,
then the features and rewards for all K x E rows at once. The bench runs it.
Kernel or plain version is chosen by the tensors' device.
"""

import dataclasses
from typing import NamedTuple

import torch

from ble_tpu_torch import resolve_device
from ble_tpu_torch.env import atmosphere as atmosphere_lib
from ble_tpu_torch.env import balloon as balloon_lib
from ble_tpu_torch.env import features as features_lib
from ble_tpu_torch.env import safety
from ble_tpu_torch.env import solar
from ble_tpu_torch.env import stable_init
from ble_tpu_torch.env import wind_field as wind_field_lib
from ble_tpu_torch.env import wind_gp
from ble_tpu_torch.generative import vae
from ble_tpu_torch.ops import gp_window
from ble_tpu_torch.ops import physics
from ble_tpu_torch.utils import constants
from ble_tpu_torch.utils import prng
from ble_tpu_torch.utils import profiling
from ble_tpu_torch.utils import sampling
from ble_tpu_torch.utils import transforms

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
  with profiling.span('env.gp'):
    gp, error_means, deviations = gp_window.step(
        state.gp, b.x_m, b.y_m, b.pressure_pa, elapsed, noise_u, noise_v,
        enabled)
  state = dataclasses.replace(state, gp=gp)
  with profiling.span('env.features'):
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
    device: torch device (default: cuda).

  Returns:
    (EnvState, observation (E, 1099)).
  """
  device = resolve_device(device)
  with profiling.span('reset.draws'):
    ic = sampling.sample_initial_conditions(keys)
  with profiling.span('reset.init'):
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


def reset_keys(params: EnvParams, keys, field_fn, device=None):
  """Fresh episodes from reset keys (E, 2) (ble_tpu/env/env.py:142-158;
  reference balloon_arena.py:161-182): each env's forecast grid from
  field_fn(forecast_keys(keys), device) (see make_field_fn), then
  reset_from_field. Returns (EnvState, observation (E, 1099))."""
  device = resolve_device(device)
  with profiling.span('reset.draws'):
    fkeys = forecast_keys(keys)
  with profiling.span('reset.decode'):
    field = field_fn(fkeys, device)
  return reset_from_field(keys, params, field, device)


def reset(params: EnvParams, seeds, field_fn, device=None):
  """Fresh episodes for integer `seeds`: reset_keys on seed_keys(seeds), so
  seed s gives the world of the JAX package's env.reset(seed_to_key(s)).
  Returns (EnvState, observation (E, 1099))."""
  with profiling.span('env.reset'):
    with profiling.span('reset.draws'):
      keys = seed_keys(seeds)
    return reset_keys(params, keys, field_fn, device)


# Latents a decoder call. cuBLAS picks a GEMM by its row count, and two
# GEMMs may sum in other orders, so on the card a seed's decoded field
# would differ in its last bits with the number of seeds decoded beside it
# (a rank's share of the envs, a selective reset's count, an eval shard).
# Every call decodes exactly this many rows.
DECODE_BLOCK = 16


def make_field_fn(kind: str = 'generative', decoder=None):
  """A field_fn(forecast keys (E, 2), device) for `reset`.

  kinds: 'generative' decodes one grid per env with `decoder`
  (generative/vae.Decoder) from the latent normal(key, (64,)) of its
  forecast key (ble_tpu/generative/vae.py:119-122), drawn on the host, in
  decoder calls of DECODE_BLOCK latents each (the last one padded), so a
  key's grid does not depend on its batch, to the bit:
  (E, 21, 21, 10, 9, 2). 'static' is the 4-direction test field
  (reference wind_field.py:149-184), one grid shared by every env.
  """
  if kind == 'static':
    return lambda keys, device: wind_field_lib.simple_static_field(device)
  if kind != 'generative':
    raise ValueError(f'unknown wind field kind: {kind}')
  if decoder is None:
    raise ValueError('the generative field needs a decoder')

  @torch.no_grad()
  def field_fn(keys, device):
    z = vae.sample_latent(keys).to(next(decoder.parameters()).device)
    n = z.shape[0]
    z = torch.cat([z, z.new_zeros(((-n) % DECODE_BLOCK, z.shape[1]))])
    return torch.cat([decoder(c).to(device)
                      for c in z.split(DECODE_BLOCK)])[:n]

  return field_fn


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
  with profiling.span('env.step_batched'):
    if state.wind.slab is not None and refresh != 'never':
      if (global_step is None or
          int(global_step) % params.field_cache_every == 0):
        with profiling.span('env.slab'):
          state = refresh_field_cache(state)
    was_ok = state.balloon.status == balloon_lib.STATUS_OK
    with profiling.span('env.physics'):
      balloon = physics.simulate_step_fused(
          params.balloon, state.atmosphere, state.balloon, state.wind_u,
          state.wind_v, actions.to(torch.int32))

    # Ground truth = forecast + noise at the same point, so the GP error
    # (truth - forecast) is exactly the noise.
    with profiling.span('env.wind'):
      col, forecast, noise_u, noise_v = _wind_and_forecast(state.wind,
                                                           balloon)
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
    with profiling.span('env.outcome'):
      outcome = step_outcome(params, state.balloon, state.wind)
    return StepOutput(state, obs, *outcome)


def rollout_window(params: EnvParams, state: EnvState, actions) -> StepOutput:
  """K open-loop steps with the GP state resident across the window (the
  port of ble_tpu/env/env.py:rollout_window).

  Positions and winds do not depend on the GP or the features, which only
  observe the trajectory, so when the K actions are known up front the
  steps are staged:
    1. a loop over the K steps runs the physics (B1, one launch a step on
       the card), one effective_column and the noise at the balloon, and
       the sunrise/sunset advance;
    2. one gp_window.window call observes and queries all K steps (on the
       card one launch of B2, kinv in shared memory for the window);
    3. the level forecast, features, rewards, done flags and info for all
       K x E rows at once.
  It computes what K `step_batched` calls compute from the same state
  (tests/test_torch_rollout_window.py); actions that depend on each step's
  observation need `step_batched`. The slab is not re-centred inside the
  window: with the cache on, the caller re-centres it (refresh_field_cache)
  before each window of at most params.field_cache_every steps. Info has
  step_batched's keys: with the cache on, slab_oob holds each step's
  position against the slab the window used. Nothing in it waits for the
  device.

  Args:
    params: EnvParams.
    state: EnvState, leaves leading with (E,).
    actions: (K, E) int actions on the envs' device.

  Returns:
    StepOutput with the final state and (K, E)-leading observation, reward,
    done and info.
  """
  actions = actions.to(torch.int32)
  k, n = actions.shape
  balloon, wind_u, wind_v = state.balloon, state.wind_u, state.wind_v
  sunrise, sunset = state.sunrise_s, state.sunset_s
  per_step = []
  for i in range(k):
    was_ok = balloon.status == balloon_lib.STATUS_OK
    balloon = physics.simulate_step_fused(params.balloon, state.atmosphere,
                                          balloon, wind_u, wind_v,
                                          actions[i])
    col, forecast, noise_u, noise_v = _wind_and_forecast(state.wind, balloon)
    wind_u = forecast[:, 0] + noise_u
    wind_v = forecast[:, 1] + noise_v
    sunrise = safety.advance_past(sunrise, balloon.time_s)
    sunset = safety.advance_past(sunset, balloon.time_s)
    per_step.append((balloon, col, noise_u, noise_v, was_ok, sunrise, sunset))
  balloons, cols, noise_u, noise_v, was_ok, sunrises, sunsets = (
      tree_map(lambda *xs: torch.stack(xs), *leaves)
      for leaves in zip(*per_step))

  elapsed = balloons.time_elapsed_s.to(torch.float32)
  obs_seq = gp_window.pack_obs(balloons.x_m, balloons.y_m,
                               balloons.pressure_pa, elapsed, noise_u,
                               noise_v, was_ok)  # (K, E, 8)
  gp, level = gp_window.window(state.gp, obs_seq)

  flat = lambda tree: tree_map(lambda x: x.reshape((k * n,) + x.shape[2:]),
                               tree)
  atmosphere = tree_map(lambda x: x.expand((k,) + x.shape), state.atmosphere)
  levels = features_lib.pressure_levels(actions.device)
  forecast_levels = wind_field_lib.column_at_levels(flat(cols), levels)
  obs = features_lib.get_features_precomputed(
      params.balloon, flat(balloons), flat(atmosphere), flat(sunrises),
      flat(sunsets), flat(level[..., 0:2]), flat(level[..., 2]),
      forecast_levels).reshape(k, n, -1)
  reward, done, info = step_outcome(params, balloons, state.wind)
  final = dataclasses.replace(
      state, balloon=balloon, gp=gp, wind_u=wind_u, wind_v=wind_v,
      sunrise_s=sunrise, sunset_s=sunset, steps=state.steps + k)
  return StepOutput(final, obs, reward, done, info)


def step(params: EnvParams, state: EnvState, actions,
         refresh: str = 'auto') -> StepOutput:
  """One agent step for every env by ble_tpu's single-env route
  (ble_tpu/env/env.py:step and _post_physics; reference
  balloon_env.py:157-190 + balloon_arena.py:184-202): equal to
  jax.vmap(ble_tpu env.step). The GP error is the ground truth minus the
  forecast, each looked up on its own, and the GP observe and the features'
  column query are separate calls (on the card, the kernels of
  ops/gp_observe.py and ops/gp_query.py).

  refresh: 'auto' re-centres the slab every step when the cache is on;
  'never' leaves it to the caller (refresh_field_cache).
  """
  if state.wind.slab is not None and refresh != 'never':
    state = refresh_field_cache(state)
  was_ok = state.balloon.status == balloon_lib.STATUS_OK
  balloon = physics.simulate_step_fused(
      params.balloon, state.atmosphere, state.balloon, state.wind_u,
      state.wind_v, actions.to(torch.int32))
  elapsed = balloon.time_elapsed_s.to(torch.float32)
  wind_u, wind_v = wind_field_lib.get_ground_truth(
      state.wind, balloon.x_m, balloon.y_m, balloon.pressure_pa, elapsed)
  state = dataclasses.replace(
      state, balloon=balloon, wind_u=wind_u, wind_v=wind_v,
      sunrise_s=safety.advance_past(state.sunrise_s, balloon.time_s),
      sunset_s=safety.advance_past(state.sunset_s, balloon.time_s),
      steps=state.steps + 1)
  forecast_u, forecast_v = wind_field_lib.get_forecast(
      state.wind, balloon.x_m, balloon.y_m, balloon.pressure_pa, elapsed)
  # Terminal balloons freeze; their exact-duplicate measurements stay out
  # of the GP. The step where a balloon becomes terminal still observes.
  gp = wind_gp.observe(state.gp, balloon.x_m, balloon.y_m,
                       balloon.pressure_pa, elapsed, wind_u - forecast_u,
                       wind_v - forecast_v, enabled=was_ok)
  state = dataclasses.replace(state, gp=gp)
  obs = features_lib.get_features(params.balloon, balloon, gp, state.wind,
                                  state.atmosphere, state.sunrise_s,
                                  state.sunset_s)
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
