"""Fused physics substeps: the port of ble_tpu/ops/pallas_physics.py.

`simulate_step_fused` is balloon.simulate_step with the substep loop in
one kernel (csrc/physics.cu: CTAs of `env_split` envs, each computing its
envs' solar track for every substep in parallel, then running each env's
serial chain on one thread); the once-per-step safety remap stays in
torch. For CUDA tensors the wrapper launches the kernel; for CPU tensors it
runs the plain version, `balloon.run_substeps`. There is no other
fallback. `solar_track_plain` is the plain version of the kernel's first
phase, for the tests.

TPU kernel replaced: ble_tpu/ops/pallas_physics.py:simulate_substeps_fused.
Bound and design: see the note at the top of csrc/physics.cu.
"""

import ctypes
import dataclasses

import torch

from ble_tpu_torch.env import atmosphere as atmosphere_lib
from ble_tpu_torch.env import balloon as balloon_lib
from ble_tpu_torch.env import solar
from ble_tpu_torch.ops import cuda_build
from ble_tpu_torch.utils import constants
from ble_tpu_torch.utils import spherical

_F32 = balloon_lib.SUBSTEP_F32_FIELDS
_I32 = balloon_lib.SUBSTEP_I32_FIELDS
_PARAM_ORDER = (
    'envelope_volume_base', 'envelope_volume_dv_pressure', 'envelope_mass',
    'envelope_max_superpressure', 'envelope_cod', 'payload_mass',
    'nighttime_power_load_w', 'daytime_power_load_w',
    'acs_valve_hole_diameter_m', 'battery_capacity_j', 'mols_lift_gas')
# Envs a CTA at most: the serial threads of a CTA fill one warp.
MAX_ENVS_PER_CTA = 32
_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 4 + (
    ctypes.c_void_p, ctypes.c_void_p)


def env_split(n_envs: int, n_sms: int) -> int:
  """Envs G of each CTA for a batch of `n_envs` on a card with `n_sms`
  SMs: as few as spread the batch over every SM, at least 1 and at most
  MAX_ENVS_PER_CTA (csrc/physics.cu's `envs_per_cta`). CTA b takes envs
  [b G, min(n_envs, b G + G))."""
  return min(max(-(-n_envs // n_sms), 1), MAX_ENVS_PER_CTA)


def solar_track_plain(state: balloon_lib.BalloonState, wind_u, wind_v,
                      num_substeps: int, stride_s: int):
  """The plain version of the physics kernel's first phase: for each env
  and substep s, what substep s of balloon.substep_math takes from the sun
  if the balloon is still OK there: (E, num_substeps, 5) = [elevation
  (deg), flux, solar.elevation_sine_term, solar.panel_terms], at x and y
  advanced s times by the wind and at time_s + s * stride_s."""
  dt = float(stride_s)
  x, y = state.x_m, state.y_m
  rows = []
  for s in range(num_substeps):
    lat, lng = spherical.latlng_from_offset(
        state.center_lat_rad, state.center_lng_rad, x, y)
    el, _, flux = solar.solar_calculator(lat, lng,
                                         state.time_s + s * stride_s)
    rows.append(torch.stack([el, flux, solar.elevation_sine_term(el),
                             *solar.panel_terms(el)], dim=-1))
    x = x + wind_u * dt
    y = y + wind_v * dt
  return torch.stack(rows, dim=1)


def uniform_params(params: balloon_lib.BalloonParams):
  """The 11 float params for the kernel; raises unless fleet-uniform."""
  values = []
  for name in _PARAM_ORDER:
    x = getattr(params, name)
    if isinstance(x, torch.Tensor):
      if x.numel() != 1:
        raise ValueError(
            'The fused physics kernel requires fleet-uniform BalloonParams '
            f'({name} has shape {tuple(x.shape)}); run on CPU tensors for '
            'the plain version.')
      x = x.item()
    values.append(float(x))
  return (ctypes.c_float * len(values))(*values)


def pack(state: balloon_lib.BalloonState,
         atmosphere: atmosphere_lib.AtmosphereParams, wind_u, wind_v, act):
  """The kernel's structure-of-arrays inputs: (16, E) f32, (3, E) i32,
  (23, E) f32 atmosphere, (2, E) f32 wind, (E,) i32 action."""
  f32 = torch.stack([getattr(state, n).to(torch.float32) for n in _F32])
  i32 = torch.stack([getattr(state, n).to(torch.int32) for n in _I32])
  atmo = torch.cat([atmosphere.lapse_rates, atmosphere.temperature_transitions,
                    atmosphere.pressure_transitions], dim=-1).T.contiguous()
  wind = torch.stack([wind_u, wind_v]).to(torch.float32)
  return f32, i32, atmo.to(torch.float32), wind, act.to(torch.int32).contiguous()


def launch(f32, i32, atmo, wind, action, f32_out, i32_out,
           num_substeps: int, stride_s: int, params_c,
           envs_per_cta=None) -> None:
  """One launch of csrc/physics.cu on packed CUDA buffers (see `pack`), on
  the current stream, `envs_per_cta` envs a CTA (default `env_split`'s);
  adds one to `launch.launches`."""
  n = f32.shape[1]
  for name, a, shape, dtype in (
      ('f32', f32, (len(_F32), n), torch.float32),
      ('i32', i32, (len(_I32), n), torch.int32),
      ('atmosphere', atmo, (23, n), torch.float32),
      ('wind', wind, (2, n), torch.float32),
      ('action', action, (n,), torch.int32),
      ('f32_out', f32_out, (len(_F32), n), torch.float32),
      ('i32_out', i32_out, (len(_I32), n), torch.int32)):
    if (tuple(a.shape) != shape or a.dtype != dtype or not a.is_cuda or
        a.device != f32.device or not a.is_contiguous()):
      raise ValueError(f'{name}: expected a contiguous {dtype} {shape} on '
                       f'{f32.device}, got {a.dtype} {tuple(a.shape)} on '
                       f'{a.device}')
  if envs_per_cta is None:
    envs_per_cta = env_split(n, cuda_build.sm_count(f32.device.index or 0))
  fn = cuda_build.entry('physics', 'ble_physics_substeps', _ARGTYPES)
  status = fn(f32.data_ptr(), i32.data_ptr(), atmo.data_ptr(),
              wind.data_ptr(), action.data_ptr(), f32_out.data_ptr(),
              i32_out.data_ptr(), n, num_substeps, stride_s, envs_per_cta,
              ctypes.addressof(params_c),
              torch.cuda.current_stream(f32.device).cuda_stream)
  cuda_build.check(status, 'ble_physics_substeps')
  launch.launches += 1


launch.launches = 0


def substeps_kernel(params: balloon_lib.BalloonParams,
                    atmosphere: atmosphere_lib.AtmosphereParams,
                    state: balloon_lib.BalloonState, wind_u, wind_v, act,
                    num_substeps: int, stride_s: int
                    ) -> balloon_lib.BalloonState:
  """Launches csrc/physics.cu on CUDA tensors: `num_substeps` substeps
  with terminal balloons frozen. `act` is the action after the safety
  remap."""
  params_c = uniform_params(params)
  bufs = pack(state, atmosphere, wind_u, wind_v, act)
  f32_out = torch.empty_like(bufs[0])
  i32_out = torch.empty_like(bufs[1])
  launch(*bufs, f32_out, i32_out, num_substeps, stride_s, params_c)
  updates = {name: f32_out[i] for i, name in enumerate(_F32)
             if name not in balloon_lib.READ_ONLY_FIELDS}
  updates.update({name: i32_out[i] for i, name in enumerate(_I32)})
  return dataclasses.replace(state, **updates)


def simulate_step_fused(params: balloon_lib.BalloonParams,
                        atmosphere: atmosphere_lib.AtmosphereParams,
                        state: balloon_lib.BalloonState, wind_u, wind_v,
                        action,
                        time_delta_s: int = constants.AGENT_TIME_STEP_SECONDS,
                        stride_s: int = constants.PHYSICS_STRIDE_SECONDS
                        ) -> balloon_lib.BalloonState:
  """Batched balloon.simulate_step with the substep loop fused: the kernel
  for CUDA tensors, the plain version for CPU tensors."""
  if time_delta_s % stride_s:
    raise ValueError('time_delta_s must be a multiple of stride_s')
  state, act = balloon_lib.apply_safety(params, atmosphere, state, action)
  num_substeps = time_delta_s // stride_s
  if state.x_m.is_cuda:
    return substeps_kernel(params, atmosphere, state, wind_u, wind_v, act,
                           num_substeps, stride_s)
  if state.x_m.device.type != 'cpu':
    raise ValueError(f'unsupported device {state.x_m.device}')
  return balloon_lib.run_substeps(params, atmosphere, state, wind_u, wind_v,
                                  act, num_substeps, stride_s)
