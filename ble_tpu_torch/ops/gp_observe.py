"""GP observe (the bordered-inverse update) of one observation per env: the
port of ble_tpu/ops/pallas_gp_observe.py.

`observe_kernel` is wind_gp.observe's route for CUDA tensors: one launch
of csrc/gp_observe.cu for the whole batch, which is the TPU package's
`observe` (B3) at E = 1 and its `observe_batched` (B4) at any E. Each env
runs on one CTA when the envs alone fill the card, else on a thread-block
cluster of S CTAs that split its inverse's rows (`observe_split`).
`observe_plain` is its plain version, gp_window's plain observe
(pallas_gp_window._observe_core with pallas_gp_observe._finish), which the
tests and chip_smoke.py hold the kernel to; `observe_sliced_plain` is the
same with the 4x4 pivot matrix summed from S row slices in the cluster's
rank order, the only sum the slicing reorders across CTAs.
wind_gp.observe's CPU route is the JAX package's CPU form.

TPU kernels replaced: ble_tpu/ops/pallas_gp_observe.py:observe and
:observe_batched. Bound and design: see the note at the top of
csrc/gp_observe.cu.
"""

import ctypes

import torch

from ble_tpu_torch.env import wind_gp
from ble_tpu_torch.ops import cuda_build
from ble_tpu_torch.ops import gp_window

CAP = wind_gp.CAPACITY
# The largest cluster of the sliced observe: the portable cluster size.
MAX_SPLIT = 8
_ARGTYPES = (ctypes.c_void_p,) * 13 + (ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p)


def observe_split(n_envs: int, n_sms: int) -> int:
  """CTAs S over which each env's observe is spread, for a batch of
  `n_envs` on a card with `n_sms` SMs: 1 when the envs alone give every SM
  a CTA (the one-CTA-per-env kernel), else the least power of two that
  gives every SM a CTA, at most MAX_SPLIT. S divides CAP, and each CTA
  owns CAP / S rows of the inverse: csrc/gp_observe.cu's `split`."""
  if n_envs >= n_sms:
    return 1
  want = -(-n_sms // max(n_envs, 1))
  split = 1
  while split < min(want, MAX_SPLIT):
    split *= 2
  return split


def _state_from(loc, err, act, kinv, alpha, count) -> wind_gp.WindGPState:
  return wind_gp.WindGPState(locations=loc, errors=err, active=act > 0.5,
                             kinv=kinv, alpha=alpha, count=count)


def _observe(state: wind_gp.WindGPState, obs, n_slices: int):
  return _state_from(*gp_window.observe_one(
      obs, state.locations, state.errors, state.active.to(torch.float32),
      state.kinv, state.alpha, state.count, n_slices=n_slices))


def observe_plain(state: wind_gp.WindGPState, obs) -> wind_gp.WindGPState:
  """The plain version of the observe kernel (any device); obs (E, 8)."""
  return _observe(state, obs, 1)


def observe_sliced_plain(state: wind_gp.WindGPState, obs,
                         n_slices: int) -> wind_gp.WindGPState:
  """The plain version of the cluster kernel at cluster size `n_slices`
  (any device): `observe_plain` with U^T M summed from the partials of
  `n_slices` contiguous row slices, in slice order."""
  return _observe(state, obs, n_slices)


def launch(obs, loc, err, act, kinv, alpha, count, split=None):
  """One launch of csrc/gp_observe.cu on CUDA float32 buffers (int32
  `count`), on the current stream, each env over `split` CTAs (default
  `observe_split`'s); adds one to `launch.launches`. Returns the new (loc,
  err, act, kinv, alpha, count) buffers."""
  n = obs.shape[0]
  cuda_build.check_buffers(obs.device, (
      ('obs', obs, (n, 8), torch.float32),
      ('locations', loc, (n, CAP, 4), torch.float32),
      ('errors', err, (n, CAP, 2), torch.float32),
      ('active', act, (n, CAP), torch.float32),
      ('kinv', kinv, (n, CAP, CAP), torch.float32),
      ('alpha', alpha, (n, CAP, 2), torch.float32),
      ('count', count, (n,), torch.int32)))
  outs = [torch.empty_like(a) for a in (loc, err, act, kinv, alpha, count)]
  if split is None:
    split = observe_split(n, cuda_build.sm_count(obs.device.index or 0))
  fn = cuda_build.entry('gp_observe', 'ble_gp_observe', _ARGTYPES)
  status = fn(*(a.data_ptr() for a in (obs, loc, err, act, kinv, alpha,
                                       count, *outs)),
              n, split, torch.cuda.current_stream(obs.device).cuda_stream)
  cuda_build.check(status, 'ble_gp_observe')
  launch.launches += 1
  return outs


launch.launches = 0


def observe_kernel(state: wind_gp.WindGPState, obs) -> wind_gp.WindGPState:
  """csrc/gp_observe.cu on the CUDA tensors of `state` and `obs` (E, 8)
  (gp_window.pack_obs's rows; a 0 in column 6 makes it a no-op)."""
  f32 = lambda a: a.to(torch.float32).contiguous()
  return _state_from(*launch(
      f32(obs), f32(state.locations), f32(state.errors), f32(state.active),
      f32(state.kinv), f32(state.alpha),
      state.count.to(torch.int32).contiguous()))
