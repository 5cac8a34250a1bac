"""GP posterior at a column of pressures sharing each env's (x, y, t): the
port of ble_tpu/ops/pallas_gp.py.

`query_kernel` is wind_gp.query_column's route for CUDA tensors: one launch
of csrc/gp_query.cu for the whole batch, a grid of E x S CTAs where each
env's levels are split into S slices when E alone does not fill the card
(`level_split`). `query_plain`,
a batched transcription of pallas_gp._kernel, is its plain version, which
the tests and chip_smoke.py hold the kernel to; wind_gp.query_column's CPU
route is the JAX package's CPU form.

TPU kernel replaced: ble_tpu/ops/pallas_gp.py:query_column. Bound and
design: see the note at the top of csrc/gp_query.cu.
"""

import ctypes

import torch

from ble_tpu_torch.env import wind_gp
from ble_tpu_torch.ops import cuda_build

CAP = wind_gp.CAPACITY
_LS = wind_gp.LENGTH_SCALES
# Levels a warp of the query engine owns (csrc/gp_query_core.cuh:
# kWarpLevels): a slice holds a whole number of them.
WARP_LEVELS = 16
_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)


def slice_levels(n_levels: int, n_slices: int) -> int:
  """Levels of each CTA when one env's levels are split into `n_slices`
  slices: csrc/gp_query_core.cuh:slice_levels."""
  per = -(-n_levels // n_slices)
  return -(-per // WARP_LEVELS) * WARP_LEVELS


def level_split(n_envs: int, n_levels: int, n_sms: int) -> int:
  """Slices S of each env's levels, one CTA each, for a batch of `n_envs`
  on a card with `n_sms` SMs: 1 when the envs alone give every SM a CTA
  (more slices would read each inverse again for no gain in occupancy),
  else as many as give every SM one, at most one a warp's levels. Every
  slice of `slice_levels(n_levels, S)` levels holds at least one level."""
  if n_envs >= n_sms or n_levels <= WARP_LEVELS:
    return 1
  want = min(-(-n_sms // max(n_envs, 1)), -(-n_levels // WARP_LEVELS))
  return -(-n_levels // slice_levels(n_levels, want))


def query_plain(loc, act, alpha, kinv, q, pres):
  """The plain version of the query kernel (any device).

  Args:
    loc: (E, CAP, 4) locations; act: (E, CAP) 0/1 float32; alpha
      (E, CAP, 2); kinv (E, CAP, CAP); q (E, 4) = [x, y, t, 0]; pres (N,).

  Returns:
    (E, N, 3) = [mean_u, mean_v, deviation].
  """
  lsx, lsy, lsp, lst = _LS
  dx = (q[:, 0:1] - loc[..., 0]) / lsx
  dy = (q[:, 1:2] - loc[..., 1]) / lsy
  dt = (q[:, 2:3] - loc[..., 3]) / lst
  c = dx * dx + dy * dy + dt * dt + 1e-12  # (E, CAP)
  dp = (pres[None, :, None] - loc[:, None, :, 2]) / lsp  # (E, N, CAP)
  d = torch.sqrt(c[:, None, :] + dp * dp)
  k_star = (wind_gp.SIGMA_EXP_SQUARED * torch.exp(-d)) * act[:, None, :]
  means = k_star @ alpha  # (E, N, 2)
  v = k_star @ kinv  # (E, N, CAP)
  var = wind_gp.SIGMA_EXP_SQUARED - (k_star * v).sum(dim=-1)
  dev = torch.clamp(var / wind_gp.SIGMA_EXP_SQUARED, 0.0, 1.0)
  any_valid = (act.amax(dim=-1) > 0.0).to(torch.float32)[:, None, None]
  return torch.cat([means, dev[..., None]], dim=-1) * any_valid


def launch(loc, act, alpha, kinv, q, pres):
  """One launch of csrc/gp_query.cu on CUDA float32 buffers, on the
  current stream, with the levels split by `level_split`; adds one to
  `launch.launches`. Returns (E, N, 3)."""
  n, levels = loc.shape[0], pres.shape[0]
  cuda_build.check_buffers(loc.device, (
      ('locations', loc, (n, CAP, 4), torch.float32),
      ('active', act, (n, CAP), torch.float32),
      ('alpha', alpha, (n, CAP, 2), torch.float32),
      ('kinv', kinv, (n, CAP, CAP), torch.float32),
      ('q', q, (n, 4), torch.float32),
      ('pressures', pres, (levels,), torch.float32)))
  out = torch.empty((n, levels, 3), dtype=torch.float32, device=loc.device)
  slices = level_split(n, levels, cuda_build.sm_count(loc.device.index or 0))
  fn = cuda_build.entry('gp_query', 'ble_gp_query', _ARGTYPES)
  status = fn(*(a.data_ptr() for a in (loc, act, alpha, kinv, q, pres, out)),
              n, levels, slices,
              torch.cuda.current_stream(loc.device).cuda_stream)
  cuda_build.check(status, 'ble_gp_query')
  launch.launches += 1
  return out


launch.launches = 0


def pack(state: wind_gp.WindGPState, x_m, y_m, elapsed_s, pressures):
  """The (loc, act, alpha, kinv, q, pres) float32 arguments of `launch` and
  `query_plain` for a query at the pressures (N,) sharing each env's
  (x, y, t)."""
  f32 = lambda a: a.to(torch.float32).contiguous()
  q = torch.stack([f32(x_m), f32(y_m), f32(elapsed_s),
                   torch.zeros_like(f32(x_m))], dim=-1)
  return (f32(state.locations), f32(state.active), f32(state.alpha),
          f32(state.kinv), q, f32(pressures))


def query_kernel(state: wind_gp.WindGPState, x_m, y_m, elapsed_s,
                 pressures):
  """csrc/gp_query.cu on CUDA tensors -> (means (E, N, 2), deviations
  (E, N))."""
  out = launch(*pack(state, x_m, y_m, elapsed_s, pressures))
  return out[..., 0:2], out[..., 2]
