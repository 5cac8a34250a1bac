"""Wind fields: per-env 4-D forecast grids + procedural noise (the port of
ble_tpu/env/wind_field.py; reference env/wind_field.py and
grid_based_wind_field.py).

Lookups gather the two grid corners of each interpolated axis instead of
contracting one-hot weight vectors. The first (x) stage multiplies the
grid's own dtype (bf16 by default) by weights cast to that dtype and
accumulates in float32, as the JAX package's contraction does.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from portbench.reference.sim import opensimplex4d
from portbench.reference.sim import simplex_noise
from portbench.reference.sim import prng

LATLNG_SLICES = 21
PRESSURE_SLICES = 10
TIME_SLICES = 9
LATLNG_DISPLACEMENT_KM = 500.0
MIN_PRESSURE_PA = 5000.0
MAX_PRESSURE_PA = 14000.0
TIME_HORIZON_HOURS = 48.0

GRID_SHAPE = (LATLNG_SLICES, LATLNG_SLICES, PRESSURE_SLICES, TIME_SLICES, 2)

# Storage dtype of the forecast grid (EnvParams.wind_field_f32 selects
# float32). bf16 halves the step's largest stream; the contraction still
# accumulates in float32.
FIELD_DTYPE = torch.bfloat16

# Slab-cache window (lat/lng cells) around the balloon; see refresh_slab.
SLAB_W = 4


@dataclasses.dataclass
class WindFieldState:
  """Per-env forecast grids and noise parameters; leaves lead with (E,)."""
  field: torch.Tensor  # (E, 21, 21, 10, 9, 2) FIELD_DTYPE, [u, v] m/s.
  noise_seeds: torch.Tensor  # (E, 2, 5) int32.
  noise_offsets: torch.Tensor  # (E, 2, 5, 4) float32 in [-1, 1].
  # Parity mode (None on the fast path): (E, 2, 5, 256) int32 OpenSimplex
  # permutation tables; when set, get_noise evaluates OpenSimplex 4-D
  # noise instead of the hash-lattice noise.
  noise_perms: Optional[torch.Tensor] = None
  # Windowed slab cache (None = read the full grid each query).
  slab: Optional[torch.Tensor] = None  # (E, SLAB_W, SLAB_W, 10, 9, 2).
  slab_x0: Optional[torch.Tensor] = None  # (E,) int32 window base corner.
  slab_y0: Optional[torch.Tensor] = None


def reset_noise(keys):
  """Noise seeds (E, 2, 5) int32 and offsets (E, 2, 5, 4) from noise keys
  (E, 2), on the CPU (ble_tpu/env/wind_field.py:83-88; reference
  simplex_wind_noise.py:98-114)."""
  ks = prng.split(keys)
  seeds = prng.randint(ks[:, 0], (2, 5), 0, 2**31 - 1)
  offsets = prng.uniform(ks[:, 1], (2, 5, 4)) * 2.0 - 1.0
  return seeds, offsets


def reset_noise_exact(keys):
  """The parity mode's noise reset from noise keys (E, 2), on the CPU
  (ble_tpu/env/wind_field.py:91-121): the reference's draws in its order
  (wind_field.py:195-207 reset_wind_noise, then per component and
  harmonic a seed `choice` and a grid translation `uniform` from the SAME
  harmonic key, simplex_wind_noise.py:98-114), and the OpenSimplex
  permutation table of each seed, built on the host.

  Returns:
    (seeds (E, 2, 5) int32, offsets (E, 2, 5, 4) float32,
     perms (E, 2, 5, 256) int32).
  """
  harmonic = prng.split(prng.split(keys, 2), 5)  # (E, 2, 5, 2)
  seeds = prng.choice(harmonic, 1634753849)
  offsets = prng.uniform(harmonic, (4,)) * 2.0 - 1.0
  perms = torch.from_numpy(np.stack([
      opensimplex4d.cached_perm(s) for s in seeds.flatten().tolist()
  ]).reshape(seeds.shape + (256,)))
  return seeds, offsets, perms


def make_state(field, keys, exact_noise: bool = False,
               field_dtype=None) -> WindFieldState:
  """The WindFieldState of noise keys (E, 2) (ble_tpu/env/wind_field.py:
  make_state over a leading key axis): the noise drawn on the host by
  reset_noise, or by reset_noise_exact with `exact_noise` (the parity
  mode's OpenSimplex tables), then moved to the grid's device; the grid in
  `field_dtype` (default FIELD_DTYPE), one per env, a shared
  (21, 21, 10, 9, 2) grid copied to each. No slab: the caller centres it
  (refresh_slab)."""
  dtype = FIELD_DTYPE if field_dtype is None else field_dtype
  perms = None
  if exact_noise:
    seeds, offsets, perms = reset_noise_exact(keys)
  else:
    seeds, offsets = reset_noise(keys)
  field = field.to(dtype)
  if field.ndim == len(GRID_SHAPE):
    field = field.expand((keys.shape[0],) + field.shape).contiguous()
  to = lambda x: None if x is None else x.to(field.device)
  return WindFieldState(field=field, noise_seeds=to(seeds),
                        noise_offsets=to(offsets), noise_perms=to(perms))


def _boomerang_hours(elapsed_s):
  """Reflects time past the 48-h horizon (grid_based_wind_field.py:134-143)."""
  hours = elapsed_s.to(torch.float32) / 3600.0
  cycle = torch.floor(hours / TIME_HORIZON_HOURS).to(torch.int32)
  remainder = torch.fmod(hours, TIME_HORIZON_HOURS)
  remainder = torch.where(remainder < 0, remainder + TIME_HORIZON_HOURS,
                          remainder)
  backward = (cycle % 2) == 1
  return torch.where(backward, TIME_HORIZON_HOURS - remainder, remainder)


def _axis_corners(coord, n: int, lo: float, hi: float):
  """(i0, w0, w1): lower corner index and the two linear-interpolation
  weights along one grid axis, with the query clamped to the grid."""
  t = (coord - lo) / (hi - lo) * (n - 1)
  t = torch.clamp(t, 0.0, n - 1)
  i0 = torch.clamp(torch.floor(t), 0, n - 2)
  frac = t - i0
  return i0.to(torch.int64), 1.0 - frac, frac


def _grid_coord(v_km):
  """Continuous (clamped) lat/lng grid coordinate in [0, n-1]."""
  n = LATLNG_SLICES
  t = ((v_km + LATLNG_DISPLACEMENT_KM) / (2.0 * LATLNG_DISPLACEMENT_KM)
       * (n - 1))
  return torch.clamp(t, 0.0, n - 1)


def _slab_base(v_m):
  return torch.clamp(torch.floor(_grid_coord(v_m / 1000.0)) - 1, 0,
                     LATLNG_SLICES - SLAB_W).to(torch.int32)


def refresh_slab(state: WindFieldState, x_m, y_m) -> WindFieldState:
  """Re-centers every env's slab cache on its balloon: a gather of the
  (SLAB_W, SLAB_W) lat/lng window, bit-identical to the grid's entries."""
  x0 = _slab_base(x_m)
  y0 = _slab_base(y_m)
  offs = torch.arange(SLAB_W, device=x_m.device)
  e = torch.arange(x_m.shape[0], device=x_m.device)
  ix = x0.to(torch.int64)[:, None] + offs  # (E, SLAB_W)
  iy = y0.to(torch.int64)[:, None] + offs
  slab = state.field[e[:, None, None], ix[:, :, None], iy[:, None, :]]
  return dataclasses.replace(state, slab=slab, slab_x0=x0, slab_y0=y0)


def slab_oob(state: WindFieldState, x_m, y_m):
  """True where (x, y) falls outside the cached window before the clamp,
  i.e. the documented ~34.7 m/s speed bound was violated."""
  if state.slab is None:
    return torch.zeros(x_m.shape, dtype=torch.bool, device=x_m.device)

  def axis_oob(coord, base):
    local = coord - base.to(torch.float32)
    lo_cl = base == 0
    hi_cl = base == LATLNG_SLICES - SLAB_W
    return ((local < 0.0) & ~lo_cl) | ((local > SLAB_W - 1.0) & ~hi_cl)

  return (axis_oob(_grid_coord(x_m / 1000.0), state.slab_x0) |
          axis_oob(_grid_coord(y_m / 1000.0), state.slab_y0))


def _window_corners(coord, base):
  local = torch.clamp(coord - base.to(torch.float32), 0.0, SLAB_W - 1)
  i0 = torch.clamp(torch.floor(local), 0, SLAB_W - 2)
  frac = local - i0
  return i0.to(torch.int64), 1.0 - frac, frac


def _lerp_axis1(grid, i0, w0, w1):
  """w0 * grid[e, i0] + w1 * grid[e, i0 + 1] along axis 1 of (E, n, ...)."""
  e = torch.arange(grid.shape[0], device=grid.device)
  shape = (-1,) + (1,) * (grid.ndim - 2)
  return (w0.reshape(shape) * grid[e, i0] +
          w1.reshape(shape) * grid[e, i0 + 1])


def effective_column(state: WindFieldState, x_m, y_m, elapsed_s):
  """(E, 10, 2) wind column at each balloon's (x, y, t): the grid
  interpolated over lat/lng/time. Reads only the slab when it is set."""
  x_km = x_m / 1000.0
  y_km = y_m / 1000.0
  t_hours = _boomerang_hours(elapsed_s)
  if state.slab is not None:
    grid = state.slab
    ix, wx0, wx1 = _window_corners(_grid_coord(x_km), state.slab_x0)
    iy, wy0, wy1 = _window_corners(_grid_coord(y_km), state.slab_y0)
  else:
    grid = state.field
    span = (-LATLNG_DISPLACEMENT_KM, LATLNG_DISPLACEMENT_KM)
    ix, wx0, wx1 = _axis_corners(x_km, LATLNG_SLICES, *span)
    iy, wy0, wy1 = _axis_corners(y_km, LATLNG_SLICES, *span)
  # First stage in the grid's dtype with float32 accumulation: the bf16
  # weight * bf16 value products are exact in float32.
  to_grid = lambda w: w.to(grid.dtype).to(torch.float32)
  e = torch.arange(grid.shape[0], device=grid.device)
  col = (to_grid(wx0)[:, None, None, None, None] * grid[e, ix].float() +
         to_grid(wx1)[:, None, None, None, None] * grid[e, ix + 1].float())
  col = _lerp_axis1(col, iy, wy0, wy1)  # (E, 10, 9, 2)
  it, wt0, wt1 = _axis_corners(t_hours, TIME_SLICES, 0.0, TIME_HORIZON_HOURS)
  col = col.transpose(1, 2)  # (E, 9, 10, 2)
  return _lerp_axis1(col, it, wt0, wt1)


def column_at_pressure(column, pressure_pa):
  """Interpolates (E, 10, 2) columns at per-env pressures -> (E, 2)."""
  ip, w0, w1 = _axis_corners(pressure_pa, PRESSURE_SLICES, MIN_PRESSURE_PA,
                             MAX_PRESSURE_PA)
  return _lerp_axis1(column, ip, w0, w1)


def column_at_levels(column, levels):
  """Interpolates (E, 10, 2) columns at pressure levels (L,) shared by
  every env -> (E, L, 2)."""
  ip, w0, w1 = _axis_corners(levels, PRESSURE_SLICES, MIN_PRESSURE_PA,
                             MAX_PRESSURE_PA)
  return w0[:, None] * column[:, ip] + w1[:, None] * column[:, ip + 1]


def get_forecast(state: WindFieldState, x_m, y_m, pressure_pa, elapsed_s):
  """Forecast (u, v) [m/s] at each env's balloon point, (E,) each."""
  uv = column_at_pressure(effective_column(state, x_m, y_m, elapsed_s),
                          pressure_pa)
  return uv[:, 0], uv[:, 1]


def get_noise(state: WindFieldState, x_m, y_m, pressure_pa, elapsed_s):
  """Simplex wind noise (u, v) [m/s] (reference wind_field.py:188-219):
  OpenSimplex noise in parity mode (noise_perms set), else the hash
  noise. Every step route looks the noise up here."""
  coords = (x_m / 1000.0, y_m / 1000.0, pressure_pa,
            elapsed_s.to(torch.float32) / 3600.0)
  if state.noise_perms is not None:
    return simplex_noise.uv_noise_exact(*coords, state.noise_perms,
                                        state.noise_offsets)
  return simplex_noise.uv_noise(*coords, state.noise_seeds,
                                state.noise_offsets)


def get_ground_truth(state: WindFieldState, x_m, y_m, pressure_pa, elapsed_s):
  """Forecast + noise (reference wind_field.py:125-145)."""
  fu, fv = get_forecast(state, x_m, y_m, pressure_pa, elapsed_s)
  nu, nv = get_noise(state, x_m, y_m, pressure_pa, elapsed_s)
  return fu + nu, fv + nv


def simple_static_field(device=None) -> torch.Tensor:
  """The 4-direction test field (reference wind_field.py:149-184) as one
  (21, 21, 10, 9, 2) float32 grid."""
  pressures = torch.linspace(MIN_PRESSURE_PA, MAX_PRESSURE_PA,
                             PRESSURE_SLICES, device=device)
  ten = torch.full_like(pressures, 10.0)
  zero = torch.zeros_like(pressures)
  u = torch.where(pressures < 8000.0, ten,
                  torch.where(pressures < 10000.0, zero,
                              torch.where(pressures < 12000.0, -ten, zero)))
  v = torch.where(pressures < 8000.0, zero,
                  torch.where(pressures < 10000.0, ten,
                              torch.where(pressures < 12000.0, zero, -ten)))
  uv = torch.stack([u, v], dim=-1)  # (10, 2)
  return uv[None, None, :, None, :].expand(GRID_SHAPE).contiguous()
