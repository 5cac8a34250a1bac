"""4-D gradient (simplex) noise, stateless (the port of
ble_tpu/env/simplex_noise.py; harmonic constants from the reference
simplex_wind_noise.py:50-76).

The corner gradients come from a uint32 avalanche hash of (cell, seed).
It is computed in int64 with every product reduced mod 2**32 before it
can overflow, which gives the uint32 wraparound on the CPU and on CUDA
alike.
"""

import math

import torch

from portbench.reference.sim import opensimplex4d

_F4 = (math.sqrt(5.0) - 1.0) / 4.0
_G4 = (5.0 - math.sqrt(5.0)) / 20.0

U_HARMONICS = (
    (0.1445, 702.269, 2116.987, 2587.802, 245.0),
    (0.2766, 1483.570, 752.124, 646.208, 16.39),
    (0.2627, 276.810, 147.040, 587.702, 3.836),
    (0.2137, 10214.525, 1512.216, 965.629, 41.780),
    (0.1025, 181.286, 420.942, 8500.0, 245.0),
)
V_HARMONICS = (
    (0.2716, 1974.228, 2028.814, 713.697, 26.435),
    (0.2684, 699.738, 541.845, 632.116, 9.530),
    (0.2348, 217.750, 196.522, 686.825, 3.546),
    (0.1186, 47.500, 43.048, 66.553, 8.424),
    (0.1066, 3663.291, 232.023, 7499.741, 225.0),
)

RAW_VARIANCE = 0.0884
TARGET_BLEND_VARIANCE = 1.02
NOISE_MAGNITUDE = math.sqrt(TARGET_BLEND_VARIANCE / RAW_VARIANCE)

_MASK32 = 0xFFFFFFFF


def _mul32(a, m: int):
  """(a * m) mod 2**32 for int64 tensors a in [0, 2**32) and a uint32
  constant m, without int64 overflow (16-bit halves of m)."""
  lo = a * (m & 0xFFFF)
  hi = ((a * (m >> 16)) & 0xFFFF) << 16
  return (lo + hi) & _MASK32


def hash_gradient_index(ix, iy, iz, iw, seed):
  """Stateless avalanche hash of 4 lattice coords + seed -> [0, 32)."""
  h = seed.to(torch.int64) & _MASK32
  for c, mult in ((ix, 0x9E3779B1), (iy, 0x85EBCA77), (iz, 0xC2B2AE3D),
                  (iw, 0x27D4EB2F)):
    h = h ^ _mul32(c.to(torch.int64) & _MASK32, mult)
    h = _mul32(h, 0x85EBCA77)
    h = h ^ (h >> 13)
  h = _mul32(h, 0xC2B2AE3D)
  h = h ^ (h >> 16)
  return h & 31


def simplex4d(coords, seed):
  """4-D simplex noise at (..., 4) float32 coords; `seed` int broadcast
  against coords[..., 0]. Output ~[-1, 1]."""
  s = coords.sum(dim=-1, keepdim=True) * _F4
  cell = torch.floor(coords + s)
  t = cell.sum(dim=-1, keepdim=True) * _G4
  origin = cell - t
  d0 = coords - origin

  # Rank of each coordinate of d0 among the four (3 = largest); ties go
  # by index order.
  di = d0[..., :, None]
  dj = d0[..., None, :]
  gt = (di > dj).to(torch.int64)
  ge = (di >= dj).to(torch.int64)
  upper = torch.triu(torch.ones((4, 4), dtype=torch.int64,
                                device=coords.device), diagonal=1)
  lower = torch.tril(torch.ones((4, 4), dtype=torch.int64,
                                device=coords.device), diagonal=-1)
  rank = (gt * lower + ge * upper).sum(dim=-1)

  cell_i = cell.to(torch.int64)
  total = torch.zeros(coords.shape[:-1], dtype=torch.float32,
                      device=coords.device)
  for corner in range(5):
    offs = (rank >= (4 - corner)).to(torch.int64) if corner else \
        torch.zeros_like(rank)
    d = d0 - offs.to(torch.float32) + corner * _G4
    tt = torch.clamp_min(0.6 - (d * d).sum(dim=-1), 0.0)
    ci = cell_i + offs
    gi = hash_gradient_index(ci[..., 0], ci[..., 1], ci[..., 2], ci[..., 3],
                             seed)
    # grad . d from the index bits: component `dim` of gradient gi is 0
    # when dim == gi >> 3, else the sign bit (dim adjusted past the zero
    # dim) of gi & 7.
    zero_dim = gi >> 3
    signs = gi & 7
    dot = torch.zeros_like(total)
    for dim in range(4):
      bit = torch.where(dim < zero_dim, dim, dim - 1)
      sign = 2.0 * ((signs >> bit) & 1).to(torch.float32) - 1.0
      dot = dot + torch.where(dim == zero_dim, torch.zeros_like(dot),
                              sign * d[..., dim])
    t2 = tt * tt
    total = total + (t2 * t2) * dot
  return 27.0 * total


def harmonic_noise(x_km, y_km, pressure_pa, time_hours, seeds, offsets,
                   harmonics):
  """One wind component's weighted multi-harmonic noise for a batch of
  envs (ble_tpu/env/simplex_noise.py:harmonic_noise; the variance
  calibration of the reference simplex_wind_noise.py:195-209). uv_noise
  computes both components at once.

  Args:
    x_km, y_km, pressure_pa, time_hours: (E,) query coordinates.
    seeds: (E, 5) int32 per-harmonic hash seeds.
    offsets: (E, 5, 4) float32 per-harmonic grid translations.
    harmonics: U_HARMONICS or V_HARMONICS.

  Returns:
    (E,) blended noise in m/s.
  """
  weighted = 0.0
  total_weight = 0.0
  total_weight_sq = 0.0
  for h, (weight, xs, ys, ps, ts) in enumerate(harmonics):
    coords = torch.stack([x_km / xs + offsets[:, h, 0],
                          y_km / ys + offsets[:, h, 1],
                          pressure_pa / ps + offsets[:, h, 2],
                          time_hours / ts + offsets[:, h, 3]], dim=-1)
    noise = NOISE_MAGNITUDE * simplex4d(coords, seeds[:, h])
    weighted = weighted + noise * weight
    total_weight += weight
    total_weight_sq += weight ** 2
  weighted = weighted / total_weight
  return weighted * math.sqrt(total_weight / total_weight_sq)


_UV_WEIGHTS = (tuple(h[0] for h in U_HARMONICS),
               tuple(h[0] for h in V_HARMONICS))
_UV_SPACINGS = (tuple(h[1:] for h in U_HARMONICS),
                tuple(h[1:] for h in V_HARMONICS))


def uv_noise(x_km, y_km, pressure_pa, time_hours, seeds, offsets):
  """Both wind components' blended noise for a batch of envs.

  Args:
    x_km, y_km, pressure_pa, time_hours: (E,) query coordinates.
    seeds: (E, 2, 5) int32 per (component, harmonic).
    offsets: (E, 2, 5, 4) float32 grid translations.

  Returns:
    (u_noise, v_noise), each (E,).
  """
  dev = x_km.device
  coords = torch.stack([x_km, y_km, pressure_pa, time_hours], dim=-1)
  sp = torch.tensor(_UV_SPACINGS, dtype=torch.float32, device=dev)
  p = coords[:, None, None, :] / sp + offsets  # (E, 2, 5, 4)
  noise = NOISE_MAGNITUDE * simplex4d(p, seeds)  # (E, 2, 5)
  w = torch.tensor(_UV_WEIGHTS, dtype=torch.float32, device=dev)  # (2, 5)
  total_w = w.sum(dim=1)
  total_w2 = (w * w).sum(dim=1)
  blend = (noise * w).sum(dim=-1)  # (E, 2)
  blend = blend * (torch.sqrt(total_w / total_w2) / total_w)
  return blend[:, 0], blend[:, 1]


# The reference's calibrated raw variance of true OpenSimplex noise
# (simplex_wind_noise.py:69-76), which the parity mode's noise uses.
OPENSIMPLEX_VARIANCE = 0.0569


def uv_noise_exact(x_km, y_km, pressure_pa, time_hours, perms, offsets):
  """`uv_noise` with OpenSimplex 4-D noise, the parity mode
  (ble_tpu/env/simplex_noise.py:178-223): each (component, harmonic)
  lattice is the reference's seeded permutation table instead of the
  stateless hash.

  Args:
    x_km, y_km, pressure_pa, time_hours: (E,) query coordinates.
    perms: (E, 2, 5, 256) int32 tables from opensimplex4d.perm_from_seed.
    offsets: (E, 2, 5, 4) float32 grid translations.

  Returns:
    (u_noise, v_noise), each (E,).
  """
  dev = x_km.device
  magnitude = math.sqrt(TARGET_BLEND_VARIANCE / OPENSIMPLEX_VARIANCE)
  coords = torch.stack([x_km, y_km, pressure_pa, time_hours], dim=-1)
  sp = torch.tensor(_UV_SPACINGS, dtype=torch.float32, device=dev)
  p = coords[:, None, None, :] / sp + offsets  # (E, 2, 5, 4)
  noise = magnitude * opensimplex4d.noise4d(
      perms, p[..., 0], p[..., 1], p[..., 2], p[..., 3])  # (E, 2, 5)
  w = torch.tensor(_UV_WEIGHTS, dtype=torch.float32, device=dev)
  total_w = w.sum(dim=1)
  total_w2 = (w * w).sum(dim=1)
  blend = (noise * w).sum(dim=-1)  # (E, 2)
  blend = blend * (torch.sqrt(total_w / total_w2) / total_w)
  return blend[:, 0], blend[:, 1]
