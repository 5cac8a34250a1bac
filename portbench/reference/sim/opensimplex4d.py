"""OpenSimplex 4-D noise (Spencer 2014) in torch, the parity mode's noise
(the port of ble_tpu/env/opensimplex4d.py; reference
env/simplex_wind_noise.py:102-146, which calls the `opensimplex`
package's OpenSimplex(seed).noise4d).

The original walks an A4* lattice with data-dependent branches. As in the
JAX package, the value is summed instead over the fixed superset of
lattice offsets {-1, 0, 1, 2}^4 around the containing stretched hypercube
(256 candidates): a point outside the original's candidate lists has
attn = 2 - d.d <= 0 and adds exactly 0, so the sum is the same.
Everything seed-dependent is the original's: the 64-entry gradient table,
the 256-entry permutation from a 64-bit LCG Fisher-Yates shuffle of the
integer seed (built on the host), the perm-chain gradient index, the
stretch/squish constants, the attn^4 falloff and the /30 normalization.
"""

import functools

import numpy as np
import torch

STRETCH_4D = (1.0 / np.sqrt(5.0) - 1.0) / 4.0  # -0.138196601125011
SQUISH_4D = (np.sqrt(5.0) - 1.0) / 4.0  # 0.309016994374947
NORM_4D = 30.0

# 64 gradients x 4 components: for sign combo c in [0, 16) (bit i = axis i
# sign) and long axis p in [0, 4), component i is 3 if i == p else 1, with
# sign bit i of c: the original's gradients4D table.
_GRADS = np.zeros((64, 4), np.float64)
for _c in range(16):
  for _p in range(4):
    for _i in range(4):
      _mag = 3.0 if _i == _p else 1.0
      _GRADS[_c * 4 + _p, _i] = -_mag if (_c >> _i) & 1 else _mag

# Candidate lattice offsets around the containing stretched hypercube.
_OFFSETS = np.stack(np.meshgrid(*([np.arange(-1, 3)] * 4), indexing='ij'),
                    axis=-1).reshape(-1, 4)
_OFFSETS_SUM = _OFFSETS.sum(axis=-1)

_LCG_MUL = 6364136223846793005
_LCG_ADD = 1442695040888963407
_MASK64 = (1 << 64) - 1


def perm_from_seed(seed: int) -> np.ndarray:
  """The (256,) int32 permutation the original builds from an integer
  seed: Java-semantics 64-bit LCG and Fisher-Yates (the OpenSimplexNoise(long
  seed) constructor; ble_tpu/env/opensimplex4d.py:52-74). Sequential host
  work."""
  s = int(seed) & _MASK64
  for _ in range(3):
    s = (s * _LCG_MUL + _LCG_ADD) & _MASK64
  source = list(range(256))
  perm = np.zeros(256, np.int32)
  for i in range(255, -1, -1):
    s = (s * _LCG_MUL + _LCG_ADD) & _MASK64
    signed = s - (1 << 64) if s >= (1 << 63) else s
    # Java's ((seed + 31) % (i + 1)) + (r < 0 ? i + 1 : 0) equals Python's
    # floored modulo for a positive divisor.
    r = (signed + 31) % (i + 1)
    perm[i] = source[r]
    source[r] = source[i]
  return perm


@functools.lru_cache(maxsize=64)
def cached_perm(seed: int) -> np.ndarray:
  """perm_from_seed, memoized (resets reuse seeds)."""
  return perm_from_seed(int(seed))


def noise4d(perm, x, y, z, w):
  """OpenSimplex 4-D noise at float32 points.

  Args:
    perm: (..., 256) integer permutation tables from `perm_from_seed`,
      broadcasting against the points' shape.
    x, y, z, w: float32 coordinates of one shape.

  Returns:
    Noise in [-1, 1] of the points' shape.
  """
  dtype = x.dtype
  dev = x.device
  coords = torch.stack(torch.broadcast_tensors(x, y, z, w), dim=-1)
  stretched = coords + coords.sum(dim=-1, keepdim=True) * STRETCH_4D
  base = torch.floor(stretched)
  d0 = coords - (base + base.sum(dim=-1, keepdim=True) * SQUISH_4D)
  offs = torch.as_tensor(_OFFSETS, dtype=torch.int64, device=dev)
  lat = base.to(torch.int64)[..., None, :] + offs  # (..., 256, 4)
  # Original: perm[(perm[(perm[(perm[x&0xFF]+y)&0xFF]+z)&0xFF]+w)&0xFF]
  table = perm.to(torch.int64).expand(lat.shape[:-2] + (256,))
  i = torch.gather(table, -1, lat[..., 0] & 0xFF)
  for axis in (1, 2, 3):
    i = torch.gather(table, -1, (i + lat[..., axis]) & 0xFF)
  grads = torch.as_tensor(_GRADS, dtype=dtype, device=dev)
  g = grads[(i & 0xFC) >> 2]  # (..., 256, 4)
  offs_sum = torch.as_tensor(_OFFSETS_SUM, dtype=dtype, device=dev)
  d = d0[..., None, :] - offs.to(dtype) - SQUISH_4D * offs_sum[:, None]
  attn = 2.0 - (d * d).sum(dim=-1)
  attn = torch.where(attn > 0.0, attn, torch.zeros_like(attn))
  attn2 = attn * attn
  value = (attn2 * attn2 * (g * d).sum(dim=-1)).sum(dim=-1)
  return value / NORM_4D


def noise4d_np(perm, x, y, z, w) -> np.ndarray:
  """OpenSimplex 4-D noise in float64 numpy, the reference the torch
  version is held to (ble_tpu/env/opensimplex4d.py:noise4d_np, the JAX
  package's compat shim's evaluation).

  Args:
    perm: (..., 256) integer permutation tables from `perm_from_seed`,
      broadcasting against the points' shape.
    x, y, z, w: coordinates, broadcast against each other.

  Returns:
    Noise in [-1, 1] of the points' broadcast shape, float64.
  """
  coords = np.stack(np.broadcast_arrays(
      *(np.asarray(c, np.float64) for c in (x, y, z, w))), axis=-1)
  stretched = coords + coords.sum(axis=-1, keepdims=True) * STRETCH_4D
  base = np.floor(stretched)
  d0 = coords - (base + base.sum(axis=-1, keepdims=True) * SQUISH_4D)
  lat = base.astype(np.int64)[..., None, :] + _OFFSETS  # (..., 256, 4)
  # Original: perm[(perm[(perm[(perm[x&0xFF]+y)&0xFF]+z)&0xFF]+w)&0xFF]
  table = np.broadcast_to(np.asarray(perm, np.int64),
                          lat.shape[:-2] + (256,))
  i = np.take_along_axis(table, lat[..., 0] & 0xFF, axis=-1)
  for axis in (1, 2, 3):
    i = np.take_along_axis(table, (i + lat[..., axis]) & 0xFF, axis=-1)
  g = _GRADS[(i & 0xFC) >> 2]  # (..., 256, 4)
  d = d0[..., None, :] - _OFFSETS - SQUISH_4D * _OFFSETS_SUM[:, None]
  attn = 2.0 - (d * d).sum(axis=-1)
  attn = np.where(attn > 0.0, attn, 0.0)
  return (attn ** 4 * (g * d).sum(axis=-1)).sum(axis=-1) / NORM_4D
