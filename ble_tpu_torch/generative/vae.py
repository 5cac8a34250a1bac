"""Wind-field VAE decoder: latents to divergence-free winds (the port of
ble_tpu/generative/vae.py; reference generative/vae.py:107-224).

A 3 x 1000 MLP maps 64 latents to 7 x 7 stream functions, one per
(pressure, time) slice; they are bilinearly upsampled to 23 x 23 and
differentiated (curl) into (u, v) on the 21 x 21 grid, so the winds are
incompressible. The dense layers are plain nn.Linear: the JAX package runs
them outside any Pallas kernel. Their parameters cross from the JAX
package's flax tree through bridge.decoder_params_from_flax.
"""

import hashlib

import torch
import torch.nn.functional as F
from torch import nn

from ble_tpu_torch.env import wind_field
from ble_tpu_torch.utils import prng

NUM_LATENTS = 64
_HIDDEN = 1000
_NUM_HIDDEN_LAYERS = 3
_FLOW_WIDTH = 7
_NUM_FLOW_FIELDS = wind_field.PRESSURE_SLICES * wind_field.TIME_SLICES


class Decoder(nn.Module):
  """Latents (..., 64) -> wind grids (..., 21, 21, 10, 9, 2)."""

  def __init__(self):
    super().__init__()
    widths = [NUM_LATENTS] + [_HIDDEN] * _NUM_HIDDEN_LAYERS + [
        _FLOW_WIDTH * _FLOW_WIDTH * _NUM_FLOW_FIELDS]
    self.layers = nn.ModuleList(
        nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))

  def forward(self, z):
    lead = z.shape[:-1]
    z = z.reshape(-1, NUM_LATENTS)
    for layer in self.layers[:-1]:
      z = F.relu(layer(z))
    z = self.layers[-1](z)
    psi = z.reshape(-1, _FLOW_WIDTH, _FLOW_WIDTH, _NUM_FLOW_FIELDS)
    # Upsample with a one-pixel halo so the finite differences below never
    # touch the boundary (jax.image.resize 'linear' is half-pixel bilinear).
    n = wind_field.LATLNG_SLICES + 2
    psi = F.interpolate(psi.permute(0, 3, 1, 2), size=(n, n),
                        mode='bilinear', align_corners=False)
    psi = psi.permute(0, 2, 3, 1)  # (B, 23, 23, 90)
    # (u, v) = curl(psi): u = d psi / dy (first grid axis), v = -d psi / dx.
    dpsi_dy = (torch.roll(psi, -1, 1) - torch.roll(psi, 1, 1)) / 2.0
    dpsi_dx = (torch.roll(psi, -1, 2) - torch.roll(psi, 1, 2)) / 2.0
    inner = (slice(None), slice(1, -1), slice(1, -1))
    grid = lead + wind_field.GRID_SHAPE[:-1]
    u = dpsi_dy[inner].reshape(grid)
    v = -dpsi_dx[inner].reshape(grid)
    return torch.stack([u, v], dim=-1)


def _flax_param_key(key, module_name: str):
  """The rng flax hands the first parameter of child module `module_name`
  of a root scope initialised with `key`: the key with the first 4 bytes
  (big-endian) of the SHA-1 of the path (module name, then the module's
  rng counter 1) folded in (flax core/scope.py:_fold_in_static and
  Scope.make_rng; flax_fix_rng_separator off, its default)."""
  digest = hashlib.sha1(module_name.encode('utf-8') + bytes([1])).digest()
  return prng.fold_in(key, int.from_bytes(digest[:4], 'big'))


def init_decoder_params(key) -> dict:
  """The state dict of the JAX package's init_decoder_params(key)
  (ble_tpu/generative/vae.py:114-116): flax's init of Decoder, drawn on
  the CPU. Dense_i's kernel is lecun_normal, a normal truncated to +-2
  scaled by sqrt(1 / fan_in) / 0.87962566103423978, drawn over its
  (fan_in, fan_out) layout from Dense_i's rng; the biases are zeros.
  `key` is a (2,) key (utils/prng.py); the JAX fallback's is key(0)."""
  params = {}
  for i, layer in enumerate(Decoder().layers):
    fan_out, fan_in = layer.weight.shape
    variance = torch.tensor(1.0 / fan_in, dtype=torch.float32)
    stddev = torch.sqrt(variance) / torch.tensor(.87962566103423978,
                                                 dtype=torch.float32)
    kernel = prng.truncated_normal(_flax_param_key(key, f'Dense_{i}'),
                                   (fan_in, fan_out)) * stddev
    params[f'layers.{i}.weight'] = kernel.t().contiguous()
    params[f'layers.{i}.bias'] = torch.zeros((fan_out,))
  return params


def sample_latent(keys):
  """z ~ N(0, I), (E, 64): normal(key, (64,)) of each key (E, 2), drawn on
  the CPU (ble_tpu/generative/vae.py:119-122)."""
  return prng.normal(keys, (NUM_LATENTS,))


@torch.no_grad()
def sample_field(decoder: Decoder, keys):
  """Decoded grids (E, 21, 21, 10, 9, 2) from the latents of keys (E, 2)
  (reference generative_wind_field.py:52-62), on the decoder's device."""
  device = next(decoder.parameters()).device
  return decoder(sample_latent(keys).to(device))
