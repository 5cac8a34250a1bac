"""Wind-field VAE decoder: latents to divergence-free winds (the port of
ble_tpu/generative/vae.py; reference generative/vae.py:107-224).

A 3 x 1000 MLP maps 64 latents to 7 x 7 stream functions, one per
(pressure, time) slice; they are bilinearly upsampled to 23 x 23 and
differentiated (curl) into (u, v) on the 21 x 21 grid, so the winds are
incompressible. The dense layers are plain nn.Linear: the JAX package runs
them outside any Pallas kernel. Their parameters cross from the JAX
package's flax tree through bridge.decoder_params_from_flax.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ble_tpu_torch.env import wind_field

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


def init_decoder_params(generator: torch.Generator) -> dict:
  """A deterministic untrained decoder's state dict, drawn from
  `generator` on the CPU with flax's Dense initialisers: kernels
  lecun_normal (a normal of variance 1/fan_in truncated at 2 standard
  deviations), biases zero. torch cannot reproduce jax.random, so these are
  not the values of the JAX package's init_decoder_params(PRNGKey(0))."""
  params = {}
  for name, w in Decoder().state_dict().items():
    if name.endswith('bias'):
      params[name] = torch.zeros_like(w)
      continue
    fan_in = w.shape[1]
    # Inverse-CDF draws of the standard normal truncated to [-2, 2], scaled
    # so the truncated distribution has variance 1/fan_in.
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = lo + (1.0 - 2.0 * lo) * torch.rand(w.shape, generator=generator,
                                           dtype=torch.float64)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    params[name] = (x * std).to(torch.float32)
  return params


def sample_latent(generator: torch.Generator):
  """z ~ N(0, I), (64,), drawn on the CPU from `generator`."""
  return torch.randn((NUM_LATENTS,), generator=generator)


@torch.no_grad()
def sample_field(decoder: Decoder, generator: torch.Generator):
  """One decoded grid (21, 21, 10, 9, 2) from a latent drawn from
  `generator` (reference generative_wind_field.py:52-62), on the decoder's
  device."""
  device = next(decoder.parameters()).device
  return decoder(sample_latent(generator).to(device))
