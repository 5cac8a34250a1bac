"""Wind-field VAE: latents to divergence-free winds and back (the port of
ble_tpu/generative/vae.py; reference generative/vae.py:107-224).

The decoder's 3 x 1000 MLP maps 64 latents to 7 x 7 stream functions, one
per (pressure, time) slice; they are bilinearly upsampled to 23 x 23 and
differentiated (curl) into (u, v) on the 21 x 21 grid, so the winds are
incompressible. The encoder squashes a flattened grid into [-1, 1] and maps
it through 3 x 1000 ReLU layers to the latents' mean and log-variance;
WindFieldVAE joins the two with a learned output sigma (the sigma-VAE that
generative/train_vae.py trains). The dense layers are plain nn.Linear: the
JAX package runs them outside any Pallas kernel. Parameters cross from the
JAX package's flax trees through bridge.decoder_params_from_flax and
bridge.vae_params_from_flax.
"""

import hashlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ble_tpu_torch import resolve_device
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


def _squash(x, cap: float = 50.0):
  """Saturates inputs to [-1, 1] (reference vae.py:107-113)."""
  s = torch.sign(x)
  a = torch.abs(x)
  return s * a / (cap + a)


class Encoder(nn.Module):
  """Wind grids (..., 21, 21, 10, 9, 2) -> latent (mean, logvar), each
  (..., 64). The grid is flattened in C order, as the JAX package's
  reshape does, and squashed before the first layer."""

  def __init__(self):
    super().__init__()
    widths = [math.prod(wind_field.GRID_SHAPE)] + [_HIDDEN] * (
        _NUM_HIDDEN_LAYERS)
    self.layers = nn.ModuleList(
        nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
    self.mean = nn.Linear(_HIDDEN, NUM_LATENTS)
    self.logvar = nn.Linear(_HIDDEN, NUM_LATENTS)

  def forward(self, x):
    grid = len(wind_field.GRID_SHAPE)
    x = _squash(x.reshape(x.shape[:-grid] + (-1,)))
    for layer in self.layers:
      x = F.relu(layer(x))
    return self.mean(x), self.logvar(x)


class WindFieldVAE(nn.Module):
  """The full VAE (ble_tpu/generative/vae.py:88-111): the encoder, the
  decoder and a learned scalar output sigma that starts at 1.0.

  forward(x, z_key) returns (reconstruction, (mean, logvar), sigma). With
  `reparameterize` the latent is mean + normal(z_key, logvar.shape) *
  exp(logvar / 2), the draw jax.random.normal(z_rng, logvar.shape) takes
  (utils/prng.py, on the host, moved to the model's device once); without
  it the latent is the mean and z_key is not read."""

  def __init__(self, reparameterize: bool = True):
    super().__init__()
    self.reparameterize = reparameterize
    self.encoder = Encoder()
    self.decoder = Decoder()
    self.sigma = nn.Parameter(torch.tensor(1.0))

  def forward(self, x, z_key=None):
    mean, logvar = self.encoder(x)
    if self.reparameterize:
      std = torch.exp(0.5 * logvar)
      noise = prng.normal(z_key, tuple(logvar.shape)).to(logvar.device)
      z = mean + noise * std
    else:
      z = mean
    return self.decoder(z), (mean, logvar), self.sigma

  def generate(self, z):
    return self.decoder(z)


def make_vae(state_dict: dict, device=None) -> WindFieldVAE:
  """A WindFieldVAE on `device` (default cuda) holding `state_dict`, built
  without drawing torch's own init for its 88 M parameters."""
  device = resolve_device(device)
  with torch.device('meta'):
    model = WindFieldVAE()
  model = model.to_empty(device=device)
  model.load_state_dict(state_dict)
  return model


def _flax_param_key(key, *path: str):
  """The rng flax hands the first parameter of the module at `path` (its
  names from the root down, e.g. ('encoder', 'Dense_1')) of a root scope
  initialised with `key`: the key with the first 4 bytes (big-endian) of
  the SHA-1 of the path's bytes, then the module's rng counter 1, folded
  in (flax core/scope.py:_fold_in_static and Scope.make_rng;
  flax_fix_rng_separator off, its default)."""
  data = b''.join(name.encode('utf-8') for name in path) + bytes([1])
  digest = hashlib.sha1(data).digest()
  return prng.fold_in(key, int.from_bytes(digest[:4], 'big'))


def _lecun_normal(key, fan_in: int, fan_out: int):
  """flax's lecun_normal kernel (fan_in, fan_out) transposed to nn.Linear's
  (fan_out, fan_in) weight: a normal truncated to +-2 scaled by
  sqrt(1 / fan_in) / 0.87962566103423978."""
  variance = torch.tensor(1.0 / fan_in, dtype=torch.float32)
  stddev = torch.sqrt(variance) / torch.tensor(.87962566103423978,
                                               dtype=torch.float32)
  kernel = prng.truncated_normal(key, (fan_in, fan_out)) * stddev
  return kernel.t().contiguous()


def init_decoder_params(key) -> dict:
  """The state dict of the JAX package's init_decoder_params(key)
  (ble_tpu/generative/vae.py:114-116): flax's init of Decoder, drawn on
  the CPU. Dense_i's kernel is lecun_normal, a normal truncated to +-2
  scaled by sqrt(1 / fan_in) / 0.87962566103423978, drawn over its
  (fan_in, fan_out) layout from Dense_i's rng; the biases are zeros.
  `key` is a (2,) key (utils/prng.py); the JAX fallback's is key(0)."""
  with torch.device('meta'):
    decoder = Decoder()
  return _dense_params(key, (), decoder)


def _dense_params(key, path: tuple, module: nn.Module) -> dict:
  """flax's init of `module`'s nn.Linear children (their flax names:
  layers.i is Dense_i, the others their own) under the module path
  `path`, as a state dict."""
  params = {}
  for name, layer in module.named_children():
    children = (layer.named_children() if isinstance(layer, nn.ModuleList)
                else [(None, layer)])
    for i, linear in children:
      prefix = name if i is None else f'{name}.{i}'
      flax_name = name if i is None else f'Dense_{i}'
      fan_out, fan_in = linear.weight.shape
      params[f'{prefix}.weight'] = _lecun_normal(
          _flax_param_key(key, *path, flax_name), fan_in, fan_out)
      params[f'{prefix}.bias'] = torch.zeros((fan_out,))
  return params


def init_vae_params(key) -> dict:
  """The state dict of the JAX package's WindFieldVAE().init(key, grid,
  z_rng) (ble_tpu/generative/train_vae.py:93-94): each dense layer's
  kernel drawn as init_decoder_params draws it from the rng of its path,
  encoder/Dense_i, encoder/mean, encoder/logvar and decoder/Dense_i; the
  biases zeros and sigma 1.0. Drawn on the CPU (~7 s for the 88 M
  weights; the encoder's first kernel alone is 79,380 x 1,000)."""
  with torch.device('meta'):
    model = WindFieldVAE()
  params = {}
  for name in ('encoder', 'decoder'):
    params.update({f'{name}.{k}': v for k, v in _dense_params(
        key, (name,), getattr(model, name)).items()})
  params['sigma'] = torch.tensor(1.0)
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
