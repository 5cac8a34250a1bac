"""The VAE wind decoder, plain: 64 latents through a 3 x 1000 ReLU MLP to
7 x 7 stream functions per (pressure, time) slice, bilinearly upsampled
to 23 x 23 with half-pixel centres and differentiated (curl) into (u, v)
on the 21 x 21 grid (upstream generative/vae.py)."""

import torch
import torch.nn.functional as F

from portbench.reference.sim import prng

NUM_LATENTS = 64
GRID = (21, 21, 10, 9)
FLOW = 7


def sample_latent(keys):
  """z ~ N(0, I), (E, 64): normal(key, (64,)) of each forecast key."""
  return prng.normal(keys, (NUM_LATENTS,))


def decode(weights, z):
  """Wind grids (E, 21, 21, 10, 9, 2) of latents z (E, 64); `weights` is
  the list of (weight (out, in), bias (out,)) of the four dense layers."""
  x = z
  for i, (w, b) in enumerate(weights):
    x = x @ w.T + b
    if i < len(weights) - 1:
      x = torch.relu(x)
  slices = GRID[2] * GRID[3]
  psi = x.reshape(-1, FLOW, FLOW, slices).permute(0, 3, 1, 2)
  n = GRID[0] + 2
  psi = F.interpolate(psi, size=(n, n), mode='bilinear',
                      align_corners=False).permute(0, 2, 3, 1)
  u = (psi[:, 2:, 1:-1] - psi[:, :-2, 1:-1]) / 2.0
  v = -(psi[:, 1:-1, 2:] - psi[:, 1:-1, :-2]) / 2.0
  shape = (-1,) + GRID
  return torch.stack([u.reshape(shape), v.reshape(shape)], dim=-1)


# Latents a decoder product. On the card a matrix product's bits depend on
# its row count; the port decodes every seed in a product of this many
# rows, so that a seed's field does not depend on the seeds beside it.
BLOCK = 16


def decode_in_blocks(weights, z):
  """`decode` of z (E, 64) in products of BLOCK rows, the last padded
  with zeros."""
  n = z.shape[0]
  z = torch.cat([z, z.new_zeros(((-n) % BLOCK, z.shape[1]))])
  return torch.cat([decode(weights, b) for b in z.split(BLOCK)])[:n]
