"""Policy and value networks (the port of ble_tpu/agents/networks.py;
reference agents/networks.py:27-98).

Batch-first modules mapping (..., obs_dim) to per-action outputs. The dense
layers are plain nn.Linear: the JAX package computes them with flax
nn.Dense, outside any Pallas kernel. Parameters are drawn from an explicit
torch.Generator with the reference's distributions (torch cannot reproduce
jax.random, so the values are not flax's); a flax tree crosses through
bridge.quantile_params_from_flax / mlp_params_from_flax.
"""

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

NUM_ATOMS = 51
HIDDEN_UNITS = 600
NUM_LAYERS = 8


def _dense_stack(obs_dim: int, hidden_units: int, num_layers: int,
                 out_units: int) -> nn.ModuleList:
  widths = [obs_dim] + [hidden_units] * (num_layers - 1) + [out_units]
  return nn.ModuleList(
      nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))


@torch.no_grad()
def _init_uniform(layers: nn.ModuleList, limit_fn,
                  generator: torch.Generator) -> None:
  """Kernels uniform in +-limit_fn(fan_in, fan_out), biases zero (flax's
  Dense with a variance_scaling 'uniform' kernel_init)."""
  for layer in layers:
    fan_out, fan_in = layer.weight.shape
    limit = limit_fn(fan_in, fan_out)
    draw = torch.rand(layer.weight.shape, generator=generator,
                      device=generator.device)
    layer.weight.copy_((2.0 * draw - 1.0) * limit)
    layer.bias.zero_()


class MLPNetwork(nn.Module):
  """num_layers x hidden MLP -> Q-values (reference networks.py:27-60)."""

  def __init__(self, obs_dim: int, num_actions: int = 3,
               num_layers: int = NUM_LAYERS,
               hidden_units: int = HIDDEN_UNITS,
               generator: torch.Generator = None):
    super().__init__()
    self.layers = _dense_stack(obs_dim, hidden_units, num_layers, num_actions)
    if generator is not None:
      # glorot_uniform: variance_scaling(1, fan_avg, uniform).
      _init_uniform(self.layers,
                    lambda fan_in, fan_out: math.sqrt(6.0 / (fan_in + fan_out)),
                    generator)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    for layer in self.layers[:-1]:
      x = F.relu(layer(x))
    return self.layers[-1](x)


class QuantileNetwork(nn.Module):
  """MLP -> (num_actions, num_atoms) quantile logits
  (reference networks.py:63-98): 7 x (Linear + ReLU), then one Linear to
  num_actions * num_atoms."""

  def __init__(self, obs_dim: int, num_actions: int = 3,
               num_layers: int = NUM_LAYERS,
               hidden_units: int = HIDDEN_UNITS,
               num_atoms: int = NUM_ATOMS,
               generator: torch.Generator = None):
    super().__init__()
    self.num_actions = num_actions
    self.num_atoms = num_atoms
    self.layers = _dense_stack(obs_dim, hidden_units, num_layers,
                               num_actions * num_atoms)
    if generator is not None:
      # variance_scaling(1/sqrt(3), fan_in, uniform): limit sqrt(3 s / fan_in).
      _init_uniform(self.layers,
                    lambda fan_in, fan_out: math.sqrt(math.sqrt(3.0) / fan_in),
                    generator)

  def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (q_values (..., A), logits (..., A, N)); q is the mean of
    the atoms."""
    x = x.to(torch.float32)
    for layer in self.layers[:-1]:
      x = F.relu(layer(x))
    x = self.layers[-1](x)
    logits = x.reshape(x.shape[:-1] + (self.num_actions, self.num_atoms))
    return logits.mean(dim=-1), logits
