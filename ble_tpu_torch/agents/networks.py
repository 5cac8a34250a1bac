"""Policy and value networks (the port of ble_tpu/agents/networks.py;
reference agents/networks.py:27-98).

Batch-first modules mapping (..., obs_dim) to per-action outputs. The dense
layers are plain nn.Linear and the LSTM is nn.LSTM: the JAX package
computes them with flax nn.Dense and OptimizedLSTMCell, outside any Pallas
kernel. Parameters are drawn from an explicit torch.Generator with the
reference's distributions, so the values are not flax's: training's draws
stay on torch.Generator (learning is held by curves, not bits; worlds and
eval policies draw from utils/prng.py). A flax tree crosses through
bridge.quantile_params_from_flax, mlp_params_from_flax and
lstm_quantile_params_from_flax.
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


class LstmQuantileNetwork(nn.Module):
  """Recurrent quantile network (ble_tpu networks.py:35-79; reference
  acme_utils.py:100-157, the R2D2 variant): torso_layers x (Linear + ReLU),
  an LSTM of lstm_units, and a duelling head, value and advantage streams
  combined per atom as q = V + A - mean_a(A).

  The carry is flax's (c, h), each (B, lstm_units); nn.LSTM takes (h, c),
  and the swap happens only in `unroll`. The LSTM's gate rows are i, f,
  g, o, as in flax's OptimizedLSTMCell. flax's cell has one bias a gate,
  on the recurrent side (bias_hh); nn.LSTM's input-side bias_ih stays zero
  and is frozen (requires_grad False), so no optimizer moves it.
  """

  def __init__(self, obs_dim: int, num_actions: int = 3,
               num_atoms: int = NUM_ATOMS, torso_layers: int = 2,
               hidden_units: int = HIDDEN_UNITS, lstm_units: int = 256,
               duelling: bool = True, generator: torch.Generator = None):
    super().__init__()
    self.num_actions = num_actions
    self.num_atoms = num_atoms
    self.lstm_units = lstm_units
    self.duelling = duelling
    widths = [obs_dim] + [hidden_units] * torso_layers
    self.torso = nn.ModuleList(
        nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
    self.lstm = nn.LSTM(widths[-1], lstm_units, batch_first=True)
    nn.init.zeros_(self.lstm.bias_ih_l0)
    self.lstm.bias_ih_l0.requires_grad_(False)
    out = num_actions * num_atoms
    self.head = nn.ModuleList(
        [nn.Linear(lstm_units, lstm_units), nn.Linear(lstm_units, num_atoms),
         nn.Linear(lstm_units, out)] if duelling else
        [nn.Linear(lstm_units, out)])
    if generator is not None:
      self._init(generator)

  @torch.no_grad()
  def _init(self, generator: torch.Generator) -> None:
    """flax's initializers, drawn from `generator`: the dense layers
    variance_scaling(1/sqrt(3), fan_in, uniform); each gate's input kernel
    lecun_normal (a normal truncated at 2 sigma, sigma rescaled as
    jax.nn.initializers does), each gate's recurrent kernel orthogonal;
    every bias zero."""
    limit = lambda fan_in, fan_out: math.sqrt(math.sqrt(3.0) / fan_in)
    _init_uniform(self.torso, limit, generator)
    _init_uniform(self.head, limit, generator)
    units = self.lstm_units
    fan_in = self.lstm.input_size
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    for gate in range(4):
      rows = slice(gate * units, (gate + 1) * units)
      nn.init.trunc_normal_(self.lstm.weight_ih_l0[rows], std=std,
                            a=-2.0 * std, b=2.0 * std, generator=generator)
      nn.init.orthogonal_(self.lstm.weight_hh_l0[rows], generator=generator)
    self.lstm.bias_ih_l0.zero_()
    self.lstm.bias_hh_l0.zero_()

  def initial_state(self, batch: int, device=None):
    """The zero carry (c, h) of `batch` envs at episode start."""
    zeros = torch.zeros((batch, self.lstm_units), device=device)
    return zeros, zeros.clone()

  def unroll(self, carry, x: torch.Tensor):
    """The network over a (B, T, obs_dim) sequence from carry (c, h):
    returns (the carry after the last step, (q (B, T, A), logits
    (B, T, A, N))). The torso and the head run once over all B x T rows;
    the LSTM is one nn.LSTM call over the sequence."""
    x = x.to(torch.float32)
    for layer in self.torso:
      x = F.relu(layer(x))
    c0, h0 = carry
    x, (h, c) = self.lstm(x, (h0[None].contiguous(), c0[None].contiguous()))
    if self.duelling:
      y = F.relu(self.head[0](x))
      value = self.head[1](y)
      adv = self.head[2](y)
      adv = adv.reshape(adv.shape[:-1] + (self.num_actions, self.num_atoms))
      logits = value[..., None, :] + adv - adv.mean(dim=-2, keepdim=True)
    else:
      x = self.head[0](x)
      logits = x.reshape(x.shape[:-1] + (self.num_actions, self.num_atoms))
    return (c[0], h[0]), (logits.mean(dim=-1), logits)

  def forward(self, carry, x: torch.Tensor):
    """One step over (B, obs_dim): (carry, (q (B, A), logits (B, A, N)))."""
    carry, (q, logits) = self.unroll(carry, x[:, None])
    return carry, (q[:, 0], logits[:, 0])


def mlp_network_from_params(params, device=None) -> MLPNetwork:
  """An MLPNetwork holding `params` (a state dict), its widths read from
  the tensors' shapes."""
  n = sum(1 for k in params if k.endswith('.weight'))
  first, last = params['layers.0.weight'], params[f'layers.{n - 1}.weight']
  network = MLPNetwork(first.shape[1], num_actions=last.shape[0],
                       num_layers=n, hidden_units=first.shape[0])
  network.load_state_dict(params)
  return network.to(device if device is not None else first.device)


def lstm_network_from_params(params, num_actions: int = 3,
                             device=None) -> LstmQuantileNetwork:
  """An LstmQuantileNetwork holding `params` (a state dict), its widths
  read from the tensors' shapes."""
  torso = sum(1 for k in params
              if k.startswith('torso.') and k.endswith('.weight'))
  head = sum(1 for k in params
             if k.startswith('head.') and k.endswith('.weight'))
  obs_dim = (params['torso.0.weight'].shape[1] if torso else
             params['lstm.weight_ih_l0'].shape[1])
  hidden = params['lstm.weight_ih_l0'].shape[1]
  units = params['lstm.weight_hh_l0'].shape[1]
  duelling = head == 3
  atoms = (params['head.1.weight'].shape[0] if duelling else
           params['head.0.weight'].shape[0] // num_actions)
  network = LstmQuantileNetwork(
      obs_dim, num_actions=num_actions, num_atoms=atoms, torso_layers=torso,
      hidden_units=hidden, lstm_units=units, duelling=duelling)
  network.load_state_dict(params)
  device = device if device is not None else params['lstm.weight_hh_l0'].device
  return network.to(device)
