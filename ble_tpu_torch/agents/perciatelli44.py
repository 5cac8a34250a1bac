"""Perciatelli44: the frozen Nature-paper QR-DQN policy (the port of
ble_tpu/agents/perciatelli44.py; reference agents/perciatelli44.py:37-79).

The converted weights (models/convert_perciatelli44.py) drive the port's
QuantileNetwork, so inference is one batched stack of matmuls on the card
instead of a TF1 session a step. The trained blob is not in the
repository: without it, pass `params` (a QuantileNetwork state dict).
"""

from typing import Optional, Sequence

import torch

from ble_tpu_torch import resolve_device
from ble_tpu_torch.agents import base
from ble_tpu_torch.agents import qrdqn
from ble_tpu_torch.models import loader


def make_policy(network):
  """A pure `obs (..., 1099) -> greedy actions (...,) int32` function of
  the QuantileNetwork `network`."""

  @torch.no_grad()
  def policy(observation: torch.Tensor) -> torch.Tensor:
    return network(observation)[0].argmax(dim=-1).to(torch.int32)

  return policy


@base.register('perciatelli44')
class Perciatelli44(base.FunctionalAgent):
  """The greedy Perciatelli44 policy on `device` (default: cuda), from the
  blob that models/loader.py resolves or from `params`."""

  def __init__(self, num_actions: int, observation_shape: Sequence[int],
               seed: Optional[int] = None, params=None, device=None):
    if num_actions != 3:
      raise ValueError('Perciatelli44 only supports 3 actions.')
    if list(observation_shape) != [1099]:
      raise ValueError('Perciatelli44 only supports 1099 dimensional input.')
    device = resolve_device(device)
    network = (loader.load_perciatelli44(device=device) if params is None
               else qrdqn.network_from_params(params, device=device))
    policy = make_policy(network)
    super().__init__(
        num_actions, observation_shape,
        init_fn=lambda keys, device: (),
        policy_fn=lambda state, obs, draws: (state, policy(obs)),
        seed=seed, device=device)
