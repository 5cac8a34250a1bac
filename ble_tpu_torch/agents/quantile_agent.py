"""Registry agents for the QR-DQN and DQN policies (the port of
ble_tpu/agents/quantile_agent.py; reference agents/quantile_agent.py and
agents/dqn_agent.py).

Training happens in the batched harness (train/learner.py); these agents
act greedily, on `device` (default: cuda), from learner parameters: freshly
drawn, restored from a training run's checkpoints, or, for
`finetune_perciatelli`, the converted Perciatelli44 weights.
"""

from typing import Optional, Sequence

import torch

from ble_tpu_torch import resolve_device
from ble_tpu_torch.agents import base
from ble_tpu_torch.agents import dqn as dqn_lib
from ble_tpu_torch.agents import networks
from ble_tpu_torch.agents import qrdqn as qrdqn_lib


def _restore_params(checkpoint_dir: str):
  # The learner's online network alone, whatever replay and env sizes the
  # run trained with.
  from ble_tpu_torch.train import train_lib
  params, _ = train_lib.restore_latest_learner_params(checkpoint_dir)
  return params


class _GreedyAgent(base.FunctionalAgent):
  """Acts with `select(network, obs)` of one network, no state."""

  def __init__(self, num_actions, observation_shape, network, select, seed,
               device):
    self.network = network
    super().__init__(
        num_actions, observation_shape, init_fn=lambda keys, device: (),
        policy_fn=lambda state, obs, draws: (state, select(network, obs)),
        seed=seed, device=device)


@base.register('quantile')
class QuantileAgent(_GreedyAgent):
  """Greedy policy over the quantile network (agents/quantile_agent.py:40).
  `params` is a QuantileNetwork state dict."""

  def __init__(self, num_actions: int, observation_shape: Sequence[int],
               seed: Optional[int] = None,
               checkpoint_dir: Optional[str] = None, params=None,
               config: Optional[qrdqn_lib.QrDqnConfig] = None, device=None):
    device = resolve_device(device)
    config = config or qrdqn_lib.QrDqnConfig(num_actions=num_actions)
    if params is None and checkpoint_dir is not None:
      params = _restore_params(checkpoint_dir)
    if params is None:
      network = qrdqn_lib.init(torch.Generator().manual_seed(seed or 0),
                               config, observation_shape[0], device).network
    else:
      network = qrdqn_lib.network_from_params(params, num_actions, device)
    super().__init__(
        num_actions, observation_shape, network,
        lambda net, obs: qrdqn_lib.select_action(config, net, obs), seed,
        device)


@base.register('finetune_perciatelli')
class FinetunePerciatelliAgent(QuantileAgent):
  """QuantileAgent from the converted Perciatelli44 weights, or from a
  training run's checkpoints when `checkpoint_dir` is given."""

  def __init__(self, num_actions: int, observation_shape: Sequence[int],
               seed: Optional[int] = None,
               checkpoint_dir: Optional[str] = None, device=None):
    from ble_tpu_torch.models import loader
    params = None
    if checkpoint_dir is None:
      params = loader.load_perciatelli44(device=device).state_dict()
    super().__init__(num_actions, observation_shape, seed=seed,
                     checkpoint_dir=checkpoint_dir, params=params,
                     device=device)


@base.register('dqn')
class DQNAgent(_GreedyAgent):
  """Greedy policy over the MLP Q-network (agents/dqn_agent.py:32).
  `params` is an MLPNetwork state dict."""

  def __init__(self, num_actions: int, observation_shape: Sequence[int],
               seed: Optional[int] = None, params=None,
               config: Optional[dqn_lib.DqnConfig] = None, device=None):
    device = resolve_device(device)
    config = config or dqn_lib.DqnConfig(num_actions=num_actions)
    if params is None:
      network = dqn_lib.init(torch.Generator().manual_seed(seed or 0),
                             config, observation_shape[0], device).network
    else:
      network = networks.mlp_network_from_params(params, device)
    super().__init__(
        num_actions, observation_shape, network,
        lambda net, obs: dqn_lib.select_action(config, net, obs), seed,
        device)
