"""DQN learner: n-step MSE TD loss on the MLP Q-network (the port of
ble_tpu/agents/dqn.py).

Counterpart of the reference's Dopamine `JaxDQNAgent` wrapper
(agents/dqn_agent.py:32-142; configs/dqn.gin: 8x600 MLP, gamma=0.993,
n-step 5, Adam lr 2e-6 eps 2e-5, loss mse, epsilon_train 0.01). It keeps
QR-DQN's learner state (qrdqn.LearnerState), replay and actor machinery;
the rate is constant.

One departure from the JAX package, on purpose: ble_tpu's mse_loss sums
per_sample * w, so a quarantined sample (weight 0 and a non-finite value,
replay's quarantine) makes the loss itself NaN (NaN x 0), and the gradient
with it. Here the quarantined samples' inputs are zeroed before the
networks see them (qrdqn.quarantine), so the loss and the gradient stay
finite and equal ble_tpu's on the batch without those samples' values.
Their `per_sample_loss` still reads NaN, as in ble_tpu, so prioritized
replay gives them priority 1.0; `mean_q` then averages their zeroed
values where ble_tpu reads NaN.
"""

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from ble_tpu_torch.agents import networks
from ble_tpu_torch.agents import qrdqn
from ble_tpu_torch.utils import profiling

LearnerState = qrdqn.LearnerState


@dataclasses.dataclass(frozen=True)
class DqnConfig:
  num_actions: int = 3
  num_layers: int = networks.NUM_LAYERS
  hidden_units: int = networks.HIDDEN_UNITS
  gamma: float = 0.993
  learning_rate: float = 2e-6
  adam_eps: float = 2e-5
  target_update_period: int = 100
  update_period: int = 4
  min_replay_history: int = 500
  epsilon_train: float = 0.01


def make_network(config: DqnConfig, obs_dim: int,
                 generator: Optional[torch.Generator] = None
                 ) -> networks.MLPNetwork:
  return networks.MLPNetwork(obs_dim, num_actions=config.num_actions,
                             num_layers=config.num_layers,
                             hidden_units=config.hidden_units,
                             generator=generator)


def init(generator: torch.Generator, config: DqnConfig, obs_dim: int,
         device=None) -> LearnerState:
  """Fresh networks drawn from `generator` (target = online) and Adam at
  the constant rate (optax.adam(lr, eps))."""
  network = make_network(config, obs_dim, generator).to(device)
  target = make_network(config, obs_dim).to(device)
  target.load_state_dict(network.state_dict())
  target.requires_grad_(False)
  return LearnerState(
      network=network, target_network=target,
      optimizer=torch.optim.Adam(network.parameters(),
                                 lr=config.learning_rate,
                                 eps=config.adam_eps))


@torch.no_grad()
def select_action(config: DqnConfig, network: networks.MLPNetwork, obs,
                  generator: Optional[torch.Generator] = None,
                  epsilon: float = 0.0) -> torch.Tensor:
  """Epsilon-greedy argmax of the Q-values (batched): (B,) int32."""
  return qrdqn.epsilon_greedy(network(obs), config.num_actions, generator,
                              epsilon)


def mse_loss(config: DqnConfig, network, target_network,
             batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
  """The n-step TD loss (ble_tpu dqn.py:70-84): (Q(s, a) - (r^n + gamma^n
  max_a' Q_target(s', a')))^2, weighted by `weight`. Quarantined samples
  enter the networks with zero inputs (module docstring)."""
  del config
  obs, next_obs, reward, discount, w, quarantined = qrdqn.quarantine(batch)
  with torch.no_grad():
    target = reward + discount * target_network(next_obs).max(dim=-1).values
  q = network(obs)
  action = batch['action'].to(torch.int64)
  chosen = torch.take_along_dim(q, action[:, None], dim=-1)[:, 0]
  per_sample = (chosen - target) ** 2
  per_sample_loss = per_sample.detach()
  if quarantined is not None:
    per_sample_loss = torch.where(quarantined, math.nan, per_sample_loss)
  loss = (per_sample * w).sum() / torch.clamp_min(w.sum(), 1.0)
  return loss, {'loss': loss, 'mean_q': chosen.mean().detach(),
                'per_sample_loss': per_sample_loss}


def train_step(config: DqnConfig, state: LearnerState,
               batch: Dict[str, torch.Tensor],
               grad_transform: Optional[Callable] = None
               ) -> Tuple[LearnerState, Dict[str, torch.Tensor]]:
  """One Adam step and the periodic target sync (ble_tpu dqn.py:87-104),
  in place; returns (state, metrics) with `loss` detached."""
  with profiling.span('dqn.loss'):
    loss, metrics = mse_loss(config, state.network, state.target_network,
                             batch)
  qrdqn.optimizer_step(state, loss, config.learning_rate,
                       config.target_update_period, grad_transform)
  metrics['loss'] = loss.detach()
  return state, metrics
