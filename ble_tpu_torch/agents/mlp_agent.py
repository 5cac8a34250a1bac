"""Online SARSA-style MLP agent (the port of ble_tpu/agents/mlp_agent.py;
reference agents/mlp_agent.py:61-147).

A small on-policy baseline: one-step TD targets from consecutive
transitions and an SGD step after every env step, no replay and no target
network. The network is the JAX package's MLPNetwork(num_layers=1,
hidden_units=256), a single linear layer obs_dim -> 3, with SGD at 3e-4
and gamma 0.9.
"""

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ble_tpu_torch import resolve_device
from ble_tpu_torch.agents import base
from ble_tpu_torch.agents import networks
from ble_tpu_torch.agents import qrdqn

NUM_ACTIONS = 3
NUM_LAYERS = 1
HIDDEN_UNITS = 256
LEARNING_RATE = 3e-4
GAMMA = 0.9


def make_network(obs_dim: int, generator: Optional[torch.Generator] = None
                 ) -> networks.MLPNetwork:
  return networks.MLPNetwork(obs_dim, num_actions=NUM_ACTIONS,
                             num_layers=NUM_LAYERS,
                             hidden_units=HIDDEN_UNITS, generator=generator)


def make_optimizer(network: torch.nn.Module) -> torch.optim.SGD:
  """optax.sgd(3e-4): params - lr * grad."""
  return torch.optim.SGD(network.parameters(), lr=LEARNING_RATE)


def _q_of(network, obs, action) -> torch.Tensor:
  return torch.take_along_dim(network(obs), action.to(torch.int64)[:, None],
                              dim=-1)[:, 0]


def _sgd_step(network, optimizer, loss, grad_transform=None) -> None:
  params = list(network.parameters())
  for p in params:
    p.grad = None
  loss.backward()
  if grad_transform is not None:
    grad_transform([p.grad for p in params])
  optimizer.step()


# --- The stateful agent of one env (ble_tpu mlp_agent.py:18-73) ----------


@dataclasses.dataclass
class MLPAgentState:
  network: networks.MLPNetwork
  optimizer: torch.optim.SGD
  last_obs: torch.Tensor  # (1, D)
  last_action: torch.Tensor  # (1,) int32
  has_last: bool = False


def init(generator: torch.Generator, obs_dim: int = 1099,
         device=None) -> MLPAgentState:
  network = make_network(obs_dim, generator).to(device)
  return MLPAgentState(
      network=network, optimizer=make_optimizer(network),
      last_obs=torch.zeros((1, obs_dim), device=device),
      last_action=torch.zeros((1,), dtype=torch.int32, device=device))


def step(state: MLPAgentState, reward: float, obs: torch.Tensor):
  """Acts greedily at `obs` (1, D), then takes the SARSA TD(0) step on the
  previous transition, r + gamma Q(s, a) against Q(s_prev, a_prev), when
  there is one (ble_tpu's zeroed gradient with has_last False leaves the
  parameters as they are). Returns (state, (1,) int32 action)."""
  with torch.no_grad():
    action = state.network(obs).argmax(dim=-1).to(torch.int32)
  if state.has_last:
    with torch.no_grad():
      target = reward + GAMMA * _q_of(state.network, obs, action)
    loss = ((_q_of(state.network, state.last_obs, state.last_action) -
             target) ** 2).sum()
    _sgd_step(state.network, state.optimizer, loss)
  return dataclasses.replace(state, last_obs=obs, last_action=action,
                             has_last=True), action


# --- The batched online learner of the training harness ------------------
#
# The reference trains the MLP agent through the generic train.py loop:
# agent.step(reward, obs) selects a_t and TD-updates on the previous
# transition (mlp_agent.py:61-90). The batched equivalent keeps one shared
# network and per-env "pending transition" lanes (s_{t-1}, a_{t-1},
# r_{t-1}); when a_t is chosen at s_t the SARSA target r + gamma Q(s_t,
# a_t) becomes computable and one batched SGD step runs over the valid
# lanes.


@dataclasses.dataclass
class OnlineState:
  """ble_tpu's MlpOnlineState, and train_steps, the SGD steps taken."""
  network: networks.MLPNetwork
  optimizer: torch.optim.SGD
  p_obs: torch.Tensor  # (E, D)
  p_action: torch.Tensor  # (E,) int32
  p_reward: torch.Tensor  # (E,)
  p_boot: torch.Tensor  # (E,): gamma, or 0 if the pending step was terminal.
  p_valid: torch.Tensor  # (E,) bool
  train_steps: int = 0


def online_init(generator: torch.Generator, obs_dim: int, num_envs: int,
                device=None) -> OnlineState:
  network = make_network(obs_dim, generator).to(device)
  zeros = lambda *shape, dtype=torch.float32: torch.zeros(
      shape, dtype=dtype, device=device)
  return OnlineState(
      network=network, optimizer=make_optimizer(network),
      p_obs=zeros(num_envs, obs_dim),
      p_action=zeros(num_envs, dtype=torch.int32),
      p_reward=zeros(num_envs), p_boot=zeros(num_envs),
      p_valid=zeros(num_envs, dtype=torch.bool))


@torch.no_grad()
def online_select(network: networks.MLPNetwork, obs: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  epsilon: float = 0.0) -> torch.Tensor:
  return qrdqn.epsilon_greedy(network(obs), NUM_ACTIONS, generator, epsilon)


def online_train(state: OnlineState, obs, action, reward, done, active,
                 grad_transform: Optional[Callable] = None):
  """One batched SARSA step on the pending transitions, then the lanes
  rotate to this step's; in place (ble_tpu mlp_agent.py:112-145).

  Args:
    obs: (E, D) the observations a_t was selected at (the pending
      transitions' next state).
    action: (E,) a_t.
    reward: (E,) r_t from stepping a_t.
    done: (E,) terminal after this step.
    active: (E,) env was live at this step.
  Returns (state, the mean loss over the valid lanes, a 0-d tensor).
  """
  with torch.no_grad():
    target = state.p_reward + state.p_boot * _q_of(state.network, obs, action)
  per_env = (_q_of(state.network, state.p_obs, state.p_action) - target) ** 2
  w = state.p_valid.to(torch.float32)
  loss = (per_env * w).sum() / torch.clamp_min(w.sum(), 1.0)
  _sgd_step(state.network, state.optimizer, loss, grad_transform)
  state = dataclasses.replace(
      state, p_obs=obs, p_action=action.to(torch.int32), p_reward=reward,
      p_boot=torch.where(done, 0.0, GAMMA), p_valid=active,
      train_steps=state.train_steps + 1)
  return state, loss.detach()


def online_invalidate(state: OnlineState, mask: torch.Tensor) -> OnlineState:
  """Drops the pending lanes of envs reset at a chunk boundary."""
  return dataclasses.replace(state, p_valid=state.p_valid & ~mask)


def _generator(keys) -> torch.Generator:
  """A CPU generator seeded with the 64 bits of an episode's key (1, 2):
  the network's init stays on torch.Generator, as training's draws do."""
  return torch.Generator().manual_seed(
      (int(keys[0, 0]) << 32) | int(keys[0, 1]))


@base.register('mlp')
class MLPAgent(base.FunctionalAgent):
  """The online SARSA agent of one env, on `device` (default: cuda)."""

  def __init__(self, num_actions: int, observation_shape: Sequence[int],
               seed: Optional[int] = None, device=None):
    device = resolve_device(device)
    obs_dim = observation_shape[0]
    super().__init__(
        num_actions, observation_shape,
        init_fn=lambda keys, device: init(_generator(keys), obs_dim, device),
        policy_fn=lambda state, obs, draws: step(state, 0.0, obs),
        seed=seed, device=device)

  def step(self, reward: float, observation) -> int:
    self._state, action = step(self._state, float(reward),
                               self._observation(observation))
    return int(action[0])
