"""Agent interface and registry (the port of ble_tpu/agents/base.py;
reference agents/agent.py:33-162, agents/agent_registry.py:40-75).

Two interfaces:
  - the functional one every policy implements, over a batch, with the
    JAX package's per-env keys for any random draw (utils/prng.py):
    `init(keys (E, 2), device) -> state`,
    `policy(state, observations (E, 1099), draws) -> (state, actions
    (E,))` and, for a policy that draws, `draw(keys (..., 2)) -> draws
    (...)`: what one step's key gives an env, drawn on the host. The
    caller draws ahead (the batched evaluator one GP chunk of steps at a
    time) and hands `policy` its step's draws on the observations' device,
    None when the policy has no `draw`. This is what the batched
    evaluator steps.
  - the stateful `Agent`, the reference's begin_episode/step/end_episode
    API for one env, for host-side episode loops such as the gym env.
"""

import abc
import enum
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ble_tpu_torch import resolve_device
from ble_tpu_torch.utils import prng


class Policy(NamedTuple):
  """A batched functional policy: init, step and, for a policy that draws,
  draw (see the module docstring)."""
  init: Callable
  step: Callable
  draw: Optional[Callable] = None


class AgentMode(enum.Enum):
  TRAIN = 'train'
  EVAL = 'eval'


class Agent(abc.ABC):
  """Stateful agent API (reference agents/agent.py:33-146)."""

  def __init__(self, num_actions: int, observation_shape: Sequence[int]):
    self._num_actions = num_actions
    self._observation_shape = tuple(observation_shape)
    self._mode = AgentMode.TRAIN

  def get_name(self) -> str:
    return type(self).__name__

  @abc.abstractmethod
  def begin_episode(self, observation) -> int:
    ...

  @abc.abstractmethod
  def step(self, reward: float, observation) -> int:
    ...

  @abc.abstractmethod
  def end_episode(self, reward: float, terminal: bool = True) -> None:
    ...

  def set_mode(self, mode: AgentMode) -> None:
    self._mode = mode

  def save_checkpoint(self, checkpoint_dir: str, iteration: int) -> None:
    pass

  def load_checkpoint(self, checkpoint_dir: str, iteration: int) -> None:
    pass

  def reload_latest_checkpoint(self, checkpoint_dir: str) -> int:
    return -1


_REGISTRY: Dict[str, Callable[..., Agent]] = {}


def register(name: str):
  def deco(ctor):
    _REGISTRY[name] = ctor
    return ctor
  return deco


def available_agents():
  _register_all()
  return sorted(_REGISTRY)


def _register_all() -> None:
  """Imports every agent module, each of which registers its agents (the
  JAX package does this in its agents/__init__.py)."""
  import importlib
  for module in ('mlp_agent', 'perciatelli44', 'quantile_agent',
                 'random_walk', 'station_seeker'):
    importlib.import_module(f'ble_tpu_torch.agents.{module}')


def create_agent(name: str, num_actions: int,
                 observation_shape: Sequence[int], **kwargs) -> Agent:
  _register_all()
  if name not in _REGISTRY:
    raise ValueError(
        f'Unknown agent {name!r}; available: {available_agents()}')
  return _REGISTRY[name](num_actions=num_actions,
                         observation_shape=observation_shape, **kwargs)


class FunctionalAgent(Agent):
  """Adapts a batched functional policy to the stateful Agent API: one
  observation is a batch of one env, a tensor on `device` (default: cuda,
  as every entry point of the port; pass device='cpu' for the CPU). The
  agents with networks pass the device their networks live on. The keys
  follow ble_tpu/agents/base.py:100-121: key(seed), split at
  begin_episode and at each act."""

  def __init__(self, num_actions: int, observation_shape: Sequence[int],
               init_fn: Callable[[torch.Tensor, torch.device], Any],
               policy_fn: Callable[[Any, torch.Tensor, Any],
                                   Tuple[Any, torch.Tensor]],
               seed: Optional[int] = None, device=None,
               draw_fn: Optional[Callable] = None):
    super().__init__(num_actions, observation_shape)
    self._init_fn = init_fn
    self._policy_fn = policy_fn
    self._draw_fn = draw_fn
    self._key = prng.key(0 if seed is None else seed)
    self._device = resolve_device(device)
    self._state = None

  def _next_key(self) -> torch.Tensor:
    """A fresh (1, 2) key: self._key, key = split(self._key)."""
    self._key, key = prng.split(self._key)
    return key[None]

  def begin_episode(self, observation) -> int:
    self._state = self._init_fn(self._next_key(), self._device)
    return self._act(observation)

  def step(self, reward: float, observation) -> int:
    del reward
    return self._act(observation)

  def end_episode(self, reward: float, terminal: bool = True) -> None:
    pass

  def _observation(self, observation) -> torch.Tensor:
    """One observation as a (1, D) float32 tensor on the agent's device."""
    return torch.as_tensor(np.asarray(observation, np.float32),
                           device=self._device)[None]

  def _act(self, observation) -> int:
    key = self._next_key()
    draws = (None if self._draw_fn is None else
             self._draw_fn(key).to(self._device))
    self._state, action = self._policy_fn(
        self._state, self._observation(observation), draws)
    return int(action[0])
