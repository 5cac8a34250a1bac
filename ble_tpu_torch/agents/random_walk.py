"""Random-walk and uniform random agents, batched (the port of
ble_tpu/agents/random_walk.py; reference agents/random_walk_agent.py and
agents/agent.py:149-162).

A target pressure performs a Gaussian random walk whose step grows with the
episode time elapsed (random_walk_agent.py:80-91), and the policy chases it
with 100 Pa hysteresis. Draws come from a torch.Generator, and the state
lives, on the generator's device; actions go to the observations' device.
"""

import dataclasses

import torch

from ble_tpu_torch.agents import base
from ble_tpu_torch.env import features as features_lib
from ble_tpu_torch.env import safety
from ble_tpu_torch.utils import constants

HYSTERESIS_PA = 100.0
STDDEV = 0.1666  # ~10 Pa/min (random_walk_agent.py:39).


@dataclasses.dataclass
class RandomWalkState:
  target_pressure: torch.Tensor  # (E,)
  time_elapsed_s: torch.Tensor  # (E,)


def init(n: int, generator: torch.Generator) -> RandomWalkState:
  """Fresh target pressures in [6500, 11400) Pa (random_walk_agent.py:58-60:
  sample_pressure without an atmosphere uses the conservative 11400 Pa)."""
  dev = generator.device
  target = 6500.0 + torch.rand((n,), generator=generator, device=dev) * (
      11400.0 - 6500.0)
  return RandomWalkState(target_pressure=target,
                         time_elapsed_s=torch.zeros((n,), device=dev))


def select_action(state: RandomWalkState, observation):
  """UP above the target, DOWN below it, STAY within the hysteresis."""
  balloon_pressure = features_lib.parse(observation).balloon_pressure
  target = state.target_pressure.to(observation.device)
  up = torch.full_like(balloon_pressure, safety.UP, dtype=torch.int32)
  return torch.where(
      balloon_pressure - HYSTERESIS_PA > target, up,
      torch.where(balloon_pressure + HYSTERESIS_PA < target,
                  torch.full_like(up, safety.DOWN),
                  torch.full_like(up, safety.STAY)))


def step(state: RandomWalkState, observation, generator: torch.Generator):
  """Drifts each target and picks the actions (random_walk_agent.py:80-91)."""
  n = state.target_pressure.shape[0]
  elapsed = state.time_elapsed_s + constants.AGENT_TIME_STEP_SECONDS
  target = (state.target_pressure + elapsed * STDDEV * torch.randn(
      (n,), generator=generator, device=generator.device))
  new_state = RandomWalkState(target_pressure=target, time_elapsed_s=elapsed)
  return new_state, select_action(new_state, observation)


def random_policy(num_actions: int):
  """(init, policy) of the uniform random agent."""
  def policy(state, observation, generator):
    n = observation.shape[0]
    actions = torch.randint(0, num_actions, (n,), generator=generator,
                            dtype=torch.int32, device=generator.device)
    return state, actions.to(observation.device)
  return (lambda n, generator: ()), policy


@base.register('random_walk')
class RandomWalkAgent(base.FunctionalAgent):

  def __init__(self, num_actions, observation_shape, seed=None, device=None):
    super().__init__(num_actions, observation_shape, init_fn=init,
                     policy_fn=step, seed=seed, device=device)

  def begin_episode(self, observation) -> int:
    # The first action uses the fresh target without drift
    # (random_walk_agent.py:75-78).
    self._state = init(1, self._generator)
    return int(select_action(self._state, self._observation(observation))[0])


@base.register('random')
class RandomAgent(base.FunctionalAgent):
  """Uniform random policy (reference agents/agent.py:149-162)."""

  def __init__(self, num_actions, observation_shape, seed=None, device=None):
    init_fn, policy_fn = random_policy(num_actions)
    super().__init__(num_actions, observation_shape, init_fn=init_fn,
                     policy_fn=policy_fn, seed=seed, device=device)
