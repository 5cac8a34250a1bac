"""Random-walk and uniform random agents, batched (the port of
ble_tpu/agents/random_walk.py; reference agents/random_walk_agent.py and
agents/agent.py:149-162).

A target pressure performs a Gaussian random walk whose step grows with the
episode time elapsed (random_walk_agent.py:80-91), and the policy chases it
with 100 Pa hysteresis. The evaluator and the host agents draw from the JAX
package's keys (utils/prng.py): `init` from a key an env, `step` with the
standard normals `draw` gives its step's keys, so a seed's walk is the
JAX package's. MarcoPolo's exploration in training draws from a
torch.Generator instead (`init_from_generator`, `step_from_generator`).
"""

import dataclasses

import torch

from ble_tpu_torch.agents import base
from ble_tpu_torch.env import features as features_lib
from ble_tpu_torch.env import safety
from ble_tpu_torch.utils import constants
from ble_tpu_torch.utils import prng

HYSTERESIS_PA = 100.0
STDDEV = 0.1666  # ~10 Pa/min (random_walk_agent.py:39).
# sample_pressure without an atmosphere uses the conservative 11400 Pa
# (random_walk_agent.py:58-60).
_MIN_TARGET_PA = 6500.0
_MAX_TARGET_PA = 11400.0


@dataclasses.dataclass
class RandomWalkState:
  target_pressure: torch.Tensor  # (E,)
  time_elapsed_s: torch.Tensor  # (E,)


def _start(target) -> RandomWalkState:
  return RandomWalkState(target_pressure=target,
                         time_elapsed_s=torch.zeros_like(target))


def init(keys, device) -> RandomWalkState:
  """Fresh target pressures, uniform(key, 6500, 11400) of each key (E, 2)
  (ble_tpu/agents/random_walk.py:29-34), on `device`."""
  return _start(prng.uniform(keys, (), _MIN_TARGET_PA,
                             _MAX_TARGET_PA).to(device))


def init_from_generator(n: int, generator: torch.Generator
                        ) -> RandomWalkState:
  """n fresh target pressures from `generator`, on its device."""
  target = _MIN_TARGET_PA + torch.rand(
      (n,), generator=generator, device=generator.device) * (
          _MAX_TARGET_PA - _MIN_TARGET_PA)
  return _start(target)


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


def draw(keys):
  """The standard normal a step's key gives (jax.random.normal(key)), for
  keys (..., 2): (...) float32 on the CPU."""
  return prng.normal(keys)


def step(state: RandomWalkState, observation, z):
  """Drifts each target by STDDEV x the time elapsed x z, the step's
  standard normals (E,) (ble_tpu/agents/random_walk.py:44-50;
  random_walk_agent.py:80-91), and picks the actions."""
  elapsed = state.time_elapsed_s + constants.AGENT_TIME_STEP_SECONDS
  target = state.target_pressure + elapsed * STDDEV * z
  new_state = RandomWalkState(target_pressure=target, time_elapsed_s=elapsed)
  return new_state, select_action(new_state, observation)


def step_from_generator(state: RandomWalkState, observation,
                        generator: torch.Generator):
  """`step` with the normals drawn from `generator`, on its device."""
  n = state.target_pressure.shape[0]
  return step(state, observation, torch.randn(
      (n,), generator=generator, device=generator.device))


def random_policy(num_actions: int) -> base.Policy:
  """The uniform random agent's policy: randint(key, (), 0, num_actions)
  a step (ble_tpu/train/eval.py:28-30)."""
  return base.Policy(
      init=lambda keys, device: (),
      step=lambda state, observation, draws: (
          state, draws.to(observation.device)),
      draw=lambda keys: prng.randint(keys, (), 0, num_actions))


@base.register('random_walk')
class RandomWalkAgent(base.FunctionalAgent):

  def __init__(self, num_actions, observation_shape, seed=None, device=None):
    super().__init__(num_actions, observation_shape, init_fn=init,
                     policy_fn=step, seed=seed, device=device, draw_fn=draw)

  def begin_episode(self, observation) -> int:
    # The first action uses the fresh target without drift
    # (random_walk_agent.py:75-78).
    self._state = init(self._next_key(), self._device)
    return int(select_action(self._state, self._observation(observation))[0])


@base.register('random')
class RandomAgent(base.FunctionalAgent):
  """Uniform random policy (reference agents/agent.py:149-162)."""

  def __init__(self, num_actions, observation_shape, seed=None, device=None):
    init_fn, policy_fn, draw_fn = random_policy(num_actions)
    super().__init__(num_actions, observation_shape, init_fn=init_fn,
                     policy_fn=policy_fn, seed=seed, device=device,
                     draw_fn=draw_fn)
