"""MarcoPolo exploration over a batch of envs (the port of
ble_tpu/agents/marco_polo.py; reference agents/marco_polo_exploration.py).

With probability 0.8 an episode is exploratory; within it, a 4-hour RL
phase (80 agent steps) alternates with a 2-hour exploratory phase (40
steps) whose actions come from the random-walk agent. Every leaf has a
leading env axis; the draws come from a torch.Generator, on its device.
"""

import dataclasses

import torch

from ble_tpu_torch.agents import random_walk
from ble_tpu_torch.utils import profiling

RL_PHASE_STEPS = 80  # 4 h at 3-minute steps (marco_polo_exploration.py:35).
EXPLORATORY_PHASE_STEPS = 40  # 2 h (marco_polo_exploration.py:36).
EXPLORATORY_EPISODE_PROBABILITY = 0.8  # configs/quantile.gin.


@dataclasses.dataclass
class MarcoPoloState:
  exploratory_episode: torch.Tensor  # (E,) bool
  exploratory_phase: torch.Tensor  # (E,) bool
  phase_steps: torch.Tensor  # (E,) int32
  rw: random_walk.RandomWalkState


def begin_episode(n: int, generator: torch.Generator,
                  probability: float = EXPLORATORY_EPISODE_PROBABILITY
                  ) -> MarcoPoloState:
  """Episode init for n envs; episodes always begin in the RL phase
  (marco_polo_exploration.py:58-66)."""
  dev = generator.device
  exploratory = torch.rand((n,), generator=generator, device=dev)
  return MarcoPoloState(
      exploratory_episode=exploratory <= probability,
      exploratory_phase=torch.zeros((n,), dtype=torch.bool, device=dev),
      phase_steps=torch.zeros((n,), dtype=torch.int32, device=dev),
      rw=random_walk.init_from_generator(n, generator))


def step(state: MarcoPoloState, observation, rl_action,
         generator: torch.Generator):
  """Phase bookkeeping and action mixing (marco_polo_exploration.py:68-93).

  Returns (new_state, action).
  """
  with profiling.span('marco_polo.step'):
    phase_steps = state.phase_steps + 1
    expired = torch.where(state.exploratory_phase,
                          phase_steps >= EXPLORATORY_PHASE_STEPS,
                          phase_steps >= RL_PHASE_STEPS)
    flip = state.exploratory_episode & expired
    exploratory_phase = state.exploratory_phase ^ flip
    phase_steps = torch.where(flip, 0, phase_steps)

    # The random-walk agent only advances when queried
    # (marco_polo_exploration.py:88-93).
    rw_next, rw_action = random_walk.step_from_generator(state.rw, observation,
                                                         generator)
    rw_state = random_walk.RandomWalkState(**{
        f.name: torch.where(exploratory_phase, getattr(rw_next, f.name),
                            getattr(state.rw, f.name))
        for f in dataclasses.fields(rw_next)})

    action = torch.where(exploratory_phase, rw_action,
                         rl_action.to(rw_action.dtype))
    return MarcoPoloState(
        exploratory_episode=state.exploratory_episode,
        exploratory_phase=exploratory_phase,
        phase_steps=phase_steps.to(torch.int32),
        rw=rw_state), action
