"""Gymnasium-compatible single-env wrapper (the port of
ble_tpu/env/gym_env.py; reference env/balloon_env.py:106-300, env/gym.py).

`BalloonEnv` is the stateful reset/step/seed/render API around env.reset
and env.step at a batch of one. Its state stays on `device` (default:
cuda); observations come back as numpy arrays. A renderer
(rendering/renderer.py) records the balloon's track at every reset and
step, and `render` draws it. It subclasses gymnasium.Env when
gymnasium imports and is a plain class otherwise, so nothing here requires
it. Registered as `BalloonLearningEnvironment-v0` by `register_env()`.
"""

import time
from typing import Any, Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from ble_tpu_torch import resolve_device
from ble_tpu_torch.env import balloon as balloon_lib
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.utils import prng

try:
  import gymnasium as gym
  _GYM = True
except ImportError:
  _GYM = False


class BalloonEnv(gym.Env if _GYM else object):
  """Station-keeping environment, gym API (reference balloon_env.py:106)."""

  metadata = {'render.modes': []}

  def __init__(self,
               *,
               station_keeping_radius_km: float = 50.0,
               params: Optional[env_lib.EnvParams] = None,
               field_fn: Optional[Callable] = None,
               wind_field: str = 'generative',
               seed: Optional[int] = None,
               renderer=None,
               device=None):
    self._device = resolve_device(device)
    if params is None:
      params = env_lib.EnvParams(
          station_keeping_radius_km=station_keeping_radius_km)
    self._params = params
    if field_fn is None:
      if wind_field == 'generative':
        from ble_tpu_torch.models import loader
        field_fn = env_lib.make_field_fn(
            'generative', loader.load_offlineskies22(device=self._device))
      else:
        field_fn = env_lib.make_field_fn('static')
    self._field_fn = field_fn
    self._renderer = renderer
    if renderer is not None:
      self.metadata = {'render.modes': renderer.render_modes}
    self.seed(seed if seed is not None else int(time.time() * 1e6))
    self.reset()

  def seed(self, seed: int) -> None:
    """The env's key is key(seed) (ble_tpu/env/gym_env.py:61-62)."""
    self._rng = prng.key(seed)

  def reset(self, *, seed: Optional[int] = None, options=None):
    """Gymnasium API: (observation, info). Each episode's world comes from
    the next arena key, self._rng, arena = split(self._rng)
    (ble_tpu/env/gym_env.py:64-75; reference balloon_env.py:213), so
    BalloonEnv(seed=s) resets through the JAX package's worlds."""
    del options
    if seed is not None:
      self.seed(seed)
    self._rng, arena = prng.split(self._rng)
    self._state, obs = env_lib.reset_keys(self._params, arena[None],
                                          self._field_fn, self._device)
    if self._renderer is not None:
      self._renderer.reset()
      self._renderer.step(self._state)
    return obs[0].cpu().numpy(), {}

  def step(self, action: int
           ) -> Tuple[np.ndarray, float, bool, bool, Mapping[str, Any]]:
    """Gymnasium API: (obs, reward, terminated, truncated, info).

    `terminated` is the reference's `is_done` (power, burst or zero
    pressure; balloon_env.py:157-190); truncation at 960 steps is the
    harness's job, so `truncated` is always False.
    """
    actions = torch.tensor([int(action)], dtype=torch.int32,
                           device=self._device)
    self._state, obs, reward, done, info = env_lib.step(
        self._params, self._state, actions)
    if self._renderer is not None:
      self._renderer.step(self._state)
    info = {k: v[0].item() for k, v in info.items()}
    return (obs[0].cpu().numpy(), float(reward[0]), bool(done[0]), False,
            info)

  def render(self, mode: str = 'human'):
    """The renderer's image in `mode`; None without a renderer."""
    if self._renderer is None:
      return None
    return self._renderer.render(mode)

  def close(self) -> None:
    pass

  @property
  def action_space(self):
    return gym.spaces.Discrete(env_lib.NUM_ACTIONS)

  @property
  def observation_space(self):
    low = np.zeros(env_lib.OBSERVATION_DIM, np.float32)
    high = np.ones(env_lib.OBSERVATION_DIM, np.float32)
    low[[3, 4, 5, 6]] = -1.0
    low[15] = 1.0
    high[15] = np.inf
    return gym.spaces.Box(low=low, high=high)

  @property
  def reward_range(self) -> Tuple[float, float]:
    return (0.0, 1.0)

  def get_simulator_state(self) -> env_lib.EnvState:
    """The full simulator state, a batch of one (balloon_arena.py:204-207)."""
    return self._state

  def set_simulator_state(self, state: env_lib.EnvState) -> None:
    self._state = state

  def get_balloon_state(self) -> balloon_lib.BalloonState:
    return self._state.balloon

  def __str__(self) -> str:
    return 'BalloonEnv'


def register_env() -> None:
  """Registers BalloonLearningEnvironment-v0 (reference env/gym.py:20)."""
  if not _GYM:
    raise ImportError('gymnasium is required for registration')
  try:
    gym.register(id='BalloonLearningEnvironment-v0',
                 entry_point='ble_tpu_torch.env.gym_env:BalloonEnv')
  except gym.error.Error:
    pass  # Already registered.
