"""Metric collectors: console, pickle and tensorboard, with a dispatcher
(the port of ble_tpu/metrics/collectors.py; reference metrics/
collector.py:39-86, collector_dispatcher.py:62-99).

Statistics arrive as host arrays, one instance per lockstep batch step of
the vectorized harness.
"""

import dataclasses
import os
import pickle
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class StatisticsInstance:
  """Per-step statistics (reference statistics_instance.py:22).

  `action_histogram` carries the (num_actions,) action counts over live
  envs and `terminal` the count of envs that terminated this step.
  """
  step: int
  action: np.ndarray  # (E,) or scalar
  reward: np.ndarray
  terminal: np.ndarray
  action_histogram: Optional[np.ndarray] = None  # (num_actions,) counts


class Collector:
  """Lifecycle hooks (reference collector.py:39-86)."""

  def __init__(self, base_dir: Optional[str], num_actions: int,
               current_episode: int = 0):
    if base_dir is not None:
      self._base_dir = os.path.join(base_dir, 'metrics', self.get_name())
      os.makedirs(self._base_dir, exist_ok=True)
    else:
      self._base_dir = None
    self._num_actions = num_actions

  def get_name(self) -> str:
    raise NotImplementedError

  def pre_training(self) -> None:
    pass

  def begin_episode(self) -> None:
    pass

  def step(self, statistics: StatisticsInstance) -> None:
    pass

  def end_episode(self, statistics: StatisticsInstance) -> None:
    pass

  def end_training(self) -> None:
    pass


class ConsoleCollector(Collector):
  """Running reward and action histogram (reference console_collector.py)."""

  def get_name(self) -> str:
    return 'console'

  def pre_training(self) -> None:
    self._episode = 0

  def begin_episode(self) -> None:
    self._reward = 0.0
    self._action_counts = np.zeros(self._num_actions, np.int64)
    self._steps = 0

  def step(self, statistics: StatisticsInstance) -> None:
    self._reward += float(np.mean(statistics.reward))
    if statistics.action_histogram is not None:
      self._action_counts += np.asarray(statistics.action_histogram,
                                        np.int64)
    else:
      actions = np.atleast_1d(np.asarray(statistics.action))
      for a in range(self._num_actions):
        self._action_counts[a] += int(np.sum(actions == a))
    self._steps += 1

  def end_episode(self, statistics: StatisticsInstance) -> None:
    self.step(statistics)
    total = max(self._action_counts.sum(), 1)
    hist = ', '.join(f'{a}: {c / total:.2f}'
                     for a, c in enumerate(self._action_counts))
    print(f'[episode {self._episode}] steps={self._steps} '
          f'mean_reward={self._reward:.3f} actions=({hist})')
    self._episode += 1


class PickleCollector(Collector):
  """Per-episode pickle dumps (reference pickle_collector.py)."""

  def __init__(self, base_dir: Optional[str], num_actions: int,
               current_episode: int = 0):
    if base_dir is None:
      raise ValueError('PickleCollector requires a base directory.')
    super().__init__(base_dir, num_actions, current_episode)
    self._episode = current_episode

  def get_name(self) -> str:
    return 'pickle'

  def begin_episode(self) -> None:
    self._stats: List[StatisticsInstance] = []

  def step(self, statistics: StatisticsInstance) -> None:
    self._stats.append(statistics)

  def end_episode(self, statistics: StatisticsInstance) -> None:
    self._stats.append(statistics)
    path = os.path.join(self._base_dir, f'episode_{self._episode:06d}.pkl')
    with open(path, 'wb') as f:
      pickle.dump(self._stats, f)
    self._episode += 1


class TensorboardCollector(Collector):
  """Episode reward and length summaries (reference
  tensorboard_collector.py), through torch.utils.tensorboard."""

  def __init__(self, base_dir: Optional[str], num_actions: int,
               current_episode: int = 0):
    if base_dir is None:
      raise ValueError('TensorboardCollector requires a base directory.')
    try:
      from torch.utils import tensorboard
    except ImportError as e:
      raise ImportError(
          'the tensorboard collector needs the tensorboard package, which '
          'is not installed; choose --collectors console,pickle') from e
    super().__init__(base_dir, num_actions, current_episode)
    self._writer = tensorboard.SummaryWriter(self._base_dir)
    self._episode = current_episode

  def get_name(self) -> str:
    return 'tensorboard'

  def begin_episode(self) -> None:
    self._reward = 0.0
    self._steps = 0

  def step(self, statistics: StatisticsInstance) -> None:
    self._reward += float(np.mean(statistics.reward))
    self._steps += 1

  def end_episode(self, statistics: StatisticsInstance) -> None:
    self.step(statistics)
    self._writer.add_scalar('Train/EpisodeReward', self._reward,
                            self._episode)
    self._writer.add_scalar('Train/EpisodeLength', self._steps,
                            self._episode)
    self._writer.flush()
    self._episode += 1

  def end_training(self) -> None:
    self._writer.close()


AVAILABLE_COLLECTORS = {
    'console': ConsoleCollector,
    'pickle': PickleCollector,
    'tensorboard': TensorboardCollector,
}


class CollectorDispatcher:
  """Fans lifecycle calls out to collectors
  (reference collector_dispatcher.py:62-99)."""

  def __init__(self, base_dir: Optional[str], num_actions: int,
               collectors: Sequence[str], current_episode: int = 0):
    self._collectors = []
    for name in collectors:
      if name not in AVAILABLE_COLLECTORS:
        raise ValueError(f'Unknown collector: {name}')
      self._collectors.append(
          AVAILABLE_COLLECTORS[name](base_dir, num_actions, current_episode))

  def pre_training(self) -> None:
    for c in self._collectors:
      c.pre_training()

  def begin_episode(self) -> None:
    for c in self._collectors:
      c.begin_episode()

  def step(self, statistics: StatisticsInstance) -> None:
    for c in self._collectors:
      c.step(statistics)

  def end_episode(self, statistics: StatisticsInstance) -> None:
    for c in self._collectors:
      c.end_episode(statistics)

  def end_training(self) -> None:
    for c in self._collectors:
      c.end_training()
