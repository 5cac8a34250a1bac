"""Training harness: iteration loop, collectors, checkpoints and resume (the
port of ble_tpu/train/train_lib.py; reference train_lib.py:40-131).

Envs run continuously with their own episode boundaries: inactive envs are
re-initialized at chunk boundaries (learner.selective_reset), and one
"iteration" is `episodes_per_iteration * episode_length` lockstep steps.
Collectors receive per-step statistics, brought to the host once a chunk,
and with render_final the last iteration's env-0 flight track is drawn
into base_dir/final_flight_path.png (reference train.py:95-109).

A checkpoint is one `torch.save` file, checkpoints/ckpt_<iteration>.pt,
holding the full TrainState (networks, optimizer, replay, env and
MarcoPolo state, the generator's state and the counters) or, when light,
the learner alone.
"""

import copy
import dataclasses
import logging
import os
import re
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.metrics import collectors as collectors_lib
from ble_tpu_torch.train import learner as learner_lib

_CKPT = re.compile(r'^ckpt_(\d+)\.pt$')


def _checkpoint_dir(base_dir: str) -> str:
  return os.path.join(os.path.abspath(base_dir), 'checkpoints')


def _checkpoints(base_dir: str):
  """{iteration: path} of the checkpoints under base_dir."""
  directory = _checkpoint_dir(base_dir)
  if not os.path.isdir(directory):
    return {}
  found = {}
  for name in os.listdir(directory):
    m = _CKPT.match(name)
    if m:
      found[int(m.group(1))] = os.path.join(directory, name)
  return found


def _to_tree(obj):
  """A dataclass of tensors as nested dicts (tensors, ints and None kept)."""
  if dataclasses.is_dataclass(obj):
    return {f.name: _to_tree(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}
  return obj


def _from_tree(template, data):
  """`template` with its leaves taken from _to_tree's dicts, each tensor on
  the template's device."""
  if dataclasses.is_dataclass(template):
    return dataclasses.replace(template, **{
        f.name: _from_tree(getattr(template, f.name), data[f.name])
        for f in dataclasses.fields(template)})
  if isinstance(template, torch.Tensor):
    return data.to(template.device)
  if isinstance(template, tuple):
    return tuple(_from_tree(t, d) for t, d in zip(template, data))
  return data


def learner_state_dict(learner) -> dict:
  """A learner state (a dataclass: qrdqn.LearnerState, or the MLP's
  OnlineState with its per-env lanes) as a dict by field: each module's
  and optimizer's state_dict, each tensor and int as it is."""
  out = {}
  for f in dataclasses.fields(learner):
    value = getattr(learner, f.name)
    if isinstance(value, (torch.nn.Module, torch.optim.Optimizer)):
      value = value.state_dict()
    out[f.name] = value
  return out


def load_learner_state(learner, data: dict) -> None:
  """Loads learner_state_dict's data into `learner`, in place; tensors go
  to the device of the ones they replace. Optimizer moments are copied: on
  the same device load_state_dict would keep the very tensors of `data`,
  which may be another learner's."""
  for f in dataclasses.fields(learner):
    value = getattr(learner, f.name)
    if isinstance(value, torch.nn.Module):
      value.load_state_dict(data[f.name])
    elif isinstance(value, torch.optim.Optimizer):
      value.load_state_dict(copy.deepcopy(data[f.name]))
    elif isinstance(value, torch.Tensor):
      setattr(learner, f.name, data[f.name].to(value.device, copy=True))
    else:
      setattr(learner, f.name, data[f.name])


def train_state_dict(ts: learner_lib.TrainState) -> dict:
  out = {}
  for f in dataclasses.fields(ts):
    value = getattr(ts, f.name)
    if f.name == 'learner':
      out[f.name] = learner_state_dict(value)
    elif f.name == 'generator':
      out[f.name] = value.get_state()
    else:
      out[f.name] = _to_tree(value)
  return out


def load_train_state(template: learner_lib.TrainState,
                     data: dict) -> learner_lib.TrainState:
  """`template` with train_state_dict's data; its learner and generator are
  loaded in place."""
  load_learner_state(template.learner, data['learner'])
  template.generator.set_state(data['generator'].cpu())
  return dataclasses.replace(template, **{
      f.name: _from_tree(getattr(template, f.name), data[f.name])
      for f in dataclasses.fields(template)
      if f.name not in ('learner', 'generator')})


def save_checkpoint(base_dir: str, ts: learner_lib.TrainState,
                    iteration: int, max_to_keep: int = 5,
                    light: bool = False) -> str:
  """Writes checkpoints/ckpt_<iteration>.pt and keeps the newest
  `max_to_keep`. light=True saves only the learner (networks, optimizer,
  train_steps): a few MB instead of the GB of a full TrainState, whose
  replay ring alone is E x ring_len x 1099 floats. A light checkpoint
  restores through restore_latest_learner_params and the eval CLI;
  training resumed from it re-warms the replay ring. Returns the path."""
  directory = _checkpoint_dir(base_dir)
  os.makedirs(directory, exist_ok=True)
  payload = {'iteration': int(iteration)}
  if light:
    payload['learner'] = learner_state_dict(ts.learner)
  else:
    payload['train_state'] = train_state_dict(ts)
  path = os.path.join(directory, f'ckpt_{int(iteration):08d}.pt')
  torch.save(payload, path + '.tmp')
  os.replace(path + '.tmp', path)
  found = _checkpoints(base_dir)
  for old in sorted(found)[:-max_to_keep]:
    os.remove(found[old])
  return path


def _load_latest(base_dir: str, mmap: bool = False):
  found = _checkpoints(base_dir)
  if not found:
    return None, -1
  latest = max(found)
  data = torch.load(found[latest], map_location='cpu', weights_only=True,
                    mmap=mmap)
  return data, latest


def restore_latest_checkpoint(base_dir: str,
                              template: learner_lib.TrainState):
  """Returns (train_state, iteration), or (template, -1) if there is no
  checkpoint. A light checkpoint restores the learner into `template`,
  whose other fields stay fresh."""
  data, latest = _load_latest(base_dir)
  if data is None:
    return template, -1
  if 'train_state' in data:
    return load_train_state(template, data['train_state']), latest
  logging.warning('checkpoint %d is light: the learner is restored, the '
                  'envs, replay and MarcoPolo state start fresh.', latest)
  load_learner_state(template.learner, data['learner'])
  return template, latest


def restore_latest_learner_params(base_dir: str):
  """Returns (the online network's state dict, iteration) from the latest
  checkpoint, full or light, without a TrainState template (the replay and
  env shapes of training do not matter to a policy). Raises ValueError if
  no checkpoint exists."""
  data, latest = _load_latest(base_dir, mmap=True)
  if data is None:
    raise ValueError(f'No checkpoint found in {base_dir}')
  learner = data['learner'] if 'learner' in data else (
      data['train_state']['learner'])
  return {k: v.clone() for k, v in learner['network'].items()}, latest


def run_training_loop(base_dir: Optional[str],
                      env_params: env_lib.EnvParams,
                      field_fn: Callable,
                      config: learner_lib.TrainConfig,
                      num_iterations: int,
                      episodes_per_iteration: int = 1,
                      episode_length: Optional[int] = None,
                      chunk_steps: int = 96,
                      collectors: Sequence[str] = ('console',),
                      seed: int = 0,
                      checkpoint: bool = True,
                      eval_fn: Optional[Callable] = None,
                      eval_every: int = 0,
                      render_final: bool = False,
                      max_seconds: Optional[float] = None,
                      device=None) -> learner_lib.TrainState:
  """Runs the vectorized training loop (reference train_lib.py:81-131) on
  `device` (default cuda).

  One reference "episode" maps to `config.num_envs` parallel episodes with
  independent boundaries.

  Args:
    eval_fn: optional callback `(train_state, iteration) -> None` invoked
      every `eval_every` iterations (and after the last one).
    render_final: record env 0's track over the last iteration and save
      its render as base_dir/final_flight_path.png.
    max_seconds: optional wall-clock budget; the loop checkpoints and stops
      cleanly once exceeded.
  """
  episode_length = episode_length or config.episode_length
  config = dataclasses.replace(config, episode_length=episode_length)
  steps_per_iteration = episodes_per_iteration * episode_length
  dispatcher = collectors_lib.CollectorDispatcher(
      base_dir, env_lib.NUM_ACTIONS, collectors)
  dispatcher.pre_training()

  ts = learner_lib.init_train_state(seed, env_params, field_fn, config,
                                    device)
  start_iteration = 0
  if checkpoint and base_dir is not None:
    ts, latest = restore_latest_checkpoint(base_dir, ts)
    start_iteration = latest + 1

  renderer = None
  if render_final:
    from ble_tpu_torch.env.rendering import renderer as renderer_lib
    renderer = renderer_lib.MatplotlibRenderer(
        env_params.station_keeping_radius_km)

  t_start = time.time()
  for iteration in range(start_iteration, num_iterations):
    iter_t0 = time.time()
    dispatcher.begin_episode()
    render = renderer is not None and iteration == num_iterations - 1
    if render:
      renderer.reset()
    steps_done = 0
    completed_returns = []
    while steps_done < steps_per_iteration:
      # Inactive envs get fresh episodes at the chunk boundary.
      ts, reset_stats = learner_lib.selective_reset(ts, env_params, field_fn,
                                                    config)
      completed = reset_stats['completed'].cpu().numpy()
      if completed.any():
        completed_returns.extend(
            reset_stats['returns'].cpu().numpy()[completed].tolist())

      n = min(chunk_steps, steps_per_iteration - steps_done)
      ts, metrics = learner_lib.run_episode_chunk(config, env_params, ts, n)
      metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
      for i in range(n):
        dispatcher.step(collectors_lib.StatisticsInstance(
            step=steps_done + i,
            action=np.zeros(()),
            action_histogram=metrics['action_hist'][i],
            reward=metrics['reward'][i],
            terminal=metrics['terminals'][i]))
        if render:
          renderer.add_point(*(float(v) for v in metrics['path'][i]))
      steps_done += n
    dispatcher.end_episode(collectors_lib.StatisticsInstance(
        step=steps_done, action=np.zeros(()),
        action_histogram=np.zeros((env_lib.NUM_ACTIONS,), np.int64),
        reward=np.zeros(()), terminal=np.zeros((), np.int64)))

    dt = time.time() - iter_t0
    mean_return = (float(np.mean(completed_returns))
                   if completed_returns else float('nan'))
    logging.info(
        'iteration %d: %.0f env-steps/s, %d episodes done (mean return '
        '%.2f), loss %.4g', iteration,
        steps_per_iteration * config.num_envs / max(dt, 1e-9),
        len(completed_returns), mean_return, float(metrics['loss'][-1]))

    if checkpoint and base_dir is not None:
      save_checkpoint(base_dir, ts, iteration)
    if eval_fn is not None and eval_every > 0 and (
        iteration % eval_every == 0 or iteration == num_iterations - 1):
      eval_fn(ts, iteration)
    if max_seconds is not None and time.time() - t_start > max_seconds:
      logging.info('max_seconds (%.0f) reached at iteration %d; stopping.',
                   max_seconds, iteration)
      break

  if renderer is not None and base_dir is not None:
    image = renderer.render('rgb_array')
    try:
      import matplotlib.pyplot as plt
      path = os.path.join(base_dir, 'final_flight_path.png')
      plt.imsave(path, image)
      logging.info('saved final flight path render to %s', path)
    except Exception as e:  # matplotlib backend quirks must not kill a run.
      logging.warning('could not save final render: %s', e)
  dispatcher.end_training()
  return ts
