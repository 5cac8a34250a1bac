"""Faults planted in the program, underneath the harness, to show that
the check fails them: each rebinds one function of the port for the
length of a run (calibrate.py --fault, and the CPU tests).

  state_unchanged  the env step hands back the state it was given
  reward_altered   the env step's rewards are off by 1e-3
  action_altered   the policy's actions are turned by one (mod 3)
  half_batch       QR-DQN's loss is the mean over half of the batch
  update_skipped   QR-DQN's train step returns the batch's loss and
                   leaves both networks and Adam as they were, with
                   train_steps still counted
  sync_skipped     QR-DQN's train step never sets the target network

The train step's faults wrap qrdqn.train_step, which runs its CUDA graph
on the card and the eager path elsewhere, so they plant on both: the
step runs, then the fault undoes its update, or it runs with a target
period of 2**62.
"""

import dataclasses
import importlib

import torch

from portbench import check


class Fault:

  def __init__(self, module: str, attr: str, wrapper_of):
    self.module, self.attr, self.wrapper_of = module, attr, wrapper_of
    self._undo = None

  def __call__(self, run=None):
    self._undo = check.rebind(importlib.import_module(self.module), self.attr,
                              self.wrapper_of)

  def undo(self):
    if self._undo is not None:
      self._undo()
      self._undo = None


def _state_unchanged(original):
  def step_batched(params, state, actions, global_step=None, refresh='auto'):
    out = original(params, state, actions, global_step=global_step,
                   refresh=refresh)
    return out._replace(state=state)
  return step_batched


def _reward_altered(original):
  def step_outcome(params, balloon, wind):
    reward, done, info = original(params, balloon, wind)
    return reward + 1e-3, done, info
  return step_outcome


def _turned(original):
  def policy(*args, **kwargs):
    return (original(*args, **kwargs) + 1) % 3
  return policy


def _half_batch(original):
  def quantile_loss(config, network, target_network, batch):
    half = batch['obs'].shape[0] // 2
    return original(config, network, target_network,
                    {k: v[:half] for k, v in batch.items()})
  return quantile_loss


def _update_skipped(original):
  def train_step(config, state, batch, grad_transform=None):
    params = [*state.network.parameters(),
              *state.target_network.parameters()]
    kept = [p.detach().clone() for p in params]
    adam = {p: {k: v.clone() for k, v in state.optimizer.state.get(p, {})
                .items() if torch.is_tensor(v)}
            for p in state.network.parameters()}
    state, metrics = original(config, state, batch, grad_transform)
    with torch.no_grad():
      for p, k in zip(params, kept):
        p.copy_(k)
      # A moment or count the step created reads as a fresh Adam's: zero.
      for p, before in adam.items():
        for key, v in state.optimizer.state.get(p, {}).items():
          if not torch.is_tensor(v):
            continue
          if key in before:
            v.copy_(before[key])
          else:
            v.zero_()
    return state, metrics
  return train_step


def _sync_skipped(original):
  def train_step(config, state, batch, grad_transform=None):
    return original(dataclasses.replace(config, target_update_period=2**62),
                    state, batch, grad_transform)
  return train_step


FAULTS = {
    'state_unchanged': Fault('ble_tpu_torch.env.env', 'step_batched',
                             _state_unchanged),
    'reward_altered': Fault('ble_tpu_torch.env.env', 'step_outcome',
                            _reward_altered),
    'action_altered': Fault('ble_tpu_torch.agents.station_seeker',
                            'pick_action', _turned),
    'q_action_altered': Fault('ble_tpu_torch.agents.qrdqn', 'epsilon_greedy',
                              _turned),
    'half_batch': Fault('ble_tpu_torch.agents.qrdqn', 'quantile_loss',
                        _half_batch),
    'update_skipped': Fault('ble_tpu_torch.agents.qrdqn', 'train_step',
                            _update_skipped),
    'sync_skipped': Fault('ble_tpu_torch.agents.qrdqn', 'train_step',
                          _sync_skipped),
}
