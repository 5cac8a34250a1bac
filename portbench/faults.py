"""Faults planted in the program, underneath the harness, to show that
the check fails them: each rebinds one function of the port for the
length of a run (calibrate.py --fault, and the CPU tests).

  state_unchanged  the env step hands back the state it was given
  reward_altered   the env step's rewards are off by 1e-3
  action_altered   the policy's actions are turned by one (mod 3)
  half_batch       QR-DQN's loss is the mean over half of the batch
  update_skipped   the train step leaves the network unchanged
  sync_skipped     the train step never sets the target network
"""

import importlib

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
  def optimizer_step(state, loss, learning_rate, target_update_period,
                     grad_transform=None):
    state.train_steps += 1
  return optimizer_step


def _sync_skipped(original):
  def optimizer_step(state, loss, learning_rate, target_update_period,
                     grad_transform=None):
    original(state, loss, learning_rate, 2**62, grad_transform)
  return optimizer_step


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
    'update_skipped': Fault('ble_tpu_torch.agents.qrdqn', 'optimizer_step',
                            _update_skipped),
    'sync_skipped': Fault('ble_tpu_torch.agents.qrdqn', 'optimizer_step',
                          _sync_skipped),
}
