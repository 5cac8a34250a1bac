"""What decides `correct`: the timed path's outputs, captured for a sample
of envs drawn from the seed, against the plain reference in reference/.

Capture wraps the port's own entry points by rebinding them in their
modules, so the window's calls run through them unchanged and only the
sampled rows are copied: env.step_batched here, and the policy's actor,
replay sample and train step from its module under policies/, which
keeps them through Capture's bookkeeping. The reference runs after the
window, on the captured inputs: it follows the program step by step from
the program's own state (the env state entering a step; the learner's
replay rows and state), and the start (the reset) is checked by itself.
This module holds what every policy shares: the capture, the env's
numbers and their control, and the decision.

Every number compared is printed beside its limit; `correct` is true when
each number is at most its limit, and nothing else decides it.
"""

import contextlib
import dataclasses

import numpy as np
import torch

from portbench.reference import decoder as ref_decoder
from portbench.reference.sim import atmosphere as ref_atmosphere
from portbench.reference.sim import balloon as ref_balloon
from portbench.reference.sim import env as ref_env
from portbench.reference.sim import safety as ref_safety
from portbench.reference.sim import wind_field as ref_wind_field
from portbench.reference.sim import wind_gp as ref_wind_gp

_REFERENCE_CLASSES = {
    'EnvState': ref_env.EnvState,
    'BalloonState': ref_balloon.BalloonState,
    'AtmosphereParams': ref_atmosphere.AtmosphereParams,
    'WindFieldState': ref_wind_field.WindFieldState,
    'WindGPState': ref_wind_gp.WindGPState,
    'PowerSafetyState': ref_safety.PowerSafetyState,
}


def rows(tree, idx):
  """A copy of rows `idx` of every tensor leaf of a dataclass tree."""
  if dataclasses.is_dataclass(tree):
    return dataclasses.replace(tree, **{
        f.name: rows(getattr(tree, f.name), idx)
        for f in dataclasses.fields(tree)})
  if tree is None:
    return None
  return tree[idx].clone()


def to_reference(tree):
  """The port's state dataclasses as the reference's, field by field."""
  if dataclasses.is_dataclass(tree):
    cls = _REFERENCE_CLASSES[type(tree).__name__]
    return cls(**{f.name: to_reference(getattr(tree, f.name))
                  for f in dataclasses.fields(tree)})
  return tree


def sample_rows(seed: int, n: int, k: int) -> torch.Tensor:
  """k distinct env rows of n, drawn from the seed, in order."""
  rng = np.random.default_rng(seed)
  return torch.from_numpy(np.sort(rng.choice(n, size=min(k, n),
                                             replace=False)))


def rebind(module, name, wrapper_of):
  """Replaces module.name by wrapper_of(original); returns an undo."""
  original = getattr(module, name)
  setattr(module, name, wrapper_of(original))
  return lambda: setattr(module, name, original)


class Capture:
  """The sampled rows of what the timed path produces.

  steps: the step indices (global_step, or the step within a chunk) whose
  inputs and outputs are kept; each call of a captured step overwrites
  the last one's, so what remains is the window's last call.

  The env step is captured here (install_env). The policy's own entry
  points are rebound by its module under policies/ (`install`), which
  calls the bookkeeping below: `keep_policy` at the actor's calls, and
  for training `learn`, `actor_step`, `sample_runs` and
  `wrap_train_step`.
  """

  def __init__(self, idx, steps, device):
    self.idx = idx.to(device)
    self.steps = set(steps)
    self.env = {}
    self.policy = {}
    # Per-env tensors the policy's wraps note for the next kept record,
    # such as a network's values.
    self.noted = {}
    self.train = None  # The first train steps' run, once `learn` starts.
    self.window = None
    self.reset_obs = None
    self._undo = []

  def rebind(self, module, name, wrapper_of):
    """module.name replaced by wrapper_of(original) until close()."""
    self._undo.append(rebind(module, name, wrapper_of))

  def close(self):
    for undo in reversed(self._undo):
      undo()
    self._undo = []

  def install_env(self, env_lib):
    def wrap(original):
      def step_batched(params, state, actions, global_step=None,
                       refresh='auto'):
        t = None if global_step is None else int(global_step)
        keep = t in self.steps
        if keep:
          rec = {'state': rows(state, self.idx),
                 'actions': actions[self.idx].clone(),
                 'global_step': t}
        out = original(params, state, actions, global_step=global_step,
                       refresh=refresh)
        if keep:
          rec.update(obs=out.observation[self.idx].clone(),
                     reward=out.reward[self.idx].clone(),
                     alpha=out.state.gp.alpha[self.idx].clone(),
                     balloon=rows(out.state.balloon, self.idx))
          self.env[t] = rec
        return out
      return step_batched
    self.rebind(env_lib, 'step_batched', wrap)

  def wrap_policy_step(self, step, period: int):
    """The eval policy's step, keeping the observation, the action and
    what the policy noted of the calls that follow captured steps; call k
    of each `period` follows step k - 1."""
    calls = [0]

    def policy_step(state, obs, draws):
      t = calls[0] % period - 1
      calls[0] += 1
      state, actions = step(state, obs, draws)
      self.keep_policy(t, obs, actions)
      return state, actions
    return policy_step

  def keep_policy(self, t, obs, actions, more=None):
    """The sampled rows of an actor call's observation, action and noted
    tensors, with the entries `more()` gives (such as the network's
    weights), kept as step t's when t is a captured step."""
    if t not in self.steps:
      return
    rec = {'obs': obs[self.idx].clone(), 'actions': actions[self.idx].clone()}
    rec.update({k: v[self.idx].clone() for k, v in self.noted.items()})
    if more is not None:
      rec.update(more())
    self.policy[t] = rec

  def learn(self, period: int, sync_period: int, first_steps: int = 3):
    """Starts keeping two runs of `first_steps` train steps: the first
    ones (set-up, from a fresh optimizer), and in the last env step of
    the window's first chunk (chunk 1 of `period` env steps; set-up runs
    chunk 0) the first ones whose second step ends with the target sync
    (`sync_period`), so that the third trains against the synced target.
    A fixed chunk, not the last, because the gaps grow as training goes on
    and the number of chunks in a window follows the host's speed. Of each
    train step a run keeps what the policy's sample wrap records of the
    replay sample (`samples`), the batch and the loss; at its entry the
    online and target networks and Adam's moments, the gradients the
    optimizer got in its first step, and both networks after its last."""
    self._period, self._sync, self._first = period, sync_period, first_steps
    self._calls = 0
    self._k = 0  # The learner's train steps before the next one.
    self._armed = False
    self._pending = None
    self.train = {'samples': [], 'batches': [], 'losses': []}
    self.window = None

  def actor_step(self) -> int:
    """The env step within its chunk of this actor call (one an env
    step); arms the window's run in chunk 1's last env step."""
    t = self._calls % self._period
    self._armed = t == self._period - 1 and self._calls // self._period == 1
    self._calls += 1
    return t

  def sample_runs(self):
    """The kept runs that take the next replay sample; empty where the
    sample is not kept."""
    k = self._k
    if (self._pending is None and self._armed and k >= self._first and
        (k + 2) % self._sync == 0):
      self._armed = False
      self._pending = {'start': k, 'samples': [], 'batches': [],
                       'losses': []}
    return [r for r in (self.train if k < self._first else None,
                        self._pending) if r is not None]

  def wrap_train_step(self, original):
    """The learner's train_step(config, state, batch, ...), keeping the
    kept runs' steps; `state` has `network`, `target_network`,
    `optimizer` and `train_steps`, as the port's learner states do."""
    first = self._first

    def networks(state):
      return ([p.detach().clone() for p in state.network.parameters()],
              [p.detach().clone() for p in state.target_network.parameters()])

    def moments(state, key):
      return [state.optimizer.state.get(p, {}).get(
          key, torch.zeros_like(p)).detach().clone()
              for p in state.network.parameters()]

    def train_step(config, state, batch, *args, **kwargs):
      k = state.train_steps
      run = (self.train if k < first else
             self._pending if self._pending is not None and
             k - self._pending['start'] < first else None)
      if run is None:
        self._k = k + 1
        return original(config, state, batch, *args, **kwargs)
      slot = k if run is self.train else k - run['start']
      if slot == 0 and run is not self.train:
        run['entry'] = {'networks': networks(state),
                        'exp_avg': moments(state, 'exp_avg'),
                        'exp_avg_sq': moments(state, 'exp_avg_sq'),
                        'train_steps': k}
      run['batches'].append({k: v.clone() for k, v in batch.items()})
      state, metrics = original(config, state, batch, *args, **kwargs)
      self._k = state.train_steps
      run['losses'].append(metrics['loss'].detach().clone())
      if slot == 0:
        run['grad'] = [torch.zeros_like(p) if p.grad is None else
                       p.grad.detach().clone()
                       for p in state.network.parameters()]
      if slot == first - 1:
        run['after'] = networks(state)
        if run is self._pending:
          self.window, self._pending = run, None
      return state, metrics
    return train_step


@contextlib.contextmanager
def tf32():
  """Float32 matrix products in TF32: the control's precision."""
  saved = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
  torch.backends.cuda.matmul.allow_tf32 = True
  torch.backends.cudnn.allow_tf32 = True
  torch.set_float32_matmul_precision('high')
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.backends.cudnn.allow_tf32 = saved[1]
    torch.set_float32_matmul_precision(saved[2])


def max_abs(a, b) -> float:
  return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def reference_env_params(env_cfg: dict):
  return ref_env.EnvParams(**env_cfg)


def reference_reset(env_cfg, seeds, decoder_weights, device):
  """The reference's observations of fresh episodes of `seeds`."""
  keys = ref_env.seed_keys(seeds)
  z = ref_decoder.sample_latent(ref_env.forecast_keys(keys)).to(device)
  field = ref_decoder.decode_in_blocks(decoder_weights, z)
  _, obs = ref_env.reset_from_field(keys, reference_env_params(env_cfg),
                                    field, device)
  return obs


def reference_step(env_cfg, rec):
  """The reference's step from a captured step's input state."""
  out = ref_env.step_batched(reference_env_params(env_cfg),
                             to_reference(rec['state']), rec['actions'],
                             global_step=rec['global_step'])
  return out.observation, out.state.gp.alpha


def reference_reward(env_cfg, balloon):
  """The reward of the program's own stepped balloons, by the reference's
  formula."""
  params = reference_env_params(env_cfg)
  b = to_reference(balloon)
  return ref_env.reward_function(
      params, b, ref_balloon.excess_energy(params.balloon, b))


def env_numbers(env_cfg, capture, reset_seeds, decoder_weights, device):
  """reset_obs, step_obs, step_gp (reference in float32) and reward
  (exact), with the reference's own outputs for the control."""
  ref_reset = reference_reset(env_cfg, reset_seeds, decoder_weights, device)
  out = {'reset_obs': max_abs(capture.reset_obs, ref_reset)}
  ref_steps = {t: reference_step(env_cfg, rec)
               for t, rec in sorted(capture.env.items())}
  out['step_obs'] = max(max_abs(capture.env[t]['obs'], o)
                        for t, (o, _) in ref_steps.items())
  out['step_gp'] = max(max_abs(capture.env[t]['alpha'], a)
                       for t, (_, a) in ref_steps.items())
  out['reward'] = max(
      max_abs(rec['reward'], reference_reward(env_cfg, rec['balloon']))
      for rec in capture.env.values())
  return out, (ref_reset, ref_steps)


def env_control(env_cfg, capture, reset_seeds, decoder_weights, device,
                reference):
  """The same numbers with the reference in TF32 in the program's place."""
  ref_reset, ref_steps = reference
  with tf32():
    ctl_reset = reference_reset(env_cfg, reset_seeds, decoder_weights, device)
    ctl_steps = {t: reference_step(env_cfg, rec)
                 for t, rec in sorted(capture.env.items())}
  return {
      'reset_obs': max_abs(ctl_reset, ref_reset),
      'step_obs': max(max_abs(ctl_steps[t][0], ref_steps[t][0])
                      for t in ref_steps),
      'step_gp': max(max_abs(ctl_steps[t][1], ref_steps[t][1])
                     for t in ref_steps),
  }


def decide(numbers: dict, limits: dict):
  """[(name, value, limit, ok)] for every number, in the limits' order;
  a number without a limit, or a limit without a number, fails."""
  out = []
  for name in list(limits) + [n for n in numbers if n not in limits]:
    value, limit = numbers.get(name), limits.get(name)
    ok = (value is not None and limit is not None and
          np.isfinite(value) and value <= limit)
    out.append((name, value, limit, ok))
  return out
