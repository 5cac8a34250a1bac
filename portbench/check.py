"""What decides `correct`: the timed path's outputs, captured for a sample
of envs drawn from the seed, against the plain reference in reference/.

Capture wraps the port's own entry points (env.step_batched, the policy's
step, qrdqn.q_values and select_action, replay.sample, qrdqn.train_step)
by rebinding them in their modules, so the window's calls run through
them unchanged and only the sampled rows are copied. The reference runs
after the window, on the captured inputs: it follows the program step by
step from the program's own state (the env state entering a step, the
replay ring's rows), and the start (the reset) is checked by itself.

Every number compared is printed beside its limit; `correct` is true when
each number is at most its limit, and nothing else decides it.
"""

import contextlib
import dataclasses

import numpy as np
import torch

from portbench.reference import decoder as ref_decoder
from portbench.reference import qrdqn as ref_qrdqn
from portbench.reference import station_seeker as ref_seeker
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
  """

  def __init__(self, idx, steps, device):
    self.idx = idx.to(device)
    self.steps = set(steps)
    self.env = {}
    self.policy = {}
    self.train = {'batches': [], 'draws': [], 'rings': [], 'losses': []}
    self.window = None
    self.reset_obs = None
    self._last_q = None
    self._undo = []

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
    self._undo.append(rebind(env_lib, 'step_batched', wrap))

  def wrap_policy_step(self, step, period: int):
    """The eval policy's step, keeping the observation, the action and
    (for a network) its values of the calls that follow captured steps;
    call k of each `period` follows step k - 1."""
    calls = [0]

    def policy_step(state, obs, draws):
      t = calls[0] % period - 1
      calls[0] += 1
      state, actions = step(state, obs, draws)
      if t in self.steps:
        self.policy[t] = self._policy_record(obs, actions)
      return state, actions
    return policy_step

  def _policy_record(self, obs, actions, network=None):
    rec = {'obs': obs[self.idx].clone(), 'actions': actions[self.idx].clone()}
    if self._last_q is not None:
      rec['q'] = self._last_q[self.idx].clone()
    if network is not None:
      rec['params'] = [(l.weight.detach().clone(), l.bias.detach().clone())
                       for l in network.layers]
    return rec

  def install_q_values(self, qrdqn_lib):
    def wrap(original):
      def q_values(network, obs):
        q = original(network, obs)
        self._last_q = q
        return q
      return q_values
    self._undo.append(rebind(qrdqn_lib, 'q_values', wrap))

  def install_train(self, qrdqn_lib, replay_lib, period: int,
                    sync_period: int, first_steps: int = 3):
    """The actor's network at captured env steps (select_action is called
    once an env step), and two runs of `first_steps` train steps: the
    first ones (set-up, from a fresh optimizer), and in the last env step
    of the window's first chunk (chunk 1; set-up runs chunk 0) the first
    ones whose second step ends with the target sync (`sync_period`), so
    that the third trains against the synced target. A fixed chunk, not
    the last, because the gaps grow as training goes on and the number of
    chunks in a window follows the host's speed. Of each train step: the
    replay sample's draws and the ring rows they read, the batch, the
    loss; at a run's entry the online and target networks and Adam's
    moments, the gradients the optimizer got in its first step, and both
    networks after its last."""
    calls = [0]
    self._k = 0  # The learner's train steps before the next one.
    self._armed = False
    self._pending = None
    self.window = None

    def wrap_select(original):
      def select_action(config, network, obs, generator=None, epsilon=0.0):
        t = calls[0] % period
        self._armed = t == period - 1 and calls[0] // period == 1
        calls[0] += 1
        actions = original(config, network, obs, generator, epsilon)
        if t in self.steps:
          self.policy[t] = self._policy_record(obs, actions, network)
        return actions
      return select_action

    def wrap_sample(original):
      def sample(state, config, generator):
        k = self._k
        if (self._pending is None and self._armed and k >= first_steps and
            (k + 2) % sync_period == 0):
          self._armed = False
          self._pending = {'start': k, 'draws': [], 'rings': [],
                           'batches': [], 'losses': []}
        runs = [r for r in (self.train if k < first_steps else None,
                            self._pending) if r is not None]
        if not runs:
          return original(state, config, generator)
        draws = replay_lib.draw(state, config, generator)
        env_idx = draws['env_idx'].to(state.obs.device)
        t = min(state.total, config.ring_len)
        ring = {k: getattr(state, k)[env_idx, :t].clone()
                for k in ('obs', 'action', 'reward', 'terminal', 'valid',
                          'episode_step')}
        for run in runs:
          run['draws'].append({k: v.clone() for k, v in draws.items()})
          run['rings'].append((ring, state.total))
        return replay_lib.sample_from_draws(state, config, **draws)
      return sample

    def networks(state):
      return ([p.detach().clone() for p in state.network.parameters()],
              [p.detach().clone() for p in state.target_network.parameters()])

    def moments(state, key):
      return [state.optimizer.state.get(p, {}).get(
          key, torch.zeros_like(p)).detach().clone()
              for p in state.network.parameters()]

    def wrap_train(original):
      def train_step(config, state, batch, grad_transform=None):
        k = state.train_steps
        run = (self.train if k < first_steps else
               self._pending if self._pending is not None and
               k - self._pending['start'] < first_steps else None)
        if run is None:
          self._k = k + 1
          return original(config, state, batch, grad_transform)
        slot = k if run is self.train else k - run['start']
        if slot == 0 and run is not self.train:
          run['entry'] = {'networks': networks(state),
                          'exp_avg': moments(state, 'exp_avg'),
                          'exp_avg_sq': moments(state, 'exp_avg_sq'),
                          'train_steps': k}
        run['batches'].append({k: v.clone() for k, v in batch.items()})
        state, metrics = original(config, state, batch, grad_transform)
        self._k = state.train_steps
        run['losses'].append(metrics['loss'].detach().clone())
        if slot == 0:
          run['grad'] = [torch.zeros_like(p) if p.grad is None else
                         p.grad.detach().clone()
                         for p in state.network.parameters()]
        if slot == first_steps - 1:
          run['after'] = networks(state)
          if run is self._pending:
            self.window, self._pending = run, None
        return state, metrics
      return train_step

    self._undo.append(rebind(qrdqn_lib, 'select_action', wrap_select))
    self._undo.append(rebind(replay_lib, 'sample', wrap_sample))
    self._undo.append(rebind(qrdqn_lib, 'train_step', wrap_train))


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


def _max_abs(a, b) -> float:
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
  out = {'reset_obs': _max_abs(capture.reset_obs, ref_reset)}
  ref_steps = {t: reference_step(env_cfg, rec)
               for t, rec in sorted(capture.env.items())}
  out['step_obs'] = max(_max_abs(capture.env[t]['obs'], o)
                        for t, (o, _) in ref_steps.items())
  out['step_gp'] = max(_max_abs(capture.env[t]['alpha'], a)
                       for t, (_, a) in ref_steps.items())
  out['reward'] = max(
      _max_abs(rec['reward'], reference_reward(env_cfg, rec['balloon']))
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
      'reset_obs': _max_abs(ctl_reset, ref_reset),
      'step_obs': max(_max_abs(ctl_steps[t][0], ref_steps[t][0])
                      for t in ref_steps),
      'step_gp': max(_max_abs(ctl_steps[t][1], ref_steps[t][1])
                     for t in ref_steps),
  }


def seeker_numbers(capture):
  """policy: how far StationSeeker's chosen actions score below the best
  level under the reference's scores of the same observations (exact)."""
  return {'policy': max(float(ref_seeker.action_gap(r['obs'],
                                                    r['actions']).max())
                        for r in capture.policy.values())}


def q_numbers(capture, weights, num_actions, control=False):
  """policy_q: the network's values against the reference's, relative to
  the largest; policy: how far the chosen action's value lies below the
  best of the program's own values (exact)."""
  worst_q, worst_gap = 0.0, 0.0
  for r in capture.policy.values():
    params = r.get('params', weights)
    _, q_ref = ref_qrdqn.forward(params, r['obs'], num_actions)
    got = r['q']
    if control:
      with tf32():
        _, got = ref_qrdqn.forward(params, r['obs'], num_actions)
    scale = max(float(q_ref.abs().max()), 1e-30)
    worst_q = max(worst_q, _max_abs(got, q_ref) / scale)
    chosen = torch.take_along_dim(r['q'], r['actions'].to(torch.int64)[:, None],
                                  1)[:, 0]
    worst_gap = max(worst_gap, float((r['q'].amax(-1) - chosen).max()))
  if control:
    return {'policy_q': worst_q}
  return {'policy_q': worst_q, 'policy': worst_gap}


def _train_run(run, cfg, control=False):
  """The reference's train steps from a captured run's entry state, on the
  n-step batches it draws itself from the captured ring rows and draws."""
  q = cfg['qrdqn']
  batches = [ref_qrdqn.n_step_sample(ring, draws, total, cfg['ring_len'],
                                     q['n_step'], q['gamma'])
             for (ring, total), draws in zip(run['rings'], run['draws'])]
  entry = run['entry']
  online, target = ([(leaves[2 * i], leaves[2 * i + 1])
                     for i in range(len(leaves) // 2)]
                    for leaves in entry['networks'])
  with tf32() if control else contextlib.nullcontext():
    losses, grads, after, target_after = ref_qrdqn.train(
        online, batches, q['num_actions'], q['learning_rate'], q['adam_eps'],
        target=target, moments=(entry['exp_avg'], entry['exp_avg_sq']),
        step0=entry['train_steps'], sync_period=q['target_update_period'])
  return batches, losses, grads, (after, target_after)


def _run_numbers(run, want, got, keep, with_target):
  """loss, grad, change and (with_target) target of a captured run
  (`got`: the program's losses, first gradient and networks after)
  against the reference's (`want`)."""
  _, losses, grads, (after, target_after) = want
  g_losses, g_grads, (g_after, g_target) = got
  online0, target0 = run['entry']['networks']
  delta = lambda xs, x0: [a - b for a, b in zip(xs, x0)]
  out = {
      'loss': max(ref_qrdqn.relative_gap(g, r)
                  for g, r in zip(g_losses, losses)),
      'grad': ref_qrdqn.leaf_norm_gap(g_grads, grads),
      'change': ref_qrdqn.median_leaf_norm_gap(
          delta(g_after, online0), delta(after, online0), keep),
  }
  if with_target:
    out['target'] = ref_qrdqn.leaf_norm_gap(
        delta(g_target, target0), delta(target_after, target0), keep)
  return out


def learner_numbers(capture, weights, cfg, control=False):
  """The learner's numbers, of the first train steps (set-up) and of the
  window's run across a target sync (names prefixed `window_`), each
  against the reference's train steps from the run's entry state:
  sample (the batches, exact), loss (the worst relative gap of the
  losses), grad (the worst leaf's gap of the first step's gradient norm,
  the program's as its optimizer got it), change (the median leaf's gap
  of the online network's change norm after the run) and, for the
  window, target (the worst leaf's gap of the target network's change
  norm, across its sync). Leaves count where the reference's first
  gradient is at least a thousandth of the median leaf's (Adam moves the
  others by round-off alone). The first steps start from `weights`, the
  benchmark's own, and a fresh Adam; the window's from the program's
  state at the run's entry. With `control`, the reference in TF32 in the
  program's place."""
  leaves = [t for pair in weights for t in pair]
  zeros = [torch.zeros_like(t) for t in leaves]
  capture.train['entry'] = {'networks': (leaves, leaves), 'exp_avg': zeros,
                            'exp_avg_sq': zeros, 'train_steps': 0}
  out = {}
  for prefix, run in (('', capture.train), ('window_', capture.window)):
    if run is None:
      continue
    want = _train_run(run, cfg)
    keep = ref_qrdqn.small_leaves(want[2])
    if control:
      _, c_losses, c_grads, c_nets = _train_run(run, cfg, control=True)
      got = (c_losses, c_grads, c_nets)
    else:
      got = ([float(x) for x in run['losses']], run['grad'], run['after'])
      sample = 0.0
      for batch, ref_batch in zip(run['batches'], want[0]):
        for k, v in ref_batch.items():
          sample = max(sample, _max_abs(batch[k].to(torch.float32),
                                        v.to(torch.float32)))
      out[prefix + 'sample'] = sample
    numbers = _run_numbers(run, want, got, keep, with_target=bool(prefix))
    out.update({prefix + k: v for k, v in numbers.items()})
  return out


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
