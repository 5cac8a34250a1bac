"""QR-DQN (the port's agents/qrdqn.py): its train config, weights, eval
policy, captured entry points, numbers against reference/qrdqn.py and
work, for the runners (policies/__init__.py lists what each gives).

The check's numbers: policy_q (the network's values against the
reference's, relative to the largest), policy (the chosen action's gap
below the best of the program's own values, exact), and for training the
learner's (`learner_numbers`) over the first train steps and the
window's run across a target sync (check.Capture.learn).
"""

import contextlib
import math

import torch

from portbench import check
from portbench import harness
from portbench import workcount
from portbench.reference import qrdqn as ref_qrdqn


def train_config(cfg, num_envs: int):
  from ble_tpu_torch.agents import qrdqn as qrdqn_lib
  from ble_tpu_torch.agents import replay as replay_lib
  from ble_tpu_torch.train import learner as learner_lib
  q = cfg['qrdqn']
  return learner_lib.TrainConfig(
      agent='quantile', num_envs=num_envs,
      samples_per_insert=q['samples_per_insert'],
      use_marco_polo=q['marco_polo'], epsilon_train=q['epsilon_train'],
      qrdqn=qrdqn_lib.QrDqnConfig(
          num_actions=q['num_actions'], num_atoms=q['num_atoms'],
          num_layers=q['num_layers'], hidden_units=q['hidden_units'],
          gamma=q['gamma'], learning_rate=q['learning_rate'],
          adam_eps=q['adam_eps'],
          target_update_period=q['target_update_period'],
          min_replay_history=q['min_replay_history']),
      replay=replay_lib.ReplayConfig(ring_len=cfg['ring_len'],
                                     n_step=q['n_step'], gamma=q['gamma'],
                                     batch_size=q['batch_size']))


def widths(cfg, obs_dim: int):
  q = cfg['qrdqn']
  return workcount.qrdqn_widths(obs_dim, q['num_layers'], q['hidden_units'],
                                q['num_actions'], q['num_atoms'])


def weights(seed: int, cfg, obs_dim: int, device):
  """The quantile network's dense layers from the seed, on the device, in
  one draw: kernels uniform in +-sqrt(sqrt(3) / fan_in) (the upstream
  variance_scaling(1/sqrt(3), fan_in, uniform)), biases zero."""
  w = widths(cfg, obs_dim)
  gen = torch.Generator(device=device).manual_seed(seed ^ 0x5eed)
  sizes = [a * b for a, b in zip(w[:-1], w[1:])]
  flat = torch.rand(sum(sizes), generator=gen, device=device)
  out, at = [], 0
  for (a, b), n in zip(zip(w[:-1], w[1:]), sizes):
    limit = math.sqrt(math.sqrt(3.0) / a)
    out.append(((2.0 * flat[at:at + n] - 1.0).view(b, a) * limit,
                torch.zeros(b, device=device)))
    at += n
  return out


def load(train_state, weights):
  from ble_tpu_torch.agents import qrdqn as qrdqn_lib
  qrdqn_lib.load_params(train_state.learner, harness.state_dict_of(weights))


def eval_policy(cfg, num_envs: int, weights, device):
  from ble_tpu_torch.agents import qrdqn as qrdqn_lib
  from ble_tpu_torch.train import learner as learner_lib
  q = cfg['qrdqn']
  network = harness.module_on(
      qrdqn_lib.networks.QuantileNetwork, weights, device,
      obs_dim=weights[0][0].shape[1], num_actions=q['num_actions'],
      num_layers=q['num_layers'], hidden_units=q['hidden_units'],
      num_atoms=q['num_atoms'])
  policy = learner_lib.make_eval_policy(train_config(cfg, num_envs), network)
  return policy.init, policy.step


def install(capture, cfg, train_config, chunk: int):
  """qrdqn.q_values (the values it returns are noted for the next kept
  record); for training also the actor (select_action, once an env step,
  with its network's weights kept), replay.sample (a kept sample is drawn
  eagerly, with the ring rows its draws read) and qrdqn.train_step."""
  from ble_tpu_torch.agents import qrdqn as qrdqn_lib
  from ble_tpu_torch.agents import replay as replay_lib

  def wrap_q_values(original):
    def q_values(network, obs):
      q = original(network, obs)
      capture.noted['q'] = q
      return q
    return q_values
  capture.rebind(qrdqn_lib, 'q_values', wrap_q_values)
  if train_config is None:
    return
  capture.learn(chunk, train_config.qrdqn.target_update_period)

  def wrap_select(original):
    def select_action(config, network, obs, generator=None, epsilon=0.0):
      t = capture.actor_step()
      actions = original(config, network, obs, generator, epsilon)
      capture.keep_policy(t, obs, actions, lambda: {'params': [
          (l.weight.detach().clone(), l.bias.detach().clone())
          for l in network.layers]})
      return actions
    return select_action

  def wrap_sample(original):
    def sample(state, config, generator):
      runs = capture.sample_runs()
      if not runs:
        return original(state, config, generator)
      draws = replay_lib.draw(state, config, generator)
      env_idx = draws['env_idx'].to(state.obs.device)
      t = min(state.total, config.ring_len)
      ring = {k: getattr(state, k)[env_idx, :t].clone()
              for k in ('obs', 'action', 'reward', 'terminal', 'valid',
                        'episode_step')}
      for run in runs:
        run['samples'].append(({k: v.clone() for k, v in draws.items()},
                               ring, state.total))
      return replay_lib.sample_from_draws(state, config, **draws)
    return sample

  capture.rebind(qrdqn_lib, 'select_action', wrap_select)
  capture.rebind(replay_lib, 'sample', wrap_sample)
  capture.rebind(qrdqn_lib, 'train_step', capture.wrap_train_step)


def spans(spans):
  from ble_tpu_torch.agents import qrdqn as qrdqn_lib
  spans.install(qrdqn_lib, 'select_action', 'policy')


def numbers(capture, weights, cfg, control=False):
  out = q_numbers(capture, weights, cfg['qrdqn']['num_actions'], control)
  if capture.train is not None:
    out.update(learner_numbers(capture, weights, cfg, control))
  return out


def work(cfg, obs_dim: int, batch: int):
  """A train step's online forward and backward (twice the forward) and
  target forward over the batch; the actor's forward of one row."""
  w = widths(cfg, obs_dim)
  return {'train_step': workcount.qrdqn_grad_step_flops(w, batch),
          'actor_row': workcount.mlp_forward_flops(w)}


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
      with check.tf32():
        _, got = ref_qrdqn.forward(params, r['obs'], num_actions)
    scale = max(float(q_ref.abs().max()), 1e-30)
    worst_q = max(worst_q, check.max_abs(got, q_ref) / scale)
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
             for draws, ring, total in run['samples']]
  entry = run['entry']
  online, target = ([(leaves[2 * i], leaves[2 * i + 1])
                     for i in range(len(leaves) // 2)]
                    for leaves in entry['networks'])
  with check.tf32() if control else contextlib.nullcontext():
    losses, grads, after, target_after = ref_qrdqn.train(
        online, batches, q['num_actions'], q['learning_rate'], q['adam_eps'],
        target=target, moments=(entry['exp_avg'], entry['exp_avg_sq']),
        step0=entry['train_steps'], sync_period=q['target_update_period'])
  return batches, losses, grads, (after, target_after)


def run_numbers(run, want, got, keep, with_target):
  """loss, grad, change and (with_target) target of a captured run
  (`got`: the program's losses, first gradient and networks after)
  against the reference's (`want`: its batches, losses, first gradient
  and networks after)."""
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
          sample = max(sample, check.max_abs(batch[k].to(torch.float32),
                                             v.to(torch.float32)))
      out[prefix + 'sample'] = sample
    numbers = run_numbers(run, want, got, keep, with_target=bool(prefix))
    out.update({prefix + k: v for k, v in numbers.items()})
  return out
