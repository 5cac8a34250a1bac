"""R2D2 (the port's agents/r2d2.py on networks.LstmQuantileNetwork): its
train config, weights, captured entry points, numbers against
reference/r2d2.py and work, for the runners (policies/__init__.py lists
what each gives). It has no eval traffic.

The check's numbers: policy_q (the actor's values against the
reference's one LSTM step from the carry the actor was given, relative to
the largest), policy_carry (the actor's new carry (c, h) against the
reference's, relative to the largest), policy (the chosen action's gap
below the best of the program's own values, exact), and the learner's
over the first train steps and the window's run across a target sync
(check.Capture.learn): sample and window_sample (the windows, exact) and
the loss, gradient, change and target numbers by QR-DQN's rules
(policies/qrdqn.run_numbers).
"""

import contextlib
import math

import torch

from portbench import check
from portbench import workcount
from portbench.policies.qrdqn import run_numbers
from portbench.reference import qrdqn as ref_qrdqn
from portbench.reference import r2d2 as ref_r2d2

# The configuration's keys that R2d2Config takes as they are.
NETWORK_KEYS = ('num_actions', 'num_atoms', 'torso_layers', 'hidden_units',
                'lstm_units', 'duelling', 'gamma', 'kappa', 'learning_rate',
                'adam_eps', 'target_update_period', 'min_replay_history',
                'seq_len', 'burn_in', 'priority_eta', 'stored_state')
# The port's parameter the reference lacks: nn.LSTM's input-side bias, a
# frozen zero beside the recurrent side's (the reference's one bias).
FROZEN = 'lstm.bias_ih_l0'
# The ring's fields a kept sample copies for the reference's sequence_sample.
RING_KEYS = ('obs', 'action', 'reward', 'terminal', 'valid', 'episode_step')


def train_config(cfg, num_envs: int):
  from ble_tpu_torch.agents import r2d2 as r2d2_lib
  from ble_tpu_torch.agents import replay as replay_lib
  from ble_tpu_torch.train import learner as learner_lib
  r = cfg['r2d2']
  if r['stored_state']:
    raise ValueError('the reference unrolls from a zero carry: '
                     'stored_state must be false')
  return learner_lib.TrainConfig(
      agent='r2d2', num_envs=num_envs,
      samples_per_insert=r['samples_per_insert'],
      use_marco_polo=r['marco_polo'], epsilon_train=r['epsilon_train'],
      r2d2=r2d2_lib.R2d2Config(**{k: r[k] for k in NETWORK_KEYS}),
      replay=replay_lib.ReplayConfig(ring_len=cfg['ring_len'],
                                     gamma=r['gamma'],
                                     batch_size=r['batch_size']))


def weights(seed: int, cfg, obs_dim: int, device):
  """The network's parameters from the seed, on the device, as a state
  dict in parameters() order, by the upstream initializers: dense kernels
  uniform in +-sqrt(sqrt(3) / fan_in) (variance_scaling(1/sqrt(3),
  fan_in, uniform)), each gate's input kernel lecun-normal (a normal
  truncated to +-2, scaled by sqrt(1 / fan_in) / 0.8796), each gate's
  recurrent kernel orthogonal, every bias zero. The names and shapes are
  the port network's, built on the meta device."""
  from ble_tpu_torch.agents import r2d2 as r2d2_lib
  config = train_config(cfg, 1).r2d2
  with torch.device('meta'):
    shapes = [(n, p.shape) for n, p in
              r2d2_lib.make_network(config, obs_dim).named_parameters()]
  u = config.lstm_units
  gen = torch.Generator(device=device).manual_seed(seed ^ 0x5eed)
  out = {}
  for name, shape in shapes:
    if name == 'lstm.weight_ih_l0':
      w = torch.empty(shape, device=device)
      torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
      out[name] = w * (math.sqrt(1.0 / shape[1]) / 0.87962566103423978)
    elif name == 'lstm.weight_hh_l0':
      q, rr = torch.linalg.qr(torch.randn((4, u, u), generator=gen,
                                          device=device))
      out[name] = (q * torch.sign(torch.diagonal(rr, dim1=-2, dim2=-1))[
          :, None, :]).reshape(shape)
    elif name.endswith('.weight'):
      limit = math.sqrt(math.sqrt(3.0) / shape[1])
      out[name] = (2.0 * torch.rand(shape, generator=gen, device=device) -
                   1.0) * limit
    else:
      out[name] = torch.zeros(shape, device=device)
  return out


def load(train_state, weights):
  from ble_tpu_torch.agents import qrdqn as qrdqn_lib
  qrdqn_lib.load_params(train_state.learner, weights)


def eval_policy(cfg, num_envs: int, weights, device):
  raise NotImplementedError('R2D2 has no eval traffic in the benchmark')


def install(capture, cfg, train_config, chunk: int):
  """For training: the actor (r2d2.actor_select, once an env step, with
  the carry it was given, the carry it returns and its network's weights
  kept; the values it chose from are noted from qrdqn.epsilon_greedy),
  replay.sample_sequence (a kept sample is drawn eagerly, with the whole
  ring rows of the envs its draws read) and r2d2.train_step."""
  from ble_tpu_torch.agents import qrdqn as qrdqn_lib
  from ble_tpu_torch.agents import r2d2 as r2d2_lib
  from ble_tpu_torch.agents import replay as replay_lib
  if train_config is None:
    return
  capture.learn(chunk, train_config.r2d2.target_update_period)
  rows = lambda xs: [x[capture.idx].clone() for x in xs]

  def wrap_greedy(original):
    def epsilon_greedy(q, num_actions, generator=None, epsilon=0.0):
      capture.noted['q'] = q
      return original(q, num_actions, generator, epsilon)
    return epsilon_greedy

  def wrap_select(original):
    def actor_select(config, network, carry, obs, generator=None,
                     epsilon=0.0):
      t = capture.actor_step()
      carry_in = rows(carry) if t in capture.steps else None
      new_carry, actions = original(config, network, carry, obs, generator,
                                    epsilon)
      capture.keep_policy(t, obs, actions, lambda: {
          'carry_in': carry_in, 'carry': rows(new_carry),
          'params': [p.detach().clone() for p in network.parameters()]})
      return new_carry, actions
    return actor_select

  def wrap_sample(original):
    def sample_sequence(state, config, generator, seq_len):
      runs = capture.sample_runs()
      if not runs:
        return original(state, config, generator, seq_len)
      draws = replay_lib.draw_sequence(state, config, generator)
      env_idx = draws['env_idx'].to(state.obs.device)
      ring = {k: getattr(state, k)[env_idx].clone() for k in RING_KEYS}
      for run in runs:
        run['samples'].append(({k: v.clone() for k, v in draws.items()},
                               ring, state.total))
      return replay_lib.sample_sequence_from_draws(state, config, seq_len,
                                                   **draws)
    return sample_sequence

  capture.rebind(qrdqn_lib, 'epsilon_greedy', wrap_greedy)
  capture.rebind(r2d2_lib, 'actor_select', wrap_select)
  capture.rebind(replay_lib, 'sample_sequence', wrap_sample)
  capture.rebind(r2d2_lib, 'train_step', capture.wrap_train_step)


def spans(spans):
  from ble_tpu_torch.agents import r2d2 as r2d2_lib
  from ble_tpu_torch.agents import replay as replay_lib
  spans.install(r2d2_lib, 'actor_select', 'policy')
  spans.install(replay_lib, 'sample_sequence', 'seq_sample')
  spans.install(r2d2_lib, 'sequence_loss', 'seq_loss')


def numbers(capture, weights, cfg, control=False):
  """The reference in float32 (TF32 off), or in TF32 for the control."""
  with ref_r2d2.Float32():
    out = actor_numbers(capture, list(weights), cfg, control)
    if capture.train is not None:
      out.update(learner_numbers(capture, weights, cfg, control))
  return out


def forward_flops(r, obs_dim: int) -> float:
  """One row through the network: the torso's dense layers, the LSTM
  cell's two products (its gates' elementwise work left out) and the
  head's dense layers."""
  h, u = r['hidden_units'], r['lstm_units']
  out = r['num_actions'] * r['num_atoms']
  torso = workcount.mlp_forward_flops([obs_dim] + [h] * r['torso_layers'])
  head = (workcount.mlp_forward_flops([u, u]) + 2.0 * u * (r['num_atoms'] +
                                                             out)
          if r['duelling'] else 2.0 * u * out)
  return torso + 2.0 * 4 * u * (h + u) + head


def work(cfg, obs_dim: int, batch: int):
  """A train step's online unroll forward and backward (twice the
  forward) and target unroll over the batch's windows of seq_len + 1
  rows; the actor's forward of one row."""
  r = cfg['r2d2']
  row = forward_flops(r, obs_dim)
  return {'train_step': 4.0 * batch * (r['seq_len'] + 1) * row,
          'actor_row': row}


def _reference_leaves(names, leaves):
  """The port's leaves in parameters() order as the reference's (the
  frozen input-side bias left out)."""
  return [t for n, t in zip(names, leaves) if n != FROZEN]


def _network(names, leaves, cfg):
  return ref_r2d2.from_leaves(_reference_leaves(names, leaves),
                              cfg['r2d2']['torso_layers'])


def actor_numbers(capture, names, cfg, control=False):
  """policy_q, policy_carry and (not for the control) policy, over the
  kept actor steps."""
  a = cfg['r2d2']['num_actions']
  worst_q, worst_carry, worst_gap = 0.0, 0.0, 0.0
  for rec in capture.policy.values():
    params = _network(names, rec['params'], cfg)
    carry_in = tuple(rec['carry_in'])
    carry_ref, _, q_ref = ref_r2d2.step(params, rec['obs'], carry_in, a)
    got_carry, got_q = rec['carry'], rec['q']
    if control:
      with check.tf32():
        got_carry, _, got_q = ref_r2d2.step(params, rec['obs'], carry_in, a)
    scale = max(float(q_ref.abs().max()), 1e-30)
    worst_q = max(worst_q, check.max_abs(got_q, q_ref) / scale)
    for got, want in zip(got_carry, carry_ref):
      worst_carry = max(worst_carry, check.max_abs(got, want) /
                        max(float(want.abs().max()), 1e-30))
    chosen = torch.take_along_dim(rec['q'], rec['actions'].to(
        torch.int64)[:, None], 1)[:, 0]
    worst_gap = max(worst_gap, float((rec['q'].amax(-1) - chosen).max()))
  out = {'policy_q': worst_q, 'policy_carry': worst_carry}
  if not control:
    out['policy'] = worst_gap
  return out


def _train_run(run, names, cfg, control=False):
  """The reference's train steps from a captured run's entry state, on
  the windows it draws itself from the captured ring rows and draws."""
  r = cfg['r2d2']
  batches = [ref_r2d2.sequence_sample(ring, draws, total, cfg['ring_len'],
                                      r['seq_len'])
             for draws, ring, total in run['samples']]
  entry = run['entry']
  online, target = (_network(names, leaves, cfg)
                    for leaves in entry['networks'])
  moments = tuple(_reference_leaves(names, entry[k])
                  for k in ('exp_avg', 'exp_avg_sq'))
  with check.tf32() if control else contextlib.nullcontext():
    losses, grads, after, target_after = ref_r2d2.train(
        online, batches, r, target=target, moments=moments,
        step0=entry['train_steps'])
  return batches, losses, grads, (after, target_after)


def learner_numbers(capture, weights, cfg, control=False):
  """The learner's numbers of the first train steps (set-up, from the
  benchmark's weights and a fresh Adam) and of the window's run across a
  target sync (prefixed `window_`, from the program's state at its
  entry), each against the reference's train steps, by QR-DQN's rules
  (policies/qrdqn.learner_numbers), over the reference's leaves. With
  `control`, the reference in TF32 in the program's place."""
  names, leaves = list(weights), list(weights.values())
  zeros = [torch.zeros_like(t) for t in leaves]
  capture.train['entry'] = {'networks': (leaves, leaves), 'exp_avg': zeros,
                            'exp_avg_sq': zeros, 'train_steps': 0}
  ours = lambda xs: _reference_leaves(names, xs)
  out = {}
  for prefix, run in (('', capture.train), ('window_', capture.window)):
    if run is None:
      continue
    want = _train_run(run, names, cfg)
    keep = ref_qrdqn.small_leaves(want[2])
    if control:
      _, c_losses, c_grads, c_nets = _train_run(run, names, cfg, control=True)
      got = (c_losses, c_grads, c_nets)
    else:
      got = ([float(x) for x in run['losses']], ours(run['grad']),
             tuple(ours(n) for n in run['after']))
      sample = 0.0
      for batch, ref_batch in zip(run['batches'], want[0]):
        for k, v in ref_batch.items():
          sample = max(sample, check.max_abs(batch[k].to(torch.float32),
                                             v.to(torch.float32)))
      out[prefix + 'sample'] = sample
    entry = {'entry': {'networks': tuple(ours(n) for n in
                                         run['entry']['networks'])}}
    numbers = run_numbers(entry, want, got, keep, with_target=bool(prefix))
    out.update({prefix + k: v for k, v in numbers.items()})
  return out
