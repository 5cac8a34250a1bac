"""R2D2, plain: the recurrent quantile network (a ReLU torso, one LSTM
cell, a duelling quantile head), its sequence sample from the replay
ring, the 1-step double-DQN quantile-regression loss over a window with
burn-in, and Adam with the periodic target sync, written out from the
upstream description (balloon_learning_environment/acme_utils.py:100-157,
280-285; Kapturowski et al. 2019, "Recurrent Experience Replay in
Distributed Reinforcement Learning"; Dabney et al. 2018; Kingma and Ba
2015).

A network is a dict: 'torso', a list of (weight (out, in), bias (out,))
pairs, each followed by a ReLU; 'lstm', (w_x (4U, H), w_h (4U, U), b
(4U,)), one bias a gate as flax's OptimizedLSTMCell, gate rows i, f, g,
o; 'head', the duelling head's [(hidden), (value), (advantage)] pairs,
or [(out)] without duelling. The LSTM cell is written out as two matrix
products and its gate nonlinearities; the carry is (c, h), each (B, U).
An action's value is the mean of its quantiles.

Departures from the upstream description, which the program keeps:
  * the LSTM has one bias a gate; the program's input-side bias is a
    frozen zero beside it, so it does not appear here;
  * non-finite observation rows and rewards are zeroed before the
    networks run in the loss (the program's quarantine, documented in
    its agents/r2d2.py), so the loss and its gradient stay finite.
"""

import torch


class Float32:
  """While entered, float32 matrix products and cuDNN calls stay float32 on
  the card instead of TF32: the reference's precision."""

  def __enter__(self):
    self._saved = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return self

  def __exit__(self, *exc):
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = self._saved
    return False


def leaves(params):
  """The network's tensors in a fixed order: torso, LSTM, head."""
  out = [t for pair in params['torso'] for t in pair]
  out += list(params['lstm'])
  out += [t for pair in params['head'] for t in pair]
  return out


def from_leaves(flat, torso_layers: int):
  """The network of `leaves`' order."""
  torso = [(flat[2 * i], flat[2 * i + 1]) for i in range(torso_layers)]
  at = 2 * torso_layers
  rest = flat[at + 3:]
  return {'torso': torso, 'lstm': tuple(flat[at:at + 3]),
          'head': [(rest[2 * i], rest[2 * i + 1])
                   for i in range(len(rest) // 2)]}


def torso(params, x):
  for w, b in params['torso']:
    x = torch.relu(x @ w.T + b)
  return x


def lstm_cell(params, x_proj, carry):
  """One step from carry (c, h), with x_proj = x @ w_x.T already taken."""
  _, w_h, b = params['lstm']
  c, h = carry
  z = x_proj + h @ w_h.T + b
  i, f, g, o = z.chunk(4, dim=-1)
  c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
  h = torch.sigmoid(o) * torch.tanh(c)
  return c, h


def head(params, y, num_actions: int):
  """Quantiles (..., A, N) of LSTM outputs (..., U)."""
  if len(params['head']) == 3:
    (w0, b0), (wv, bv), (wa, ba) = params['head']
    y = torch.relu(y @ w0.T + b0)
    value = y @ wv.T + bv
    adv = (y @ wa.T + ba).unflatten(-1, (num_actions, -1))
    return value[..., None, :] + adv - adv.mean(dim=-2, keepdim=True)
  (w, b), = params['head']
  return (y @ w.T + b).unflatten(-1, (num_actions, -1))


def unroll(params, obs, carry, num_actions: int):
  """The network over obs (B, T, D) from carry (c, h): (the carry after
  the last step, quantiles (B, T, A, N), values (B, T, A)). The torso,
  the input side of the cell and the head take every row at once; the
  recurrence goes step by step."""
  x_proj = torso(params, obs) @ params['lstm'][0].T
  outs = []
  for t in range(obs.shape[1]):
    carry = lstm_cell(params, x_proj[:, t], carry)
    outs.append(carry[1])
  quantiles = head(params, torch.stack(outs, dim=1), num_actions)
  return carry, quantiles, quantiles.mean(dim=-1)


def step(params, obs, carry, num_actions: int):
  """The actor's step over obs (B, D): (carry, quantiles (B, A, N),
  values (B, A))."""
  carry, quantiles, q = unroll(params, obs[:, None], carry, num_actions)
  return carry, quantiles[:, 0], q[:, 0]


def zero_carry(params, batch: int):
  units = params['lstm'][1].shape[1]
  z = params['lstm'][1].new_zeros((batch, units))
  return z, z.clone()


def sequence_sample(ring, draws, total: int, ring_len: int, seq_len: int):
  """A batch of windows of seq_len + 1 ring slots, from `ring`, the
  sampled envs' whole rows of the replay ring (obs (B, T, D), action,
  reward, terminal, valid, episode_step (B, T), T = ring_len), and the
  sample's draws: the first step g = oldest + time_draw mod (hi -
  oldest), with oldest the first step the ring still holds and hi =
  total - seq_len (at least oldest + 1), and the window's slots g .. g +
  seq_len mod ring_len. step_weight (B, seq_len) is 1 where step t's
  transition to t + 1 counts: both slots written in one episode (the
  episode's step counts on from the window's first slot), no terminal
  before t in the window, and its observations and reward finite."""
  oldest = max(0, total - ring_len)
  hi = max(oldest + 1, total - seq_len)
  g = oldest + torch.remainder(draws['time_draw'].to(torch.int64),
                               max(hi - oldest, 1))
  ts = torch.arange(seq_len + 1, device=g.device)
  slots = torch.remainder(g[:, None] + ts, ring_len)
  rows = torch.arange(g.shape[0], device=g.device)[:, None]
  get = lambda k: ring[k][rows, slots]
  obs, reward = get('obs').to(torch.float32), get('reward')
  terminal, valid = get('terminal').to(torch.bool), get('valid').to(
      torch.bool)
  episode_step = get('episode_step').to(torch.int64)
  same_episode = episode_step == episode_step[:, :1] + ts
  ended_before = torch.zeros_like(terminal)
  for t in range(1, seq_len + 1):
    ended_before[:, t] = ended_before[:, t - 1] | terminal[:, t - 1]
  finite = torch.isfinite(obs).all(dim=-1)
  weight = (valid[:, :-1] & same_episode[:, 1:] & ~ended_before[:, :-1] &
            finite[:, :-1] & finite[:, 1:] & torch.isfinite(reward[:, :-1]))
  return {'obs': obs, 'action': get('action'), 'reward': reward,
          'terminal': terminal, 'step_weight': weight.to(torch.float32)}


def sequence_loss(params, target_params, batch, cfg):
  """The weighted mean, over the windows' steps from burn_in on, of the
  quantile Huber loss of step t's taken action's quantiles against
  r_t + gamma (1 - terminal_t) x the target network's quantiles at step
  t + 1 and the online network's greedy action there; both networks
  unroll the whole window from a zero carry. cfg: num_actions, gamma,
  kappa, burn_in."""
  obs, reward = batch['obs'], batch['reward']
  obs = torch.where(torch.isfinite(obs).all(-1, keepdim=True), obs, 0.0)
  reward = torch.where(torch.isfinite(reward), reward, 0.0)
  b, length = obs.shape[0], obs.shape[1] - 1
  a = cfg['num_actions']
  _, quant, q = unroll(params, obs, zero_carry(params, b), a)
  with torch.no_grad():
    _, tquant, _ = unroll(target_params, obs, zero_carry(target_params, b),
                          a)
    best = q[:, 1:].argmax(dim=-1)
    theta_t = torch.take_along_dim(tquant[:, 1:], best[..., None, None],
                                   2)[:, :, 0]
    alive = 1.0 - batch['terminal'][:, :-1].to(torch.float32)
    target = reward[:, :-1, None] + cfg['gamma'] * alive[..., None] * theta_t
  taken = batch['action'][:, :-1].to(torch.int64)
  theta = torch.take_along_dim(quant[:, :-1], taken[..., None, None],
                               2)[:, :, 0]
  kappa = cfg['kappa']
  n = theta.shape[-1]
  u = target[..., None, :] - theta[..., :, None]  # (B, L, predicted, target)
  huber = torch.where(u.abs() <= kappa, 0.5 * u * u,
                      kappa * (u.abs() - 0.5 * kappa))
  tau = (torch.arange(n, dtype=torch.float32, device=u.device) + 0.5) / n
  rho = (tau[:, None] - (u < 0).to(torch.float32)).abs() * huber / kappa
  per_step = rho.mean(dim=-1).sum(dim=-1)  # (B, L)
  w = batch['step_weight'] * (torch.arange(length, device=u.device) >=
                              cfg['burn_in']).to(torch.float32)
  return torch.where(w > 0, per_step * w, 0.0).sum() / w.sum().clamp_min(1.0)


def train(params, batches, cfg, target=None, moments=None, step0: int = 0,
          beta1: float = 0.9, beta2: float = 0.999):
  """Adam at cfg's learning_rate and adam_eps over `params` on `batches`
  in turn, from Adam's moments `moments` ((m, v) in `leaves`' order;
  zeros by default) after `step0` steps, against the target network
  `target` (`params` by default), which is set to the online one after
  each step whose count is a multiple of cfg's target_update_period.
  Returns (the losses, the first step's gradients, the online network's
  leaves after the last step, the target's), in `leaves`' order."""
  layers = len(params['torso'])
  flat = [t.detach().clone().requires_grad_(True) for t in leaves(params)]
  tgt = [t.detach().clone() for t in leaves(params if target is None
                                            else target)]
  if moments is None:
    m = [torch.zeros_like(t) for t in flat]
    v = [torch.zeros_like(t) for t in flat]
  else:
    m, v = ([t.clone() for t in ts] for ts in moments)
  lr, eps = cfg['learning_rate'], cfg['adam_eps']
  losses, first = [], None
  for k, batch in enumerate(batches, start=step0 + 1):
    loss = sequence_loss(from_leaves(flat, layers), from_leaves(tgt, layers),
                         batch, cfg)
    grads = torch.autograd.grad(loss, flat)
    losses.append(float(loss.detach()))
    if first is None:
      first = [g.detach().clone() for g in grads]
    with torch.no_grad():
      for p, g, mi, vi in zip(flat, grads, m, v):
        mi.mul_(beta1).add_(g, alpha=1.0 - beta1)
        vi.mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
        p.sub_(lr * (mi / (1.0 - beta1 ** k)) /
               (torch.sqrt(vi / (1.0 - beta2 ** k)) + eps))
    if k % cfg['target_update_period'] == 0:
      tgt = [p.detach().clone() for p in flat]
  return losses, first, [p.detach() for p in flat], tgt
