"""QR-DQN, plain: the quantile network's forward, its greedy action gap,
the replay's n-step sample, the quantile-regression Huber loss and Adam,
written out from the upstream description (agents/quantile_agent.py with
agents/configs/quantile.gin; Dabney et al. 2018; Kingma and Ba 2015).

A network is a list of (weight (out, in), bias (out,)) pairs; the hidden
layers take a ReLU, the last layer gives num_actions x num_atoms
quantiles, and an action's value is the mean of its quantiles.
"""

import torch


def forward(params, obs, num_actions: int):
  """Quantiles (B, A, N) and values (B, A) of observations (B, D)."""
  x = obs.to(params[0][0].dtype)
  for i, (w, b) in enumerate(params):
    x = x @ w.T + b
    if i < len(params) - 1:
      x = torch.relu(x)
  quantiles = x.reshape(x.shape[0], num_actions, -1)
  return quantiles, quantiles.mean(dim=-1)


def action_gap(params, obs, actions, num_actions: int):
  """How far the value of `actions` (B,) lies below the best value: 0
  where the action is greedy."""
  _, q = forward(params, obs, num_actions)
  mine = torch.take_along_dim(q, actions.to(torch.int64)[:, None], 1)[:, 0]
  return q.amax(-1) - mine


def n_step_sample(ring, draws, total: int, ring_len: int, n: int,
                  gamma: float):
  """An n-step batch (upstream update_horizon semantics) from `ring`, the
  sampled envs' rows of the replay ring (obs (B, T, D), action, reward,
  terminal, valid, episode_step (B, T)) with T = min(total, ring_len)
  slots, and the sample's draws: base step g = oldest + time_draw mod
  (hi - oldest) over the steps whose window g .. g + n is written."""
  oldest = max(0, total - ring_len)
  hi = max(oldest + 1, total - n)
  g = oldest + torch.remainder(draws['time_draw'].to(torch.int64),
                               max(hi - oldest, 1))
  b = g.shape[0]
  rows = torch.arange(b, device=g.device)[:, None]
  slots = torch.remainder(g[:, None] + torch.arange(n + 1,
                                                    device=g.device), ring_len)
  reward = ring['reward'][rows, slots[:, :n]]
  terminal = ring['terminal'][rows, slots[:, :n]].to(torch.bool)
  # A reward counts up to and including the first terminal.
  before = torch.ones_like(reward)
  for k in range(1, n):
    before[:, k] = before[:, k - 1] * (~terminal[:, k - 1]).to(torch.float32)
  powers = gamma ** torch.arange(n, dtype=torch.float32, device=g.device)
  n_step_reward = (reward * powers * before).sum(dim=1)
  hit = terminal.any(dim=1)
  discount = torch.where(hit, 0.0, gamma ** n)
  obs = ring['obs'][rows[:, 0], slots[:, 0]].to(torch.float32)
  next_obs = ring['obs'][rows[:, 0], slots[:, n]].to(torch.float32)
  # Coherent: the base slot was written while live, and every slot the
  # return reads up to the bootstrap lies in the same episode.
  steps = ring['episode_step'][rows, slots]
  same = steps == steps[:, :1] + torch.arange(n + 1, device=g.device)
  need = torch.cat([before > 0, ~hit[:, None]], dim=1)
  coherent = (same | ~need).all(dim=1)
  finite = (torch.isfinite(obs).all(-1) & torch.isfinite(next_obs).all(-1) &
            torch.isfinite(n_step_reward))
  weight = (coherent & ring['valid'][rows[:, 0], slots[:, 0]].to(torch.bool)
            & finite).to(torch.float32)
  return {'obs': obs, 'action': ring['action'][rows[:, 0], slots[:, 0]],
          'n_step_reward': n_step_reward, 'bootstrap_discount': discount,
          'next_obs': next_obs, 'weight': weight}


def quantile_loss(params, target_params, batch, num_actions: int,
                  kappa: float = 1.0):
  """The weighted mean over the batch of the quantile Huber loss of the
  taken action's quantiles against r + discount x the target network's
  quantiles at its own greedy action."""
  with torch.no_grad():
    tquant, tq = forward(target_params, batch['next_obs'], num_actions)
    best = tq.argmax(-1)
    theta_t = tquant[torch.arange(best.shape[0]), best]
    target = (batch['n_step_reward'][:, None] +
              batch['bootstrap_discount'][:, None] * theta_t)
  quant, _ = forward(params, batch['obs'], num_actions)
  theta = quant[torch.arange(quant.shape[0]),
                batch['action'].to(torch.int64)]
  n = theta.shape[1]
  u = target[:, None, :] - theta[:, :, None]  # (B, predicted, target)
  huber = torch.where(u.abs() <= kappa, 0.5 * u * u,
                      kappa * (u.abs() - 0.5 * kappa))
  tau = (torch.arange(n, dtype=torch.float32, device=u.device) + 0.5) / n
  rho = (tau[None, :, None] - (u < 0).to(torch.float32)).abs() * huber
  per_sample = (rho / kappa).mean(dim=2).sum(dim=1)
  w = batch['weight']
  return torch.where(w > 0, per_sample * w, 0.0).sum() / w.sum().clamp_min(1.0)


def train(params, batches, num_actions: int, lr: float, eps: float,
          beta1: float = 0.9, beta2: float = 0.999, target=None, moments=None,
          step0: int = 0, sync_period: int = 0):
  """Adam over `params` on `batches` in turn, from Adam's moments `moments`
  ((m, v) leaf lists; zeros by default) after `step0` steps, against the
  target network `target` (the starting parameters by default), which is
  set to the online one after each step whose count is a multiple of
  `sync_period` (0: never). Returns (the losses, the first step's
  gradients, the parameters after the last step, the target after it),
  leaf by leaf."""
  flat = [t.clone().requires_grad_(True) for pair in params for t in pair]
  tgt = [t.detach().clone()
         for pair in (params if target is None else target) for t in pair]
  if moments is None:
    m = [torch.zeros_like(t) for t in flat]
    v = [torch.zeros_like(t) for t in flat]
  else:
    m, v = ([t.clone() for t in ts] for ts in moments)
  pairs = lambda leaves: [(leaves[2 * i], leaves[2 * i + 1])
                          for i in range(len(params))]
  losses, first_grads = [], None
  for step, batch in enumerate(batches, start=step0 + 1):
    loss = quantile_loss(pairs(flat), pairs(tgt), batch, num_actions)
    grads = torch.autograd.grad(loss, flat)
    losses.append(float(loss.detach()))
    if first_grads is None:
      first_grads = [g.detach().clone() for g in grads]
    with torch.no_grad():
      for p, g, mi, vi in zip(flat, grads, m, v):
        mi.mul_(beta1).add_(g, alpha=1.0 - beta1)
        vi.mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
        m_hat = mi / (1.0 - beta1 ** step)
        v_hat = vi / (1.0 - beta2 ** step)
        p.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))
    if sync_period and step % sync_period == 0:
      tgt = [p.detach().clone() for p in flat]
  return losses, first_grads, [p.detach() for p in flat], tgt


def leaf_norm_gaps(got, want, keep=None):
  """Each counted leaf's |norm(got) - norm(want)| over the larger of
  norm(want) and the median leaf's norm(want); `keep` masks the leaves
  that count."""
  norms = [float(torch.linalg.vector_norm(w.double())) for w in want]
  median = sorted(norms)[len(norms) // 2]
  gaps = []
  for i, (g, w) in enumerate(zip(got, want)):
    if keep is not None and not keep[i]:
      continue
    gap = abs(float(torch.linalg.vector_norm(g.double())) - norms[i])
    gaps.append(gap / max(norms[i], median, 1e-30))
  return gaps


def leaf_norm_gap(got, want, keep=None):
  """The worst leaf's gap (leaf_norm_gaps)."""
  return max(leaf_norm_gaps(got, want, keep))


def median_leaf_norm_gap(got, want, keep=None):
  """The median leaf's gap (leaf_norm_gaps)."""
  gaps = sorted(leaf_norm_gaps(got, want, keep))
  return gaps[len(gaps) // 2]


def small_leaves(grads, share: float = 1e-3):
  """Which leaves count: those whose gradient norm is at least `share` of
  the median leaf's. The others move under Adam by round-off alone."""
  norms = [float(torch.linalg.vector_norm(g.double())) for g in grads]
  median = sorted(norms)[len(norms) // 2]
  return [n >= share * median for n in norms]


def relative_gap(got, want):
  return abs(got - want) / max(abs(want), 1e-30)

