"""Recurrent quantile learner: R2D2-style sequence replay and unroll (the
port of ble_tpu/agents/r2d2.py; reference acme_utils.py:100-157, 280-285).

  * sequences come out of the replay ring on the device as strided
    gathers (replay.sample_sequence);
  * the learner unrolls the online and the target network over the whole
    (B, L+1) window (networks.LstmQuantileNetwork.unroll: the torso and the
    head once over all rows, one nn.LSTM call over the sequence) and takes
    a 1-step double-DQN quantile-regression loss at every trainable step;
    the first `burn_in` steps only warm the LSTM state;
  * the actor carries a per-env LSTM state (learner.TrainState.actor) and
    zeroes the lanes of re-initialized envs (actor_reset).

The learner state is QR-DQN's (qrdqn.LearnerState): online and target
networks, Adam at a constant rate, and a host-int train_steps.

One departure from the JAX package, on purpose: a non-finite observation
inside a window passes, in ble_tpu, through the LSTM carry into every
later step of the window, steps with weight > 0 included, so
sequence_loss's jnp.where does not keep the loss (or the gradient)
finite. Here non-finite observation rows and rewards are zeroed before the
networks run, so the loss and the gradient stay finite. The per-sequence
priorities (`per_sample_loss`) read NaN exactly where ble_tpu's do (some
step with weight > 0 depends on a non-finite value), so prioritized replay
gives those windows priority 1.0, as in ble_tpu; elsewhere every value is
ble_tpu's.
"""

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from ble_tpu_torch.agents import networks
from ble_tpu_torch.agents import qrdqn
from ble_tpu_torch.utils import profiling

LearnerState = qrdqn.LearnerState


@dataclasses.dataclass(frozen=True)
class R2d2Config:
  num_actions: int = 3
  num_atoms: int = 51
  torso_layers: int = 2
  hidden_units: int = 600
  lstm_units: int = 256
  # Duelling value/advantage head, the reference's R2D2 head shape
  # (acme_utils.py:126-142 DuellingMLP).
  duelling: bool = True
  gamma: float = 0.993
  # ble_tpu's round-4 recipe (results/r2d2_run_r4): 5e-5, with the
  # per-sequence samples-per-insert accounting of
  # learner.TrainConfig.grad_steps_per_env_step.
  learning_rate: float = 5e-5
  adam_eps: float = 0.00002
  target_update_period: int = 100
  min_replay_history: int = 500
  kappa: float = 1.0
  # Total replayed window length; the first `burn_in` steps only warm the
  # LSTM state (no loss), leaving seq_len - burn_in trainable steps.
  seq_len: int = 24
  burn_in: int = 8
  # Sequence priority: eta * max_t + (1 - eta) * mean_t of the per-step
  # losses (Kapturowski et al. 2019).
  priority_eta: float = 0.9
  # Stored-state replay: the learner's unroll starts from the actor's
  # carry recorded with the window's first transition instead of zeros
  # (2 * lstm_units floats a replay slot).
  stored_state: bool = False


def make_network(config: R2d2Config, obs_dim: int,
                 generator: Optional[torch.Generator] = None
                 ) -> networks.LstmQuantileNetwork:
  return networks.LstmQuantileNetwork(
      obs_dim, num_actions=config.num_actions, num_atoms=config.num_atoms,
      torso_layers=config.torso_layers, hidden_units=config.hidden_units,
      lstm_units=config.lstm_units, duelling=config.duelling,
      generator=generator)


def init(generator: torch.Generator, config: R2d2Config, obs_dim: int,
         device=None) -> LearnerState:
  """Fresh networks drawn from `generator` (target = online) and Adam at
  the constant rate."""
  network = make_network(config, obs_dim, generator).to(device)
  target = make_network(config, obs_dim).to(device)
  target.load_state_dict(network.state_dict())
  target.requires_grad_(False)
  return LearnerState(
      network=network, target_network=target,
      optimizer=torch.optim.Adam(network.parameters(),
                                 lr=config.learning_rate,
                                 eps=config.adam_eps))


def actor_init(network: networks.LstmQuantileNetwork, num_envs: int,
               device=None):
  """The actor's zero carry (c, h) for `num_envs` envs at episode start;
  its width is the network's."""
  return network.initial_state(num_envs, device)


def carry_to_vec(carry) -> torch.Tensor:
  """(c, h) LSTM carry -> (..., 2 * units) flat vector (replay storage)."""
  c, h = carry
  return torch.cat([c, h], dim=-1)


def vec_to_carry(vec: torch.Tensor):
  units = vec.shape[-1] // 2
  return vec[..., :units], vec[..., units:]


def actor_reset(carry, mask: torch.Tensor):
  """The carry with the lanes of the envs in `mask` (E,) zeroed."""
  return tuple(torch.where(mask[:, None], 0.0, c) for c in carry)


@torch.no_grad()
def actor_select(config: R2d2Config, network: networks.LstmQuantileNetwork,
                 carry, obs: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 epsilon: float = 0.0):
  """One recurrent policy step over the (E, D) batch: (carry, (E,) int32
  epsilon-greedy actions)."""
  with profiling.span('r2d2.select_action'):
    carry, (q, _) = network(carry, obs)
    return carry, qrdqn.epsilon_greedy(q, config.num_actions, generator,
                                       epsilon)


def sequence_loss(config: R2d2Config, network, target_network,
                  batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
  """The 1-step double-DQN quantile regression at every step of the unroll
  (ble_tpu r2d2.py:143-222).

  batch: obs (B, L+1, D), action, reward and terminal (B, L+1),
  step_weight (B, L), and start_state (B, 2 * units) for stored-state
  replay. Steps before burn_in contribute no loss (LSTM warm-up).
  Non-finite inputs are zeroed first (module docstring).
  """
  obs, reward = batch['obs'], batch['reward']
  seq_len = obs.shape[1] - 1
  bad_obs = ~torch.isfinite(obs).all(dim=-1)  # (B, L+1)
  bad_reward = ~torch.isfinite(reward)
  obs = torch.where(bad_obs[..., None], 0.0, obs)
  reward = torch.where(bad_reward, 0.0, reward)

  if config.stored_state and 'start_state' in batch:
    carry0 = vec_to_carry(batch['start_state'].detach())
  else:
    carry0 = network.initial_state(obs.shape[0], obs.device)
  with profiling.span('r2d2.unroll'):
    q_online, logits_online = network.unroll(carry0, obs)[1]
    with torch.no_grad():
      logits_target = target_network.unroll(carry0, obs)[1][1]
  profiling.count('r2d2.unroll_rows', 2 * obs.shape[0] * obs.shape[1])
  with torch.no_grad():
    # theta(s_t, a_t) for t in [0, L); the double-DQN target takes a* from
    # the ONLINE network at t+1 and its value from the target network.
    best = q_online[:, 1:].argmax(dim=-1)  # (B, L)
    target_theta = torch.take_along_dim(
        logits_target[:, 1:], best[:, :, None, None], dim=2)[:, :, 0, :]
    not_done = 1.0 - batch['terminal'][:, :-1].to(torch.float32)
    target = (reward[:, :-1, None] +
              config.gamma * not_done[:, :, None] * target_theta)
  action = batch['action'][:, :-1].to(torch.int64)
  theta = torch.take_along_dim(logits_online[:, :-1],
                               action[:, :, None, None], dim=2)[:, :, 0, :]

  u = target[..., None, :] - theta[..., :, None]  # (B, L, N, N)
  kappa = config.kappa
  abs_u = u.abs()
  huber = torch.where(abs_u <= kappa, 0.5 * u * u,
                      kappa * (abs_u - 0.5 * kappa))
  tau = (torch.arange(config.num_atoms, dtype=torch.float32,
                      device=u.device) + 0.5) / config.num_atoms
  qr_weight = (tau[None, None, :, None] - (u < 0).to(torch.float32)).abs()
  per_step = (qr_weight * huber / kappa).mean(dim=3).sum(dim=2)  # (B, L)

  w = batch['step_weight']
  if config.burn_in:
    w = w * (torch.arange(seq_len, device=w.device) >=
             config.burn_in).to(torch.float32)
  live = w > 0
  loss = (torch.where(live, per_step * w, 0.0).sum() /
          torch.clamp_min(w.sum(), 1.0))
  kept = torch.where(live, per_step.detach(), 0.0)
  priority = (config.priority_eta * kept.max(dim=1).values +
              (1.0 - config.priority_eta) * kept.sum(dim=1) /
              torch.clamp_min(live.sum(dim=1), 1).to(torch.float32))
  # ble_tpu's per-step loss at t is non-finite when a value it reads is:
  # an observation up to t + 1 (through the carry) or the reward at t.
  tainted = torch.cummax(bad_obs.to(torch.int32), dim=1).values[:, 1:] > 0
  tainted = tainted | bad_reward[:, :-1]
  priority = torch.where((tainted & live).any(dim=1), math.nan, priority)
  metrics = {
      'loss': loss,
      'mean_q': q_online.detach().mean(),
      'valid_frac': live.to(torch.float32).mean(),
      'per_sample_loss': priority,
  }
  return loss, metrics


def train_step(config: R2d2Config, state: LearnerState,
               batch: Dict[str, torch.Tensor],
               grad_transform: Optional[Callable] = None
               ) -> Tuple[LearnerState, Dict[str, torch.Tensor]]:
  """One Adam step and the periodic target sync (ble_tpu r2d2.py:225-240),
  in place; returns (state, metrics) with `loss` detached."""
  with profiling.span('r2d2.loss'):
    loss, metrics = sequence_loss(config, state.network, state.target_network,
                                  batch)
  qrdqn.optimizer_step(state, loss, config.learning_rate,
                       config.target_update_period, grad_transform)
  metrics['loss'] = loss.detach()
  return state, metrics
