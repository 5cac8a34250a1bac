"""Vectorized actor-learner on the device (the port of
ble_tpu/train/learner.py).

E envs step in lockstep through env.step_batched (B1 and B2 on the card),
write into the replay ring on the device, and the learner takes
`E * samples_per_insert / batch_size` gradient steps per env step: the
reference's samples-per-insert ratio (Acme SPI=8; Dopamine's
update_period=4 with batch 32).

Envs reset on their own: terminal (or truncated) envs freeze and are
re-initialized at chunk boundaries (selective_reset) from fresh world
seeds taken from a host counter, like the reference's per-process episodes
(balloon_arena.py:161).

The step is a Python loop over eager PyTorch; on the card a QR-DQN train
step replays two CUDA graphs, the replay sample's (agents/replay.py) and
the loss, backward and Adam's (agents/qrdqn.py). The counters a step tests
(replay.total, train_steps, env_steps, the world-seed counter) are host
ints, so no step waits on the device; the per-step metrics stay on the
device until the caller reads a chunk's worth. The replay ring and the
learner are updated in place: a state passed to env_step must not be used
again.

The trainable agent is chosen by name, as in the JAX package:
  quantile              QR-DQN, epsilon_train 0.0 (configs/quantile.gin)
  finetune_perciatelli  QR-DQN started from the converted Perciatelli44
                        weights (a random init, with a warning, when the
                        blob is absent)
  dqn                   MSE DQN, epsilon_train 0.01 (configs/dqn.gin)
  mlp                   online SARSA MLP, no replay sampling
                        (agents/mlp_agent.py)
  r2d2                  recurrent quantile network, sequence replay and
                        unroll learner, per-env LSTM actor state
                        (agents/r2d2.py)
"""

import dataclasses
import functools
import logging
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ble_tpu_torch import resolve_device
from ble_tpu_torch.agents import base
from ble_tpu_torch.agents import dqn as dqn_lib
from ble_tpu_torch.agents import marco_polo
from ble_tpu_torch.agents import mlp_agent
from ble_tpu_torch.agents import qrdqn as qrdqn_lib
from ble_tpu_torch.agents import r2d2 as r2d2_lib
from ble_tpu_torch.agents import replay as replay_lib
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.env import wind_gp
from ble_tpu_torch.models import loader
from ble_tpu_torch.utils import profiling

TRAINABLE_AGENTS = ('quantile', 'finetune_perciatelli', 'dqn', 'mlp',
                    'r2d2')
# Training worlds are seeded apart from the eval suites' seeds (small
# ints): the k-th episode of run `seed` starts from world seed
# TRAIN_SEED_BASE + seed * 2**33 + k.
TRAIN_SEED_BASE = 1 << 40


@dataclasses.dataclass(frozen=True)
class TrainConfig:
  agent: str = 'quantile'
  num_envs: int = 1024
  episode_length: int = 960
  samples_per_insert: float = 8.0
  use_marco_polo: bool = True
  # < 0 means the agent's default: quantile 0.0 (quantile.gin:20), dqn
  # 0.01 (dqn.gin:17), the others 0.0.
  epsilon_train: float = -1.0
  qrdqn: qrdqn_lib.QrDqnConfig = dataclasses.field(
      default_factory=qrdqn_lib.QrDqnConfig)
  dqn: dqn_lib.DqnConfig = dataclasses.field(
      default_factory=dqn_lib.DqnConfig)
  r2d2: r2d2_lib.R2d2Config = dataclasses.field(
      default_factory=r2d2_lib.R2d2Config)
  replay: replay_lib.ReplayConfig = dataclasses.field(
      default_factory=replay_lib.ReplayConfig)

  def grad_steps_per_env_step(self) -> int:
    """Train steps an env step at the samples-per-insert ratio: one n-step
    sample trains batch_size transitions, one sequence sample batch_size x
    (seq_len - burn_in) (ble_tpu learner.py:71-85): 256 for the
    feedforward agents at their defaults, 16 for r2d2."""
    per_sample = self.replay.batch_size
    if self.agent == 'r2d2':
      per_sample *= max(self.r2d2.seq_len - self.r2d2.burn_in, 1)
    return max(1, round(self.num_envs * self.samples_per_insert /
                        per_sample))


class AgentCore(NamedTuple):
  """The functions a trainable agent gives the actor-learner (ble_tpu
  learner.py:88-123)."""
  name: str
  uses_replay: bool
  epsilon_train: float
  init: Callable  # (generator, obs_dim, device) -> learner state
  params_of: Callable  # learner state -> policy network
  # (network, obs (B, D), generator, epsilon) -> (B,) int32
  select_action: Optional[Callable]
  # Replay agents: (learner state, batch, grad_transform) -> (state,
  # metrics).
  train_step: Optional[Callable] = None
  # Online agents: (state, obs, action, reward, done, active,
  # grad_transform) -> (state, mean loss).
  train_inline: Optional[Callable] = None
  # (learner state, reset mask (E,)) -> learner state, when envs are reset
  # (drops per-env lanes, e.g. SARSA's pending transitions).
  on_reset: Optional[Callable] = None
  min_replay_history: int = 500
  # Recurrent agents' per-env actor state:
  #   actor_init: (network, num_envs, device) -> carry with (E, ...) leaves
  #   actor_select: (network, carry, obs, generator, epsilon)
  #                 -> (carry, actions)
  #   actor_reset: (carry, reset mask (E,)) -> carry
  actor_init: Optional[Callable] = None
  actor_select: Optional[Callable] = None
  actor_reset: Optional[Callable] = None
  # 'transition' (n-step batches, replay.sample) or 'sequence' (windows,
  # replay.sample_sequence).
  sample_kind: str = 'transition'
  seq_len: int = 0
  # Stored-state replay: the actor's carry flattened into the ring with
  # each transition (carry -> (E, S)), S floats a slot.
  actor_to_vec: Optional[Callable] = None
  actor_state_dim: int = 0


def _finetune_init(qcfg: qrdqn_lib.QrDqnConfig):
  """QR-DQN's init with the online and target networks set to the
  converted Perciatelli44 weights when the blob is found (ble_tpu
  learner.py:130-142); else a warning and the random init."""
  def init(generator, obs_dim, device):
    state = qrdqn_lib.init(generator, qcfg, obs_dim, device)
    try:
      network = loader.load_perciatelli44(device=device)
    except FileNotFoundError:
      logging.warning('finetune_perciatelli: perciatelli44.msgpack missing; '
                      'starting from random init.')
      return state
    qrdqn_lib.load_params(state, network.state_dict())
    return state
  return init


def make_agent_core(config: TrainConfig) -> AgentCore:
  eps = config.epsilon_train
  if config.agent in ('quantile', 'finetune_perciatelli'):
    qcfg = config.qrdqn
    return AgentCore(
        name=config.agent, uses_replay=True,
        epsilon_train=0.0 if eps < 0 else eps,
        init=(_finetune_init(qcfg) if config.agent == 'finetune_perciatelli'
              else lambda gen, d, device: qrdqn_lib.init(gen, qcfg, d,
                                                         device)),
        params_of=lambda s: s.network,
        select_action=lambda net, obs, gen, e: qrdqn_lib.select_action(
            qcfg, net, obs, gen, e),
        train_step=lambda s, batch, gt: qrdqn_lib.train_step(qcfg, s, batch,
                                                             gt),
        min_replay_history=qcfg.min_replay_history)
  if config.agent == 'dqn':
    dcfg = config.dqn
    return AgentCore(
        name='dqn', uses_replay=True,
        epsilon_train=dcfg.epsilon_train if eps < 0 else eps,
        init=lambda gen, d, device: dqn_lib.init(gen, dcfg, d, device),
        params_of=lambda s: s.network,
        select_action=lambda net, obs, gen, e: dqn_lib.select_action(
            dcfg, net, obs, gen, e),
        train_step=lambda s, batch, gt: dqn_lib.train_step(dcfg, s, batch,
                                                           gt),
        min_replay_history=dcfg.min_replay_history)
  if config.agent == 'r2d2':
    rcfg = config.r2d2
    return AgentCore(
        name='r2d2', uses_replay=True,
        epsilon_train=0.0 if eps < 0 else eps,
        init=lambda gen, d, device: r2d2_lib.init(gen, rcfg, d, device),
        params_of=lambda s: s.network,
        select_action=None,  # Recurrent: actor_select.
        train_step=lambda s, batch, gt: r2d2_lib.train_step(rcfg, s, batch,
                                                            gt),
        min_replay_history=rcfg.min_replay_history,
        actor_init=r2d2_lib.actor_init,
        actor_select=lambda net, carry, obs, gen, e: r2d2_lib.actor_select(
            rcfg, net, carry, obs, gen, e),
        actor_reset=r2d2_lib.actor_reset,
        sample_kind='sequence', seq_len=rcfg.seq_len,
        actor_to_vec=r2d2_lib.carry_to_vec if rcfg.stored_state else None,
        actor_state_dim=2 * rcfg.lstm_units if rcfg.stored_state else 0)
  if config.agent == 'mlp':
    num_envs = config.num_envs
    return AgentCore(
        name='mlp', uses_replay=False,
        epsilon_train=0.0 if eps < 0 else eps,
        init=lambda gen, d, device: mlp_agent.online_init(gen, d, num_envs,
                                                          device),
        params_of=lambda s: s.network,
        select_action=lambda net, obs, gen, e: mlp_agent.online_select(
            net, obs, gen, e),
        train_inline=mlp_agent.online_train,
        on_reset=mlp_agent.online_invalidate)
  raise ValueError(f'Unknown trainable agent {config.agent!r}; '
                   f'choose from {TRAINABLE_AGENTS}')


@dataclasses.dataclass
class TrainState:
  env_state: env_lib.EnvState  # Batched (E, ...).
  obs: torch.Tensor  # (E, obs_dim)
  active: torch.Tensor  # (E,) bool: env not yet terminal/truncated.
  episode_step: torch.Tensor  # (E,) int32 step within each env's episode.
  episode_return: torch.Tensor  # (E,) float32 running episodic return.
  mp: marco_polo.MarcoPoloState
  # The agent's learner state: qrdqn.LearnerState (quantile,
  # finetune_perciatelli, dqn, r2d2) or mlp_agent.OnlineState (mlp).
  learner: Any
  # Recurrent agents' per-env policy state, the LSTM carry (c, h) with
  # (E, units) leaves; () for feedforward agents.
  actor: Any
  replay: replay_lib.ReplayState
  # Every draw of the loop (exploration, MarcoPolo, replay sampling), on
  # the envs' device.
  generator: torch.Generator
  env_steps: int = 0  # Lockstep env steps taken.
  episodes_done: int = 0
  next_world_seed: int = TRAIN_SEED_BASE  # Seed of the next fresh episode.


def first_world_seed(seed: int) -> int:
  return TRAIN_SEED_BASE + (int(seed) << 33)


def train_state_from_envs(config: TrainConfig, env_state: env_lib.EnvState,
                          obs: torch.Tensor, seed: int = 0,
                          next_world_seed: Optional[int] = None
                          ) -> TrainState:
  """A fresh TrainState around envs already reset: the network drawn from a
  CPU generator seeded with `seed` (the same weights on any device), the
  loop's generator on the envs' device seeded with `seed`."""
  with profiling.span('learner.init'):
    core = make_agent_core(config)
    n, obs_dim = obs.shape
    dev = obs.device
    generator = torch.Generator(dev).manual_seed(seed)
    learner = core.init(torch.Generator().manual_seed(seed), obs_dim, dev)
    actor = (core.actor_init(core.params_of(learner), n, dev)
             if core.actor_init is not None else ())
    return TrainState(
        env_state=env_state, obs=obs,
        active=torch.ones((n,), dtype=torch.bool, device=dev),
        episode_step=torch.zeros((n,), dtype=torch.int32, device=dev),
        episode_return=torch.zeros((n,), dtype=torch.float32, device=dev),
        mp=marco_polo.begin_episode(n, generator), learner=learner,
        actor=actor,
        replay=replay_lib.init(n, obs_dim, config.replay, dev,
                               core.actor_state_dim),
        generator=generator,
        next_world_seed=(first_world_seed(seed) + n if next_world_seed is None
                         else next_world_seed))


def init_train_state(seed: int, env_params: env_lib.EnvParams,
                     field_fn: Callable, config: TrainConfig,
                     device=None) -> TrainState:
  """config.num_envs fresh episodes (world seeds from first_world_seed) and
  a fresh learner, replay and MarcoPolo state on `device` (default cuda)."""
  device = resolve_device(device)
  make_agent_core(config)
  first = first_world_seed(seed)
  seeds = list(range(first, first + config.num_envs))
  env_state, obs = env_lib.reset(env_params, seeds, field_fn, device)
  return train_state_from_envs(config, env_state, obs, seed,
                               first + config.num_envs)


def _scatter(old, idx, new):
  """`old` with rows `idx` of every leaf replaced by `new`'s."""
  if dataclasses.is_dataclass(old):
    return dataclasses.replace(old, **{
        f.name: _scatter(getattr(old, f.name), idx, getattr(new, f.name))
        for f in dataclasses.fields(old)})
  if old is None:
    return None
  return old.index_copy(0, idx, new.to(old.dtype))


def selective_reset(ts: TrainState, env_params: env_lib.EnvParams,
                    field_fn: Callable, config: TrainConfig
                    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
  """Re-initializes every inactive env from a fresh world; the others
  continue (ble_tpu learner.py:258-301). The fresh episodes take the next
  world seeds of the host counter, through env.reset on field_fn; only
  those envs are reset, and scattered back, and the agent drops their
  per-env lanes (AgentCore.on_reset, actor_reset). Reads the inactive
  envs' indices on the host, once.

  Returns (state, stats): stats carries each env's `completed` flag and its
  episode's `returns` and `lengths` for the collectors.
  """
  needs = ~ts.active
  stats = {'completed': needs, 'returns': ts.episode_return,
           'lengths': ts.episode_step}
  idx = torch.nonzero(needs).flatten()
  k = idx.numel()
  if k == 0:
    return ts, stats
  seeds = list(range(ts.next_world_seed, ts.next_world_seed + k))
  new_env, new_obs = env_lib.reset(env_params, seeds, field_fn,
                                   ts.obs.device)
  new_mp = marco_polo.begin_episode(k, ts.generator)
  core = make_agent_core(config)
  ts = dataclasses.replace(
      ts,
      learner=(core.on_reset(ts.learner, needs) if core.on_reset is not None
               else ts.learner),
      actor=(core.actor_reset(ts.actor, needs)
             if core.actor_reset is not None else ts.actor),
      env_state=_scatter(ts.env_state, idx, new_env),
      obs=ts.obs.index_copy(0, idx, new_obs),
      active=torch.ones_like(ts.active),
      episode_step=ts.episode_step.index_fill(0, idx, 0),
      episode_return=ts.episode_return.index_fill(0, idx, 0.0),
      mp=_scatter(ts.mp, idx, new_mp),
      next_world_seed=ts.next_world_seed + k,
      episodes_done=ts.episodes_done + k)
  return ts, stats


def learn(config: TrainConfig, core: AgentCore, learner,
          replay: replay_lib.ReplayState, generator: torch.Generator,
          grad_transform=None):
  """The learner's share of an env step: grad_steps_per_env_step() train
  steps on fresh replay samples, n-step batches or sequence windows by the
  agent's sample_kind (and their priority updates). Returns (learner, the
  mean loss as a 0-d device tensor)."""
  with profiling.span('learner.learn', cpu=True):
    n = config.grad_steps_per_env_step()
    loss_sum = None
    for _ in range(n):
      if core.sample_kind == 'sequence':
        batch = replay_lib.sample_sequence(replay, config.replay, generator,
                                           core.seq_len)
      else:
        batch = replay_lib.sample(replay, config.replay, generator)
      learner, metrics = core.train_step(learner, batch, grad_transform)
      if config.replay.prioritized:
        replay_lib.update_priorities(replay, config.replay, batch['env_idx'],
                                     batch['slot'], metrics['per_sample_loss'])
      # A copy first: a graphed train step's loss is overwritten by the
      # next one.
      loss_sum = (metrics['loss'].clone() if loss_sum is None
                  else loss_sum + metrics['loss'])
    return learner, loss_sum / n


def env_step(config: TrainConfig, env_params: env_lib.EnvParams,
             ts: TrainState, grad_transform=None, global_step=None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
  """One lockstep actor step and its learner updates (ble_tpu
  learner.py:304-408): actions, MarcoPolo, step_batched, replay.add, then
  the train steps once replay can sample, or, for an online agent, its
  inline step on the transition just completed. global_step, the step's
  index in its chunk, sets step_batched's slab re-centre cadence (None
  re-centres every step)."""
  with profiling.span('learner.env_step'):
    core = make_agent_core(config)
    network = core.params_of(ts.learner)
    if core.actor_select is not None:
      actor, rl_actions = core.actor_select(network, ts.actor, ts.obs,
                                            ts.generator, core.epsilon_train)
    else:
      actor = ts.actor
      rl_actions = core.select_action(network, ts.obs, ts.generator,
                                      core.epsilon_train)
    if config.use_marco_polo:
      mp, actions = marco_polo.step(ts.mp, ts.obs, rl_actions, ts.generator)
    else:
      mp, actions = ts.mp, rl_actions

    out = env_lib.step_batched(env_params, ts.env_state, actions,
                               global_step=global_step)

    terminal = ts.active & out.done
    # Stored-state replay keeps ts.actor, the carry BEFORE consuming ts.obs:
    # the state that seeds a learner unroll starting at this slot.
    rep = replay_lib.add(
        ts.replay, config.replay, ts.obs, actions, out.reward, terminal,
        ts.active, ts.episode_step,
        actor_state=(core.actor_to_vec(ts.actor)
                     if core.actor_to_vec is not None else None))

    learner = ts.learner
    if not core.uses_replay:
      # Online (SARSA) agents: the pending transition completes now that a_t
      # at s_t is known; one batched TD step.
      learner, mean_loss = core.train_inline(
          learner, ts.obs, actions, out.reward, out.done, ts.active,
          grad_transform)
    elif replay_lib.can_sample(rep, config.replay, core.min_replay_history):
      learner, mean_loss = learn(config, core, learner, rep, ts.generator,
                                 grad_transform)
    else:
      mean_loss = torch.zeros((), device=ts.obs.device)

    active_f = ts.active.to(torch.float32)
    masked_reward = torch.where(ts.active, out.reward, 0.0)
    truncated = (ts.episode_step + 1) >= config.episode_length
    new_active = ts.active & ~(out.done | truncated)

    # Per-step collector statistics: action histogram over live envs,
    # terminal counts, and env 0's flight track.
    action_hist = torch.zeros((env_lib.NUM_ACTIONS,), dtype=torch.int32,
                              device=actions.device).index_add_(
                                  0, actions.to(torch.int64),
                                  ts.active.to(torch.int32))
    metrics = {
        'reward': masked_reward.sum() / torch.clamp_min(active_f.sum(), 1.0),
        'loss': mean_loss,
        'active_frac': new_active.to(torch.float32).mean(),
        'action_hist': action_hist,
        'terminals': terminal.to(torch.int32).sum(),
        'path': torch.stack([out.info['x_km'][0], out.info['y_km'][0],
                             out.info['pressure_pa'][0],
                             out.info['battery_soc'][0]]),
    }
    ts = dataclasses.replace(
        ts, env_state=out.state, obs=out.observation, active=new_active,
        episode_step=ts.episode_step + ts.active.to(torch.int32),
        episode_return=ts.episode_return + masked_reward,
        mp=mp, learner=learner, actor=actor, replay=rep,
        env_steps=ts.env_steps + 1)
    return ts, metrics


def run_episode_chunk(config: TrainConfig, env_params: env_lib.EnvParams,
                      ts: TrainState, num_steps: int, grad_transform=None
                      ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
  """`num_steps` lockstep env steps (ble_tpu learner.py:411-454); returns
  (state, metrics stacked over the steps, still on the device).

  The chunk starts with one exact GP refresh (one batched Cholesky per
  env), which washes out the incremental updates' float32 drift. With the
  slab cache on, step t passes global_step=t, so the slab is re-centred
  before every env_params.field_cache_every steps, the tail included:
  ble_tpu's nested scans do the same.
  """
  with profiling.span('learner.chunk'):
    ts = dataclasses.replace(ts, env_state=dataclasses.replace(
        ts.env_state, gp=wind_gp.refresh(ts.env_state.gp)))
    steps = []
    for t in range(num_steps):
      ts, metrics = env_step(config, env_params, ts, grad_transform,
                             global_step=t)
      steps.append(metrics)
    return ts, {k: torch.stack([m[k] for m in steps]) for k in steps[0]}


def make_parametric_eval_policy(config: TrainConfig) -> base.Policy:
  """The greedy policy of config's agent with the network as a leading
  argument, for eval_lib.build_parametric_eval_fn: init(network, keys,
  device) and step(network, state, obs, draws); it draws nothing. A
  recurrent agent threads its LSTM carry through the policy state, one
  lane an env (ble_tpu learner.py:457-484; ble_tpu/train/train.py:30-41)."""
  core = make_agent_core(config)
  if core.actor_select is not None:
    return base.Policy(
        lambda network, keys, device: core.actor_init(network, keys.shape[0],
                                                      device),
        lambda network, state, obs, draws: core.actor_select(
            network, state, obs, None, 0.0))
  return base.Policy(
      lambda network, keys, device: (),
      lambda network, state, obs, draws: (
          state, core.select_action(network, obs, None, 0.0)))


def make_eval_policy(config: TrainConfig, network) -> base.Policy:
  """The greedy policy of `network` for eval_lib.build_eval_fn:
  make_parametric_eval_policy with the network bound."""
  policy = make_parametric_eval_policy(config)
  return base.Policy(functools.partial(policy.init, network),
                     functools.partial(policy.step, network))
