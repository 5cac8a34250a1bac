"""Circular replay on the device for vectorized actors (the port of
ble_tpu/agents/replay.py).

Buffers are laid out (envs, time_ring, ...): every env writes its
transition each step at the same ring cursor (lockstep episodes), and
n-step returns are computed at sample time from the stored reward and
terminal lanes. `add` and `update_priorities` write in place. The cursor
`total` is a host int, so `can_sample` and the slot index never wait on
the device.

Sampling is split in two: `draw` takes every random number a sample needs
from a torch.Generator (env indices, and base-step integers or, for the
prioritized path, the uniform variates of the Gumbel-max), and the
deterministic `sample_from_draws` does the rest (n-step return, bootstrap
discount, coherence mask, finite quarantine, importance weights). The
recurrent learner's windows split the same way: `draw_sequence` and
`sample_sequence_from_draws`.

On the card, `sample` of a uniform ring replays `sample_from_draws` as one
CUDA graph (`_SampleGraph`), captured at the ring's first sample: `draw`
writes into the graph's static inputs, and the batch it returns is held
in the graph's static outputs (a `GraphBatch`), which the next sample of
the same ring overwrites. The graph runs the same kernels on the same
inputs, so the batch is the eager one, bit for bit. Prioritized rings,
sequence samples and the CPU stay eager.

Capacity = num_envs * ring_len (the reference uses 2M transitions, e.g.
4096 envs x 512 slots).
"""

import dataclasses
from typing import Dict, Optional

import torch
from torch.utils import weak

from ble_tpu_torch.utils import profiling

_INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
  ring_len: int = 512
  n_step: int = 5
  gamma: float = 0.993
  batch_size: int = 32
  # Prioritized replay (reference quantile.gin uses Dopamine's prioritized
  # buffer): envs are drawn uniformly, the time slot within each drawn env
  # by priority via Gumbel-max over a (B, ring_len) tile. Loss weights and
  # priority updates follow Dopamine's sqrt scheme.
  prioritized: bool = False
  priority_epsilon: float = 1e-3


@dataclasses.dataclass
class ReplayState:
  obs: torch.Tensor  # (E, T, obs_dim) float32
  action: torch.Tensor  # (E, T) int32
  reward: torch.Tensor  # (E, T) float32
  terminal: torch.Tensor  # (E, T) bool: episode ended AT this step.
  valid: torch.Tensor  # (E, T) bool: transition written and pre-terminal.
  episode_step: torch.Tensor  # (E, T) int32: step index within episode.
  priority: torch.Tensor  # (E, T) float32 sampling priorities.
  total: int = 0  # Global steps written (shared cursor).
  # Recurrent-actor state at the START of each stored step (R2D2
  # stored-state replay, Kapturowski et al. 2019): (E, T, S) flattened
  # carries, or None for feedforward agents.
  actor_state: Optional[torch.Tensor] = None


def init(num_envs: int, obs_dim: int, config: ReplayConfig,
         device=None, actor_state_dim: int = 0) -> ReplayState:
  t = config.ring_len
  zeros = lambda *shape, dtype=torch.float32: torch.zeros(
      shape, dtype=dtype, device=device)
  return ReplayState(
      obs=zeros(num_envs, t, obs_dim),
      action=zeros(num_envs, t, dtype=torch.int32),
      reward=zeros(num_envs, t),
      terminal=zeros(num_envs, t, dtype=torch.bool),
      valid=zeros(num_envs, t, dtype=torch.bool),
      episode_step=zeros(num_envs, t, dtype=torch.int32),
      priority=zeros(num_envs, t),
      actor_state=(zeros(num_envs, t, actor_state_dim) if actor_state_dim
                   else None))


@torch.no_grad()
def add(state: ReplayState, config: ReplayConfig, obs, action, reward,
        terminal, active, episode_step, actor_state=None) -> ReplayState:
  """Writes one lockstep batch of transitions (obs_t, a_t, r_t) in place.

  Args:
    obs: (E, obs_dim) observations BEFORE the action.
    action, reward, terminal: (E,) transition data.
    active: (E,) whether the env was still live at this step (frozen
      post-terminal balloons write invalid slots).
    episode_step: (E,) step index within the current episode.
    actor_state: (E, S) flattened recurrent-actor carries at this step
      (required iff the ring was initialized with actor_state_dim).
  """
  with profiling.span('replay.add'):
    slot = state.total % config.ring_len
    # New transitions get the current max priority (Dopamine convention) so
    # they are sampled at least once.
    max_priority = torch.clamp_min(state.priority.max(), 1.0)
    state.priority[:, slot] = torch.where(active, max_priority, 0.0)
    state.obs[:, slot] = obs
    state.action[:, slot] = action
    state.reward[:, slot] = reward
    state.terminal[:, slot] = terminal
    state.valid[:, slot] = active
    state.episode_step[:, slot] = episode_step
    if state.actor_state is not None:
      state.actor_state[:, slot] = actor_state
    state.total += 1
    return state


def draw(state: ReplayState, config: ReplayConfig,
         generator: torch.Generator,
         out: Optional[Dict[str, torch.Tensor]] = None
         ) -> Dict[str, torch.Tensor]:
  """The random numbers of one sample, on the generator's device: env
  indices, and base-step integers in [0, 2^31 - 1) (uniform) or uniform
  variates in [1e-10, 1) over every slot (prioritized). A uniform draw
  may write into `out`'s int64 tensors (the sample graph's inputs); the
  generator advances as it does without."""
  dev = generator.device
  b = config.batch_size
  out = out or {}
  draws = {'env_idx': torch.randint(0, state.obs.shape[0], (b,),
                                    generator=generator, device=dev,
                                    out=out.get('env_idx'))}
  if config.prioritized:
    u = torch.rand((b, config.ring_len), generator=generator, device=dev)
    draws['uniform'] = torch.clamp_min(1e-10 + (1.0 - 1e-10) * u, 1e-10)
  else:
    draws['time_draw'] = torch.randint(0, _INT32_MAX, (b,),
                                       generator=generator, device=dev,
                                       out=out.get('time_draw'))
  return draws


def _base_step_bounds(total: int, config: ReplayConfig, window: int):
  """The oldest base step a sample may take and the number of them, from
  the host cursor: base steps g in [max(0, total - ring_len), total -
  window - 1], where a sample reads slots g..g+window."""
  oldest = max(0, total - config.ring_len)
  hi = max(oldest + 1, total - window)
  return oldest, max(hi - oldest, 1)


@torch.no_grad()
def sample_from_draws(state: ReplayState, config: ReplayConfig, env_idx,
                      time_draw: Optional[torch.Tensor] = None,
                      uniform: Optional[torch.Tensor] = None):
  """A uniform or prioritized n-step sample (Dopamine update_horizon
  semantics) from the draws of `draw`.

  Returns a dict with (B, ...) leaves: obs, action, n_step_reward (rewards
  discounted and summed up to the first terminal), bootstrap_discount
  (gamma^n, or 0 if the horizon hit a terminal), next_obs (at t+n), weight
  (0 for incoherent or non-finite samples; times the importance weight when
  prioritized), env_idx and slot.
  """
  oldest, span = _base_step_bounds(state.total, config, config.n_step)
  return _n_step_sample(state, config, env_idx, time_draw, uniform, oldest,
                        span)


def _n_step_sample(state: ReplayState, config: ReplayConfig, env_idx,
                   time_draw, uniform, oldest, span):
  """`sample_from_draws` with the base-step bounds given: host ints, or,
  in the sample graph, 0-d int64 tensors on the ring's device."""
  n = config.n_step
  t_ring = config.ring_len
  dev = state.obs.device
  env_idx = env_idx.to(device=dev, dtype=torch.int64)
  total = state.total

  if config.prioritized:
    # Per drawn env, Gumbel-max over log-priorities of eligible slots.
    prio = state.priority[env_idx]  # (B, T)
    cursor_prev = (total - 1) % t_ring
    s_iota = torch.arange(t_ring, device=dev)
    g_of_s = total - 1 - torch.remainder(cursor_prev - s_iota, t_ring)
    eligible = (g_of_s >= oldest) & (g_of_s <= total - 1 - n)
    logits = torch.log(torch.clamp_min(prio, 1e-20))
    gumbel = -torch.log(-torch.log(uniform.to(dev)))
    masked = torch.where(eligible[None, :] & (prio > 0), logits + gumbel,
                         -torch.inf)
    slot0 = masked.argmax(dim=-1)  # (B,)
    g = g_of_s[slot0]
    prio_sum = torch.where(eligible[None, :], prio, 0.0).sum(dim=-1)
    probability = (torch.take_along_dim(prio, slot0[:, None], -1)[:, 0] /
                   torch.clamp_min(prio_sum, 1e-20))
  else:
    g = oldest + torch.remainder(time_draw.to(device=dev, dtype=torch.int64),
                                 span)

  slots = torch.remainder(
      g[:, None] + torch.arange(n + 1, device=dev)[None, :], t_ring)
  rows = env_idx[:, None]
  rewards = state.reward[rows, slots[:, :n]]  # (B, n)
  terminals = state.terminal[rows, slots[:, :n]]
  valids = state.valid[rows, slots]
  ep_steps = state.episode_step[rows, slots]

  # Mask rewards after the first terminal inside the window.
  not_term_before = torch.cumprod(torch.cat(
      [torch.ones_like(terminals[:, :1], dtype=torch.int32),
       1 - terminals[:, :-1].to(torch.int32)], dim=1),
      dim=1).to(torch.float32)  # (B, n): 1 until (incl.) first terminal.
  discounts = config.gamma ** torch.arange(n, device=dev,
                                           dtype=torch.float32)
  n_step_reward = (rewards * discounts * not_term_before).sum(dim=1)

  hit_terminal = terminals.any(dim=1)
  bootstrap = torch.where(hit_terminal, 0.0, config.gamma ** n)

  obs = state.obs[env_idx, slots[:, 0]].to(torch.float32)
  next_obs = state.obs[env_idx, slots[:, n]].to(torch.float32)
  action = state.action[env_idx, slots[:, 0]]

  # Coherence: base slot valid, and the window stays within one episode up
  # to the first terminal (episode_step increments by 1 per slot).
  expected = ep_steps[:, :1] + torch.arange(n + 1, device=dev)[None, :]
  coherent_steps = ep_steps == expected
  # Only slots up to the bootstrap target need coherence; slots after a
  # terminal contribute nothing (rewards masked, bootstrap zeroed).
  need = torch.cat([not_term_before > 0, ~hit_terminal[:, None]], dim=1)
  coherent = (coherent_steps | ~need).all(dim=1)
  base_ok = valids[:, 0]
  # Numerical quarantine: a transition holding a non-finite value gets
  # weight 0 (and quantile_loss keeps it out of the gradient).
  finite = (torch.isfinite(obs).all(dim=-1) &
            torch.isfinite(next_obs).all(dim=-1) &
            torch.isfinite(n_step_reward))
  weight = (coherent & base_ok & finite).to(torch.float32)

  if config.prioritized:
    # Dopamine scheme: importance weights 1/sqrt(prob), normalized by max.
    iw = 1.0 / torch.sqrt(probability + config.priority_epsilon)
    iw = iw / torch.clamp_min(iw.max(), 1e-20)
    weight = weight * iw

  return {
      'obs': obs,
      'action': action,
      'n_step_reward': n_step_reward,
      'bootstrap_discount': bootstrap,
      'next_obs': next_obs,
      'weight': weight,
      'env_idx': env_idx,
      'slot': slots[:, 0],
  }


class GraphBatch(dict):
  """A batch held in a sample graph's static output tensors: the next
  `sample` of the same ring overwrites them."""


def _ring(state: ReplayState):
  return (state.obs, state.action, state.reward, state.terminal, state.valid,
          state.episode_step)


class _SampleGraph:
  """`sample_from_draws` of a uniform ring, captured as one CUDA graph.

  Its inputs are static: the draws, and the base-step bounds as 0-d
  device tensors, filled when the host cursor `total` has moved since the
  last replay (once an env step in the learner). A replay writes the
  batch into the static outputs.
  """

  def __init__(self, state: ReplayState, config: ReplayConfig):
    dev = state.obs.device
    b = config.batch_size
    self.config = config
    self.ring = _ring(state)
    self.draws = {k: torch.zeros((b,), dtype=torch.int64, device=dev)
                  for k in ('env_idx', 'time_draw')}
    self.oldest = torch.zeros((), dtype=torch.int64, device=dev)
    self.span = torch.ones((), dtype=torch.int64, device=dev)
    self.total = None
    self.graph = None
    self.outputs = None

  def fits(self, state: ReplayState, config: ReplayConfig) -> bool:
    return (config is self.config or config == self.config) and all(
        a is b for a, b in zip(_ring(state), self.ring))

  def replay(self, state: ReplayState) -> GraphBatch:
    if state.total != self.total:
      oldest, span = _base_step_bounds(state.total, self.config,
                                       self.config.n_step)
      self.oldest.fill_(oldest)
      self.span.fill_(span)
      self.total = state.total
    if self.graph is None:
      self._capture(state)
    self.graph.replay()
    profiling.count('replay.graph_replays')
    return GraphBatch(self.outputs)

  @torch.no_grad()
  def _capture(self, state: ReplayState) -> None:
    """One eager run on the capture stream first (the sample is pure, so
    it changes nothing), then the capture, which runs nothing."""
    body = lambda: _n_step_sample(state, self.config, self.draws['env_idx'],
                                  self.draws['time_draw'], None, self.oldest,
                                  self.span)
    stream = torch.cuda.Stream(device=state.obs.device)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
      body()
    torch.cuda.current_stream().wait_stream(stream)
    self.graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(self.graph, stream=stream):
      self.outputs = body()
    profiling.count('replay.graph_captures')


# The sample graph of each ring, keyed weakly by the ReplayState object: a
# graph lives as long as its ring, and what copies or saves a state's
# fields (deepcopy, checkpoints) never meets it.
_SAMPLE_GRAPHS = weak.WeakIdKeyDictionary()


def _sample_graph(state: ReplayState, config: ReplayConfig,
                  generator: torch.Generator) -> Optional[_SampleGraph]:
  """The ring's sample graph, made on its first use, where one can serve:
  a uniform ring on the card with the generator on the ring's device."""
  dev = generator.device
  if dev.type == 'cuda' and dev.index is None:  # torch.Generator('cuda').
    dev = torch.device('cuda', torch.cuda.current_device())
  if config.prioritized or not state.obs.is_cuda or dev != state.obs.device:
    return None
  graph = _SAMPLE_GRAPHS.get(state)
  if graph is None or not graph.fits(state, config):
    graph = _SAMPLE_GRAPHS[state] = _SampleGraph(state, config)
  return graph


def sample(state: ReplayState, config: ReplayConfig,
           generator: torch.Generator):
  """`sample_from_draws` on fresh draws from `generator`; on the card, of a
  uniform ring, as a replay of the ring's sample graph, whose batch (a
  `GraphBatch`) the ring's next sample overwrites."""
  with profiling.span('replay.sample'):
    graph = _sample_graph(state, config, generator)
    if graph is None:
      return sample_from_draws(state, config,
                               **draw(state, config, generator))
    draw(state, config, generator, out=graph.draws)
    return graph.replay(state)


@torch.no_grad()
def update_priorities(state: ReplayState, config: ReplayConfig, env_idx,
                      slot, per_sample_loss) -> ReplayState:
  """Sets sampled slots' priorities to sqrt(loss + eps) (Dopamine), in
  place. Non-finite losses give priority 1.0: `add` seeds new slots with
  max(priority), so one NaN would otherwise poison the whole lane."""
  new_p = torch.sqrt(per_sample_loss + config.priority_epsilon)
  new_p = torch.where(torch.isfinite(new_p), new_p, 1.0)
  state.priority[env_idx, slot] = new_p
  return state


def draw_sequence(state: ReplayState, config: ReplayConfig,
                  generator: torch.Generator) -> Dict[str, torch.Tensor]:
  """The random numbers of one sequence sample, on the generator's device:
  env indices and start-step integers in [0, 2^31 - 1). Sequences are
  drawn uniformly whether or not the ring is prioritized, as in ble_tpu."""
  dev = generator.device
  b = config.batch_size
  return {'env_idx': torch.randint(0, state.obs.shape[0], (b,),
                                   generator=generator, device=dev),
          'time_draw': torch.randint(0, _INT32_MAX, (b,),
                                     generator=generator, device=dev)}


@torch.no_grad()
def sample_sequence_from_draws(state: ReplayState, config: ReplayConfig,
                               seq_len: int, env_idx, time_draw):
  """Contiguous windows for recurrent (R2D2-style) learners (ble_tpu
  replay.py:231-300) from the draws of `draw_sequence`: seq_len + 1
  consecutive ring slots of each drawn env, one strided gather.

  Returns a dict of (B, L+1, ...) leaves plus a per-step loss mask:
  obs (B, L+1, D), action, reward and terminal (B, L+1), step_weight
  (B, L): 1 where the 1-step transition t -> t+1 is written, inside one
  episode, finite and not after a terminal; env_idx, slot (the window's
  first slot), and start_state (B, S) when the ring stores actor states.
  """
  profiling.count('replay.sequence_samples')
  t_ring = config.ring_len
  dev = state.obs.device
  env_idx = env_idx.to(device=dev, dtype=torch.int64)
  oldest, span = _base_step_bounds(state.total, config, seq_len)
  g = oldest + torch.remainder(time_draw.to(device=dev, dtype=torch.int64),
                               span)
  steps = torch.arange(seq_len + 1, device=dev)
  slots = torch.remainder(g[:, None] + steps[None, :], t_ring)
  rows = env_idx[:, None]
  obs = state.obs[rows, slots].to(torch.float32)  # (B, L+1, D)
  reward = state.reward[rows, slots]
  terminal = state.terminal[rows, slots]
  valid = state.valid[rows, slots]
  ep_steps = state.episode_step[rows, slots]

  # Step t's transition (t -> t+1) is trainable iff both slots were
  # written, they belong to one episode (episode_step increments), no
  # terminal occurred strictly before t inside the window, and the values
  # are finite (the quarantine of `sample_from_draws`).
  coherent = ep_steps == ep_steps[:, :1] + steps[None, :]
  pair_ok = valid[:, :-1] & coherent[:, 1:]
  no_term_before = torch.cumprod(torch.cat(
      [torch.ones_like(terminal[:, :1], dtype=torch.int32),
       1 - terminal[:, :-1].to(torch.int32)], dim=1), dim=1)[:, :-1]
  finite = torch.isfinite(obs).all(dim=-1)
  step_weight = (pair_ok & (no_term_before > 0) & finite[:, :-1] &
                 finite[:, 1:] & torch.isfinite(reward[:, :-1])
                 ).to(torch.float32)
  out = {
      'obs': obs,
      'action': state.action[rows, slots],
      'reward': reward,
      'terminal': terminal,
      'step_weight': step_weight,
      'env_idx': env_idx,
      'slot': slots[:, 0],
  }
  if state.actor_state is not None:
    out['start_state'] = state.actor_state[env_idx, slots[:, 0]]
  return out


def sample_sequence(state: ReplayState, config: ReplayConfig,
                    generator: torch.Generator, seq_len: int):
  """`sample_sequence_from_draws` on fresh draws from `generator`."""
  with profiling.span('replay.sample'):
    return sample_sequence_from_draws(
        state, config, seq_len, **draw_sequence(state, config, generator))


def can_sample(state: ReplayState, config: ReplayConfig,
               min_history: int) -> bool:
  return state.total > (min_history // max(state.obs.shape[0], 1) +
                        config.n_step)
