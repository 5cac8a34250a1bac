"""QR-DQN learner: quantile-regression loss, Adam, target network (the port
of ble_tpu/agents/qrdqn.py).

Counterpart of the reference's Dopamine `JaxQuantileAgent` wrapper
(agents/quantile_agent.py:40-159) with the Nature-paper hyperparameters
(agents/configs/quantile.gin): 8x600 MLP, 51 atoms, gamma=0.993, n-step 5,
Adam lr 2e-6 eps 2e-5, target period 100. Dopamine's update period of 4
env steps a batch of 32 becomes the learner's samples_per_insert of 8
(train/learner.py: TrainConfig).

The networks and the optimizer are torch objects that `train_step` updates
in place; `LearnerState.train_steps` is a host int, so the learning-rate
schedule and the target sync never wait on the device.

One departure from the JAX package, on purpose: `quantile_loss` zeroes the
inputs of quarantined samples (weight 0 and a non-finite value: replay's
quarantine) before the networks see them. In ble_tpu the masked loss is
finite but its gradient is not (0 x NaN flows back through the masked
branch), so one quarantined sample poisons the parameters; here the loss
is the same select-then-sum and the gradient stays finite. Their
`per_sample_loss` still reads NaN, as in ble_tpu, so prioritized replay
gives them priority 1.0; only `mean_q` then differs, averaging their
zeroed quantiles where ble_tpu reads NaN.

On the card, `train_step` replays the loss, the backward and Adam's step
as one CUDA graph (`_TrainGraph`, one a LearnerState), over static batch
tensors: those of the replay's sample graph (agents/replay.py), into which
any other batch is copied. It engages when the networks are on the card,
no `grad_transform` is given, Adam has stepped once (its moments exist),
and the first graphed batch is a sample graph's. Everything else runs the
eager path: the CPU, the data-parallel learner, prioritized replay (its
batches are eager), and dqn and r2d2, which call `optimizer_step`. The
graphed Adam is torch's, capturable, with its rate and step counts float64
device tensors; the target sync and `train_steps` stay on the host.
"""

import copy
import dataclasses
import math
import warnings
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils import weak

from ble_tpu_torch.agents import networks
from ble_tpu_torch.agents import replay
from ble_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class QrDqnConfig:
  num_actions: int = 3
  num_atoms: int = networks.NUM_ATOMS
  num_layers: int = networks.NUM_LAYERS
  hidden_units: int = networks.HIDDEN_UNITS
  gamma: float = 0.993
  learning_rate: float = 2e-6
  adam_eps: float = 2e-5
  target_update_period: int = 100
  min_replay_history: int = 500
  kappa: float = 1.0  # Huber threshold.
  # Optional warmup+cosine LR schedule (both 0 -> constant learning_rate,
  # the reference setting), indexed by the learner's train_steps.
  lr_warmup_steps: int = 0
  lr_decay_steps: int = 0
  lr_final_scale: float = 1.0


@dataclasses.dataclass
class LearnerState:
  """ble_tpu's (params, target_params, opt_state, train_steps): the online
  and target networks, Adam over the online network, and the number of
  train steps taken. The DQN and R2D2 learners keep the same state."""
  network: torch.nn.Module
  target_network: torch.nn.Module
  optimizer: torch.optim.Adam
  train_steps: int = 0


def make_network(config: QrDqnConfig, obs_dim: int,
                 generator: Optional[torch.Generator] = None
                 ) -> networks.QuantileNetwork:
  return networks.QuantileNetwork(
      obs_dim, num_actions=config.num_actions, num_layers=config.num_layers,
      hidden_units=config.hidden_units, num_atoms=config.num_atoms,
      generator=generator)


def network_from_params(params: Dict[str, torch.Tensor], num_actions: int = 3,
                        device=None) -> networks.QuantileNetwork:
  """A QuantileNetwork holding `params` (a state dict), its widths read
  from the tensors' shapes."""
  num_layers = sum(1 for k in params if k.endswith('.weight'))
  first = params['layers.0.weight']
  last = params[f'layers.{num_layers - 1}.weight']
  network = networks.QuantileNetwork(
      first.shape[1], num_actions=num_actions, num_layers=num_layers,
      hidden_units=first.shape[0], num_atoms=last.shape[0] // num_actions)
  network.load_state_dict(params)
  return network.to(device if device is not None else first.device)


def learning_rate_at(config: QrDqnConfig, count: int) -> float:
  """The rate of the update that follows `count` updates: optax's
  warmup_cosine_decay_schedule (ble_tpu make_optimizer) read at the count
  before the increment, as optax's scale_by_schedule does, so with warmup
  the first update has rate 0. Both periods 0: the constant rate."""
  peak = config.learning_rate
  if not (config.lr_warmup_steps or config.lr_decay_steps):
    return peak
  warmup = max(int(config.lr_warmup_steps), 1)
  decay = max(int(config.lr_decay_steps), int(config.lr_warmup_steps) + 1)
  if count < warmup:
    return peak * count / warmup
  end = peak * config.lr_final_scale
  alpha = 0.0 if peak == 0.0 else end / peak
  span = decay - warmup
  cosine = 0.5 * (1.0 + math.cos(math.pi * min(count - warmup, span) / span))
  return peak * ((1.0 - alpha) * cosine + alpha)


def make_optimizer(config: QrDqnConfig,
                   network: torch.nn.Module) -> torch.optim.Adam:
  """torch's Adam steps by (m / bc1) / (sqrt(v) / sqrt(bc2) + eps), which
  is optax's m_hat / (sqrt(v_hat) + eps); train_step sets the rate before
  each step."""
  return torch.optim.Adam(network.parameters(),
                          lr=learning_rate_at(config, 0),
                          eps=config.adam_eps)


def init(generator: torch.Generator, config: QrDqnConfig, obs_dim: int,
         device=None) -> LearnerState:
  """Fresh networks drawn from `generator` (target = online) and Adam."""
  network = make_network(config, obs_dim, generator).to(device)
  target = make_network(config, obs_dim).to(device)
  target.load_state_dict(network.state_dict())
  target.requires_grad_(False)
  return LearnerState(network=network, target_network=target,
                      optimizer=make_optimizer(config, network))


def load_params(state: LearnerState, params: Dict[str, torch.Tensor]) -> None:
  """Sets the online and the target network to `params` (a state dict)."""
  state.network.load_state_dict(params)
  state.target_network.load_state_dict(params)


@torch.no_grad()
def q_values(network: networks.QuantileNetwork, obs) -> torch.Tensor:
  return network(obs)[0]


def epsilon_greedy(q: torch.Tensor, num_actions: int,
                   generator: Optional[torch.Generator] = None,
                   epsilon: float = 0.0) -> torch.Tensor:
  """The argmax of q (B, A) as (B,) int32, each replaced with probability
  `epsilon` by a uniform random action; the draws come from `generator`,
  on its device (none at epsilon 0)."""
  greedy = q.argmax(dim=-1).to(torch.int32)
  if epsilon == 0.0:
    return greedy
  dev = generator.device
  random_actions = torch.randint(0, num_actions, greedy.shape,
                                 generator=generator, device=dev,
                                 dtype=torch.int32)
  explore = torch.rand(greedy.shape, generator=generator, device=dev) < epsilon
  return torch.where(explore.to(greedy.device), random_actions.to(greedy.device),
                     greedy)


def select_action(config: QrDqnConfig, network: networks.QuantileNetwork,
                  obs, generator: Optional[torch.Generator] = None,
                  epsilon: float = 0.0) -> torch.Tensor:
  """Epsilon-greedy argmax over mean quantile values (batched): (B,) int32.
  Exploration draws from `generator`, on its device."""
  with profiling.span('qrdqn.select_action'):
    return epsilon_greedy(q_values(network, obs), config.num_actions,
                          generator, epsilon)


def quarantine(batch: Dict[str, torch.Tensor]):
  """An n-step batch's (obs, next_obs, n_step_reward, bootstrap_discount,
  weight, quarantined) with the inputs of quarantined samples (weight 0
  and a non-finite value: replay's quarantine) zeroed; `quarantined` is
  the (B,) mask, or None for a batch without weights (all weights 1)."""
  obs, next_obs = batch['obs'], batch['next_obs']
  reward, discount = batch['n_step_reward'], batch['bootstrap_discount']
  w = batch.get('weight')
  if w is None:
    return obs, next_obs, reward, discount, torch.ones_like(reward), None
  values = torch.cat([obs, next_obs, reward[:, None], discount[:, None]],
                     dim=1)
  quarantined = (w <= 0) & ~torch.isfinite(values).all(dim=1)
  obs = torch.where(quarantined[:, None], 0.0, obs)
  next_obs = torch.where(quarantined[:, None], 0.0, next_obs)
  reward = torch.where(quarantined, 0.0, reward)
  discount = torch.where(quarantined, 0.0, discount)
  return obs, next_obs, reward, discount, w, quarantined


def quantile_loss(config: QrDqnConfig, network, target_network,
                  batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
  """Dopamine-style quantile regression Huber loss (ble_tpu qrdqn.py:93-133).

  Quarantined samples enter the networks with zero inputs (module
  docstring); every other value is ble_tpu's.
  """
  n_atoms = config.num_atoms
  obs, next_obs, reward, discount, w, quarantined = quarantine(batch)

  # Target: r^n + gamma^n * theta_target(s', a*), a* greedy under the
  # TARGET network (Dopamine JaxQuantileAgent.target_distribution).
  with torch.no_grad():
    tq, tlogits = target_network(next_obs)
    best = tq.argmax(dim=-1)
    target_theta = torch.take_along_dim(tlogits, best[:, None, None],
                                        dim=1)[:, 0, :]  # (B, N)
    target = reward[:, None] + discount[:, None] * target_theta

  _, logits = network(obs)
  action = batch['action'].to(torch.int64)
  theta = torch.take_along_dim(logits, action[:, None, None],
                               dim=1)[:, 0, :]  # (B, N)

  # Pairwise TD errors: target sample j vs predicted quantile i.
  u = target[:, None, :] - theta[:, :, None]  # (B, N_pred, N_target)
  kappa = config.kappa
  abs_u = u.abs()
  huber = torch.where(abs_u <= kappa, 0.5 * u * u,
                      kappa * (abs_u - 0.5 * kappa))
  tau = (torch.arange(n_atoms, dtype=torch.float32, device=u.device) +
         0.5) / n_atoms
  weight = (tau[None, :, None] - (u < 0).to(torch.float32)).abs()
  per_sample = (weight * huber / kappa).mean(dim=2).sum(dim=1)
  # Unweighted per-sample losses for prioritized-replay updates; NaN for
  # quarantined samples, as ble_tpu's non-finite inputs give.
  per_sample_loss = per_sample.detach()
  if quarantined is not None:
    per_sample_loss = torch.where(quarantined, math.nan, per_sample_loss)

  # Select-then-sum (not per_sample * w), as in ble_tpu.
  loss = (torch.where(w > 0, per_sample * w, 0.0).sum() /
          torch.clamp_min(w.sum(), 1.0))
  metrics = {'loss': loss,
             'mean_q': theta.mean(dim=-1).mean().detach(),
             'valid_frac': w.mean(),
             'per_sample_loss': per_sample_loss}
  return loss, metrics


def optimizer_step(state: LearnerState, loss: torch.Tensor,
                   learning_rate: float, target_update_period: int,
                   grad_transform: Optional[Callable] = None) -> None:
  """The gradient of `loss` into the online network, one step of its
  optimizer at `learning_rate`, and the target network set to the online
  one when train_steps, after its increment, is a multiple of
  `target_update_period` (ble_tpu's jnp.where / lax.cond sync), in place.

  `grad_transform(grads)` may reduce the list of gradients in place across
  processes (the data-parallel learner).
  """
  with profiling.span('optimizer.backward'):
    trained = [p for p in state.network.parameters() if p.requires_grad]
    for p in trained:
      p.grad = None
    loss.backward()
  if grad_transform is not None:
    grad_transform([p.grad for p in trained])
  with profiling.span('optimizer.step'):
    for group in state.optimizer.param_groups:
      group['lr'] = learning_rate
    state.optimizer.step()
  state.train_steps += 1
  if state.train_steps % target_update_period == 0:
    with profiling.span('optimizer.target_sync'), torch.no_grad():
      for t, p in zip(state.target_network.parameters(),
                      state.network.parameters()):
        t.copy_(p)


# The batch entries quantile_loss reads: the train graph's static inputs.
_BATCH_KEYS = ('obs', 'action', 'n_step_reward', 'bootstrap_discount',
               'next_obs', 'weight')


def _graph_body(config: QrDqnConfig, network, target_network, optimizer,
                batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
  loss, metrics = quantile_loss(config, network, target_network, batch)
  loss.backward()
  optimizer.step()
  metrics['loss'] = loss.detach()
  return metrics


def _make_capturable(optimizer: torch.optim.Adam, lr: torch.Tensor) -> None:
  """Adam as a graph captures it: capturable, the rate read from `lr`, and
  each `step` count on the device, where the graph increments it. The
  counts and the rate are float64, so capturable Adam computes its bias
  corrections and step size in float64, as the eager path does on the
  host; in float32 (torch's default there) 1 - 0.999^t is off by ~1e-5
  relative at early steps."""
  for group in optimizer.param_groups:
    group['capturable'] = True
    group['lr'] = lr
    for p in group['params']:
      st = optimizer.state[p]
      st['step'] = st['step'].to(device=lr.device, dtype=torch.float64)


class _TrainGraph:
  """QR-DQN's loss, backward and Adam step of one LearnerState, captured
  as one CUDA graph.

  Its static inputs are a sample graph's output tensors (another batch is
  copied into them) and the rate, a float64 0-d device tensor filled when
  learning_rate_at changes. The gradients it writes are the parameters'
  `p.grad`, and its outputs (the loss and metrics) are overwritten by the
  next replay. After the capture the optimizer's groups read as eager
  again (not capturable, a float rate); each `step` count stays on the
  device.
  """

  def __init__(self, config: QrDqnConfig, state: LearnerState,
               batch: Dict[str, torch.Tensor]):
    self.config = config
    self.network = state.network
    self.target_network = state.target_network
    self.optimizer = state.optimizer
    self.optimizer_state = state.optimizer.state
    self.inputs = {k: batch[k] for k in _BATCH_KEYS}
    self.rate = learning_rate_at(config, state.train_steps)
    self.lr = torch.full((), self.rate, dtype=torch.float64,
                         device=batch['obs'].device)
    self.graph = None
    self.outputs = None

  def fits(self, config: QrDqnConfig, state: LearnerState,
           batch: Dict[str, torch.Tensor]) -> bool:
    """Whether a replay computes this step: the same config, networks and
    Adam state, and a batch of the inputs' shapes and types."""
    if not (config is self.config or config == self.config):
      return False
    if (state.network is not self.network or
        state.target_network is not self.target_network or
        state.optimizer is not self.optimizer or
        state.optimizer.state is not self.optimizer_state):
      return False
    for k, v in self.inputs.items():
      got = batch.get(k)
      if got is not v and (got is None or got.shape != v.shape or
                           got.dtype != v.dtype or got.device != v.device):
        return False
    return True

  def step(self, state: LearnerState,
           batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    for k, v in self.inputs.items():
      if batch[k] is not v:
        v.copy_(batch[k])
    rate = learning_rate_at(self.config, state.train_steps)
    if rate != self.rate:
      self.lr.fill_(rate)
      self.rate = rate
      for group in self.optimizer.param_groups:
        group['lr'] = rate
    if self.graph is None:
      self._capture()
    self.graph.replay()
    profiling.count('qrdqn.graph_replays')
    return dict(self.outputs)

  def _capture(self) -> None:
    """A warm-up step on copies of the networks and Adam, on the capture
    stream, then the capture, which runs nothing: the learner's
    parameters, moments and counts move only in the replays."""
    stream = torch.cuda.Stream(device=self.lr.device)
    scratch = copy.deepcopy((self.network, self.target_network,
                             self.optimizer))
    _make_capturable(scratch[2], self.lr)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), warnings.catch_warnings():
      # Adam warns once when a capturable step runs uncaptured.
      warnings.simplefilter('ignore', UserWarning)
      _graph_body(self.config, *scratch, self.inputs)
    torch.cuda.current_stream().wait_stream(stream)
    del scratch
    _make_capturable(self.optimizer, self.lr)
    for p in self.network.parameters():
      p.grad = None
    self.graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(self.graph, stream=stream):
      self.outputs = _graph_body(self.config, self.network,
                                 self.target_network, self.optimizer,
                                 self.inputs)
    for group in self.optimizer.param_groups:
      group['capturable'] = False
      group['lr'] = self.rate
    profiling.count('qrdqn.graph_captures')


# The train graph of each learner, keyed weakly by the LearnerState object:
# a graph lives as long as its learner, and what copies or saves a state's
# fields (deepcopy, checkpoints) never meets it.
_TRAIN_GRAPHS = weak.WeakIdKeyDictionary()


def _train_graph(config: QrDqnConfig, state: LearnerState,
                 batch: Dict[str, torch.Tensor],
                 grad_transform: Optional[Callable]) -> Optional[_TrainGraph]:
  """The learner's train graph, made at the first step it can serve; None,
  with the reason counted, where the step runs eager."""
  reason = None
  if grad_transform is not None:
    reason = 'grad_transform'
  elif not next(state.network.parameters()).is_cuda:
    reason = 'device'
  graph = _TRAIN_GRAPHS.get(state)
  if graph is not None and (reason or not graph.fits(config, state, batch)):
    # Dropped: an eager step sets new `p.grad`s, which a replay would not
    # write. Adam's step counts stay float64 on the device, where the
    # eager step reads them as it reads its own.
    del _TRAIN_GRAPHS[state]
    graph = None
  if graph is None and reason is None:
    if not isinstance(batch, replay.GraphBatch):
      reason = 'batch'
    elif not all(p in state.optimizer.state
                 for p in state.network.parameters() if p.requires_grad):
      reason = 'warmup'
    else:
      graph = _TRAIN_GRAPHS[state] = _TrainGraph(config, state, batch)
  if graph is None:
    profiling.count('qrdqn.graph_eager')
    profiling.count(f'qrdqn.graph_eager.{reason}')
  return graph


def train_step(config: QrDqnConfig, state: LearnerState,
               batch: Dict[str, torch.Tensor],
               grad_transform: Optional[Callable] = None
               ) -> Tuple[LearnerState, Dict[str, torch.Tensor]]:
  """One Adam step and the periodic target sync (ble_tpu qrdqn.py:136-159),
  in place; returns (state, metrics) with `loss` detached. On the train
  graph (module docstring) the metrics are its static outputs, which the
  learner's next train step overwrites."""
  graph = _train_graph(config, state, batch, grad_transform)
  if graph is not None:
    with profiling.span('qrdqn.graph_step'):
      metrics = graph.step(state, batch)
    state.train_steps += 1
    if state.train_steps % config.target_update_period == 0:
      with profiling.span('optimizer.target_sync'), torch.no_grad():
        for t, p in zip(state.target_network.parameters(),
                        state.network.parameters()):
          t.copy_(p)
    return state, metrics
  with profiling.span('qrdqn.loss'):
    loss, metrics = quantile_loss(config, state.network,
                                  state.target_network, batch)
  optimizer_step(state, loss, learning_rate_at(config, state.train_steps),
                 config.target_update_period, grad_transform)
  metrics['loss'] = loss.detach()
  return state, metrics
