"""Data-parallel training over processes: envs and replay split across
ranks, the learner replicated (the port of ble_tpu/parallel/distributed.py).

The JAX package's mesh axis `env` becomes a torch.distributed process
group with one rank a GPU (NCCL), or one rank a process on the CPU
(gloo). Each rank steps and stores its own contiguous block of E / W
envs; the learner starts from the same weights on every rank and stays
the same, because its gradients are averaged across ranks before every
optimizer step by one all-reduce (grad_allreduce, the counterpart of the
jax.lax.pmean in the shard_map'd step). Replay sampling stays rank-local,
so only gradients and a chunk's metrics cross between ranks.

The reference's largest network is an 8 x 600 MLP, so data parallelism
over envs is the production sharding for this workload; there is no
attention, sequence or expert axis to shard (tensor_parallel.py is a
demo).

Rank r of W holds the envs r E/W ... (r+1) E/W - 1 of the single-process
run, with the same world seeds; fresh episodes take world seeds in the
order the single process gives them (build_distributed_reset), so every
env sees the world it would see in one process.
"""

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ble_tpu_torch import resolve_device
from ble_tpu_torch.agents import marco_polo
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.train import learner as learner_lib

# Metrics summed across ranks; the others are averaged. The per-step path
# of env 0 means nothing across ranks and is dropped.
COUNT_METRICS = ('action_hist', 'terminals')


def init_process_group(device=None, *, rank: int, world_size: int,
                       init_method: str,
                       backend: Optional[str] = None) -> torch.device:
  """Joins the process group: NCCL for `device` on cuda (default), gloo on
  the CPU, or `backend` when given (gloo serves CUDA tensors too, which
  lets two ranks share one card). Returns the rank's device: on cuda,
  `device` if it names an index, else cuda:<rank % device count>. There
  is no fallback: an init that fails raises."""
  device = resolve_device(device)
  if device.type == 'cuda':
    if device.index is None:
      device = torch.device('cuda', rank % torch.cuda.device_count())
    torch.cuda.set_device(device)
  if backend is None:
    backend = 'nccl' if device.type == 'cuda' else 'gloo'
  dist.init_process_group(backend, init_method=init_method, rank=rank,
                          world_size=world_size)
  return device


def world() -> Tuple[int, int]:
  """(rank, world size): (0, 1) outside a process group."""
  if dist.is_available() and dist.is_initialized():
    return dist.get_rank(), dist.get_world_size()
  return 0, 1


def shard_bounds(num_envs: int, rank: int, world_size: int
                 ) -> Tuple[int, int]:
  """The contiguous block [lo, hi) of envs that `rank` holds."""
  if num_envs % world_size:
    raise ValueError(f'num_envs {num_envs} does not divide by the world '
                     f'size {world_size}')
  n = num_envs // world_size
  return rank * n, (rank + 1) * n


def local_config(config: learner_lib.TrainConfig, world_size: int
                 ) -> learner_lib.TrainConfig:
  """`config` with the rank's share of the global num_envs."""
  shard_bounds(config.num_envs, 0, world_size)
  return dataclasses.replace(config,
                             num_envs=config.num_envs // world_size)


def loop_seed(seed: int, rank: int) -> int:
  """The seed of rank `rank`'s loop generator (exploration, MarcoPolo,
  replay sampling): rank 0 keeps `seed`, so a world of one is the
  single-process run; the others get streams apart from it."""
  return int(seed) + (int(rank) << 32)


def init_distributed_train_state(seed: int,
                                 config: learner_lib.TrainConfig,
                                 env_params: env_lib.EnvParams,
                                 field_fn: Callable, device=None
                                 ) -> learner_lib.TrainState:
  """This rank's TrainState: its block of config.num_envs (the global
  count) fresh episodes with the single process's world seeds, the
  learner from the CPU generator seeded with `seed` (the same on every
  rank), replay, MarcoPolo and any per-env actor lanes of its own, and
  the world-seed counter at the global first + num_envs."""
  device = resolve_device(device)
  rank, size = world()
  lo, hi = shard_bounds(config.num_envs, rank, size)
  first = learner_lib.first_world_seed(seed)
  env_state, obs = env_lib.reset(
      env_params, list(range(first + lo, first + hi)), field_fn, device)
  ts = learner_lib.train_state_from_envs(
      local_config(config, size), env_state, obs, seed,
      first + config.num_envs)
  if rank:
    generator = torch.Generator(obs.device).manual_seed(loop_seed(seed, rank))
    ts = dataclasses.replace(
        ts, generator=generator,
        mp=marco_polo.begin_episode(hi - lo, generator))
  return ts


class grad_allreduce:
  """The gradient all-reduce of the data-parallel learner, a
  `grad_transform` for qrdqn.optimizer_step and mlp_agent.online_train:
  one collective a train step. The gradients are flattened into one
  buffer (allocated at the first call), all-reduced with SUM, divided by
  the world size (jax.lax.pmean's psum / n) and copied back, in place.
  `collectives` counts the all-reduces it made."""

  def __init__(self, world_size: int, group=None):
    self.world_size = world_size
    self.group = group
    self.collectives = 0
    self._shapes = None
    self._buffer = None
    self._views = None

  def __call__(self, grads):
    shapes = [g.shape for g in grads]
    if shapes != self._shapes:
      self._shapes = shapes
      self._buffer = torch.empty(sum(g.numel() for g in grads),
                                 dtype=grads[0].dtype, device=grads[0].device)
      self._views = [v.view(shape) for v, shape in zip(
          self._buffer.split([g.numel() for g in grads]), shapes)]
    torch.cat([g.reshape(-1) for g in grads], out=self._buffer)
    dist.all_reduce(self._buffer, op=dist.ReduceOp.SUM, group=self.group)
    self.collectives += 1
    self._buffer.div_(self.world_size)
    torch._foreach_copy_(grads, self._views)


def reduce_metrics(metrics: Dict[str, torch.Tensor], world_size: int
                   ) -> Dict[str, torch.Tensor]:
  """A chunk's metrics across ranks: COUNT_METRICS summed, the rest
  averaged, `path` dropped (ble_tpu distributed.py:91-96)."""
  out = {}
  for key, value in metrics.items():
    if key == 'path':
      continue
    value = value.clone()
    dist.all_reduce(value, op=dist.ReduceOp.SUM)
    out[key] = value if key in COUNT_METRICS else value / world_size
  return out


def build_distributed_step(config: learner_lib.TrainConfig,
                           env_params: env_lib.EnvParams,
                           num_steps: int = 1) -> Callable:
  """`step(train_state) -> (train_state, metrics)`: run_episode_chunk of
  `num_steps` lockstep env steps on this rank's envs (config.num_envs is
  the global count) with the gradients all-reduced, then the chunk's
  metrics reduced across ranks once. The step's `allreduce` attribute
  is its grad_allreduce."""
  _, size = world()
  local = local_config(config, size)
  allreduce = grad_allreduce(size)

  def step(ts: learner_lib.TrainState):
    ts, metrics = learner_lib.run_episode_chunk(local, env_params, ts,
                                                num_steps, allreduce)
    return ts, reduce_metrics(metrics, size)

  step.allreduce = allreduce
  return step


def build_distributed_reset(config: learner_lib.TrainConfig,
                            env_params: env_lib.EnvParams,
                            field_fn: Callable) -> Callable:
  """`reset(train_state) -> (train_state, stats)`: learner.selective_reset
  on this rank's envs. The ranks share their counts k_q of envs to
  reset; rank r's take the world seeds next + sum_{q<r} k_q onwards, and
  every rank advances next_world_seed and episodes_done by sum_q k_q
  (the psum of ble_tpu distributed.py:128), so the seeds stay disjoint
  and equal to the single process's."""
  rank, size = world()
  local = local_config(config, size)

  def reset(ts: learner_lib.TrainState):
    counts = torch.zeros((size,), dtype=torch.int64, device=ts.obs.device)
    counts[rank] = (~ts.active).sum()
    dist.all_reduce(counts, op=dist.ReduceOp.SUM)
    counts = counts.tolist()
    base_seed, base_done = ts.next_world_seed, ts.episodes_done
    ts = dataclasses.replace(ts,
                             next_world_seed=base_seed + sum(counts[:rank]))
    ts, stats = learner_lib.selective_reset(ts, env_params, field_fn, local)
    ts = dataclasses.replace(ts, next_world_seed=base_seed + sum(counts),
                             episodes_done=base_done + sum(counts))
    return ts, stats

  return reset
