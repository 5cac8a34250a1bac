"""Tensor-parallel sharding of the QR-DQN learner, a demo (the port of
ble_tpu/parallel/tensor_parallel.py).

The reference's largest network is an 8 x 600 MLP, so tensor parallelism
is not needed for this workload: data parallelism over envs is the
production sharding (distributed.py). This module shows the capability
for larger policy networks on a 2-D (env, model) device mesh: the
QuantileNetwork's nn.Linear layers alternate column-parallel (even index:
output features sharded over `model`) and row-parallel (odd index: input
features sharded, outputs all-reduced), Megatron-style, through
torch.distributed.tensor.parallel; the batch is split over `env`, whose
ranks all-reduce their gradients.
"""

import dataclasses
from typing import Dict, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.parallel import (ColwiseParallel,
                                               RowwiseParallel,
                                               parallelize_module)

from ble_tpu_torch import resolve_device
from ble_tpu_torch.agents import qrdqn
from ble_tpu_torch.parallel import distributed

ENV_AXIS = 'env'
MODEL_AXIS = 'model'


def make_2d_mesh(env_devices: int, model_devices: int,
                 device=None) -> DeviceMesh:
  """The (env, model) mesh over the process group's ranks, on `device`'s
  type (default cuda)."""
  device = resolve_device(device)
  return init_device_mesh(device.type, (env_devices, model_devices),
                          mesh_dim_names=(ENV_AXIS, MODEL_AXIS))


def param_specs(network: torch.nn.Module) -> Dict[str, object]:
  """The parallelize plan of a network whose dense layers are
  `network.layers`: layer i column-parallel if i is even, row-parallel if
  odd (ble_tpu tensor_parallel.py:30-51). A last column-parallel layer
  gathers its output, which the network reshapes into atoms."""
  plan = {}
  last = len(network.layers) - 1
  for i in range(len(network.layers)):
    if i % 2:
      plan[f'layers.{i}'] = RowwiseParallel()
    elif i == last:
      plan[f'layers.{i}'] = ColwiseParallel(output_layouts=Replicate())
    else:
      plan[f'layers.{i}'] = ColwiseParallel()
  return plan


def shard_params(network: torch.nn.Module, mesh: DeviceMesh
                 ) -> torch.nn.Module:
  """`network` with its dense layers sharded over the mesh's `model`
  axis by param_specs, in place."""
  return parallelize_module(network, mesh[MODEL_AXIS], param_specs(network))


def build_tp_train_step(mesh: DeviceMesh, config: qrdqn.QrDqnConfig,
                        obs_dim: int):
  """(init_fn, step_fn) of the quantile-loss step with (env, model)-sharded
  parameters and env-sharded batches.

  init_fn(seed, params=None) -> LearnerState: networks drawn from a CPU
  generator seeded with `seed` (or set to `params`, a state dict of the
  whole network), then sharded. step_fn(state, batch) -> (state,
  metrics): qrdqn.train_step on this env rank's contiguous block of the
  batch, its gradients averaged over the `env` axis.
  """
  device = (torch.device('cuda', torch.cuda.current_device())
            if mesh.device_type == 'cuda' else torch.device('cpu'))
  env_mesh = mesh[ENV_AXIS]
  env_size, env_rank = env_mesh.size(), env_mesh.get_local_rank()
  allreduce = distributed.grad_allreduce(env_size, env_mesh.get_group())

  def env_reduce(grads):
    allreduce([g.to_local() if isinstance(g, DTensor) else g for g in grads])

  def init_fn(seed: int = 0,
              params: Optional[Dict[str, torch.Tensor]] = None
              ) -> qrdqn.LearnerState:
    state = qrdqn.init(torch.Generator().manual_seed(seed), config, obs_dim,
                       device)
    if params is not None:
      qrdqn.load_params(state, params)
    network = shard_params(state.network, mesh)
    target = shard_params(state.target_network, mesh)
    return dataclasses.replace(state, network=network, target_network=target,
                               optimizer=qrdqn.make_optimizer(config, network))

  def step_fn(state: qrdqn.LearnerState, batch: Dict[str, torch.Tensor]):
    n = next(iter(batch.values())).shape[0]
    lo, hi = distributed.shard_bounds(n, env_rank, env_size)
    local = {k: v[lo:hi].to(device) for k, v in batch.items()}
    return qrdqn.train_step(config, state, local,
                            env_reduce if env_size > 1 else None)

  return init_fn, step_fn
