"""Distributed QR-DQN training CLI (the port of
ble_tpu/train/distributed_train.py; reference
distributed_train_acme_qrdqn.py).

One rank a GPU: each rank steps and stores its own block of the envs, the
learner is replicated and its gradients are all-reduced once a train
step (ble_tpu_torch/parallel/distributed.py). `--set num_envs=...` is the
global env count, which must divide by the number of ranks.

How it starts:
  - under torchrun, from the rank and world size in the environment;
  - with --multihost, as rank --process_id of --num_processes, meeting at
    tcp://--coordinator_address (host:port of rank 0); run one such
    process a GPU;
  - otherwise as --n_devices local workers, one a GPU (default: every
    GPU), spawned from this command; one worker runs in this process.

Examples, from the root of a checkout:
  python -m ble_tpu_torch.train.distributed_train --num_env_steps 5000
  python -m ble_tpu_torch.train.distributed_train --device cpu \\
      --n_devices 2 --wind_field static --num_env_steps 8 --chunk_steps 4 \\
      --base_dir /tmp/dist --set num_envs=8 --set replay.ring_len=64 \\
      --set replay.batch_size=8 --set qrdqn.min_replay_history=8 \\
      --set qrdqn.num_layers=2 --set qrdqn.hidden_units=32 \\
      --set qrdqn.num_atoms=11

On the CPU the ranks meet over gloo, on the card over NCCL. Rank 0
prints one line a chunk, and every rank prints a JSON summary line at the
end (its counters and its kernels' launches). With --base_dir rank 0
checkpoints its TrainState under <base_dir> (its learner is every
rank's, so `python -m ble_tpu_torch.train.eval --agent quantile
--checkpoint_dir <base_dir>` evaluates it) and rank r > 0 under
<base_dir>/rank_<r>.
"""

import argparse
import json
import os
import tempfile
import time

import torch

from ble_tpu_torch import config as config_lib
from ble_tpu_torch import resolve_device
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.models import loader
from ble_tpu_torch.ops import gp_window
from ble_tpu_torch.ops import physics
from ble_tpu_torch.parallel import distributed
from ble_tpu_torch.train import learner as learner_lib
from ble_tpu_torch.train import train_lib


def parse_args(argv=None) -> argparse.Namespace:
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--base_dir', type=str, default=None)
  parser.add_argument('--num_env_steps', type=int, default=960 * 10)
  parser.add_argument('--chunk_steps', type=int, default=96)
  parser.add_argument('--episode_length', type=int, default=960)
  parser.add_argument('--wind_field', type=str, default='generative',
                      choices=['generative', 'static'])
  parser.add_argument('--n_devices', type=int, default=None,
                      help='Local workers (default: every GPU; 1 on the '
                      'CPU).')
  parser.add_argument('--multihost', action='store_true',
                      help='Join a process group across hosts.')
  parser.add_argument('--coordinator_address', type=str, default=None,
                      help='host:port of rank 0 (multihost).')
  parser.add_argument('--num_processes', type=int, default=None)
  parser.add_argument('--process_id', type=int, default=None)
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--set', action='append', default=[])
  parser.add_argument('--no_field_cache', action='store_true',
                      help='Disable the windowed field-slab cache '
                      '(EnvParams.field_cache; on by default).')
  parser.add_argument('--device', type=str, default='cuda')
  return parser.parse_args(argv)


def _launches() -> dict:
  return {'physics': physics.launch.launches,
          'gp_window': gp_window.launch.launches}


def run_worker(rank: int, world_size: int, init_method: str,
               args: argparse.Namespace, local_rank: int = None):
  """One rank's training run, from joining the process group to leaving
  it; returns its TrainState."""
  device = torch.device(args.device)
  if device.type == 'cuda':
    device = torch.device('cuda', rank if local_rank is None else local_rank)
  device = distributed.init_process_group(
      device, rank=rank, world_size=world_size, init_method=init_method)
  try:
    launches0 = _launches()
    config = learner_lib.TrainConfig(episode_length=args.episode_length)
    config = config_lib.apply_overrides(config, args.set)
    env_params = env_lib.EnvParams(field_cache=not args.no_field_cache)
    if args.wind_field == 'generative':
      field_fn = env_lib.make_field_fn(
          'generative', loader.load_offlineskies22(device=device))
    else:
      field_fn = env_lib.make_field_fn('static')
    local = distributed.local_config(config, world_size)
    if rank == 0:
      print(f'World: {world_size} ranks on {device.type}, global envs: '
            f'{config.num_envs}, grad steps/env-step a rank: '
            f'{local.grad_steps_per_env_step()}', flush=True)

    ts = distributed.init_distributed_train_state(
        args.seed, config, env_params, field_fn, device)
    step = distributed.build_distributed_step(config, env_params,
                                              num_steps=args.chunk_steps)
    reset = distributed.build_distributed_reset(config, env_params,
                                                field_fn)
    base_dir = args.base_dir
    if base_dir and rank:
      base_dir = os.path.join(base_dir, f'rank_{rank}')
    steps_done = 0
    t_start = time.perf_counter()
    while steps_done < args.num_env_steps:
      ts, _ = reset(ts)
      ts, metrics = step(ts)
      steps_done += args.chunk_steps
      reward = float(metrics['reward'].mean())
      loss = float(metrics['loss'].mean())
      rate = steps_done * config.num_envs / (time.perf_counter() - t_start)
      if rank == 0:
        print(f'env_steps={steps_done} mean_reward={reward:.4f} '
              f'loss={loss:.5f} env-steps/s={rate:,.0f}', flush=True)
      if base_dir:
        train_lib.save_checkpoint(base_dir, ts,
                                  steps_done // args.chunk_steps)
    launches = {k: v - launches0[k] for k, v in _launches().items()}
    print(json.dumps({
        'rank': rank, 'world_size': world_size, 'device': str(device),
        'env_steps': ts.env_steps, 'train_steps': ts.learner.train_steps,
        'episodes_done': ts.episodes_done,
        'next_world_seed': ts.next_world_seed,
        'allreduce_collectives': step.allreduce.collectives,
        'launches': launches}), flush=True)
    return ts
  finally:
    torch.distributed.destroy_process_group()


def _spawned(local_rank: int, world_size: int, init_method: str,
             args: argparse.Namespace) -> None:
  torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
  run_worker(local_rank, world_size, init_method, args)


def main(argv=None):
  """Runs the training; returns this process's TrainState when it runs a
  rank (torchrun, --multihost, or one local worker), else None."""
  args = parse_args(argv)
  device = resolve_device(args.device)
  env = os.environ
  if 'RANK' in env and 'WORLD_SIZE' in env:
    return run_worker(int(env['RANK']), int(env['WORLD_SIZE']), 'env://',
                      args, int(env.get('LOCAL_RANK', env['RANK'])))
  if args.multihost:
    if not (args.coordinator_address and args.num_processes and
            args.process_id is not None):
      raise ValueError('--multihost needs --coordinator_address, '
                       '--num_processes and --process_id')
    count = torch.cuda.device_count() if device.type == 'cuda' else 1
    return run_worker(args.process_id, args.num_processes,
                      f'tcp://{args.coordinator_address}', args,
                      args.process_id % max(count, 1))
  n = args.n_devices
  if n is None:
    n = torch.cuda.device_count() if device.type == 'cuda' else 1
  if device.type == 'cuda' and n > torch.cuda.device_count():
    raise ValueError(f'--n_devices {n}: only {torch.cuda.device_count()} '
                     'GPUs')
  with tempfile.TemporaryDirectory() as d:
    init_method = 'file://' + os.path.join(d, 'rendezvous')
    if n == 1:
      return run_worker(0, 1, init_method, args)
    torch.multiprocessing.spawn(_spawned, args=(n, init_method, args),
                                nprocs=n, join=True)
  return None


if __name__ == '__main__':
  main()
