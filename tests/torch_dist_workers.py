"""Worker processes of the port's multi-process tests, and the runs they
share with the single-process references.

The workers are spawned with torch.multiprocessing; this module imports
torch and ble_tpu_torch only, never JAX, so a child never loads it. Each
worker joins a gloo process group on the CPU through a file://
rendezvous under the test's tmp_path (so xdist workers never race for a
port) and writes its results with torch.save.
"""

import os

import torch
import torch.distributed as dist

from ble_tpu_torch.agents import qrdqn
from ble_tpu_torch.agents import replay
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.parallel import distributed
from ble_tpu_torch.train import learner

WORLD = 2
LOCAL_E = 8
GLOBAL_E = WORLD * LOCAL_E
FIRST_STEPS = 5
SECOND_STEPS = 3
LEARN_STEPS = 10


def spawn(fn, tmp_path, *args, world: int = WORLD):
  """Runs fn(rank, world, init_method, out_dir, *args) in `world` spawned
  processes and returns what each saved at <out_dir>/rank_<r>.pt."""
  out_dir = str(tmp_path)
  init = 'file://' + os.path.join(out_dir, f'rendezvous_{fn.__name__}')
  torch.multiprocessing.spawn(fn, args=(world, init, out_dir) + args,
                              nprocs=world, join=True)
  return [torch.load(os.path.join(out_dir, f'rank_{r}.pt'),
                     weights_only=False) for r in range(world)]


def _join(rank, world, init):
  torch.set_num_threads(1)
  distributed.init_process_group('cpu', rank=rank, world_size=world,
                                 init_method=init)


def _save(out_dir, rank, result):
  torch.save(result, os.path.join(out_dir, f'rank_{rank}.pt'))


def small_qrdqn(**kw) -> qrdqn.QrDqnConfig:
  return qrdqn.QrDqnConfig(num_layers=2, hidden_units=32, num_atoms=11, **kw)


def trajectory_config(num_envs: int = GLOBAL_E) -> learner.TrainConfig:
  """Greedy actions, MarcoPolo off, no learning (min_replay_history beyond
  the run): any difference between the runs is the sharding's."""
  return learner.TrainConfig(
      num_envs=num_envs, use_marco_polo=False,
      qrdqn=small_qrdqn(min_replay_history=10**6),
      replay=replay.ReplayConfig(ring_len=16, batch_size=8))


def learning_config() -> learner.TrainConfig:
  return learner.TrainConfig(
      num_envs=GLOBAL_E, qrdqn=small_qrdqn(min_replay_history=2),
      replay=replay.ReplayConfig(ring_len=32, batch_size=8))


def forced_inactive(num_envs: int = GLOBAL_E) -> torch.Tensor:
  """The envs the trajectory run forces into a reset: global indices 1, 6
  and 11, so the ranks reset unequal numbers (2 and 1)."""
  return torch.arange(num_envs) % 5 == 1


def recording_field_fn(seen: list):
  """The static field_fn, noting the forecast keys of each reset's worlds
  (one a world seed)."""
  static = env_lib.make_field_fn('static')

  def field_fn(keys, device):
    seen.append(keys.tolist())
    return static(keys, device)

  return field_fn


def snapshot(ts, seen, metrics) -> dict:
  """What the trajectory comparison holds equal."""
  rep = ts.replay
  return {
      'obs': ts.obs, 'pressure': ts.env_state.balloon.pressure_pa,
      'active': ts.active, 'episode_step': ts.episode_step,
      'replay': {k: getattr(rep, k) for k in (
          'obs', 'action', 'reward', 'terminal', 'valid', 'episode_step')},
      'total': rep.total, 'next_world_seed': ts.next_world_seed,
      'episodes_done': ts.episodes_done, 'env_steps': ts.env_steps,
      'seeds': seen, 'metrics': metrics}


def single_trajectory() -> dict:
  """The single-process run of GLOBAL_E envs the ranks must reproduce:
  FIRST_STEPS steps, the forced reset, SECOND_STEPS steps."""
  params = env_lib.EnvParams()
  seen = []
  field_fn = recording_field_fn(seen)
  config = trajectory_config()
  ts = learner.init_train_state(0, params, field_fn, config, 'cpu')
  ts, m1 = learner.run_episode_chunk(config, params, ts, FIRST_STEPS)
  ts.active = ts.active & ~forced_inactive()
  ts, _ = learner.selective_reset(ts, params, field_fn, config)
  ts, m2 = learner.run_episode_chunk(config, params, ts, SECOND_STEPS)
  return snapshot(ts, seen, [m1, m2])


def _count_all_reduces(counter: list):
  real = dist.all_reduce

  def counted(*args, **kwargs):
    counter[0] += 1
    return real(*args, **kwargs)

  dist.all_reduce = counted
  return real


def data_parallel_worker(rank, world, init, out_dir, jax_case_path):
  """Three runs in one process group: the trajectory run against
  single_trajectory; the learning run, with the all-reduces of a chunk
  counted and the learner's largest distance from the rank mean; and
  QR-DQN train steps on this rank's half of each batch of the JAX case
  (`jax_case_path`: converted parameters, config and batches)."""
  _join(rank, world, init)
  try:
    params = env_lib.EnvParams()
    seen = []
    field_fn = recording_field_fn(seen)
    config = trajectory_config()
    ts = distributed.init_distributed_train_state(0, config, params,
                                                  field_fn, 'cpu')
    ts, m1 = distributed.build_distributed_step(config, params,
                                                FIRST_STEPS)(ts)
    lo, hi = distributed.shard_bounds(GLOBAL_E, rank, world)
    ts.active = ts.active & ~forced_inactive()[lo:hi]
    reset = distributed.build_distributed_reset(config, params, field_fn)
    ts, _ = reset(ts)
    ts, m2 = distributed.build_distributed_step(config, params,
                                                SECOND_STEPS)(ts)
    result = {'trajectory': snapshot(ts, seen, [m1, m2])}

    config = learning_config()
    ts = distributed.init_distributed_train_state(
        0, config, params, env_lib.make_field_fn('static'), 'cpu')
    step = distributed.build_distributed_step(config, params, LEARN_STEPS)
    counter = [0]
    real = _count_all_reduces(counter)
    try:
      ts, metrics = step(ts)
    finally:
      dist.all_reduce = real
    deviation = 0.0
    for module in (ts.learner.network, ts.learner.target_network):
      for p in module.parameters():
        mean = p.detach().clone()
        dist.all_reduce(mean)
        mean /= world
        deviation = max(deviation, float((p - mean).abs().max()))
    result['learning'] = {
        'train_steps': ts.learner.train_steps,
        'collectives': step.allreduce.collectives,
        'all_reduces': counter[0], 'metric_keys': sorted(metrics),
        'deviation': deviation, 'loss': metrics['loss']}

    case = torch.load(jax_case_path, weights_only=False)
    state = qrdqn.init(torch.Generator().manual_seed(0), case['config'],
                       case['obs_dim'], 'cpu')
    qrdqn.load_params(state, case['params'])
    allreduce = distributed.grad_allreduce(world)
    steps = []
    for batch in case['batches']:
      n = len(batch['obs']) // world
      half = {k: torch.from_numpy(v[rank * n:(rank + 1) * n].copy())
              for k, v in batch.items()}
      qrdqn.train_step(case['config'], state, half, allreduce)
      steps.append({
          'params': {k: v.clone() for k, v in
                     state.network.state_dict().items()},
          'target': {k: v.clone() for k, v in
                     state.target_network.state_dict().items()}})
    result['jax_case'] = steps
    _save(out_dir, rank, result)
  finally:
    dist.destroy_process_group()


def eval_worker(rank, world, init, out_dir, seeds, max_steps):
  """eval_lib.evaluate_distributed of StationSeeker on the static field."""
  from ble_tpu_torch.agents import station_seeker
  from ble_tpu_torch.train import eval_lib
  _join(rank, world, init)
  try:
    eval_fn = eval_lib.build_eval_fn(
        env_lib.EnvParams(), env_lib.make_field_fn('static'),
        lambda n, gen: (),
        lambda state, obs, gen: (state, station_seeker.pick_action(obs)),
        max_steps=max_steps, device='cpu')
    _save(out_dir, rank, eval_lib.evaluate_distributed(eval_fn, seeds))
  finally:
    dist.destroy_process_group()


def tensor_parallel_worker(rank, world, init, out_dir, case_path):
  """10 steps of tensor_parallel's train step on a 1 x world mesh from
  the case's converted parameters, on its batch."""
  from ble_tpu_torch.parallel import tensor_parallel
  _join(rank, world, init)
  try:
    case = torch.load(case_path, weights_only=False)
    mesh = tensor_parallel.make_2d_mesh(1, world, 'cpu')
    init_fn, step_fn = tensor_parallel.build_tp_train_step(
        mesh, case['config'], case['obs_dim'])
    state = init_fn(0, case['params'])
    shapes = {name: tuple(p.to_local().shape) for name, p in
              state.network.named_parameters()}
    batch = {k: torch.from_numpy(v.copy()) for k, v in case['batch'].items()}
    losses = []
    for _ in range(10):
      state, metrics = step_fn(state, batch)
      losses.append(float(metrics['loss']))
    _save(out_dir, rank, {'shapes': shapes, 'losses': losses})
  finally:
    dist.destroy_process_group()
