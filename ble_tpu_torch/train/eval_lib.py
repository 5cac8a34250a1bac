"""Batched evaluation: every seed of a suite steps in lockstep (the port of
ble_tpu/train/eval_lib.py; reference eval/eval_lib.py:83-211).

Each seed's world and policy draws are the JAX package's, from the same
integer seed (utils/prng.py). The episode is a Python loop over steps.
Every REFRESH_PERIOD (64) steps the GP inverse is recomputed exactly, and
with the field-slab cache on the slab re-centers every
env_params.field_cache_every (8) steps, as ble_tpu's nested scans do;
where field_cache_every does not divide REFRESH_PERIOD it re-centers every
step, as ble_tpu's eval falls back to. Terminal envs are masked: reward
accumulates through the terminal step, time_within_radius = steps within
radius / steps taken.
"""

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ble_tpu_torch import resolve_device
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.env import wind_gp as wind_gp_lib
from ble_tpu_torch.utils import prng


@dataclasses.dataclass
class EvaluationResult:
  """Per-seed result (reference eval_lib.py:83-121)."""
  seed: int
  cumulative_reward: float
  time_within_radius: float
  out_of_power: bool
  envelope_burst: bool
  zeropressure: bool
  final_timestep: int
  flight_path: Optional[List[Dict[str, float]]] = None


def policy_keys(seeds):
  """The policy keys of integer seeds, as ble_tpu/train/eval_lib.py:136-139
  and :182 make them from key = seed_to_key(seed): (pkey (E, 2), akey
  (E, 2), step_key_base (E, 2)) with pkey, akey = split(fold_in(key, 1))
  and step_key_base = fold_in(key, 2), whose split(., max_steps)[t] is
  step t's key (see step_keys)."""
  keys = env_lib.seed_keys(seeds)
  pa = prng.split(prng.fold_in(keys, 1))
  return pa[:, 0], pa[:, 1], prng.fold_in(keys, 2)


def step_keys(base, start: int, stop: int):
  """Steps start .. stop - 1 of split(base, max_steps) for any max_steps >=
  stop, (stop - start, E, 2): a fold-like split's key t depends on t alone
  (prng.py:1156-1161), so a chunk of an episode's step keys is drawn
  without the rest."""
  return prng.split(base, stop, start).transpose(0, 1)


def build_parametric_eval_fn(env_params: env_lib.EnvParams,
                             field_fn: Callable, policy_init: Callable,
                             policy_step: Callable, max_steps: int = 960,
                             record_flight_path: bool = False, device=None,
                             policy_draw: Optional[Callable] = None):
  """Like `build_eval_fn`, but the policy takes leading `params`
  (ble_tpu/train/eval_lib.py:57-75): policy_init(params, keys (E, 2),
  device) -> state and policy_step(params, state, obs, draws) -> (state,
  actions). Returns eval_fn(params, seeds), built once and called with
  each new set of parameters, as a training run's periodic evals do."""
  run = _build_run(env_params, field_fn, policy_init, policy_step, max_steps,
                   record_flight_path, device, policy_draw)
  return lambda params, seeds: run(params, seeds)


def build_eval_fn(env_params: env_lib.EnvParams, field_fn: Callable,
                  policy_init: Callable, policy_step: Callable,
                  max_steps: int = 960, record_flight_path: bool = False,
                  from_states: bool = False, device=None,
                  policy_draw: Optional[Callable] = None):
  """Returns a function evaluating a batch of seeds.

  Each seed's world and policy keys are the JAX package's
  (ble_tpu/train/eval_lib.py:136-139,182): the env reset from
  seed_to_key(seed) (env.reset) and the policy keys of policy_keys. So a
  seed's result depends neither on the seeds evaluated beside it nor on
  the shard it is in.

  Args:
    env_params: environment parameters.
    field_fn: (forecast keys (E, 2), device) -> the forecast grid every env
      starts from, (21, 21, 10, 9, 2), or one per env (env.make_field_fn).
    policy_init: (keys (E, 2), device) -> policy state (agents/base.py).
    policy_step: (policy_state, obs (E, 1099), draws) -> (policy_state,
      actions (E,) int32).
    max_steps: episode cap (suites use 960).
    record_flight_path: also return (E, T, 6) [x_km, y_km, pressure,
      superpressure, elapsed_s, soc] trajectories.
    from_states: the function takes (seeds, env_state, obs) with
      pre-built initial states (e.g. parity_reset's) instead of resetting
      from the seeds; the seeds then only make the policy keys.
    device: torch device (default: cuda).
    policy_draw: None, or keys (..., 2) -> the step's draws (...) on the
      CPU. The first action's draws come from akey, step t's from its step
      key; they are drawn on the host one GP chunk (REFRESH_PERIOD steps)
      at a time and moved to the device once a chunk, so a step launches
      nothing for them. Without it policy_step gets None.

  Returns:
    eval_fn(seeds) -> dict of (E,) result tensors (or
    eval_fn(seeds, env_state, obs) when `from_states`).
  """
  run = _build_run(env_params, field_fn,
                   lambda params, keys, dev: policy_init(keys, dev),
                   lambda params, *args: policy_step(*args), max_steps,
                   record_flight_path, device, policy_draw)
  if from_states:
    return lambda seeds, env_state, obs: run(None, seeds, env_state, obs)
  return lambda seeds: run(None, seeds)


def _build_run(env_params, field_fn, policy_init, policy_step, max_steps,
               record_flight_path, device, policy_draw):
  """The evaluator behind both build functions: run(params, seeds,
  env_state=None, obs=None) with the policy functions taking `params`
  first."""
  device = resolve_device(device)
  period = wind_gp_lib.REFRESH_PERIOD
  radius_km = env_params.station_keeping_radius_km
  n_chunked = (max_steps // period) * period
  # The slab's re-centre cadence (step_batched's global_step) holds only
  # where the GP chunk holds whole cache chunks; otherwise, and in the tail
  # after the last whole chunk, the slab re-centers every step
  # (ble_tpu/train/eval_lib.py:117-127).
  cadence = period % env_params.field_cache_every == 0

  def run(params, seeds, env_state=None, obs=None):
    seeds = [int(s) for s in seeds]
    if env_state is None:
      env_state, obs = env_lib.reset(env_params, seeds, field_fn, device)
    n = len(seeds)
    dev = obs.device
    pkey, akey, base = policy_keys(seeds)

    def draws_of(keys):
      return None if policy_draw is None else policy_draw(keys).to(dev)

    pstate = policy_init(params, pkey, dev)
    first = draws_of(akey[None])
    pstate, action = policy_step(params, pstate, obs,
                                 None if first is None else first[0])
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    reward = torch.zeros((n,), dtype=torch.float32, device=dev)
    within = torch.zeros((n,), dtype=torch.int32, device=dev)
    steps = torch.zeros((n,), dtype=torch.int32, device=dev)
    flags = {k: torch.zeros((n,), dtype=torch.bool, device=dev)
             for k in ('out_of_power', 'envelope_burst', 'zeropressure')}
    paths = []
    chunk = None
    for t in range(max_steps):
      if t % period == 0:
        stop = min(t + period, max_steps)
        chunk = (None if policy_draw is None else
                 draws_of(step_keys(base, t, stop)))
        if t < n_chunked:
          env_state = dataclasses.replace(
              env_state, gp=wind_gp_lib.refresh(env_state.gp))
      out = env_lib.step_batched(
          env_params, env_state, action,
          global_step=t if cadence and t < n_chunked else None)
      b = out.state.balloon
      dist_km = torch.sqrt(b.x_m * b.x_m + b.y_m * b.y_m) / 1000.0
      reward = reward + torch.where(active, out.reward,
                                    torch.zeros_like(out.reward))
      within = within + (active & (dist_km <= radius_km)).to(torch.int32)
      steps = steps + active.to(torch.int32)
      for k in flags:
        flags[k] = flags[k] | (active & out.info[k])
      active = active & ~out.done
      if record_flight_path:
        paths.append(torch.stack([
            b.x_m / 1000.0, b.y_m / 1000.0, b.pressure_pa,
            b.superpressure_pa, b.time_elapsed_s.to(torch.float32),
            out.info['battery_soc']], dim=-1))
      env_state = out.state
      pstate, action = policy_step(params, pstate, out.observation,
                                   None if chunk is None
                                   else chunk[t % period])

    result = {
        'cumulative_reward': reward,
        'time_within_radius': within.to(torch.float32) /
                              torch.clamp_min(steps, 1),
        'final_timestep': steps,
        **flags,
    }
    if record_flight_path:
      result['flight_path'] = torch.stack(paths, dim=1)
    return result

  return run


def evaluate(eval_fn, seeds: Sequence[int], batch_size: int = 0
             ) -> List[EvaluationResult]:
  """Runs eval_fn over seeds (optionally in batches) and unpacks results."""
  seeds = [int(s) for s in seeds]
  if batch_size <= 0:
    batch_size = len(seeds)
  chunks = []
  for start in range(0, len(seeds), batch_size):
    out = eval_fn(seeds[start:start + batch_size])
    chunks.append({k: v.cpu().numpy() for k, v in out.items()})
  merged = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}

  results = []
  for i, seed in enumerate(seeds):
    fp = None
    if 'flight_path' in merged:
      steps = int(merged['final_timestep'][i])
      fp = [{'x': float(r[0]), 'y': float(r[1]), 'pressure': float(r[2]),
             'superpressure': float(r[3]), 'elapsed_seconds': float(r[4]),
             'power': float(r[5])}
            for r in merged['flight_path'][i][:steps]]
    results.append(EvaluationResult(
        seed=seed,
        cumulative_reward=float(merged['cumulative_reward'][i]),
        time_within_radius=float(merged['time_within_radius'][i]),
        out_of_power=bool(merged['out_of_power'][i]),
        envelope_burst=bool(merged['envelope_burst'][i]),
        zeropressure=bool(merged['zeropressure'][i]),
        final_timestep=int(merged['final_timestep'][i]),
        flight_path=fp))
  return results


def evaluate_distributed(eval_fn, seeds: Sequence[int], batch_size: int = 0
                         ) -> List[EvaluationResult]:
  """`evaluate` with the seeds split across the ranks of the process group
  (the counterpart of ble_tpu's build_eval_fn(mesh=...)): each rank
  evaluates one contiguous block of the seeds, and every rank returns the
  whole list in seed order. Outside a process group, `evaluate`."""
  seeds = [int(s) for s in seeds]
  if not (dist.is_available() and dist.is_initialized()):
    return evaluate(eval_fn, seeds, batch_size)
  rank, size = dist.get_rank(), dist.get_world_size()
  block = -(-len(seeds) // size)
  mine = seeds[rank * block:(rank + 1) * block]
  local = evaluate(eval_fn, mine, batch_size) if mine else []
  gathered = [None] * size
  dist.all_gather_object(gathered, local)
  return [r for part in gathered for r in part]


def write_results_json(results: List[EvaluationResult], path: str,
                       agent_name: str = '', suite_name: str = '') -> None:
  payload = {
      'agent': agent_name,
      'suite': suite_name,
      'results': [dataclasses.asdict(r) for r in results],
  }
  with open(path, 'w') as f:
    json.dump(payload, f)


def combine_shard_results(paths: Sequence[str]) -> List[Dict[str, Any]]:
  """The results of per-shard JSON files (write_results_json's), merged and
  sorted by seed (reference eval/combine_eval_shards.py)."""
  combined = []
  for path in paths:
    with open(path) as f:
      combined.extend(json.load(f)['results'])
  combined.sort(key=lambda r: r['seed'])
  return combined


def summarize(results: List[EvaluationResult]) -> Dict[str, float]:
  return {
      'mean_cumulative_reward': float(
          np.mean([r.cumulative_reward for r in results])),
      'mean_twr': float(np.mean([r.time_within_radius for r in results])),
      'num_terminated': int(sum(r.final_timestep < 960 for r in results)),
      'num_seeds': len(results),
  }
