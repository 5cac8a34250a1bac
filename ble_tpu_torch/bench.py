"""The port's headline benchmark: env-steps/s on one card at BENCH_NUM_ENVS
envs (the counterpart of bench.py at the repository's root, which drives
ble_tpu).

  python -m ble_tpu_torch.bench                       # window mode, cuda
  BENCH_MODE=perstep python -m ble_tpu_torch.bench
  BENCH_DEVICE=cpu BENCH_NUM_ENVS=8 BENCH_NUM_STEPS=8 BENCH_WIND=static \\
      python -m ble_tpu_torch.bench

Measures the whole batched env step (physics substeps, wind column and
simplex noise, the GP observe and 181-level query, the 1099-d features and
the reward) under a uniform random policy drawn from a torch.Generator on
the envs' device. The observation is consumed every step
(reward + 1e-12 * obs.sum(-1), summed on the device): a bench that reads
only the reward would let a lazy runtime skip the GP and the features. The
one host read at the end of a run is its synchronisation.

Variables:
  BENCH_NUM_ENVS     envs (4096).
  BENCH_NUM_STEPS    env steps a run (32), a multiple of the window K.
  BENCH_MODE         'window' (default): env.rollout_window over windows of
                     K open-loop steps (K B1 launches and one B2 launch a
                     window on the card), the slab re-centred before each;
                     'perstep': env.step_batched every step, the slab
                     re-centred every K steps (what a policy that reads
                     each observation runs).
  BENCH_FIELD_CACHE  1 (default): the field-slab cache on.
  BENCH_WIND         'generative' (default; one VAE-decoded grid per env
                     from models/loader's decoder) or 'static'.
  BENCH_RESET_CHUNK  envs a reset call (512).
  BENCH_WINDOW       K with the cache off in window mode; otherwise K is
                     EnvParams.field_cache_every (8), the slab's cadence.
  BENCH_DEVICE       'cuda' (default; raises without a card) or 'cpu',
                     where the envs are capped at 256.
The JAX bench's BENCH_UNROLL, its scan's unroll factor, has no meaning in
eager PyTorch and is not read.

One warm-up run, then three timed runs from the same initial state, each
with its own actions; the best counts. The env functions do not write into
the state they are given, so every run starts from the same state.

Baseline: the reference runs ~9 env-steps/s on one GPU including the agent
(BASELINE.md); vs_baseline is the speedup over that number.

Prints progress to stderr and ONE JSON line to stdout: {"metric", "value",
"unit", "vs_baseline"}.
"""

import dataclasses
import json
import os
import sys
import time

import torch

from ble_tpu_torch import resolve_device
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.models import loader

BASELINE_STEPS_PER_S = 9.0
CPU_MAX_ENVS = 256
MODES = ('window', 'perstep')


@dataclasses.dataclass
class BenchConfig:
  num_envs: int
  num_steps: int
  mode: str
  field_cache: bool
  wind: str
  reset_chunk: int
  window: int
  device: torch.device


def config_from_env(environ) -> BenchConfig:
  """The BENCH_* variables of `environ` as a BenchConfig; raises for a
  mode, wind or step count the bench cannot run, and for a CUDA device
  where there is none."""
  device = resolve_device(environ.get('BENCH_DEVICE', 'cuda'))
  num_envs = int(environ.get('BENCH_NUM_ENVS', '4096'))
  if device.type == 'cpu':
    num_envs = min(num_envs, CPU_MAX_ENVS)
  mode = environ.get('BENCH_MODE', 'window')
  wind = environ.get('BENCH_WIND', 'generative')
  if mode not in MODES or wind not in ('generative', 'static'):
    raise ValueError(f'BENCH_MODE={mode!r} or BENCH_WIND={wind!r} unknown')
  field_cache = environ.get('BENCH_FIELD_CACHE', '1') == '1'
  window = env_lib.EnvParams().field_cache_every
  if not field_cache and mode == 'window':
    window = int(environ.get('BENCH_WINDOW', str(window)))
  num_steps = int(environ.get('BENCH_NUM_STEPS', '32'))
  if num_steps % window:
    raise ValueError(f'BENCH_NUM_STEPS={num_steps} must be a multiple of '
                     f'the window/cache chunk {window} (or set '
                     'BENCH_FIELD_CACHE=0)')
  return BenchConfig(num_envs=num_envs, num_steps=num_steps, mode=mode,
                     field_cache=field_cache, wind=wind,
                     reset_chunk=int(environ.get('BENCH_RESET_CHUNK', '512')),
                     window=window, device=device)


def reset_envs(params, config: BenchConfig, note=lambda msg: None):
  """Envs 0..num_envs-1 (the JAX package's worlds of those seeds) reset in
  chunks of reset_chunk (a reset's decode and sunrise search hold more
  memory than a step does)."""
  if config.wind == 'static':
    fn = env_lib.make_field_fn('static')
  else:
    fn = env_lib.make_field_fn('generative', loader.load_offlineskies22(
        device=config.device))
  n, chunk = config.num_envs, config.reset_chunk
  parts = []
  for i in range(0, n, chunk):
    parts.append(env_lib.reset(params, list(range(i, min(i + chunk, n))),
                               fn, config.device))
    note(f'reset chunk {i // chunk + 1}/{-(-n // chunk)}')
  state = env_lib.tree_map(lambda *xs: torch.cat(xs), *[p[0] for p in parts])
  return state, torch.cat([p[1] for p in parts])


def action_draw(seed: int, device):
  """draw(shape) -> uniform random int32 actions from a generator on
  `device` seeded with `seed`."""
  generator = torch.Generator(device=device).manual_seed(seed)
  return lambda shape: torch.randint(0, env_lib.NUM_ACTIONS, shape,
                                     generator=generator, device=device,
                                     dtype=torch.int32)


def rollout(params, config: BenchConfig, state, draw):
  """config.num_steps steps from `state` in config.mode with actions from
  draw(shape): (K, E) a window, or (E,) a step. Returns the (steps, E)
  per-step values reward + 1e-12 * obs.sum(-1) on the envs' device."""
  n = state.balloon.x_m.shape[0]
  k = config.window
  values = []
  if config.mode == 'perstep':
    for t in range(config.num_steps):
      out = env_lib.step_batched(params, state, draw((n,)), global_step=t)
      values.append((out.reward + 1e-12 * out.observation.sum(-1))[None])
      state = out.state
    return torch.cat(values)
  for _ in range(0, config.num_steps, k):
    if config.field_cache:
      state = env_lib.refresh_field_cache(state)
    out = env_lib.rollout_window(params, state, draw((k, n)))
    values.append(out.reward + 1e-12 * out.observation.sum(-1))
    state = out.state
  return torch.cat(values)


def main(environ=None) -> dict:
  """Runs the bench and prints its JSON line; returns it as a dict."""
  config = config_from_env(os.environ if environ is None else environ)
  t_start = time.perf_counter()

  def note(msg):
    print(f'[bench +{time.perf_counter() - t_start:.0f}s] {msg}',
          file=sys.stderr, flush=True)

  params = env_lib.EnvParams(field_cache=config.field_cache)
  state, _ = reset_envs(params, config, note)
  n = config.num_envs
  float(rollout(params, config, state, action_draw(7, config.device)).sum())
  note('warmup done; timing')

  times = []
  for i in range(3):
    draw = action_draw(100 + i, config.device)
    t0 = time.perf_counter()
    float(rollout(params, config, state, draw).sum())
    times.append(time.perf_counter() - t0)
  env_steps_per_s = n * config.num_steps / min(times)
  result = {
      'metric': f'env-steps/s/chip ({n} envs, {config.wind} winds, '
                f'{config.mode}, {config.device.type})',
      'value': round(env_steps_per_s, 1),
      'unit': 'env-steps/s',
      'vs_baseline': round(env_steps_per_s / BASELINE_STEPS_PER_S, 1),
  }
  print(json.dumps(result), flush=True)
  return result


if __name__ == '__main__':
  main()
