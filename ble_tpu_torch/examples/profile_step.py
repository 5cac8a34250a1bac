"""Time by stage of the batched env step, without a profiler (the
counterpart of examples/profile_step.py, which drives ble_tpu).

  python -m ble_tpu_torch.examples.profile_step --num_envs 4096 --steps 32
  python -m ble_tpu_torch.examples.profile_step --device cpu --num_envs 8 \\
      --steps 8 --wind static

Each stage runs alone for --steps iterations on a live batch (reset with
the slab cache on), timed by a StepTimer phase that ends in a device
synchronisation, after one untimed warm-up iteration. The stages:
  full step        env.step_batched with random actions, the observation
                   consumed, the slab re-centred every 8 steps;
  window K=8       env.rollout_window over --steps // 8 windows, the slab
                   re-centred before each (the bench's default mode);
  physics (B1)     physics.simulate_step_fused, the safety remap included;
  wind column      effective_column and its value at the balloon pressure;
  noise            the simplex noise at the balloon;
  gp step (B2)     gp_window.step, the fused observe + query at K = 1;
  features         the level forecast (column_at_levels) and
                   features.get_features_precomputed;
  pressure range   pressure_range.compute_pressure_range alone (inside
                   the features);
  epilogue         excess energy, reward, done flags and info.
The per-step stages of the step route sum to about a full step; the rest is
its state bookkeeping. Prints one row a stage and, last, one JSON object of
milliseconds a step by stage.
"""

import argparse
import json

import torch

from ble_tpu_torch import bench
from ble_tpu_torch import resolve_device
from ble_tpu_torch.env import balloon as balloon_lib
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.env import features
from ble_tpu_torch.env import pressure_range
from ble_tpu_torch.env import solar
from ble_tpu_torch.env import wind_field
from ble_tpu_torch.ops import gp_window
from ble_tpu_torch.ops import physics
from ble_tpu_torch.utils import profiling


def stages(params, state, n: int, steps: int, draw):
  """{stage name: fn(iterations) -> a tensor that depends on the work}."""
  b = state.balloon
  pb = params.balloon
  atmosphere = state.atmosphere
  elapsed = b.time_elapsed_s.to(torch.float32)
  col = wind_field.effective_column(state.wind, b.x_m, b.y_m,
                                    b.time_elapsed_s)
  _, means, deviations = gp_window.step(
      state.gp, b.x_m, b.y_m, b.pressure_pa, elapsed,
      torch.ones_like(b.x_m), -torch.ones_like(b.x_m),
      torch.ones_like(b.x_m, dtype=torch.bool))
  lat, lng = balloon_lib.latlng(b)
  el_deg, _, flux = solar.solar_calculator(lat, lng, b.time_s)
  k = params.field_cache_every

  def full(iters):
    st, acc = state, 0.0
    for t in range(iters):
      out = env_lib.step_batched(params, st, draw((n,)), global_step=t)
      acc = acc + out.reward.sum() + 1e-12 * out.observation.sum()
      st = out.state
    return acc

  def window(iters):
    st, acc = state, 0.0
    for _ in range(max(iters // k, 1)):
      st = env_lib.refresh_field_cache(st)
      out = env_lib.rollout_window(params, st, draw((k, n)))
      acc = acc + out.reward.sum() + 1e-12 * out.observation.sum()
      st = out.state
    return acc

  def physics_stage(iters):
    balloon = b
    for _ in range(iters):
      balloon = physics.simulate_step_fused(pb, atmosphere, balloon,
                                            state.wind_u, state.wind_v,
                                            draw((n,)))
    return balloon.pressure_pa

  def column(iters):
    acc = 0.0
    for _ in range(iters):
      c = wind_field.effective_column(state.wind, b.x_m, b.y_m,
                                      b.time_elapsed_s)
      acc = acc + wind_field.column_at_pressure(c, b.pressure_pa)
    return acc

  def noise(iters):
    acc = 0.0
    for _ in range(iters):
      u, v = wind_field.get_noise(state.wind, b.x_m, b.y_m, b.pressure_pa,
                                  b.time_elapsed_s)
      acc = acc + u + v
    return acc

  def gp_step(iters):
    gp = state.gp
    for i in range(iters):
      gp, m, _ = gp_window.step(gp, b.x_m + i, b.y_m, b.pressure_pa,
                                elapsed + 60.0 * (i + 1),
                                torch.ones_like(b.x_m),
                                -torch.ones_like(b.x_m),
                                torch.ones_like(b.x_m, dtype=torch.bool))
    return m

  def features_stage(iters):
    acc = 0.0
    levels = features.pressure_levels(b.x_m.device)
    for _ in range(iters):
      fl = wind_field.column_at_levels(col, levels)
      acc = acc + features.get_features_precomputed(
          pb, b, atmosphere, state.sunrise_s, state.sunset_s, means,
          deviations, fl).sum()
    return acc

  def range_stage(iters):
    acc = 0.0
    for _ in range(iters):
      lo, hi = pressure_range.compute_pressure_range(
          pb, atmosphere, el_deg, flux, b.upwelling_infrared_w_m2)
      acc = acc + lo + hi
    return acc

  def epilogue(iters):
    acc = 0.0
    for _ in range(iters):
      reward, done, info = env_lib.step_outcome(params, b, state.wind)
      acc = acc + reward + done + info['battery_soc']
    return acc

  return {'full step': full, f'window K={k}': window,
          'physics (B1)': physics_stage, 'wind column': column,
          'noise': noise, 'gp step (B2)': gp_step, 'features': features_stage,
          'pressure range': range_stage, 'epilogue': epilogue}


def main(argv=None) -> dict:
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--num_envs', type=int, default=4096)
  p.add_argument('--steps', type=int, default=32)
  p.add_argument('--wind', choices=('generative', 'static'),
                 default='generative')
  p.add_argument('--device', default=None, help='cuda (default) or cpu')
  args = p.parse_args(argv)
  device = resolve_device(args.device)
  n, steps = args.num_envs, args.steps
  params = env_lib.EnvParams(field_cache=True)
  window = params.field_cache_every
  if steps % window:
    raise ValueError(f'--steps must be a multiple of {window}')

  config = bench.BenchConfig(num_envs=n, num_steps=steps, mode='perstep',
                             field_cache=True, wind=args.wind,
                             reset_chunk=512, window=window, device=device)
  state, _ = bench.reset_envs(params, config)
  state = env_lib.refresh_field_cache(state)
  draw = bench.action_draw(0, device)

  timer = profiling.StepTimer()
  sync = state.balloon.x_m
  for name, fn in stages(params, state, n, steps, draw).items():
    fn(1)
    if sync.is_cuda:
      torch.cuda.synchronize(sync.device)
    with timer.phase(name, sync=sync):
      fn(steps)
  per_step = {k: 1e3 * v / steps for k, v in timer.summary().items()}

  print(f'num_envs={n} steps={steps} device={device.type} wind={args.wind}')
  for name, ms in per_step.items():
    print(f'{name:16s} {ms:10.3f} ms a step   {1e3 * ms / n:9.4f} us an '
          f'env-step   {n / ms / 1e3:8.4f} M env-steps/s')
  parts = sum(per_step[k] for k in ('physics (B1)', 'wind column', 'noise',
                                    'gp step (B2)', 'features', 'epilogue'))
  print(f'{"sum of stages":16s} {parts:10.3f} ms a step   (physics + column '
        '+ noise + gp + features + epilogue)')
  print(f'{"unattributed":16s} {per_step["full step"] - parts:10.3f} ms a '
        'step   (full step - stages)')
  print(json.dumps({'ms_per_step': per_step, 'num_envs': n, 'steps': steps,
                    'device': device.type}))
  return per_step


if __name__ == '__main__':
  main()
