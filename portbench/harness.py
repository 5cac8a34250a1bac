"""One run of one cell: set-up, the measured window, the traced slice and
the check, by the cell's files.

A cell names a configuration (configs/<name>.json) and a traffic mix
(traffic/<name>.json). The traffic's `kind` picks the runner: `eval`
repeats the batched evaluator (train/eval_lib.build_eval_fn) over the
suite's seeds from states reset once in set-up; `train` repeats the
actor-learner's chunk (train/learner.run_episode_chunk) from a train
state whose replay can sample. What is the policy's (its train config,
weights, eval policy, captured entry points, numbers and work) comes from
policies/<policy>.py, by the configuration's `policy` key, so the
runners know no policy. Weights are made on the device from the seed.
The check's limits are limits/<cell>.json; the per-layer metrics are
metrics/<name>.py, each with read(ctx) -> value or None.
"""

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

import torch

from portbench import policies

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'ble_tpu')


@dataclasses.dataclass
class Spec:
  workload: dict
  config: dict
  traffic: dict
  limits: dict
  end_to_end: list
  per_layer: list


def _load_json(*parts):
  with open(os.path.join(*parts)) as f:
    return json.load(f)


def _reports(metric: dict, name: str) -> bool:
  return name in metric.get('workloads', [name])


def load_spec(name: str, root: str = ROOT) -> Spec:
  """The cell `name` of root/BENCHMARK.json with its files."""
  bench = _load_json(root, 'BENCHMARK.json')
  cells = {w['name']: w for w in bench['workloads']}
  if name not in cells:
    raise SystemExit(f'unknown workload {name!r}; known: {sorted(cells)}')
  cell = cells[name]
  config = next(c for c in bench['configs'] if c['name'] == cell['config'])
  e2e = [m for m in bench['end_to_end'] if _reports(m, name)]
  e2e_names = {m['name'] for m in e2e}
  per_layer = [m for m in bench['per_layer']
               if (_reports(m, name) if 'workloads' in m
                   else m['moves'] in e2e_names)]
  return Spec(workload=cell, config=_load_json(root, config['file']),
              traffic=_load_json(HERE, 'traffic', f'{cell["traffic"]}.json'),
              limits=_load_json(HERE, 'limits', f'{name}.json'),
              end_to_end=e2e, per_layer=per_layer)


def read_metric(name: str, ctx: dict):
  """metrics/<name>.py's read(ctx): a number, or None when the run had
  nothing for it to read."""
  path = os.path.join(HERE, 'metrics', f'{name}.py')
  spec = importlib.util.spec_from_file_location(
      'portbench_metric_' + name.replace('.', '_'), path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module.read(ctx)


# ------------------------------------------------------------ weights --


def decoder_weights(seed: int, device):
  """The VAE decoder's four dense layers from the seed, on the device, in
  one draw: kernels lecun-normal (a normal truncated to +-2, scaled by
  sqrt(1 / fan_in) / 0.8796), biases zero, as the upstream init."""
  from ble_tpu_torch.generative import vae
  widths = ([vae.NUM_LATENTS] + [vae._HIDDEN] * vae._NUM_HIDDEN_LAYERS +
            [vae._FLOW_WIDTH ** 2 * vae._NUM_FLOW_FIELDS])
  gen = torch.Generator(device=device).manual_seed(seed)
  sizes = [a * b for a, b in zip(widths[:-1], widths[1:])]
  flat = torch.empty(sum(sizes), device=device)
  torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
  out, at = [], 0
  for (a, b), n in zip(zip(widths[:-1], widths[1:]), sizes):
    w = flat[at:at + n].view(b, a) * (math.sqrt(1.0 / a) / 0.87962566103423978)
    out.append((w, torch.zeros(b, device=device)))
    at += n
  return out


def state_dict_of(weights):
  sd = {}
  for i, (w, b) in enumerate(weights):
    sd[f'layers.{i}.weight'] = w
    sd[f'layers.{i}.bias'] = b
  return sd


def module_on(cls, weights, device, **kwargs):
  """An nn.Module of class `cls` holding `weights`, built without drawing
  torch's own init."""
  with torch.device('meta'):
    module = cls(**kwargs)
  module = module.to_empty(device=device)
  module.load_state_dict(state_dict_of(weights))
  return module.eval()


# ------------------------------------------------------------- runners --


def _env_params(cfg):
  from ble_tpu_torch.env import env as env_lib
  return env_lib.EnvParams(**cfg['env'])


def _reset(env_params, seeds, field_fn, device, chunk):
  """Fresh episodes of `seeds`, reset `chunk` seeds a call and joined."""
  from ble_tpu_torch.env import env as env_lib
  parts = [env_lib.reset(env_params, seeds[i:i + chunk], field_fn, device)
           for i in range(0, len(seeds), chunk)]
  if len(parts) == 1:
    return parts[0]
  state = env_lib.tree_map(lambda *xs: torch.cat(xs), *[p[0] for p in parts])
  return state, torch.cat([p[1] for p in parts])


class Run:
  """The state of one run, shared by the runners and the metrics."""

  def __init__(self, spec, seed, seconds, trace, device, t0):
    self.spec, self.seed, self.seconds = spec, seed, seconds
    self.trace, self.device, self.t0 = trace, torch.device(device), t0
    self.cfg, self.traffic = spec.config, spec.traffic
    self.spans = None
    self.ctx = {'kind': self.traffic['kind'], 'device': self.device.type}
    self.numbers = {}
    self.control = None


def _sync(device):
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def _call_seconds(t_start, ends):
  return [b - a for a, b in zip([t_start] + ends[:-1], ends)]


def run_eval(run: Run, faults=(), control=False):
  """The eval cell: big-batch closed-loop evaluation from reset states."""
  from ble_tpu_torch.env import env as env_lib
  from ble_tpu_torch.env import wind_gp
  from ble_tpu_torch.generative import vae
  from ble_tpu_torch.ops import gp_window
  from ble_tpu_torch.ops import physics
  from ble_tpu_torch.train import eval_lib
  from ble_tpu_torch.train import suites
  from portbench import check
  from portbench import trace as trace_lib

  cfg, tr, dev = run.cfg, run.traffic, run.device
  policy = policies.load(cfg['policy'])
  steps = tr['steps_per_call']
  seeds = suites.get_eval_suite(tr['suite']).seeds[:tr['num_seeds']]
  n = len(seeds)
  idx = check.sample_rows(run.seed, n, tr['check_rows'])
  capture = check.Capture(idx, tr['check_steps'], dev)
  for fault in faults:
    fault(run)
  if run.trace:
    run.spans = trace_lib.Spans()
    run.spans.install(env_lib, 'reset', 'reset')
    run.spans.install(env_lib, 'step_batched', 'env_step')
    run.spans.install(wind_gp, 'refresh', 'gp_refresh')
  capture.install_env(env_lib)

  dec_w = decoder_weights(run.seed, dev)
  decoder = module_on(vae.Decoder, dec_w, dev)
  field_fn = env_lib.make_field_fn('generative', decoder)
  env_params = _env_params(cfg)
  state0, obs0 = _reset(env_params, seeds, field_fn, dev, tr['reset_chunk'])
  _sync(dev)
  capture.reset_obs = obs0[capture.idx].clone()

  weights = policy.weights(run.seed, cfg, obs0.shape[1], dev)
  run.ctx['work'] = policy.work(cfg, obs0.shape[1], 0)
  policy_init, policy_step = policy.eval_policy(cfg, n, weights, dev)
  policy.install(capture, cfg, None, None)
  policy_step = capture.wrap_policy_step(policy_step, steps + 1)
  if run.spans is not None:
    policy_step = run.spans.wrap(policy_step, 'policy')
  eval_fn = eval_lib.build_eval_fn(env_params, field_fn, policy_init,
                                   policy_step, max_steps=steps,
                                   from_states=True, device=dev)

  out = eval_fn(seeds, state0, obs0)  # Warms every shape of the window.
  _sync(dev)
  run.ctx['setup_spans'] = run.spans.take() if run.spans else {}

  calls, failed, ends = 0, 0, []
  t_start = time.perf_counter()
  setup_s = t_start - run.t0
  while True:
    out = eval_fn(seeds, state0, obs0)
    _sync(dev)
    ends.append(time.perf_counter())
    calls += 1
    failed += int(not bool(torch.isfinite(out['cumulative_reward']).all()))
    if time.perf_counter() - t_start >= run.seconds:
      break
  window_s = time.perf_counter() - t_start
  run.ctx.update(window_s=window_s, calls=calls, envs=n, steps=calls * steps,
                 call_s=_call_seconds(t_start, ends),
                 window_spans=run.spans.take() if run.spans else {})
  memory = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else 0

  if run.trace and dev.type == 'cuda':
    sl = trace_lib.Slice()
    first, last = tr['trace_steps']
    counters = {'b1': lambda: physics.launch.launches,
                'b2': lambda: gp_window.launch.launches}

    def at_step(original):
      def step_batched(params, state, actions, global_step=None,
                       refresh='auto'):
        if global_step == first:
          sl.start(counters)
        if global_step == last:
          sl.stop()
        return original(params, state, actions, global_step=global_step,
                        refresh=refresh)
      return step_batched
    undo = check.rebind(env_lib, 'step_batched', at_step)
    eval_fn(seeds, state0, obs0)
    undo()
    run.ctx['trace'] = trace_lib.reduce_slice(sl, tr['kernels'])
    run.ctx['trace']['steps'] = last - first
  capture.close()
  if run.spans:
    run.spans.close()

  del state0, obs0, out, eval_fn, decoder, field_fn
  if dev.type == 'cuda':
    torch.cuda.empty_cache()
  reset_seeds = [seeds[i] for i in idx.tolist()]
  numbers, reference = check.env_numbers(cfg['env'], capture, reset_seeds,
                                         dec_w, dev)
  numbers.update(policy.numbers(capture, weights, cfg))
  run.numbers = numbers
  if control:
    run.control = check.env_control(cfg['env'], capture, reset_seeds, dec_w,
                                    dev, reference)
    run.control.update(policy.numbers(capture, weights, cfg, control=True))
  rate = n * calls * steps / window_s
  return {'eval_env_steps_per_s': rate, 'setup_s': setup_s}, calls, failed, \
      memory


def run_train(run: Run, faults=(), control=False):
  """The training cell: the policy's actor-learner chunks over E envs."""
  from ble_tpu_torch.env import env as env_lib
  from ble_tpu_torch.env import wind_gp
  from ble_tpu_torch.generative import vae
  from ble_tpu_torch.train import learner as learner_lib
  from portbench import check
  from portbench import trace as trace_lib

  cfg, tr, dev = run.cfg, run.traffic, run.device
  policy = policies.load(cfg['policy'])
  chunk = cfg['train_chunk_steps']
  n = tr['num_envs']
  config = policy.train_config(cfg, n)
  idx = check.sample_rows(run.seed, n, tr['check_rows'])
  capture = check.Capture(idx, tr['check_steps'], dev)
  for fault in faults:
    fault(run)
  if run.trace:
    run.spans = trace_lib.Spans()
    run.spans.install(env_lib, 'reset', 'reset')
    run.spans.install(env_lib, 'step_batched', 'env_step')
    run.spans.install(wind_gp, 'refresh', 'gp_refresh')
    policy.spans(run.spans)
    run.spans.install(learner_lib, 'learn', 'learn')
  capture.install_env(env_lib)
  policy.install(capture, cfg, config, chunk)

  dec_w = decoder_weights(run.seed, dev)
  decoder = module_on(vae.Decoder, dec_w, dev)
  field_fn = env_lib.make_field_fn('generative', decoder)
  env_params = _env_params(cfg)
  world = learner_lib.TRAIN_SEED_BASE + (run.seed % 2**30) * 2**12
  seeds = list(range(world, world + n))
  env_state, obs = _reset(env_params, seeds, field_fn, dev, n)
  _sync(dev)
  capture.reset_obs = obs[capture.idx].clone()
  ts = learner_lib.train_state_from_envs(config, env_state, obs,
                                         seed=run.seed % 2**62,
                                         next_world_seed=world + n)
  weights = policy.weights(run.seed, cfg, obs.shape[1], dev)
  policy.load(ts, weights)
  del env_state, obs

  # Fills replay past can_sample and takes the first train steps, through
  # the window's own call; every shape of the window runs here.
  ts, metrics = learner_lib.run_episode_chunk(config, env_params, ts, chunk)
  _sync(dev)
  if len(capture.train['losses']) < 3:
    raise RuntimeError('set-up took fewer than 3 train steps; replay could '
                       'not sample within one chunk')
  run.ctx['setup_spans'] = run.spans.take() if run.spans else {}

  calls, failed, ends = 0, 0, []
  t_start = time.perf_counter()
  setup_s = t_start - run.t0
  while True:
    ts, metrics = learner_lib.run_episode_chunk(config, env_params, ts, chunk)
    _sync(dev)
    ends.append(time.perf_counter())
    calls += 1
    failed += int(not bool(torch.isfinite(metrics['loss']).all()))
    if time.perf_counter() - t_start >= run.seconds:
      break
  window_s = time.perf_counter() - t_start
  grad = config.grad_steps_per_env_step()
  run.ctx.update(window_s=window_s, calls=calls, envs=n,
                 call_s=_call_seconds(t_start, ends),
                 steps=calls * chunk, grad_steps=calls * chunk * grad,
                 grad_steps_per_env_step=grad,
                 work=policy.work(cfg, ts.obs.shape[1],
                                  config.replay.batch_size),
                 window_spans=run.spans.take() if run.spans else {})
  memory = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else 0

  if run.trace and dev.type == 'cuda':
    from ble_tpu_torch.ops import gp_window
    from ble_tpu_torch.ops import physics
    sl = trace_lib.Slice()
    profiled = tr['trace_env_step']
    counters = {'b1': lambda: physics.launch.launches,
                'b2': lambda: gp_window.launch.launches}

    def at_step(original):
      def env_step(config, env_params, ts, grad_transform=None,
                   global_step=None):
        if global_step == profiled:
          sl.start(counters)
        out = original(config, env_params, ts, grad_transform, global_step)
        if global_step == profiled:
          sl.stop()
        return out
      return env_step
    undo = check.rebind(learner_lib, 'env_step', at_step)
    ts, _ = learner_lib.run_episode_chunk(config, env_params, ts, chunk)
    undo()
    run.ctx['trace'] = trace_lib.reduce_slice(sl, tr['kernels'])
    run.ctx['trace'].update(grad_steps=grad, steps=1)
  capture.close()
  if run.spans:
    run.spans.close()

  del ts, metrics, decoder, field_fn
  if dev.type == 'cuda':
    torch.cuda.empty_cache()
  reset_seeds = [seeds[i] for i in idx.tolist()]
  numbers, reference = check.env_numbers(cfg['env'], capture, reset_seeds,
                                         dec_w, dev)
  numbers.update(policy.numbers(capture, weights, cfg))
  run.numbers = numbers
  if control:
    run.control = check.env_control(cfg['env'], capture, reset_seeds, dec_w,
                                    dev, reference)
    run.control.update(policy.numbers(capture, weights, cfg, control=True))
  rate = n * calls * chunk / window_s
  return {'train_env_steps_per_s': rate, 'setup_s': setup_s}, calls, failed, \
      memory


RUNNERS = {'eval': run_eval, 'train': run_train}


def power_limit_w():
  """The card's power limit by nvidia-smi, or None where it cannot say."""
  try:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=power.limit', '--format=csv,noheader,'
         'nounits', '-i', '0'], capture_output=True, text=True, timeout=20)
    return float(out.stdout.strip().splitlines()[0])
  except (OSError, ValueError, IndexError, subprocess.SubprocessError):
    return None


def execute(spec: Spec, seed: int, seconds: float, trace: bool, device,
            t0: float, faults=(), control=False) -> dict:
  """One run of the cell: its result line as a dict, `checks` last."""
  run = Run(spec, seed, seconds, trace, device, t0)
  values, calls, failed, memory = RUNNERS[spec.traffic['kind']](
      run, faults, control)
  dev = run.device
  result = {'attempted': calls, 'failed': failed}
  if trace:
    metrics = {}
    for m in spec.per_layer:
      value = read_metric(m['name'], run.ctx)
      if value is not None:
        metrics[m['name']] = {'value': value, 'unit': m['unit']}
  else:
    metrics = {m['name']: {'value': values[m['name']], 'unit': m['unit']}
               for m in spec.end_to_end}
  result['metrics'] = metrics
  result['device'] = {
      'platform': 'gpu' if dev.type == 'cuda' else dev.type,
      'kind': (torch.cuda.get_device_name(dev) if dev.type == 'cuda'
               else 'cpu'),
      'count': 1,
      'memory_peak_bytes': memory,
      'power_limit_w': power_limit_w() if dev.type == 'cuda' else None,
  }
  print(f'portbench: window {run.ctx["window_s"]!r} s in calls of '
        f'{run.ctx["call_s"]!r} s', file=sys.stderr)
  tr = run.ctx.get('trace')
  if tr is not None:
    print('portbench: trace ' + json.dumps(
        {k: tr[k] for k in ('busy_s', 'window_s', 'kernels', 'launches',
                            'records', 'lost', 'launches_in', 'span_calls')}),
          file=sys.stderr)
  if trace and tr is not None:
    result['device']['busy_s'] = tr['busy_s']
    result['device']['window_s'] = tr['window_s']
    result['breakdown'] = {'device_ops': tr['device_ops'],
                           'idle_gaps': tr['idle_gaps']}
  from portbench import check
  decided = check.decide(run.numbers, spec.limits)
  result['correct'] = all(ok for *_, ok in decided) and failed == 0
  result['checks'] = {name: {'value': value, 'limit': limit}
                      for name, value, limit, _ in decided}
  result['_decided'] = decided
  result['_control'] = run.control
  result['_ctx'] = run.ctx
  return result


def forbidden_modules():
  return sorted({m.split('.')[0] for m in sys.modules} &
                set(FORBIDDEN_MODULES))


def main(argv, t0: float) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seed', type=int, required=True)
  parser.add_argument('--seconds', type=float, required=True)
  parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
  args = parser.parse_args(argv)
  spec = load_spec(args.workload)
  chips = spec.workload['chips']
  if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
    print(f'portbench: needs {chips} CUDA device(s); torch sees '
          f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
          file=sys.stderr)
    return 2
  result = execute(spec, args.seed, args.seconds, bool(args.trace), 'cuda',
                   t0)
  found = forbidden_modules()
  if found:
    print(f'portbench: the run loaded {found}; nothing it runs may import '
          'JAX or the JAX package', file=sys.stderr)
    return 3
  decided = result.pop('_decided')
  for key in ('_control', '_ctx'):
    result.pop(key)
  line = {k: result[k] for k in ('correct', 'attempted', 'failed', 'metrics',
                                 'device')}
  if 'breakdown' in result:
    line['breakdown'] = result['breakdown']
  line['checks'] = result['checks']
  for name, value, limit, ok in decided:
    if not ok:
      print(f'portbench: check {name} failed: {value} against limit {limit}',
            file=sys.stderr)
  if result['failed']:
    print(f'portbench: {result["failed"]} calls gave non-finite results',
          file=sys.stderr)
  for name, value, limit, ok in decided:
    print(f'check {name} {value!r} limit {limit!r} {"ok" if ok else "FAIL"}',
          file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(line))
  sys.stdout.flush()
  return 0
