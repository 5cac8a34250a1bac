"""The port's tracer over a QR-DQN (or, with --agent r2d2, an R2D2)
training run: what set-up and the train step spend their time on, how
long the learner waits, and where the device idles.

  python -m ble_tpu_torch.examples.trace_train --num_envs 1024 --steps 16 \\
      --profile /tmp/trace --cost 8
  python -m ble_tpu_torch.examples.trace_train --device cpu --wind static \\
      --num_envs 4 --steps 9 --set qrdqn.num_layers=2 \\
      --set qrdqn.hidden_units=32 --set qrdqn.num_atoms=11 \\
      --set qrdqn.min_replay_history=8 --set replay.ring_len=64 \\
      --set replay.batch_size=8
  python -m ble_tpu_torch.examples.trace_train --agent r2d2 \\
      --num_envs 1024 --steps 16

The tracer (utils/profiling.py) is on from before the reset. Set-up is the
reset, the learner's init, and chunks of 8 env steps (the slab cache's
cadence) until replay can sample; the window is --steps env steps in
chunks of 8. With
--profile DIR, one more env step runs under profiling.trace(DIR), and the
Chrome trace it writes is read back: each of the device's idle gaps, and
each kernel launch, is put down to the innermost `ble.` range the host was
in when it began. With --cost N, N pairs of one-step chunks then run with
the tracer off and on (the order swapped every pair), each timed alone
between device synchronisations. Prints one JSON object:
  setup, window    take()'s by_name ({span: calls, wall_s, self_s, cpu_s})
                   and counters (kernels_built, the kernel wrappers'
                   launches, the sample and train graphs' captures,
                   replays and eager steps);
  setup_s          env.reset, reset.draws, learner.init and the set-up
                   chunks (learner.chunk), and the process's time to the
                   window;
  train_step_ms    replay.sample, the loss (qrdqn.loss, or r2d2.loss
                   with both unrolls), optimizer.backward, Adam
                   (optimizer.step + optimizer.target_sync), the train
                   graph's replay (qrdqn.graph_step, where it ran) and
                   learner.learn's self time, a train step; `covered`,
                   the share of learner.learn the parts before the self
                   time take;
  learner_wait_ms  learner.learn's wall less its thread CPU time, an env
                   step: the learner's thread off the CPU;
  profile          (--profile) busy_s, idle_s, idle_gaps and launches by
                   span, largest first;
  cost             (--cost) the median env step off and on, on/off - 1 of
                   the medians and the median of the pairs' on/off - 1;
                   an empty span's ns off and on, the window's spans an
                   env step, and what they add to the step's median.
"""

import argparse
import heapq
import json
import statistics
import time

import torch

from ble_tpu_torch import config as config_lib
from ble_tpu_torch import resolve_device
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.models import loader
from ble_tpu_torch.train import learner as learner_lib
from ble_tpu_torch.utils import profiling

_DEVICE_WORK = ('kernel', 'gpu_memcpy', 'gpu_memset')
_LAUNCHES = ('cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
             'cuLaunchKernelEx', 'cudaMemcpyAsync', 'cudaMemsetAsync')


def _innermost(points, ranges):
  """For sorted times, the name of the shortest (start, end, name) range
  with start <= t < end, or None: one sweep over both."""
  ranges = sorted(ranges)
  open_, ends, out, k = {}, [], [], 0
  for t in points:
    while k < len(ranges) and ranges[k][0] <= t:
      open_[k] = ranges[k]
      heapq.heappush(ends, (ranges[k][1], k))
      k += 1
    while ends and ends[0][0] <= t:
      open_.pop(heapq.heappop(ends)[1], None)
    best = min(open_.values(), key=lambda r: r[1] - r[0], default=None)
    out.append(None if best is None else best[2])
  return out


def read_chrome_trace(events) -> dict:
  """busy_s, idle_s, and idle seconds and launches by innermost span, from
  a Chrome trace's events (microseconds): the device's work merged into
  busy intervals, each gap between two of them put down to the `ble.`
  range open on the host where it began ('none' outside every range)."""
  work, spans, launches = [], [], []
  for e in events:
    if e.get('ph') != 'X':
      continue
    start, end = e['ts'], e['ts'] + e.get('dur', 0)
    if e.get('cat') in _DEVICE_WORK:
      work.append((start, end))
    elif e.get('cat') == 'user_annotation' and e['name'].startswith('ble.'):
      spans.append((start, end, e['name'][4:]))
    elif (e.get('cat') in ('cuda_runtime', 'cuda_driver')
          and e['name'] in _LAUNCHES):
      launches.append(start)
  merged = []
  for start, end in sorted(work):
    if merged and start <= merged[-1][1]:
      merged[-1][1] = max(merged[-1][1], end)
    else:
      merged.append([start, end])
  gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
  idle, calls = {}, {}
  for (start, end), name in zip(gaps, _innermost([g[0] for g in gaps],
                                                  spans)):
    key = name or 'none'
    idle[key] = idle.get(key, 0.0) + (end - start) * 1e-6
  for name in _innermost(sorted(launches), spans):
    calls[name or 'none'] = calls.get(name or 'none', 0) + 1
  largest = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))
  return {'busy_s': sum(e - s for s, e in merged) * 1e-6,
          'idle_s': sum(e - s for s, e in gaps) * 1e-6,
          'idle_gaps': largest(idle), 'launches': largest(calls)}


def train_step_split(by_name: dict, env_steps: int) -> dict:
  """The train step's parts in ms, and the learner's wait an env step."""
  wall = lambda name: by_name.get(name, {}).get('wall_s', 0.0)
  learn = by_name.get('learner.learn')
  if learn is None:
    return {}
  steps = by_name['replay.sample']['calls']
  loss = 'r2d2.loss' if 'r2d2.loss' in by_name else 'qrdqn.loss'
  parts = {'replay.sample': wall('replay.sample'), loss: wall(loss),
           'optimizer.backward': wall('optimizer.backward'),
           'adam': wall('optimizer.step') + wall('optimizer.target_sync')}
  if 'qrdqn.graph_step' in by_name:
    parts['qrdqn.graph_step'] = wall('qrdqn.graph_step')
  split = {k: 1e3 * v / steps for k, v in parts.items()}
  split['learner.learn self'] = 1e3 * learn['self_s'] / steps
  split['covered'] = sum(parts.values()) / learn['wall_s']
  return {'train_steps': steps, 'train_step_ms': split,
          'learner_wait_ms': 1e3 * (learn['wall_s'] - learn['cpu_s'])
                             / env_steps}


def _span_ns(n: int = 100000) -> float:
  """Nanoseconds an empty span takes, the tracer as it is."""
  t = time.perf_counter_ns()
  for _ in range(n):
    with profiling.span('cost'):
      pass
  return (time.perf_counter_ns() - t) / n


def _table(taken: dict) -> dict:
  return {'by_name': taken['by_name'], 'counters': taken['counters']}


def main(argv=None) -> dict:
  start = time.perf_counter()
  p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  p.add_argument('--agent', choices=('quantile', 'r2d2'), default='quantile')
  p.add_argument('--num_envs', type=int, default=1024)
  p.add_argument('--steps', type=int, default=16)
  p.add_argument('--wind', choices=('generative', 'static'),
                 default='generative')
  p.add_argument('--seed', type=int, default=0)
  p.add_argument('--profile', default=None, metavar='DIR',
                 help='trace one more env step into DIR and read it back')
  p.add_argument('--cost', type=int, default=0, metavar='N',
                 help='N pairs of env steps, the tracer off and on')
  p.add_argument('--set', action='append', default=[],
                 help='TrainConfig override, e.g. replay.batch_size=8')
  p.add_argument('--device', default=None, help='cuda (default) or cpu')
  args = p.parse_args(argv)
  device = resolve_device(args.device)
  config = config_lib.apply_overrides(
      learner_lib.TrainConfig(agent=args.agent, num_envs=args.num_envs),
      args.set)
  params = env_lib.EnvParams(field_cache=True)
  chunk = params.field_cache_every

  def sync():
    if device.type == 'cuda':
      torch.cuda.synchronize(device)

  profiling.enable()
  if args.wind == 'generative':
    field_fn = env_lib.make_field_fn(
        'generative', loader.load_offlineskies22(device=device))
  else:
    field_fn = env_lib.make_field_fn('static')
  ts = learner_lib.init_train_state(args.seed, params, field_fn, config,
                                    device=device)
  while ts.learner.train_steps == 0:
    ts, _ = learner_lib.run_episode_chunk(config, params, ts, chunk)
  sync()
  to_window = time.perf_counter() - start
  setup = profiling.take()
  done = 0
  while done < args.steps:
    n = min(chunk, args.steps - done)
    ts, _ = learner_lib.run_episode_chunk(config, params, ts, n)
    done += n
  sync()
  window = profiling.take()

  sb = setup['by_name']
  report = {
      'agent': config.agent, 'num_envs': config.num_envs,
      'steps': args.steps,
      'device': device.type, 'wind': args.wind,
      'setup': _table(setup), 'window': _table(window),
      'setup_s': {name: sb.get(name, {}).get('wall_s') for name in (
          'env.reset', 'reset.draws', 'learner.init', 'learner.chunk')},
      **train_step_split(window['by_name'], args.steps)}
  report['setup_s']['to_window'] = to_window

  if args.profile:
    with profiling.trace(args.profile) as path:
      ts, _ = learner_lib.run_episode_chunk(config, params, ts, 1)
      sync()
    profiling.take()
    with open(path) as f:
      report['profile'] = read_chrome_trace(json.load(f)['traceEvents'])
    report['profile']['path'] = path

  if args.cost:
    seconds = {'off': [], 'on': []}
    for pair in range(args.cost):
      for mode in (('off', 'on') if pair % 2 == 0 else ('on', 'off')):
        (profiling.enable if mode == 'on' else profiling.disable)()
        sync()
        t = time.perf_counter()
        ts, _ = learner_lib.run_episode_chunk(config, params, ts, 1)
        sync()
        seconds[mode].append(time.perf_counter() - t)
        profiling.disable()
        profiling.take()
    median = {k: statistics.median(v) for k, v in seconds.items()}
    ratios = [on / off for on, off in zip(seconds['on'], seconds['off'])]
    span_ns = {'off': _span_ns()}
    profiling.enable()
    span_ns['on'] = _span_ns()
    profiling.disable()
    profiling.take()
    spans = sum(e['calls'] for e in window['by_name'].values()) / args.steps
    report['cost'] = {'median_s': median,
                      'on_vs_off': median['on'] / median['off'] - 1.0,
                      'pairs_on_vs_off': statistics.median(ratios) - 1.0,
                      'span_ns': span_ns, 'spans_per_step': spans,
                      'spans_on_vs_off': spans * 1e-9 * (
                          span_ns['on'] - span_ns['off']) / median['off'],
                      'seconds': seconds}
  profiling.disable()
  print(json.dumps(report))
  return report


if __name__ == '__main__':
  main()
