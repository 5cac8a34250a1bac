"""Spans around the port's entry points, and a device trace of a bounded
slice, for the per-layer metrics of `--trace 1` runs.

Spans rebind a port function in its module (the port has no spans of its
own): each call runs under torch.profiler.record_function('pb.<name>')
and adds its host-clock duration to the span's list. The device trace
covers a few steps only: one step of the eval makes thousands of kernel
launches, and the profiler's records of a whole window would not fit the
run's time. A slice whose kernel records are fewer than its launches has
lost records, and the metrics read from it are left out.
"""

import collections
import time

import torch
from torch.autograd import DeviceType

from portbench import check


class Spans:
  """Host-clock durations of the port's calls, by span name."""

  def __init__(self):
    self.seconds = collections.defaultdict(list)
    self._undo = []

  def install(self, module, attr: str, name: str):
    """module.attr under the span `name` until close()."""
    self._undo.append(check.rebind(module, attr,
                                   lambda original: self.wrap(original, name)))

  def wrap(self, fn, name: str):
    """`fn` under the span `name`."""
    def spanned(*args, **kwargs):
      t = time.perf_counter()
      with torch.profiler.record_function(f'pb.{name}'):
        out = fn(*args, **kwargs)
      self.seconds[name].append(time.perf_counter() - t)
      return out
    return spanned

  def take(self) -> dict:
    """The durations so far, and a fresh start."""
    out = {k: list(v) for k, v in self.seconds.items()}
    self.seconds.clear()
    return out

  def close(self):
    for undo in reversed(self._undo):
      undo()
    self._undo = []


class Slice:
  """A device trace from start() to stop(), both after a synchronise."""

  def __init__(self):
    self.prof = None
    self.host_s = None
    self.counters = {}

  def start(self, counters: dict):
    torch.cuda.synchronize()
    self.counters = {k: fn() for k, fn in counters.items()}
    self._counter_fns = counters
    self.prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
    self.prof.start()
    self._t = time.perf_counter()

  def stop(self):
    torch.cuda.synchronize()
    self.host_s = time.perf_counter() - self._t
    self.prof.stop()
    self.counters = {k: fn() - self.counters[k]
                     for k, fn in self._counter_fns.items()}


_LAUNCH_NAMES = ('cudaLaunchKernel', 'cuLaunchKernel', 'cudaLaunchKernelExC',
                 'cuLaunchKernelEx', 'cudaLaunchCooperativeKernel')


# Host ranges the profiler also copies to the device's timeline: the
# harness's spans and torch.optim's.
_ANNOTATIONS = ('pb.', 'Optimizer.')


def _union(intervals):
  """Merged (start, end) intervals, sorted."""
  merged = []
  for s, e in sorted(intervals):
    if merged and s <= merged[-1][1]:
      merged[-1][1] = max(merged[-1][1], e)
    else:
      merged.append([s, e])
  return merged


def reduce_slice(sl: Slice, kernel_names: dict) -> dict:
  """What the metrics read from a slice's trace, times in seconds:
  busy_s (the union of device records), window_s (the slice's host
  clock), kernels {name: (count, seconds)} of `kernel_names`' keys (a
  kernel is matched by a name that contains the value), launches (the
  host's launch calls), records (device kernel records), lost (records
  fewer than launches, or a counted kernel with fewer records than the
  program's launch counter), launches_in {span: count}, top device ops,
  and the idle gaps by the innermost span the host was in."""
  events = sl.prof.events()
  device, spans, launches = [], [], []
  for e in events:
    start, end = e.time_range.start, e.time_range.end
    if e.device_type == DeviceType.CUDA and (
        getattr(e, 'is_user_annotation', False) or
        e.name.startswith(_ANNOTATIONS)):
      continue  # A host range copied to the device's timeline: no work.
    if e.name.startswith('pb.'):
      spans.append((start, end, e.name[3:]))
    elif e.device_type == DeviceType.CUDA:
      device.append((start, end, e.name))
    elif e.name in _LAUNCH_NAMES:
      launches.append(start)
  kernels = {k: [0, 0.0] for k in kernel_names}
  by_name = collections.defaultdict(float)
  records = 0
  for s, e, name in device:
    if not name.startswith(('Memcpy', 'Memset', 'memcpy', 'memset')):
      records += 1
    by_name[name] += (e - s) * 1e-6
    for k, prefix in kernel_names.items():
      if prefix in name:
        kernels[k][0] += 1
        kernels[k][1] += (e - s) * 1e-6
  lost = bool(launches) and records < len(launches)
  for k, expected in sl.counters.items():
    if k in kernels and kernels[k][0] < expected:
      lost = True
  merged = _union([(s, e) for s, e, _ in device])
  busy_us = sum(e - s for s, e in merged)
  gaps = collections.defaultdict(float)
  for (_, e0), (s1, _) in zip(merged[:-1], merged[1:]):
    inner = [sp for sp in spans if sp[0] <= e0 < sp[1]]
    label = min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner else 'harness'
    gaps[label] += (s1 - e0) * 1e-6
  launches_in = collections.defaultdict(int)
  for name in {sp[2] for sp in spans}:
    ranges = [(s, e) for s, e, n in spans if n == name]
    launches_in[name] = sum(1 for t in launches
                            if any(s <= t < e for s, e in ranges))
  top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
  return {
      'busy_s': busy_us * 1e-6,
      'window_s': sl.host_s,
      'kernels': {k: tuple(v) for k, v in kernels.items()},
      'launches': len(launches),
      'records': records,
      'lost': lost,
      'launches_in': dict(launches_in),
      'span_calls': dict(collections.Counter(sp[2] for sp in spans)),
      'device_ops': [[n, s] for n, s in top],
      'idle_gaps': [[n, s] for n, s in
                    sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
  }
