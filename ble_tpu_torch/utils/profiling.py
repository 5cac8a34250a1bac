"""Tracing and timing helpers (the port of ble_tpu/utils/profiling.py).

The tracer: `span(name, cpu=False)` marks a region at one of the port's
layer boundaries, `count(name, n)` adds to a counter, and `enable()`,
`disable()` and `take()` turn it on, off, and hand over what it recorded.
The spans sit inside the port's functions:

  learner.chunk, learner.env_step, learner.learn*, learner.init
                      train/learner.py
  qrdqn.select_action, qrdqn.loss, qrdqn.graph_step, dqn.loss,
  r2d2.select_action, r2d2.loss with r2d2.unroll
                      agents/qrdqn.py, dqn.py, r2d2.py
  optimizer.backward, optimizer.step, optimizer.target_sync
                      agents/qrdqn.py:optimizer_step (every agent's)
  marco_polo.step, replay.add, replay.sample
                      agents/marco_polo.py, agents/replay.py
  env.step_batched with env.slab, env.physics, env.wind, env.gp,
  env.features, env.outcome
                      env/env.py (the parts also run in the reset)
  env.reset with reset.draws, reset.decode, reset.init
                      env/env.py
  wind_gp.refresh     env/wind_gp.py
  cuda_build.build, cuda_build.load
                      ops/cuda_build.py
and the counter `kernels_built` counts nvcc builds; `replay.graph_captures`,
`replay.graph_replays`, `qrdqn.graph_captures`, `qrdqn.graph_replays` and
`qrdqn.graph_eager` (with `qrdqn.graph_eager.<reason>`) count the CUDA
graphs of the train step (agents/replay.py, agents/qrdqn.py);
`r2d2.unroll_rows` adds B x (L + 1) for each network's unroll over a
batch of windows, and `replay.sequence_samples` counts the sequence
samples (agents/r2d2.py, agents/replay.py). `take()`
also reports the kernel wrappers' launch counters (`launch.launches` of
ops/physics.py, gp_window.py, gp_observe.py, gp_query.py) by reading
them.

Off (the default), `span` tests one module flag and returns one shared
object that does nothing: no allocation, no clock, no profiler call. On,
a span records its name, its parent (the span open on its thread when it
started) and its start and end on time.perf_counter_ns(). A span opened
with cpu=True (marked * above: one an env step) also reads the thread's
CPU time (time.thread_time_ns()) at both ends, so its wall less its CPU
time is the time the thread spent off the CPU: descheduled, blocked on a
lock or a device sync, or waiting on another thread, such as autograd's
device thread in the backward. The other spans do not: the CPU clock is
a system call, and read at every span of the train step it cost 13-17 %
of the learner's env-step time on an H100 host, where the wall clock
alone read -1.4 % and +1.3 % in two runs of 16 alternating steps.
While a torch.profiler session is active, each span also opens a
record_function range named `ble.<name>`, which puts it on the
profiler's clock beside the device's kernels.

`trace(log_dir)` wraps a region in a torch.profiler trace written as a
Chrome trace (chrome://tracing, Perfetto) and turns the tracer on for the
region: the exported trace shows the `ble.` ranges over the host's calls
and the card's kernels, which is how to read where the device waits.
examples/trace_train.py reads all of it over a QR-DQN training run: the
set-up's parts, the train step's parts and the learner's wait from
take(), kernels_built and the launch counters, the device's idle gaps by
span from trace()'s Chrome trace, and the tracer's own cost.
`StepTimer` collects wall-clock time by phase, with a device
synchronisation at the end of a phase, for quick CLI printouts.
"""

import collections
import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import Dict, NamedTuple, Optional

import torch

_on = False
# One tuple a closed span, (seq, parent seq or -1, name, start_ns, end_ns,
# cpu_start_ns, cpu_end_ns), appended as it closes; seq counts the starts;
# the CPU times are None for a span opened without cpu.
_records = []
_seq = itertools.count()
_counts: Dict[str, int] = collections.Counter()
_launch_base: Dict[str, int] = {}
_thread = threading.local()
_profiler_enabled = torch._C._autograd._profiler_enabled


class SpanRecord(NamedTuple):
  name: str
  parent: int  # Index of the parent's record in the same take(), or -1.
  start_ns: int
  end_ns: int
  cpu_start_ns: Optional[int]  # None for a span opened without cpu.
  cpu_end_ns: Optional[int]


class _Off:
  """The span of a disabled tracer: one object, doing nothing."""
  __slots__ = ()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    return False


_OFF = _Off()


class _Span:
  __slots__ = ('name', 'cpu', 'seq', 'parent', 'start', 'cpu_start',
               'range')

  def __init__(self, name: str, cpu: bool):
    self.name = name
    self.cpu = cpu
    self.range = None

  def __enter__(self):
    stack = getattr(_thread, 'stack', None)
    if stack is None:
      stack = _thread.stack = []
    self.parent = stack[-1] if stack else -1
    self.seq = next(_seq)
    stack.append(self.seq)
    if _profiler_enabled():
      self.range = torch.profiler.record_function('ble.' + self.name)
      self.range.__enter__()
    self.cpu_start = time.thread_time_ns() if self.cpu else None
    self.start = time.perf_counter_ns()
    return self

  def __exit__(self, *exc):
    end = time.perf_counter_ns()
    cpu_end = time.thread_time_ns() if self.cpu else None
    if self.range is not None:
      self.range.__exit__(None, None, None)
    _thread.stack.pop()
    _records.append((self.seq, self.parent, self.name, self.start, end,
                     self.cpu_start, cpu_end))
    return False


def span(name: str, cpu: bool = False):
  """A context manager around one of the port's layers; with `cpu`, it
  also reads the thread's CPU time. See the module docstring for what it
  records, and for its cost."""
  if not _on:
    return _OFF
  return _Span(name, cpu)


def count(name: str, n: int = 1) -> None:
  """Adds `n` to the counter `name` while the tracer is on."""
  if _on:
    _counts[name] += n


def _launches() -> Dict[str, int]:
  """The kernel wrappers' launch counters (B1-B5), read, not kept."""
  from ble_tpu_torch.ops import gp_observe
  from ble_tpu_torch.ops import gp_query
  from ble_tpu_torch.ops import gp_window
  from ble_tpu_torch.ops import physics
  return {f'launches.{m.__name__.rsplit(".", 1)[1]}': m.launch.launches
          for m in (physics, gp_window, gp_observe, gp_query)}


def _add_launches() -> None:
  """The launches since the last reading into the counters."""
  global _launch_base
  now = _launches()
  for name, value in now.items():
    _counts[name] += value - _launch_base.get(name, value)
  _launch_base = now


def enable() -> None:
  """Turns the tracer on."""
  global _on, _launch_base
  if not _on:
    _launch_base = _launches()
    _on = True


def disable() -> None:
  """Turns the tracer off; what it recorded stays until take()."""
  global _on
  if _on:
    _add_launches()
    _on = False


def take() -> dict:
  """What the tracer recorded since the last take(), and a fresh start:
  'spans', the SpanRecords of the spans that closed since, in order of
  their starts (a span still open is reported by the take() after it
  closes; a parent taken earlier reads -1); 'by_name', {name: {'calls',
  'wall_s', 'self_s' (wall time less the part its child spans cover),
  'cpu_s' (the thread's CPU time, None for a span opened without cpu)}};
  and 'counters', {name: count}, launches included, zeros left out."""
  global _records, _counts
  if _on:
    _add_launches()
  records, _records = sorted(_records), []
  counts, _counts = _counts, collections.Counter()
  index = {r[0]: i for i, r in enumerate(records)}
  spans = [SpanRecord(name, index.get(parent, -1), *times)
           for _, parent, name, *times in records]
  children_ns = [0] * len(spans)
  for s in spans:
    if s.parent >= 0:
      children_ns[s.parent] += s.end_ns - s.start_ns
  by_name = {}
  for s, inner in zip(spans, children_ns):
    entry = by_name.setdefault(s.name, {'calls': 0, 'wall_s': 0.0,
                                        'self_s': 0.0, 'cpu_s': None})
    wall = s.end_ns - s.start_ns
    entry['calls'] += 1
    entry['wall_s'] += wall * 1e-9
    entry['self_s'] += (wall - inner) * 1e-9
    if s.cpu_start_ns is not None:
      entry['cpu_s'] = (entry['cpu_s'] or 0.0) + (
          s.cpu_end_ns - s.cpu_start_ns) * 1e-9
  return {'spans': spans, 'by_name': by_name,
          'counters': {k: v for k, v in counts.items() if v}}


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
  """torch.profiler over the region (host ops, and the card's kernels when
  CUDA is available), with the tracer on so its spans show as `ble.`
  ranges, written to <log_dir>/trace_<pid>_<ns>.json, <ns> the start in
  nanoseconds; yields that path. The tracer is left as it was found, its
  records kept for take(). A no-op yielding None when log_dir is None."""
  if log_dir is None:
    yield None
    return
  os.makedirs(log_dir, exist_ok=True)
  path = os.path.join(log_dir,
                      f'trace_{os.getpid()}_{time.time_ns()}.json')
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  prof = torch.profiler.profile(activities=activities)
  was_on = _on
  enable()
  prof.start()
  try:
    yield path
  finally:
    prof.stop()
    if not was_on:
      disable()
    prof.export_chrome_trace(path)


class StepTimer:
  """Accumulates wall-clock time by phase."""

  def __init__(self):
    self._totals: Dict[str, float] = defaultdict(float)
    self._counts: Dict[str, int] = defaultdict(int)

  @contextlib.contextmanager
  def phase(self, name: str, sync=None):
    """Times the region; when `sync` is a CUDA tensor, the phase ends only
    after its device has finished the work queued so far."""
    t0 = time.perf_counter()
    yield
    if isinstance(sync, torch.Tensor) and sync.is_cuda:
      torch.cuda.synchronize(sync.device)
    self._totals[name] += time.perf_counter() - t0
    self._counts[name] += 1

  def summary(self) -> Dict[str, float]:
    """Mean seconds a phase, by name."""
    return {name: self._totals[name] / max(self._counts[name], 1)
            for name in self._totals}

  def report(self) -> str:
    return ' | '.join(f'{k}: {v * 1000:.2f}ms'
                      for k, v in sorted(self.summary().items()))
