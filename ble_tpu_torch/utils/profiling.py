"""Tracing and timing helpers (the port of ble_tpu/utils/profiling.py).

`trace` wraps a region in a torch.profiler trace, written into a directory
as a Chrome trace (chrome://tracing, Perfetto); `StepTimer` collects
wall-clock time by phase, with a device synchronisation at the end of a
phase, for quick CLI printouts.
"""

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
  """torch.profiler over the region (host ops, and the card's kernels when
  CUDA is available), written to <log_dir>/trace_<pid>_<ns>.json, <ns>
  the start in nanoseconds; yields that path. A no-op yielding None when
  log_dir is None."""
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
  prof.start()
  try:
    yield path
  finally:
    prof.stop()
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
