"""Runs one cell of the port's benchmark and prints its result line.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

from the repository's root, on a machine with the cell's CUDA devices.
The last line of standard output is one JSON object; the last lines of
standard error are the numbers that decide `correct`, each beside its
limit.
"""

import os
import sys
import time


def _process_start() -> float:
  """perf_counter's reading at this process's start (from /proc, to a
  clock tick), so set-up counts the interpreter's start too."""
  now = time.perf_counter()
  try:
    with open('/proc/self/stat') as f:
      started = int(f.read().rsplit(')', 1)[1].split()[19])
    with open('/proc/uptime') as f:
      uptime = float(f.read().split()[0])
    return now - max(0.0, uptime - started / os.sysconf('SC_CLK_TCK'))
  except (OSError, ValueError, IndexError):
    return now


T0 = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every cache of the program and of torch in fixed directories inside the
# checkout: the port builds its kernels into ble_tpu_torch/_build there.
CACHE = os.path.join(ROOT, '.portbench_cache')
os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(CACHE, 'torch_extensions')
os.environ['TRITON_CACHE_DIR'] = os.path.join(CACHE, 'triton')
os.environ['TORCHINDUCTOR_CACHE_DIR'] = os.path.join(CACHE, 'inductor')
os.environ['CUDA_CACHE_PATH'] = os.path.join(CACHE, 'cuda')
os.environ['USE_FLAX'] = '0'
sys.path.insert(0, ROOT)

if __name__ == '__main__':
  from portbench import harness
  sys.exit(harness.main(sys.argv[1:], T0))
