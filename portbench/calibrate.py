"""Readings behind the check's limits, on the card: for each seed, one
run of a cell (set-up, a short window at the cell's own size, the check)
with the numbers compared, and with --control also the control's: the
reference in TF32 put in the program's place. With --fault, a fault is
planted in the program (faults.py). One JSON line a seed, with the
port's counters of its train step's CUDA graphs (captures, replays, and
eager steps by reason), which show whether the check's steps ran the
graph: its tracer is on for the run, which the numbers do not see.

  python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
      --seconds 3 [--control] [--fault <name>]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import faults as faults_lib  # noqa: E402
from portbench import harness  # noqa: E402


def main(argv):
  parser = argparse.ArgumentParser()
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seeds', required=True)
  parser.add_argument('--seconds', type=float, default=3.0)
  parser.add_argument('--control', action='store_true')
  parser.add_argument('--fault', default=None)
  args = parser.parse_args(argv)
  import torch
  if not torch.cuda.is_available():
    print('calibrate: needs a CUDA device', file=sys.stderr)
    return 2
  from ble_tpu_torch.utils import profiling
  faults = [faults_lib.FAULTS[args.fault]] if args.fault else []
  for seed in [int(s) for s in args.seeds.split(',')]:
    spec = harness.load_spec(args.workload)
    t0 = time.perf_counter()
    profiling.enable()
    try:
      result = harness.execute(spec, seed, args.seconds, False, 'cuda', t0,
                               faults=faults, control=args.control)
    finally:
      profiling.disable()
    counters = profiling.take()['counters']
    print(json.dumps({
        'seed': seed, 'fault': args.fault, 'correct': result['correct'],
        'numbers': {k: v['value'] for k, v in result['checks'].items()},
        'control': result['_control'],
        'metrics': {k: v['value'] for k, v in result['metrics'].items()},
        'graph_counters': {k: v for k, v in counters.items()
                           if '.graph_' in k},
        'seconds': time.perf_counter() - t0}), flush=True)
    for fault in faults:
      fault.undo()
  return 0


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
