#!/usr/bin/env python3
"""Times the GP kernels (B2-B5) of one checkout's ble_tpu_torch on one
NVIDIA GPU, so that two commits can be compared on one card in one call:

  python3 gp_kernel_times.py [--root DIR]    # default: this checkout

Builds the kernels of DIR/ble_tpu_torch/csrc at first use, makes GP states
from fixed seeds with the package's plain versions, and prints one JSON
line: for B5 at E = 1 and 4096 envs (181 levels), B2 at E = 4096 (K = 1),
B3 at E = 1 and B4 at E = 4096, the mean milliseconds a launch by CUDA
events over back-to-back calls of the package's wrapper (`ms`) and the
kernels' own device time under torch.profiler (`device_ms`); and both for
the torch.bmm yardsticks of B5 and B2. At E = 1 the events time the host's
launch path, not the kernel. Compare two checkouts by running parent,
change, change, parent in one call. It uses only entry points that every
checkout since the port's second slice has, and exits non-zero without a
card.
"""

import argparse
import json
import os
import sys

import torch

# Timing helpers and GP states from this checkout's chip_smoke.py,
# imported before --root is put on the path. Their ble_tpu_torch imports
# run at call time, so the states come from the checkout under test.
import chip_smoke as cs


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--root', default=os.path.dirname(
      os.path.abspath(__file__)), help='checkout whose ble_tpu_torch to time')
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    print('gp_kernel_times: no CUDA device', file=sys.stderr)
    return 1
  sys.path.insert(0, os.path.abspath(args.root))
  import ble_tpu_torch  # noqa: F401  (the float32 precision policy)
  from ble_tpu_torch.ops import gp_observe
  from ble_tpu_torch.ops import gp_query
  from ble_tpu_torch.ops import gp_window
  if not os.path.abspath(gp_query.__file__).startswith(
      os.path.abspath(args.root)):
    raise RuntimeError(f'imported {gp_query.__file__}, not from {args.root}')

  f32 = lambda a: a.to(torch.float32).contiguous()
  state = cs.warmed_gp_state()
  state1, obs1 = cs.gp_track_state(1, 140, seed=5)
  obs = cs.gp_obs_seq(1, 2, cs.E, t0_step=140)[1]
  pres = gp_window.pressure_levels(cs.DEV)

  out = {'root': os.path.abspath(args.root),
         'device': torch.cuda.get_device_name(0)}
  for name, st, ob in (('b5_e1', state1, obs1), ('b5_e4096', state, obs)):
    a = gp_query.pack(st, ob[:, 0], ob[:, 1], ob[:, 3], pres)
    k_star = torch.rand((ob.shape[0], 181, 128), device=cs.DEV)
    out[name] = {
        'ms': cs.cuda_ms(lambda: gp_query.launch(*a), reps=20),
        'device_ms': cs.kernel_device_ms(lambda: gp_query.launch(*a)),
        'bmm_ms': cs.cuda_ms(lambda: torch.bmm(k_star, a[3]), reps=20),
        'bmm_device_ms': cs.kernel_device_ms(
            lambda: torch.bmm(k_star, a[3]))}
  w = (cs.gp_obs_seq(2, 1, cs.E, t0_step=140), f32(state.locations),
       f32(state.errors), f32(state.active), f32(state.kinv),
       f32(state.alpha), state.count.to(torch.int32).contiguous())
  k_col = torch.rand((cs.E, 128, 181), device=cs.DEV)
  out['b2_e4096'] = {
      'ms': cs.cuda_ms(lambda: gp_window.launch(*w), reps=20),
      'device_ms': cs.kernel_device_ms(lambda: gp_window.launch(*w)),
      'bmm_ms': cs.cuda_ms(lambda: torch.bmm(state.kinv, k_col), reps=20),
      'bmm_device_ms': cs.kernel_device_ms(
          lambda: torch.bmm(state.kinv, k_col))}
  for name, st, ob in (('b3_e1', state1, obs1), ('b4_e4096', state, obs)):
    a = (ob, f32(st.locations), f32(st.errors), f32(st.active),
         f32(st.kinv), f32(st.alpha), st.count.to(torch.int32).contiguous())
    out[name] = {'ms': cs.cuda_ms(lambda: gp_observe.launch(*a), reps=50),
                 'device_ms': cs.kernel_device_ms(
                     lambda: gp_observe.launch(*a))}
  print(json.dumps(out))
  return 0


if __name__ == '__main__':
  sys.exit(main())
