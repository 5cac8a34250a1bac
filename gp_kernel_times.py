#!/usr/bin/env python3
"""Times the five kernels (B1-B5) of one checkout's ble_tpu_torch on one
NVIDIA GPU, so that two commits can be compared on one card in one call:

  python3 gp_kernel_times.py [--root DIR]    # default: this checkout

Builds the kernels of DIR/ble_tpu_torch/csrc at first use, makes inputs
from fixed seeds with the package's own reset and plain versions, and
prints one JSON line: for B1 at E = 1 and 4096 envs (18 substeps, states
from the port's reset on the static field), B5 at E = 1 and 4096 (181
levels), B2 at E = 4096 (K = 1), B3 at E = 1 and B4 at E = 4096, the mean
milliseconds a launch by CUDA events over back-to-back calls of the
package's launcher (`ms`) and the kernels' own device time under
torch.profiler (`device_ms`); both for the yardsticks, `torch.bmm` for B5
and B2 and `torch.baddbmm` of the rank-8 update for B3 and B4; and for B1
the sha256 of its inputs and of its outputs, so that the call shows
whether two checkouts' B1 give the same bits. At E = 1 the events time the
host's launch path, not the kernel. Compare two checkouts by running
parent, change, change, parent in one call. It uses only entry points that
every checkout since the port's second slice has, and exits non-zero
without a card.
"""

import argparse
import hashlib
import json
import os
import sys

import torch

# Timing helpers and GP states from this checkout's chip_smoke.py,
# imported before --root is put on the path. Their ble_tpu_torch imports
# run at call time, so the states come from the checkout under test.
import chip_smoke as cs


def _sha256(tensors) -> str:
  """The sha256 of the tensors' bytes, in order."""
  digest = hashlib.sha256()
  for t in tensors:
    digest.update(t.cpu().numpy().tobytes())
  return digest.hexdigest()


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
  from ble_tpu_torch.env import env as env_lib
  from ble_tpu_torch.ops import gp_observe
  from ble_tpu_torch.ops import gp_query
  from ble_tpu_torch.ops import gp_window
  from ble_tpu_torch.ops import physics
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
  params = env_lib.EnvParams(field_cache=True)
  env_state, _ = env_lib.reset(params, list(range(cs.E)),
                               cs.static_field_fn(), cs.DEV)
  bufs = cs.b1_inputs(params, env_state)[2]
  params_c = physics.uniform_params(params.balloon)
  for name, n in (('b1_e1', 1), ('b1_e4096', cs.E)):
    a = [buf[..., :n].contiguous() for buf in bufs]
    outs = (torch.empty_like(a[0]), torch.empty_like(a[1]))
    run = lambda: physics.launch(*a, *outs, 18, 10, params_c)
    run()
    torch.cuda.synchronize()
    out[name] = {'ms': cs.cuda_ms(run, reps=50),
                 'device_ms': cs.kernel_device_ms(run),
                 'inputs_sha256': _sha256(a),
                 'outputs_sha256': _sha256(outs)}
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
    w = torch.rand((ob.shape[0], 128, 8), device=cs.DEV)
    library = lambda: torch.baddbmm(a[4], w, w.transpose(1, 2))
    out[name] = {'ms': cs.cuda_ms(lambda: gp_observe.launch(*a), reps=50),
                 'device_ms': cs.kernel_device_ms(
                     lambda: gp_observe.launch(*a)),
                 'baddbmm_ms': cs.cuda_ms(library, reps=20),
                 'baddbmm_device_ms': cs.kernel_device_ms(library)}
  print(json.dumps(out))
  return 0


if __name__ == '__main__':
  sys.exit(main())
