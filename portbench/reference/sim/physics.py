"""One agent step of balloon physics, plain: the safety remap, then the
substeps one after another (balloon.run_substeps). The reference of the
port's fused physics kernel, which runs the same substeps in one launch.
"""

from portbench.reference.sim import balloon as balloon_lib
from portbench.reference.sim import constants


def simulate_step_fused(params, atmosphere, state, wind_u, wind_v, action,
                        time_delta_s: int = constants.AGENT_TIME_STEP_SECONDS,
                        stride_s: int = constants.PHYSICS_STRIDE_SECONDS):
  """Batched balloon.simulate_step: safety, then the substep loop."""
  if time_delta_s % stride_s:
    raise ValueError('time_delta_s must be a multiple of stride_s')
  state, act = balloon_lib.apply_safety(params, atmosphere, state, action)
  return balloon_lib.run_substeps(params, atmosphere, state, wind_u, wind_v,
                                  act, time_delta_s // stride_s, stride_s)
