"""The work of the timed path, counted from the cell's shapes alone, so
that a rewrite of a kernel is judged against the same work.

B1 (the physics kernel) does NUM_SUBSTEPS substeps an env and agent step;
its operations a substep are counted by hand from the substep's equations
as (fp32, special-function, ALU) results: each float add, subtract and
multiply one fp32 flop; each division, square root, exponential,
logarithm, sine and cosine at least one special-function result; each
compare, select, min, max, abs, floor, conversion and integer operation
one ALU result. Both sides of a branchless select count.

B2 (the GP window kernel) observes one measurement an env and step and
queries the posterior at 181 pressure levels. The query's variance is the
quadratic form k*^T kinv k* with kinv symmetric, counted at what the form
needs: cap (cap + 1) flops a level.

The QR-DQN network counts 2 x in x out flops a dense layer and row.
"""

import json
import os

NUM_SUBSTEPS = 18
CAP = 128
LEVELS = 181

B1_SUBSTEP_OPS = {
    'advection, buoyancy, ascent, dp/dt': (26, 6, 6),
    'at_pressure_temperature': (6, 3, 17),
    'latlng_from_offset': (125, 16, 71),
    'solar_calculator with days_from_j2000': (205, 47, 185),
    'd_balloon_temperature_dt': (75, 27, 21),
    'superpressure and volume': (17, 3, 3),
    'ACS': (41, 9, 30),
    'solar power and battery': (26, 7, 11),
    'status, time, loop': (0, 0, 11),
}
# B1's packed state: 16 float and 3 int fields in and out, 23 floats of
# atmosphere, 2 of wind and the action in, 4 bytes each.
B1_WORDS_IN = 16 + 3 + 23 + 2 + 1
B1_WORDS_OUT = 16 + 3

# One env's observe: kinv U (4 columns), S = U^T M, the update vectors,
# the rank-8 update of kinv and alpha = kinv targets.
OBSERVE_FLOPS = (2 * CAP * CAP * 4 + 2 * 16 * CAP + CAP * 30 +
                 (2 * 8 + 1) * CAP * CAP + 2 * 2 * CAP * CAP)


def peaks() -> dict:
  with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         'peaks.json')) as f:
    return json.load(f)


def b1_ops(envs: int) -> dict:
  """(fp32, special, alu) results and bytes of one B1 launch over
  `envs` envs."""
  fp32, special, alu = (sum(c[i] for c in B1_SUBSTEP_OPS.values())
                        for i in range(3))
  substeps = envs * NUM_SUBSTEPS
  return {'fp32': substeps * fp32, 'special': substeps * special,
          'alu': substeps * alu,
          'bytes': 4.0 * envs * (B1_WORDS_IN + B1_WORDS_OUT)}


def b1_bound_s(envs: int) -> float:
  """The least time one B1 launch needs: the slowest of its operation
  classes at their peak rates and its bytes at the memory's."""
  ops, pk = b1_ops(envs), peaks()
  return max(ops['fp32'] / pk['fp32_flops_per_s'],
             ops['special'] / pk['special_function_results_per_s'],
             ops['alu'] / pk['alu_results_per_s'],
             ops['bytes'] / pk['hbm_bytes_per_s'])


def query_flops(levels: int = LEVELS) -> float:
  """One env's column query: x/y/t distances, k* (8 a level and slot),
  the means, the symmetric quadratic form, its dot and the clip."""
  return (CAP * 10 + CAP * levels * 8 + 2 * 2 * CAP * levels +
          CAP * (CAP + 1) * levels + 2 * CAP * levels + 4 * levels)


def b2_flops(envs: int, steps: int = 1) -> float:
  """`steps` steps of B2 over `envs` envs: an observe and a query each."""
  return float(envs) * steps * (OBSERVE_FLOPS + query_flops())


def b2_bytes(envs: int, steps: int = 1) -> float:
  """The GP state in and out once a launch, each step's observation row
  and its (181, 3) output."""
  state = CAP * 4 + CAP * 2 + CAP + CAP * CAP + CAP * 2 + 1
  return 4.0 * envs * (2 * state + steps * 8 + steps * LEVELS * 3)


def b2_bound_s(envs: int, steps: int = 1) -> float:
  pk = peaks()
  return max(b2_flops(envs, steps) / pk['fp32_flops_per_s'],
             b2_bytes(envs, steps) / pk['hbm_bytes_per_s'])


def mlp_forward_flops(widths) -> float:
  """One row through dense layers of `widths` (in, hidden..., out)."""
  return float(sum(2 * a * b for a, b in zip(widths[:-1], widths[1:])))


def qrdqn_widths(obs_dim: int, num_layers: int, hidden: int,
                 num_actions: int, num_atoms: int):
  return [obs_dim] + [hidden] * (num_layers - 1) + [num_actions * num_atoms]


def qrdqn_grad_step_flops(widths, batch: int) -> float:
  """One train step: the online network's forward and backward (twice
  the forward) and the target network's forward, over the batch."""
  return 4.0 * batch * mlp_forward_flops(widths)
