"""The reference-ordered episode reset: same seed, same world, parity mode
(the port of ble_tpu/env/parity_reset.py).

`env.reset` splits its key 7 ways up front. The reference instead consumes
its PRNG through a sequence of re-splits spread across BalloonEnv.reset,
BalloonArena.reset / _initialize_balloon and WindField.reset
(balloon_env.py:213, balloon_arena.py:170-177,242-258,
wind_field.py:113-123). `parity_reset` follows that split tree with the
port's samplers, so `env.seed(s); env.reset()` on the reference and
`parity_reset(s, ...)` start from the same initial conditions: atmosphere
lapse blend, start time, balloon position, pressure and upwelling IR, the
OpenSimplex noise lattices and the VAE forecast grid. It also equals the
JAX package's parity_reset(s).

The draws and the permutation builds run on the host; the state lands on
`device`. Parity runs are one env by design: the fixed-seed verification
surface, not the training path. The state feeds
eval_lib.build_eval_fn(from_states=True).
"""

import math

import torch

from ble_tpu_torch import resolve_device
from ble_tpu_torch.env import atmosphere as atmosphere_lib
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.utils import prng
from ble_tpu_torch.utils import sampling

# BalloonArena's initial-offset beta distribution (balloon_arena.py:153-154).
_ALPHA = 1.2
_BETA = 2.0


def parity_reset(seed: int, params: env_lib.EnvParams, field_fn,
                 device=None):
  """One episode reset with the reference's draw order and OpenSimplex
  noise (ble_tpu/env/parity_reset.py:35-92, at its defaults: the exact
  noise and a float32 grid, so the grid's interpolation is not what parity
  runs measure).

  Args:
    seed: the integer environment seed (reference env.seed(seed)).
    params: EnvParams (the grid is float32 whatever its wind_field_f32).
    field_fn: (forecast keys (1, 2), device) -> grid, as env.make_field_fn
      gives (the VAE decode of z = normal(key, (64,)), like the reference's
      GenerativeWindFieldSampler.sample_field).
    device: torch device (default: cuda).

  Returns:
    (EnvState, observation (1, 1099)), a batch of one.
  """
  device = resolve_device(device)
  rng = prng.key(seed)[None]

  # BalloonEnv.reset (balloon_env.py:213).
  arena_rng = prng.split(rng)[:, 1]

  # BalloonArena.reset (balloon_arena.py:170-172).
  ks = prng.split(arena_rng, 3)
  arena_rng, atmosphere_key, time_key = ks[:, 0], ks[:, 1], ks[:, 2]
  atmosphere = atmosphere_lib.reset(atmosphere_key)
  t0 = sampling.sample_time(time_key)

  # BalloonArena._initialize_balloon (balloon_arena.py:242-258).
  ks = prng.split(arena_rng, 6)
  arena_rng = ks[:, 0]
  radius_m = prng.beta(ks[:, 1], _ALPHA, _BETA) * 200_000.0
  theta = prng.uniform(ks[:, 2], (), 0.0, 2.0 * math.pi)
  x_m = torch.cos(theta) * radius_m
  y_m = torch.sin(theta) * radius_m
  center_lat, center_lng = sampling.sample_location(ks[:, 3])
  pressure = sampling.sample_pressure(ks[:, 4], atmosphere)
  upwelling_ir = sampling.sample_upwelling_infrared(ks[:, 5])

  # BalloonArena.reset -> WindField.reset (balloon_arena.py:176-177,
  # wind_field.py:121-123).
  wind_field_key = prng.split(arena_rng, 2)[:, 1]
  ks = prng.split(wind_field_key, 2)
  noise_key, forecast_key = ks[:, 0], ks[:, 1]
  field = field_fn(forecast_key, device)

  to = lambda x: x.to(device)
  x_m, y_m = to(x_m), to(y_m)
  # No slab yet, as in the JAX package: the harness centres it.
  wind = env_lib.make_wind(env_lib.EnvParams(wind_field_f32=True), field,
                           noise_key, x_m, y_m, exact_noise=True)
  return env_lib.init_state(params, env_lib.tree_map(to, atmosphere), to(t0),
                            x_m, y_m, to(center_lat), to(center_lng),
                            to(pressure), to(upwelling_ir), wind)
