"""The port's parity mode against ble_tpu's on the CPU: the OpenSimplex
permutation tables, noise4d, uv_noise_exact, parity_reset(s) for
s = 0-3, and 16 steps of one env on the exact noise.

ble_tpu's parity_reset ends in env.init_state, which runs eagerly there.
The module notes the initial conditions parity_reset hands it instead of
running it: the state's structure comes from jax.eval_shape, and the 16
steps run ble_tpu's env.step from the port's parity state carried across,
so the only program compiled is that step.
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ble_tpu.env import env as jax_env
from ble_tpu.env import opensimplex4d as jax_osx
from ble_tpu.env import parity_reset as jax_parity
from ble_tpu.env import simplex_noise as jax_noise
from ble_tpu_torch import bridge
from ble_tpu_torch.agents import station_seeker
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.env import opensimplex4d
from ble_tpu_torch.env import parity_reset
from ble_tpu_torch.env import simplex_noise
from ble_tpu_torch.train import eval_lib

PARITY_SEEDS = (0, 1, 2, 3)
STEPS = 16
_IC_NAMES = ('atmosphere', 't0', 'x_m', 'y_m', 'center_lat', 'center_lng',
             'pressure', 'upwelling_ir', 'wind')


def _recording_static(seen, static):
  """A field_fn giving `static`, noting the forecast key it was given."""
  def field_fn(key, *device):
    seen.append(np.asarray(key).reshape(-1, 2)[0].astype(np.int64))
    return static(key, *device)
  return field_fn


@pytest.fixture(scope='module')
def jax_resets():
  """ble_tpu's parity_reset of each seed (static field): the forecast key
  its field_fn was given and the initial conditions it hands
  env.init_state, by name, with the state's structure."""
  out = {}
  init_state = jax_env.init_state
  templates = []

  def noted(params, *args):
    if not templates:  # One structure serves every seed.
      templates.append(jax.eval_shape(functools.partial(init_state, params),
                                      *args)[0])
    return dict(zip(_IC_NAMES, args)), templates[0]

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jax_env, 'init_state', noted)
    for seed in PARITY_SEEDS:
      seen = []
      ics, template = jax_parity.parity_reset(
          seed, jax_env.EnvParams(),
          field_fn=_recording_static(seen, jax_env.make_field_fn('static')))
      out[seed] = (ics, template, seen[0])
  return out


def test_perm_from_seed_matches_jax():
  """Equal tables for numpy-drawn seeds, the noise reset's range and the
  Java two's-complement edges."""
  seeds = np.random.RandomState(0).randint(0, 1634753849, 16).tolist()
  for seed in seeds + [0, 1634753848, -1, 2**63 - 1, -(2**62)]:
    np.testing.assert_array_equal(opensimplex4d.perm_from_seed(seed),
                                  jax_osx.perm_from_seed(seed))


def test_noise4d_matches_jax():
  """noise4d at 512 float32 points on 3 tables within 1e-5 of ble_tpu's
  (summation order is all that differs)."""
  rng = np.random.RandomState(1)
  pts = np.broadcast_to(rng.uniform(-40.0, 40.0, (4, 1, 512)),
                        (4, 3, 512)).astype(np.float32)
  perms = np.stack([jax_osx.perm_from_seed(s) for s in (3, 17, 99)])
  want = np.asarray(jax_osx.noise4d(jnp.asarray(perms)[:, None], *pts))
  got = opensimplex4d.noise4d(torch.from_numpy(perms)[:, None],
                              *(torch.from_numpy(p) for p in pts)).numpy()
  assert got.shape == (3, 512)
  np.testing.assert_allclose(got, want, atol=1e-5)
  assert np.abs(want).max() > 0.1


def test_noise4d_np_matches_jax_and_holds_noise4d():
  """The port's float64 numpy reference against ble_tpu's to 1e-12, over
  512 points on one table and on a stack of three tables; the
  port's float32 noise4d against it within 2e-5, the bound ble_tpu holds
  its own noise4d to (tests/test_opensimplex4d.py:62-68)."""
  rng = np.random.RandomState(3)
  pts = rng.uniform(-30.0, 30.0, (4, 512))
  perm = jax_osx.perm_from_seed(99)
  want = jax_osx.noise4d_np(perm, *pts)
  got = opensimplex4d.noise4d_np(perm, *pts)
  assert got.dtype == np.float64 and got.shape == (512,)
  np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-12)
  perms = np.stack([jax_osx.perm_from_seed(s) for s in (3, 17, 99)])
  stacked = np.broadcast_to(pts[:, None], (4, 3, 512))
  np.testing.assert_allclose(
      opensimplex4d.noise4d_np(perms[:, None], *stacked),
      jax_osx.noise4d_np(perms[:, None], *stacked), rtol=0.0, atol=1e-12)
  assert opensimplex4d.noise4d_np(perm, 0.0, 0.0, 0.0, 0.0) == 0.0
  p32 = pts.astype(np.float32)
  ref = opensimplex4d.noise4d_np(perm, *p32)
  mine = opensimplex4d.noise4d(torch.from_numpy(perm),
                               *(torch.from_numpy(c) for c in p32)).numpy()
  np.testing.assert_allclose(mine, ref, atol=2e-5)
  assert np.abs(ref).max() > 0.1


def test_uv_noise_exact_matches_jax():
  """Both components of the parity noise at 64 points within 1e-5."""
  rng = np.random.RandomState(2)
  x, y = rng.uniform(-300.0, 300.0, (2, 64)).astype(np.float32)
  p = rng.uniform(5000.0, 14000.0, 64).astype(np.float32)
  t = rng.uniform(0.0, 96.0, 64).astype(np.float32)
  perms = np.stack([np.stack([jax_osx.perm_from_seed(100 * c + h)
                              for h in range(5)]) for c in range(2)])
  offsets = rng.uniform(-1.0, 1.0, (2, 5, 4)).astype(np.float32)
  ju, jv = jax_noise.uv_noise_exact(x, y, p, t, perms, offsets)
  tu, tv = simplex_noise.uv_noise_exact(
      *(torch.from_numpy(a) for a in (x, y, p, t)),
      torch.from_numpy(perms).expand(64, 2, 5, 256),
      torch.from_numpy(offsets).expand(64, 2, 5, 4))
  np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-5)
  np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


@pytest.mark.parametrize('seed', PARITY_SEEDS)
def test_parity_reset_matches_jax(jax_resets, seed):
  """parity_reset(seed) against ble_tpu's: the forecast key, noise seeds,
  offsets and permutation tables and the start time exact, the other
  initial conditions and the atmosphere within 1e-5 relative."""
  ics, _, jkey = jax_resets[seed]
  seen = []
  state, obs = parity_reset.parity_reset(
      seed, env_lib.EnvParams(),
      field_fn=_recording_static(seen, env_lib.make_field_fn('static')),
      device='cpu')
  np.testing.assert_array_equal(seen[0], jkey)
  for name in ('noise_seeds', 'noise_offsets', 'noise_perms'):
    np.testing.assert_array_equal(getattr(state.wind, name)[0].numpy(),
                                  np.asarray(getattr(ics['wind'], name)),
                                  err_msg=name)
  b = state.balloon
  np.testing.assert_array_equal(b.time_s[0].numpy(), np.asarray(ics['t0']))
  for name, got in (('x_m', b.x_m), ('y_m', b.y_m),
                    ('center_lat', b.center_lat_rad),
                    ('center_lng', b.center_lng_rad),
                    ('pressure', b.pressure_pa),
                    ('upwelling_ir', b.upwelling_infrared_w_m2)):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ics[name]),
                               rtol=1e-5, err_msg=name)
  np.testing.assert_allclose(state.atmosphere.pressure_transitions[0].numpy(),
                             np.asarray(ics['atmosphere'].pressure_transitions),
                             rtol=1e-5)
  assert bool(torch.isfinite(obs).all())


def test_exact_noise_steps_match_jax(jax_resets):
  """16 steps of one env on the OpenSimplex noise from the port's
  parity_reset(0), carried across to ble_tpu's EnvState: the same actions
  through ble_tpu's env.step and the port's give rewards within 1e-3 (the
  golden per-step bound), positions within 50 m and ground-truth winds
  (forecast + exact noise) within 1e-3 m/s."""
  state, _ = parity_reset.parity_reset(
      0, env_lib.EnvParams(), field_fn=env_lib.make_field_fn('static'),
      device='cpu')
  assert state.wind.noise_perms.shape == (1, 2, 5, 256)
  template = jax_resets[0][1]
  jstate = flax.serialization.from_state_dict(
      template, jax.tree.map(lambda x: jnp.asarray(x[0]),
                             bridge.to_dict(state)))
  step = jax.jit(functools.partial(jax_env.step, jax_env.EnvParams()))
  actions = np.random.RandomState(3).randint(0, 3, STEPS)
  params = env_lib.EnvParams()
  for t, action in enumerate(actions):
    jstate, _, jreward, _, jinfo = step(jstate, jnp.int32(action))
    out = env_lib.step(params, state, torch.tensor([action]))
    state = out.state
    np.testing.assert_allclose(float(out.reward[0]), float(jreward),
                               atol=1e-3, err_msg=f'step {t}')
    np.testing.assert_allclose(
        [float(out.info['x_km'][0]), float(out.info['y_km'][0])],
        [float(jinfo['x_km']), float(jinfo['y_km'])], atol=0.05,
        err_msg=f'step {t}')
    np.testing.assert_allclose(
        [float(state.wind_u[0]), float(state.wind_v[0])],
        [float(jstate.wind_u), float(jstate.wind_v)], atol=1e-3,
        err_msg=f'step {t}')


def test_parity_states_feed_the_evaluator():
  """parity_reset's states go through build_eval_fn(from_states=True), as
  the JAX package's do (a fixed-seed parity eval): seeds 0 and 1, 8
  StationSeeker steps on the exact noise with the slab cache on, a policy
  call for the first action and one after each step."""
  params = env_lib.EnvParams(field_cache=True)
  resets = [parity_reset.parity_reset(s, params,
                                      field_fn=env_lib.make_field_fn('static'),
                                      device='cpu') for s in (0, 1)]
  state = env_lib.tree_map(lambda *xs: torch.cat(xs), *[r[0] for r in resets])
  obs = torch.cat([r[1] for r in resets])
  assert state.wind.noise_perms.shape == (2, 2, 5, 256)
  calls = []

  def policy_step(pstate, o, draws):
    calls.append(draws)
    return pstate, station_seeker.pick_action(o)

  run = eval_lib.build_eval_fn(params, None, lambda keys, device: (),
                               policy_step, max_steps=8, from_states=True,
                               device='cpu')
  result = run([0, 1], state, obs)
  assert result['final_timestep'].tolist() == [8, 8]
  assert bool(torch.isfinite(result['cumulative_reward']).all())
  assert calls == [None] * 9
