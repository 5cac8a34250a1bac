"""step_batched's slab re-centre as ble_tpu's public API has it (global_step,
refresh, EnvParams.field_cache_every), against the JAX package on the CPU,
and the eval's per-step fallback.

The slab witness steps ble_tpu's worlds on a field fast enough that every
balloon leaves the 4x4 slab the reset centred: a step_batched that does
not re-centre reads clamped slab winds there, and its positions leave
ble_tpu's."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ble_tpu.env import env as jax_env
from ble_tpu_torch import bridge
from ble_tpu_torch.agents import station_seeker
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.env import wind_field
from ble_tpu_torch.train import eval_lib

E = 8
STEPS = 16
CADENCE_STEPS = 12
# tests/test_torch_env.py's limits: positions 0.05 km (the golden
# trajectory's), rewards 1e-3; winds 1e-3 m/s (test_torch_parity_reset.py).
XY_ATOL_KM = 0.05
REWARD_ATOL = 1e-3
WIND_ATOL = 1e-3
# The world whose first step sits on the buoyant-equilibrium knife-edge
# (tests/test_torch_gym_env.py): its pressure reads ~8 Pa from ble_tpu's,
# and the wind noise at the balloon follows the pressure (0.14 m/s apart
# at most here), so its winds are held through its positions only.
KNIFE_EDGE_WORLD = 5


def _fast_field() -> np.ndarray:
  """A (21, 21, 10, 9, 2) float32 grid, the same at every pressure and
  time, growing across the grid: u = 36 (1 + 0.02 i) and v = 36 (1 + 0.02
  j) m/s at lat/lng cell (i, j). Every balloon moves at most ~9 km along
  each axis a step (36 km over 4 steps, within a 50 km cell), has left the
  slab its reset centred by step 12, and stays inside the grid; a slab
  left where it was reads other winds than the grid."""
  ramp = 36.0 * (1.0 + 0.02 * np.arange(21, dtype=np.float32))
  grid = np.zeros(wind_field.GRID_SHAPE, np.float32)
  grid[..., 0] = ramp[:, None, None, None]
  grid[..., 1] = ramp[None, :, None, None]
  return grid


def _np_dict(obj):
  out = {}
  for f in dataclasses.fields(obj):
    v = getattr(obj, f.name)
    out[f.name] = (_np_dict(v) if dataclasses.is_dataclass(v) else
                   None if v is None else np.array(v))
  return out


def _to_port(jstate) -> env_lib.EnvState:
  return bridge.from_dict(env_lib.EnvState, _np_dict(jstate))


@pytest.fixture(scope='module')
def fast_worlds():
  """E worlds drawn by ble_tpu's reset from PRNGKey(0..E-1) on the fast
  field (float32 grid, slab cache on), the actions of STEPS steps, and
  ble_tpu's step_batched over them at its default arguments: the slab
  re-centred every step. Returns (initial state, actions, per-step
  (x_km, y_km, wind_u, wind_v, reward, slab_oob))."""
  params = jax_env.EnvParams(wind_field_f32=True, field_cache=True)
  field = jnp.asarray(_fast_field())
  keys = jnp.stack([jax.random.PRNGKey(s) for s in range(E)])
  reset = jax.jit(jax.vmap(functools.partial(
      jax_env.reset, params=params, field_fn=lambda key: field)))
  jstate, _ = reset(keys)
  state0 = _to_port(jstate)
  actions = np.random.RandomState(0).randint(0, 3, (STEPS, E)).astype(
      np.int32)
  step = jax.jit(lambda s, a: jax_env.step_batched(params, s, a,
                                                   physics='xla'))
  rows = []
  for a in actions:
    jstate, _, reward, _, info = step(jstate, jnp.asarray(a))
    rows.append(tuple(np.asarray(x) for x in (
        info['x_km'], info['y_km'], jstate.wind_u, jstate.wind_v, reward,
        info['slab_oob'])))
  return state0, actions, rows


def _assert_agrees(out, want, t):
  x_km, y_km, wind_u, wind_v, reward, jax_oob = want
  msg = f'step {t}'
  assert not jax_oob.any(), msg
  assert not bool(out.info['slab_oob'].any()), msg
  np.testing.assert_allclose(out.info['x_km'].numpy(), x_km,
                             atol=XY_ATOL_KM, err_msg=msg)
  np.testing.assert_allclose(out.info['y_km'].numpy(), y_km,
                             atol=XY_ATOL_KM, err_msg=msg)
  others = np.arange(E) != KNIFE_EDGE_WORLD
  np.testing.assert_allclose(out.state.wind_u.numpy()[others],
                             wind_u[others], atol=WIND_ATOL, err_msg=msg)
  np.testing.assert_allclose(out.state.wind_v.numpy()[others],
                             wind_v[others], atol=WIND_ATOL, err_msg=msg)
  np.testing.assert_allclose(out.reward.numpy(), reward, atol=REWARD_ATOL,
                             err_msg=msg)


def test_step_batched_recentres_the_slab_as_jax_does(fast_worlds):
  """(a) The slab witness: STEPS steps of step_batched at its default
  arguments with the cache on, in both packages, from ble_tpu's worlds on
  the fast field. Each step re-centres the slab, so positions and rewards
  agree on every world, winds on all but KNIFE_EDGE_WORLD, and no balloon
  is ever outside its slab, though every one ends outside the slab its
  reset centred."""
  state0, actions, rows = fast_worlds
  params = env_lib.EnvParams(wind_field_f32=True, field_cache=True)
  state = state0
  for t, a in enumerate(actions):
    out = env_lib.step_batched(params, state, torch.from_numpy(a))
    _assert_agrees(out, rows[t], t)
    state = out.state
  b = state.balloon
  assert bool(wind_field.slab_oob(state0.wind, b.x_m, b.y_m).all())


def test_global_step_keeps_the_cadence_of_a_hand_recentre(fast_worlds):
  """(b) With global_step passed and field_cache_every = 4, step_batched
  re-centres at steps 0, 4 and 8 of CADENCE_STEPS: equal in bits to
  refresh='never' with a re-centre by hand every 4 steps, and in agreement
  with ble_tpu. The step counter is a host int on even steps and a 0-d
  tensor on odd ones."""
  state0, actions, rows = fast_worlds
  params = env_lib.EnvParams(wind_field_f32=True, field_cache=True,
                             field_cache_every=4)
  cadence = by_hand = state0
  for t, a in enumerate(actions[:CADENCE_STEPS]):
    a = torch.from_numpy(a)
    out = env_lib.step_batched(params, cadence, a,
                               global_step=t if t % 2 == 0 else
                               torch.tensor(t))
    if t % 4 == 0:
      by_hand = env_lib.refresh_field_cache(by_hand)
    ref = env_lib.step_batched(params, by_hand, a, refresh='never')
    same = []
    env_lib.tree_map(lambda x, y: same.append(torch.equal(x, y)),
                     out.state, ref.state)
    assert len(same) > 30 and all(same), f'step {t}'
    assert torch.equal(out.observation, ref.observation), f'step {t}'
    assert torch.equal(out.reward, ref.reward), f'step {t}'
    assert all(torch.equal(out.info[k], ref.info[k]) for k in ref.info)
    _assert_agrees(out, rows[t], t)
    cadence, by_hand = out.state, ref.state


def test_refresh_never_leaves_the_slab_to_the_caller(fast_worlds):
  """refresh='never' keeps the slab the state holds, even at a step the
  cadence would re-centre: from balloons moved 150 km east and north of
  the reset's slabs, slab_oob turns on for every one, as in ble_tpu's
  info; refresh='auto' re-centres and it stays off."""
  state0, actions, _ = fast_worlds
  params = env_lib.EnvParams(wind_field_f32=True, field_cache=True)
  b = state0.balloon
  moved = dataclasses.replace(state0, balloon=dataclasses.replace(
      b, x_m=b.x_m + 150e3, y_m=b.y_m + 150e3))
  a = torch.from_numpy(actions[0])
  kept = env_lib.step_batched(params, moved, a, global_step=0,
                              refresh='never')
  assert torch.equal(kept.state.wind.slab_x0, state0.wind.slab_x0)
  assert bool(kept.info['slab_oob'].all())
  out = env_lib.step_batched(params, moved, a, global_step=0)
  assert bool((out.state.wind.slab_x0 != state0.wind.slab_x0).all())
  assert not bool(out.info['slab_oob'].any())


def _counting_recentres(monkeypatch):
  calls = []
  recentre = env_lib.refresh_field_cache

  def counted(state):
    calls.append(1)
    return recentre(state)

  monkeypatch.setattr(env_lib, 'refresh_field_cache', counted)
  return calls


def test_eval_falls_back_to_a_per_step_recentre(monkeypatch):
  """(c) The eval's fallback (ble_tpu/train/eval_lib.py:117-127), with the
  GP's refresh period cut from 64 to 8 steps so that a 10-step eval shows
  both cases: with field_cache_every = 5, which does not divide it, the
  slab re-centres every step; at 4 it re-centres every 4 steps of the
  chunk and every step of the 2-step tail. On the static field (10 m/s)
  neither leaves the slab, so both give the same bits."""
  seeds = [0]
  policy = (lambda keys, device: (),
            lambda st, obs, draws: (st, station_seeker.pick_action(obs)))
  results = {}
  for every, want in ((5, 10), (4, 8 // 4 + 2)):
    params = env_lib.EnvParams(field_cache=True, field_cache_every=every)
    state, obs = env_lib.reset(params, seeds, env_lib.make_field_fn('static'),
                               'cpu')
    with monkeypatch.context() as mp:
      mp.setattr(eval_lib.wind_gp_lib, 'REFRESH_PERIOD', 8)
      calls = _counting_recentres(mp)
      run = eval_lib.build_eval_fn(params, None, *policy, max_steps=10,
                                   from_states=True, device='cpu')
      results[every] = run(seeds, state, obs)
    assert len(calls) == want, every
  assert results[5]['final_timestep'].tolist() == [10]
  for key, value in results[4].items():
    assert torch.equal(results[5][key], value), key

