"""The plain version of the port's GP column-query kernel (ops/gp_query.py,
the port of ble_tpu/ops/pallas_gp.py) against the Pallas kernel in
interpret mode on the CPU, on GP states the JAX package populates along a
drifting track. Tolerances are tests/test_pallas_gp.py's: means atol 2e-4,
deviations 2e-5, exactly zero for an empty state. Also the kernel's level
split over CTAs, and the identity that lets one query engine serve this
kernel and the GP window's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ble_tpu.env import features as jax_features
from ble_tpu.env import wind_gp as jax_gp
from ble_tpu.ops import pallas_gp
from ble_tpu_torch import bridge
from ble_tpu_torch.env import features
from ble_tpu_torch.env import wind_gp
from ble_tpu_torch.ops import gp_query
from ble_tpu_torch.ops import gp_window

_jax_observe = jax.jit(jax_gp.observe)


def _populated_state(seed, n_obs):
  """ble_tpu's GP state after n_obs observations of a drifting track (the
  harness of tests/test_pallas_gp.py, drawn with numpy), and its time."""
  rng = np.random.RandomState(seed)
  state = jax_gp.init()
  x = y = 0.0
  p = 9000.0
  for i in range(n_obs):
    dx, dy, dp, eu, ev = rng.normal(size=5) * [2000.0, 2000.0, 150.0, 1.0,
                                               1.0]
    x, y, p = x + dx, y + dy, float(np.clip(p + dp, 5500, 13500))
    state = _jax_observe(state, x, y, p, 180.0 * (i + 1), eu, ev)
  return state, 180.0 * n_obs


def _to_port(jstates):
  """A batch of single-env ble_tpu GP states as one port state."""
  d = {f.name: np.stack([np.asarray(getattr(s, f.name)) for s in jstates])
       for f in dataclasses.fields(jstates[0])}
  return bridge.from_dict(wind_gp.WindGPState, d)


def _query_plain(state, xs, ys, ts, pres):
  out = gp_query.query_plain(*gp_query.pack(state, xs, ys, ts, pres))
  return out[..., 0:2], out[..., 2]


def _port_query(jstates, xs, ys, ts, pres):
  f32 = lambda v: torch.tensor(v, dtype=torch.float32)
  return _query_plain(_to_port(jstates), f32(xs), f32(ys), f32(ts),
                      f32(pres))


@pytest.mark.parametrize('seed,n_obs', [(0, 1), (1, 12), (2, 60)])
def test_query_plain_matches_pallas_interpret(seed, n_obs):
  state, t = _populated_state(seed, n_obs)
  pres = np.asarray(jax_features.PRESSURE_LEVELS)
  want_m, want_d = pallas_gp.query_column(state, 1234.5, -987.0, t,
                                          jnp.asarray(pres), interpret=True)
  means, dev = _port_query([state], [1234.5], [-987.0], [t], pres)
  assert means.shape == (1, 181, 2) and dev.shape == (1, 181)
  np.testing.assert_allclose(means[0].numpy(), np.asarray(want_m), atol=2e-4)
  np.testing.assert_allclose(dev[0].numpy(), np.asarray(want_d), atol=2e-5)


def test_query_plain_batch_and_ragged_levels():
  """Three envs in one batch, each against its own Pallas call, at 37
  pressures (N is an input, not fixed at 181)."""
  states, ts = zip(*[_populated_state(s, n) for s, n in ((3, 8), (4, 25),
                                                         (5, 130))])
  xs, ys = [100.0, -5000.0, 2500.0], [0.0, 3000.0, -700.0]
  pres = np.linspace(5500.0, 13500.0, 37, dtype=np.float32)
  means, dev = _port_query(states, xs, ys, ts, pres)
  for i, state in enumerate(states):
    m1, d1 = pallas_gp.query_column(state, xs[i], ys[i], ts[i],
                                    jnp.asarray(pres), interpret=True)
    np.testing.assert_allclose(means[i].numpy(), np.asarray(m1), atol=2e-4)
    np.testing.assert_allclose(dev[i].numpy(), np.asarray(d1), atol=2e-5)


def test_query_plain_empty_state_is_zero():
  state = wind_gp.init(2)
  z = torch.zeros(2)
  means, dev = _query_plain(state, z, z, z, features.pressure_levels())
  assert torch.count_nonzero(means) == 0 and torch.count_nonzero(dev) == 0


@pytest.mark.parametrize('n_levels', [1, 37, 181])
@pytest.mark.parametrize('n_envs', [1, 7, 131, 4096])
def test_level_split_covers_every_level_once(n_envs, n_levels):
  """B5's grid of E x S CTAs on a 132-SM card: each env's levels fall into
  S contiguous slices of whole warps' levels that cover every level exactly
  once, with no empty CTA; one slice when the envs fill the card, and at
  one env as many CTAs as the levels allow, at least 8 at N = 181."""
  slices = gp_query.level_split(n_envs, n_levels, 132)
  per = gp_query.slice_levels(n_levels, slices)
  assert per % gp_query.WARP_LEVELS == 0
  covered = np.zeros(n_levels, np.int64)
  for s in range(slices):
    begin, end = s * per, min(n_levels, s * per + per)
    assert begin < end, f'slice {s} of {slices} is empty'
    covered[begin:end] += 1
  np.testing.assert_array_equal(covered, 1)
  if n_envs >= 132:
    assert slices == 1
  if n_envs == 1:
    assert slices == -(-n_levels // gp_query.WARP_LEVELS)
    if n_levels == 181:
      assert n_envs * slices >= 8


def test_window_levels_match_column_query_of_its_state():
  """The GP window's plain version at K = 1 (ops/gp_window.py, kinv k*)
  and the column query's (k* kinv) on the state the window returns, at the
  same (x, y, t) and the 181 levels: one quadratic form k*^T kinv k*,
  whatever the inverse's asymmetry (here an antisymmetric part of ~1e-2
  added to it), so one query engine (csrc/gp_query_core.cuh) serves both
  kernels. The step runs in float64, where the two orders agree to 1e-9 on
  8 envs; in float32 they differ by rounding alone (deviations 8e-6 on the
  unperturbed state)."""
  n = 8
  rng = np.random.RandomState(11)
  state = wind_gp.init(n)
  x = rng.normal(0, 50e3, n)
  y = rng.normal(0, 50e3, n)
  p = rng.uniform(6000, 13000, n)
  dt = np.where(np.arange(n) % 2, 60.0, 180.0)
  obs = np.zeros((150, n, 8), np.float32)
  for i in range(150):
    x, y = x + rng.normal(0, 2000.0, n), y + rng.normal(0, 2000.0, n)
    p = np.clip(p + rng.normal(0, 150.0, n), 5500, 13500)
    obs[i, :, 0], obs[i, :, 1], obs[i, :, 2] = x, y, p
    obs[i, :, 3] = dt * (i + 1)
    obs[i, :, 4:6] = rng.normal(0, 1.0, (n, 2))
    obs[i, :, 6] = 1.0
  obs = torch.from_numpy(obs)
  state, _ = gp_window.window_plain(state, obs[:149])
  f64 = lambda a: a.to(torch.float64) if a.is_floating_point() else a
  state64 = wind_gp.WindGPState(**{
      f.name: f64(getattr(state, f.name)) for f in dataclasses.fields(state)})
  # An antisymmetric part far above the incremental inverse's own drift.
  r = torch.from_numpy(rng.normal(0, 1e-2, (n, 128, 128)))
  state64.kinv = state64.kinv + (r - r.transpose(1, 2))
  row = obs[149].to(torch.float64)
  new_state, level = gp_window.window_plain(state64, row[None])
  asym = float((new_state.kinv - new_state.kinv.transpose(1, 2)).abs().max())
  assert asym > 1e-2
  q = torch.stack([row[:, 0], row[:, 1], row[:, 3], torch.zeros(n)], dim=-1)
  out = gp_query.query_plain(
      new_state.locations, new_state.active.to(torch.float64),
      new_state.alpha, new_state.kinv, q,
      gp_window.pressure_levels().to(torch.float64))
  assert out.dtype == level.dtype == torch.float64
  np.testing.assert_allclose(out[..., :2].numpy(), level[0, ..., :2].numpy(),
                             atol=1e-9)
  np.testing.assert_allclose(out[..., 2].numpy(), level[0, ..., 2].numpy(),
                             atol=1e-9)
  assert float(level[0, ..., 2].min()) < 0.5  # the levels see the data
