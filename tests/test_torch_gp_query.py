"""The plain version of the port's GP column-query kernel (ops/gp_query.py,
the port of ble_tpu/ops/pallas_gp.py) against the Pallas kernel in
interpret mode on the CPU, on GP states the JAX package populates along a
drifting track. Tolerances are tests/test_pallas_gp.py's: means atol 2e-4,
deviations 2e-5, exactly zero for an empty state."""

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
