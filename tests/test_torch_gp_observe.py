"""The plain version of the port's GP observe kernel (ops/gp_observe.py, the
port of ble_tpu/ops/pallas_gp_observe.py) against the JAX package on the
CPU: its Pallas kernels in interpret mode, and over long tracks the jitted
XLA wind_gp.observe. Tolerances are tests/test_pallas_gp_observe.py's:
kinv and alpha atol 5e-3 along a track (5e-4 on the expiry track),
locations and errors 1e-6, a disabled observe an exact no-op. The 960-step
drift bounds are tests/test_wind.py's (test_wind_gp_960_step_churn_drift).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ble_tpu.env import wind_gp as jax_gp
from ble_tpu.ops import pallas_gp_observe
from ble_tpu_torch import bridge
from ble_tpu_torch.env import wind_gp
from ble_tpu_torch.ops import gp_observe
from ble_tpu_torch.ops import gp_window


def _track(seed, n_obs):
  """A drifting balloon track of (x, y, p, t, eu, ev) rows
  (tests/test_pallas_gp_observe.py:_trajectory, drawn with numpy)."""
  rng = np.random.RandomState(seed)
  x = y = 0.0
  p = 9000.0
  rows = []
  for i in range(n_obs):
    dx, dy, dp, eu, ev = rng.normal(size=5) * [2000.0, 2000.0, 150.0, 1.0,
                                               1.0]
    x, y, p = x + dx, y + dy, float(np.clip(p + dp, 5500, 13500))
    rows.append((x, y, p, 180.0 * (i + 1), float(eu), float(ev)))
  return rows


def _to_port(jstate, batched=False):
  d = {f.name: np.asarray(getattr(jstate, f.name))
       for f in dataclasses.fields(jstate)}
  if not batched:
    d = {k: v[None] for k, v in d.items()}
  return bridge.from_dict(wind_gp.WindGPState, d)


def _obs(rows, enabled=None):
  """(E, 8) float32 observation rows."""
  rows = np.asarray(rows, np.float64).reshape(-1, 6)
  en = np.ones(len(rows)) if enabled is None else np.asarray(enabled)
  out = np.zeros((len(rows), 8), np.float32)
  out[:, :6] = rows
  out[:, 6] = en
  return torch.from_numpy(out)


def _assert_state_close(got, want, atol, batched=False):
  w = want if batched else jax.tree.map(lambda a: np.asarray(a)[None], want)
  np.testing.assert_array_equal(got.active.numpy(), np.asarray(w.active))
  np.testing.assert_array_equal(got.count.numpy(), np.asarray(w.count))
  np.testing.assert_allclose(got.locations.numpy(), np.asarray(w.locations),
                             atol=1e-6)
  np.testing.assert_allclose(got.errors.numpy(), np.asarray(w.errors),
                             atol=1e-6)
  np.testing.assert_allclose(got.kinv.numpy(), np.asarray(w.kinv), atol=atol)
  np.testing.assert_allclose(got.alpha.numpy(), np.asarray(w.alpha),
                             atol=atol)


_jax_observe = jax.jit(jax_gp.observe)


@pytest.mark.parametrize('reference', ['pallas_interpret', 'xla'])
def test_observe_plain_matches_jax_along_track(reference):
  """40 steps against the Pallas kernel in interpret mode; 150 steps (ring
  eviction at 128 and in-window churn) against the XLA observe."""
  n_obs = 40 if reference == 'pallas_interpret' else 150
  jstate = jax_gp.init()
  state = _to_port(jstate)
  for row in _track(0, n_obs):
    if reference == 'pallas_interpret':
      jstate = pallas_gp_observe.observe(jstate, *row, interpret=True)
    else:
      jstate = _jax_observe(jstate, *row)
    state = gp_observe.observe_plain(state, _obs([row]))
    _assert_state_close(state, jstate, atol=5e-3)


def test_observe_plain_expiry_track_matches_pallas_interpret():
  """Time jumps past the 6 h horizon: expiries two at a time."""
  rows = _track(1, 30)
  rows = rows[:20] + [(x, y, p, t + 6.5 * 3600, eu, ev)
                      for (x, y, p, t, eu, ev) in rows[20:]]
  jstate = jax_gp.init()
  state = _to_port(jstate)
  for row in rows:
    jstate = pallas_gp_observe.observe(jstate, *row, interpret=True)
    state = gp_observe.observe_plain(state, _obs([row]))
  assert int(state.active.sum()) < 20
  _assert_state_close(state, jstate, atol=5e-4)


def test_observe_disabled_is_exact_noop():
  state = wind_gp.init(1)
  for row in _track(2, 10):
    state = gp_observe.observe_plain(state, _obs([row]))
  o = _obs([(1.0, 2.0, 9000.0, 99999.0, 0.5, -0.5)], enabled=[0.0])
  frozen = gp_observe.observe_plain(state, o)
  for f in dataclasses.fields(state):
    assert torch.equal(getattr(frozen, f.name), getattr(state, f.name)), f.name


@pytest.mark.parametrize('n', [8, 5])
def test_observe_plain_matches_observe_batched_interpret(n):
  """E = 8 is the blocked Pallas kernel (8 envs a program), E = 5 its vmap
  fallback; a mixed enabled mask."""
  tracks = np.asarray([_track(10 + i, 6) for i in range(n)], np.float32)
  jstate = jax.tree.map(lambda a: jnp.broadcast_to(a, (n,) + a.shape),
                        jax_gp.init())
  state = _to_port(jstate, batched=True)
  en = np.arange(n) % 3 != 0
  for step in range(6):
    rows = tracks[:, step]  # (n, 6)
    jstate = pallas_gp_observe.observe_batched(
        jstate, *(jnp.asarray(rows[:, i]) for i in range(6)),
        jnp.asarray(en), interpret=True)
    state = gp_observe.observe_plain(state, _obs(rows, en))
    _assert_state_close(state, jstate, atol=5e-3, batched=True)
  assert torch.equal(state.count,
                     torch.from_numpy(np.where(en, 6, 0).astype(np.int32)))


@pytest.mark.parametrize('refresh_period', [0, wind_gp.REFRESH_PERIOD])
def test_observe_plain_960_step_churn_drift(refresh_period):
  """tests/test_wind.py::test_wind_gp_960_step_churn_drift for the plain
  version of the observe kernel: 960 observations of a balloon-like path
  (~830 ring evictions, continuous window expiry); the incremental
  posterior on a 181-level column against the exact inverse's."""
  rng = np.random.RandomState(3)
  state = wind_gp.init(1)
  x = y = 0.0
  p = 9000.0
  for i in range(960):
    if refresh_period and i % refresh_period == 0:
      state = wind_gp.refresh(state)
    x += rng.uniform(-800, 800)
    y += rng.uniform(-800, 800)
    p = np.clip(p + rng.uniform(-40, 40), 6000, 12000)
    eu, ev = rng.randn(2) * 2.0
    state = gp_observe.observe_plain(
        state, _obs([(np.float32(x), np.float32(y), np.float32(p),
                      i * 180.0, eu, ev)]))
  args = (torch.tensor([x], dtype=torch.float32),
          torch.tensor([y], dtype=torch.float32),
          torch.tensor([960 * 180.0]), gp_window.pressure_levels())
  inc = wind_gp.query_column(state, *args)
  ex = wind_gp.query_column(wind_gp.refresh(state), *args)
  mean_drift = float((inc[0] - ex[0]).abs().max())
  dev_drift = float((inc[1] - ex[1]).abs().max())
  assert mean_drift < 5e-2, mean_drift  # m/s
  assert dev_drift < 1e-3, dev_drift


@pytest.mark.parametrize('n_sms', [114, 132])
@pytest.mark.parametrize('n_envs', [1, 2, 7, 20, 66, 131, 132, 4096])
def test_observe_split_covers_every_row_once(n_envs, n_sms):
  """The cluster observe's split: S in {1, 2, 4, 8} dividing the 128 rows
  into S slices that cover each row once; 1 when the envs alone fill the
  card; else the least power of two giving every SM a CTA, at most 8."""
  split = gp_observe.observe_split(n_envs, n_sms)
  assert split in (1, 2, 4, 8) and wind_gp.CAPACITY % split == 0
  rows = wind_gp.CAPACITY // split
  covered = np.zeros(wind_gp.CAPACITY, np.int64)
  for rank in range(split):
    covered[rank * rows:(rank + 1) * rows] += 1
  np.testing.assert_array_equal(covered, 1)
  if n_envs >= n_sms:
    assert split == 1
  else:
    assert n_envs * split >= n_sms or split == gp_observe.MAX_SPLIT
    assert split == 1 or n_envs * (split // 2) < n_sms


def _two_env_track(n_obs):
  """(n_obs, 2, 8) rows: env 0 on a track 180 s apart with a 6.5 h jump
  at step 100 (expiries two at a time, then the window churning), env 1
  60 s apart and disabled every 20th step (the ring evicts live points
  from its 129th enabled observation on)."""
  rows = np.zeros((n_obs, 2, 8), np.float32)
  for env, (seed, dt_s) in enumerate(((20, 180.0), (21, 60.0))):
    for i, (x, y, p, _, eu, ev) in enumerate(_track(seed, n_obs)):
      t = dt_s * (i + 1) + (6.5 * 3600 if env == 0 and i >= 100 else 0.0)
      rows[i, env, :6] = (x, y, p, t, eu, ev)
  rows[:, 0, 6] = 1.0
  rows[:, 1, 6] = np.arange(n_obs) % 20 != 3
  return torch.from_numpy(rows)


@pytest.mark.parametrize('n_slices', [1, 2, 8])
def test_observe_sliced_plain_matches_observe_plain_along_track(n_slices):
  """The plain sliced observe (the cluster kernel's pivot sum) against
  the plain observe over 140 observations with expiries, ring evictions
  and a disabled env: slot bookkeeping exactly at every step, a disabled
  observe an exact no-op, kinv and alpha within B3's tolerance."""
  rows = _two_env_track(140)
  sliced = plain = wind_gp.init(2)
  for k in range(rows.shape[0]):
    before = sliced
    sliced = gp_observe.observe_sliced_plain(sliced, rows[k], n_slices)
    plain = gp_observe.observe_plain(plain, rows[k])
    for f in ('active', 'count', 'locations', 'errors'):
      assert torch.equal(getattr(sliced, f), getattr(plain, f)), (k, f)
    if rows[k, 1, 6] < 0.5:
      for f in dataclasses.fields(before):
        assert torch.equal(getattr(sliced, f.name)[1],
                           getattr(before, f.name)[1]), (k, f.name)
  assert int(plain.count[0]) == 140 and int(plain.count[1]) == 133
  assert int(plain.active[0].sum()) < 128 and bool(plain.active[1].all())
  np.testing.assert_allclose(sliced.kinv.numpy(), plain.kinv.numpy(),
                             atol=5e-3)
  np.testing.assert_allclose(sliced.alpha.numpy(), plain.alpha.numpy(),
                             atol=5e-3)


@pytest.mark.parametrize('n_slices', [2, 8])
def test_observe_sliced_plain_expiry_track_matches_pallas_interpret(
    n_slices):
  """test_observe_plain_expiry_track_matches_pallas_interpret for the
  plain sliced observe."""
  rows = _track(1, 30)
  rows = rows[:20] + [(x, y, p, t + 6.5 * 3600, eu, ev)
                      for (x, y, p, t, eu, ev) in rows[20:]]
  jstate = jax_gp.init()
  state = _to_port(jstate)
  for row in rows:
    jstate = pallas_gp_observe.observe(jstate, *row, interpret=True)
    state = gp_observe.observe_sliced_plain(state, _obs([row]), n_slices)
  assert int(state.active.sum()) < 20
  _assert_state_close(state, jstate, atol=5e-4)
