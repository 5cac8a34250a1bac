"""The port's replay ring (ble_tpu_torch/agents/replay.py) against
ble_tpu.agents.replay: the same adds give the same buffers, and
sample_from_draws, given the draws ble_tpu's sample takes from its key
(recomputed here from the same key), gives the same batch; uniform and
prioritized, with terminals inside the window, ring wraparound, invalid
slots and a non-finite observation. Ints and bools equal, floats within
1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ble_tpu.agents import replay as jax_replay
from ble_tpu_torch.agents import replay

E, OBS_DIM = 4, 6


def _configs(**kw):
  kw = dict(dict(ring_len=16, n_step=3, gamma=0.9, batch_size=64), **kw)
  return jax_replay.ReplayConfig(**kw), replay.ReplayConfig(**kw)


def _fill(jcfg, cfg, steps, nan_at=None):
  """Both rings after `steps` lockstep adds: episodes of 7 steps ending in
  a terminal in envs 0 and 2 (then frozen two steps, writing invalid
  slots), truncated unannounced in env 1 every 5 steps, and running on in
  env 3; obs row `nan_at` = (step, env) holds a NaN."""
  rng = np.random.RandomState(0)
  jstate = jax_replay.init(E, OBS_DIM, jcfg)
  state = replay.init(E, OBS_DIM, cfg, 'cpu')
  ep = np.zeros(E, np.int32)
  for t in range(steps):
    obs = rng.randn(E, OBS_DIM).astype(np.float32)
    if nan_at is not None and nan_at[0] == t:
      obs[nan_at[1], 2] = np.nan
    action = rng.randint(0, 3, E).astype(np.int32)
    reward = rng.rand(E).astype(np.float32)
    phase = t % 9
    active = np.array([phase < 7, True, phase < 7, True])
    terminal = np.array([phase == 6, False, phase == 6, False])
    episode_step = np.where(active, ep, 0).astype(np.int32)
    args = (obs, action, reward, terminal, active, episode_step)
    jstate = jax_replay.add(jstate, jcfg, *map(jnp.asarray, args))
    state = replay.add(state, cfg, *map(torch.from_numpy, args))
    ep = np.where(active, ep + 1, 0)
    ep[1] = 0 if t % 5 == 4 else ep[1]
    ep[[0, 2]] = 0 if phase >= 6 else ep[[0, 2]]
  return jstate, state


def _jax_draws(jstate, jcfg, key):
  """The draws ble_tpu's sample takes from `key` (replay.py:113-143)."""
  env_key, time_key = jax.random.split(key)
  out = {'env_idx': jax.random.randint(env_key, (jcfg.batch_size,), 0,
                                       jstate.obs.shape[0])}
  if jcfg.prioritized:
    out['uniform'] = jax.random.uniform(
        time_key, (jcfg.batch_size, jcfg.ring_len), minval=1e-10,
        maxval=1.0)
  else:
    out['time_draw'] = jax.random.randint(
        time_key, (jcfg.batch_size,), 0, jnp.iinfo(jnp.int32).max)
  return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _assert_batches_equal(got, want):
  assert set(got) == set(want)
  for key, w in want.items():
    w = np.asarray(w)
    g = got[key].numpy()
    if np.issubdtype(w.dtype, np.floating):
      np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=key)
    else:
      np.testing.assert_array_equal(g, w, err_msg=key)


def _assert_rings_equal(state, jstate):
  assert state.total == int(jstate.total)
  for name in ('obs', 'action', 'reward', 'terminal', 'valid',
               'episode_step', 'priority'):
    np.testing.assert_array_equal(getattr(state, name).numpy(),
                                  np.asarray(getattr(jstate, name)),
                                  err_msg=name)


@pytest.mark.parametrize('prioritized', [False, True])
@pytest.mark.parametrize('steps', [12, 40])
def test_sample_from_draws_matches_jax(prioritized, steps):
  """12 steps (ring not yet full) and 40 (wrapped twice), terminals and
  invalid slots inside windows, one NaN observation: buffers equal after
  the adds; over three keys the batch equals ble_tpu's sample. Prioritized
  rings first get varied priorities through update_priorities."""
  jcfg, cfg = _configs(prioritized=prioritized)
  jstate, state = _fill(jcfg, cfg, steps, nan_at=(steps - 6, 3))
  _assert_rings_equal(state, jstate)
  if prioritized:
    env_idx = np.arange(E).repeat(6).astype(np.int32)
    slot = np.tile(np.arange(6) * 2, E).astype(np.int32)
    loss = np.random.RandomState(1).rand(E * 6).astype(np.float32) * 4
    jstate = jax_replay.update_priorities(jstate, jcfg, env_idx, slot, loss)
    replay.update_priorities(state, cfg, torch.from_numpy(env_idx).long(),
                             torch.from_numpy(slot).long(),
                             torch.from_numpy(loss))
    _assert_rings_equal(state, jstate)
  weights, bootstraps = [], []
  for seed in range(3):
    key = jax.random.PRNGKey(seed)
    want = jax_replay.sample(jstate, jcfg, key)
    got = replay.sample_from_draws(state, cfg,
                                   **_jax_draws(jstate, jcfg, key))
    _assert_batches_equal(got, want)
    weights.append(np.asarray(want['weight']))
    bootstraps.append(np.asarray(want['bootstrap_discount']))
  weights = np.concatenate(weights)
  # The cases the batches cover: quarantined or incoherent (0) and kept
  # samples, windows cut by a terminal and windows that bootstrap.
  assert (weights == 0).any() and (weights > 0).any()
  assert {0.0, np.float32(0.9 ** 3)} <= set(np.concatenate(bootstraps))


def test_non_finite_observation_is_quarantined():
  """A sample whose base or bootstrap observation holds a NaN gets weight
  0 in both packages."""
  jcfg, cfg = _configs(batch_size=256)
  jstate, state = _fill(jcfg, cfg, 12, nan_at=(4, 3))
  key = jax.random.PRNGKey(7)
  got = replay.sample_from_draws(state, cfg, **_jax_draws(jstate, jcfg, key))
  obs_nan = ~torch.isfinite(got['obs']).all(-1)
  next_nan = ~torch.isfinite(got['next_obs']).all(-1)
  hit = obs_nan | next_nan
  assert bool(hit.any())
  assert bool((got['weight'][hit] == 0).all())
  _assert_batches_equal(got, jax_replay.sample(jstate, jcfg, key))


def test_update_priorities_and_can_sample_match_jax():
  """update_priorities with a NaN loss (priority 1.0) and add's
  max-priority seeding give the same lane; can_sample flips at the same
  cursor."""
  jcfg, cfg = _configs(prioritized=True)
  jstate, state = _fill(jcfg, cfg, 10)
  env_idx = np.array([0, 1, 2, 3, 1], np.int32)
  slot = np.array([2, 3, 4, 5, 9], np.int32)
  loss = np.array([0.5, np.nan, 9.0, np.inf, 0.0], np.float32)
  jstate = jax_replay.update_priorities(jstate, jcfg, env_idx, slot, loss)
  replay.update_priorities(state, cfg, torch.from_numpy(env_idx).long(),
                           torch.from_numpy(slot).long(),
                           torch.from_numpy(loss))
  _assert_rings_equal(state, jstate)
  assert float(state.priority[1, 3]) == 1.0 == float(state.priority[3, 5])
  # The next add seeds live slots with the new max priority, sqrt(9 + eps).
  args = (np.zeros((E, OBS_DIM), np.float32), np.zeros(E, np.int32),
          np.zeros(E, np.float32), np.zeros(E, bool),
          np.array([True, False, True, True]), np.zeros(E, np.int32))
  jstate = jax_replay.add(jstate, jcfg, *map(jnp.asarray, args))
  replay.add(state, cfg, *map(torch.from_numpy, args))
  _assert_rings_equal(state, jstate)

  for min_history in (0, 8, 40):
    jst = jax_replay.init(E, OBS_DIM, jcfg)
    st = replay.init(E, OBS_DIM, cfg, 'cpu')
    flips = []
    for t in range(16):
      jst = jax_replay.add(jst, jcfg, *map(jnp.asarray, args))
      replay.add(st, cfg, *map(torch.from_numpy, args))
      can = replay.can_sample(st, cfg, min_history)
      assert isinstance(can, bool)
      assert can == bool(jax_replay.can_sample(jst, jcfg, min_history))
      flips.append(can)
    assert flips.count(True) == 16 - (min_history // E + cfg.n_step)


def test_draw_takes_the_samples_random_numbers_from_the_generator():
  """draw's shapes and ranges, and the same generator seed gives the same
  sample."""
  for prioritized in (False, True):
    _, cfg = _configs(prioritized=prioritized)
    state = _fill(*_configs(prioritized=prioritized), 20)[1]
    d = replay.draw(state, cfg, torch.Generator().manual_seed(0))
    assert tuple(d['env_idx'].shape) == (cfg.batch_size,)
    assert int(d['env_idx'].min()) >= 0 and int(d['env_idx'].max()) < E
    if prioritized:
      u = d['uniform']
      assert tuple(u.shape) == (cfg.batch_size, cfg.ring_len)
      assert float(u.min()) >= 1e-10 and float(u.max()) < 1.0
    else:
      assert int(d['time_draw'].min()) >= 0
    a = replay.sample(state, cfg, torch.Generator().manual_seed(3))
    b = replay.sample(state, cfg, torch.Generator().manual_seed(3))
    for key in a:
      assert torch.equal(a[key], b[key]), key


def _one_env_ring(cfg, steps, terminal_at=None, live_until=None):
  state = replay.init(1, 2, cfg, 'cpu')
  for t in range(steps):
    replay.add(state, cfg, torch.full((1, 2), float(t)),
               torch.ones((1,), dtype=torch.int32),
               torch.full((1,), float(t) if terminal_at is None else 1.0),
               torch.tensor([t == terminal_at]),
               torch.tensor([live_until is None or t <= live_until]),
               torch.full((1,), t, dtype=torch.int32))
  return state


def test_replay_n_step_return():
  """tests/test_training.py::test_replay_n_step_return on the port."""
  cfg = replay.ReplayConfig(ring_len=32, n_step=3, gamma=0.5, batch_size=64)
  state = _one_env_ring(cfg, 10)
  batch = replay.sample(state, cfg, torch.Generator().manual_seed(0))
  # For base step t: return = t + 0.5(t+1) + 0.25(t+2); next_obs = t+3.
  t0 = batch['obs'][:, 0].numpy()
  expected = t0 + 0.5 * (t0 + 1) + 0.25 * (t0 + 2)
  np.testing.assert_allclose(batch['n_step_reward'].numpy(), expected,
                             rtol=1e-6)
  np.testing.assert_allclose(batch['next_obs'][:, 0].numpy(), t0 + 3)
  assert bool((batch['bootstrap_discount'] == 0.5 ** 3).all())
  assert bool((batch['weight'] == 1.0).all())


def test_replay_terminal_cuts_bootstrap():
  """tests/test_training.py::test_replay_terminal_cuts_bootstrap on the
  port."""
  cfg = replay.ReplayConfig(ring_len=32, n_step=3, gamma=1.0, batch_size=256)
  state = _one_env_ring(cfg, 6, terminal_at=2, live_until=2)
  batch = replay.sample(state, cfg, torch.Generator().manual_seed(1))
  t0 = batch['obs'][:, 0].numpy().astype(int)
  boot = batch['bootstrap_discount'].numpy()
  rew = batch['n_step_reward'].numpy()
  w = batch['weight'].numpy()
  assert set(t0.tolist()) >= {0, 1}
  for i in range(len(t0)):
    if t0[i] == 0:  # window [0,1,2]: hits terminal at 2 -> no bootstrap.
      assert boot[i] == 0.0 and rew[i] == 3.0 and w[i] == 1.0
    if t0[i] == 1:  # window [1,2]: terminal at 2 -> rewards 1+1.
      assert boot[i] == 0.0 and rew[i] == 2.0 and w[i] == 1.0
    if t0[i] in (3, 4, 5):  # post-terminal slots are invalid.
      assert w[i] == 0.0
