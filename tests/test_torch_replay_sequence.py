"""The port's sequence replay (ble_tpu_torch/agents/replay.py:
draw_sequence, sample_sequence_from_draws, sample_sequence, and the
stored-state actor_state lane) against ble_tpu.agents.replay: given the
draws ble_tpu's sample_sequence takes from its key, the same windows; the
coherence and stored-state tests of tests/test_training.py re-run on the
port. Ints and bools equal, floats within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ble_tpu.agents import replay as jax_replay
from ble_tpu_torch.agents import replay

E, OBS_DIM, STATE_DIM = 4, 6, 4


def _configs(**kw):
  kw = dict(dict(ring_len=16, n_step=1, batch_size=64), **kw)
  return jax_replay.ReplayConfig(**kw), replay.ReplayConfig(**kw)


def _fill(jcfg, cfg, steps, nan_at=None, actor_state_dim=0):
  """tests/test_torch_replay.py's rings: episodes of 7 steps ending in a
  terminal in envs 0 and 2 (then frozen two steps, writing invalid
  slots), truncated every 5 steps in env 1, running on in env 3; obs row
  `nan_at` = (step, env) holds a NaN; with actor_state_dim, random actor
  states."""
  rng = np.random.RandomState(0)
  jstate = jax_replay.init(E, OBS_DIM, jcfg, actor_state_dim=actor_state_dim)
  state = replay.init(E, OBS_DIM, cfg, 'cpu', actor_state_dim)
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
    carry = (rng.randn(E, actor_state_dim).astype(np.float32)
             if actor_state_dim else None)
    jstate = jax_replay.add(
        jstate, jcfg, *map(jnp.asarray, args),
        actor_state=None if carry is None else jnp.asarray(carry))
    state = replay.add(
        state, cfg, *map(torch.from_numpy, args),
        actor_state=None if carry is None else torch.from_numpy(carry))
    ep = np.where(active, ep + 1, 0)
    ep[1] = 0 if t % 5 == 4 else ep[1]
    ep[[0, 2]] = 0 if phase >= 6 else ep[[0, 2]]
  return jstate, state


def _jax_draws(jstate, jcfg, key):
  """The draws ble_tpu's sample_sequence takes from `key`
  (replay.py:247-254)."""
  env_key, time_key = jax.random.split(key)
  out = {'env_idx': jax.random.randint(env_key, (jcfg.batch_size,), 0,
                                       jstate.obs.shape[0]),
         'time_draw': jax.random.randint(time_key, (jcfg.batch_size,), 0,
                                         jnp.iinfo(jnp.int32).max)}
  return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _assert_batches_equal(got, want):
  assert set(got) == set(want)
  for key, w in want.items():
    w = np.asarray(w)
    g = got[key].numpy()
    assert g.shape == w.shape, key
    if np.issubdtype(w.dtype, np.floating):
      np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=key)
    else:
      np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize('steps,seq_len,nan_at,state_dim', [
    (3, 6, None, 0),  # fewer steps than a window: every start at 0
    (12, 6, None, 0),  # terminals and truncations inside windows
    (40, 5, None, STATE_DIM),  # ring wrapped, stored states
    (30, 6, (27, 3), 0),  # a NaN observation in the live window
])
def test_sample_sequence_on_jax_draws_matches_jax(steps, seq_len, nan_at,
                                                  state_dim):
  """The same adds give the same rings, actor_state lane included; on the
  draws of ble_tpu's key, sample_sequence_from_draws gives ble_tpu's
  sample_sequence: obs, action, reward, terminal, step_weight, env_idx,
  slot and start_state."""
  jcfg, cfg = _configs()
  jstate, state = _fill(jcfg, cfg, steps, nan_at, state_dim)
  assert state.total == int(jstate.total) == steps
  if state_dim:
    np.testing.assert_array_equal(state.actor_state.numpy(),
                                  np.asarray(jstate.actor_state))
  else:
    assert state.actor_state is None and jstate.actor_state is None
  for seed in range(3):
    key = jax.random.PRNGKey(seed)
    want = jax_replay.sample_sequence(jstate, jcfg, key, seq_len)
    got = replay.sample_sequence_from_draws(state, cfg, seq_len,
                                            **_jax_draws(jstate, jcfg, key))
    _assert_batches_equal(got, want)
  w = got['step_weight'].numpy()
  assert 0 < w.sum() < w.size
  if nan_at is not None:
    bad = ~np.isfinite(got['obs'].numpy()).all(-1)
    assert bad.any()
    assert (w[bad[:, 1:]] == 0).all() and (w[bad[:, :-1]] == 0).all()


def test_replay_sample_sequence_coherence():
  """tests/test_training.py::test_replay_sample_sequence_coherence on the
  port, with its own generator: windows never train across env 0's
  terminal at t = 9, trainable steps are written and consecutive, and
  some steps train."""
  cfg = replay.ReplayConfig(ring_len=32, batch_size=16, n_step=1)
  rep = replay.init(2, 3, cfg, 'cpu')
  for t in range(20):
    ep_step = t if t < 10 else t - 10
    rep = replay.add(
        rep, cfg, obs=torch.full((2, 3), float(t)),
        action=torch.full((2,), t % 3, dtype=torch.int32),
        reward=torch.ones(2), terminal=torch.tensor([t == 9, False]),
        active=torch.tensor([True, True]),
        episode_step=torch.tensor([ep_step, t], dtype=torch.int32))
  batch = replay.sample_sequence(rep, cfg, torch.Generator().manual_seed(0),
                                 seq_len=6)
  assert tuple(batch['obs'].shape) == (16, 7, 3)
  assert tuple(batch['step_weight'].shape) == (16, 6)
  w = batch['step_weight'].numpy()
  obs0 = batch['obs'][:, :, 0].numpy()
  env = batch['env_idx'].numpy()
  for b in range(16):
    for s in range(6):
      if w[b, s] == 1.0:
        assert obs0[b, s + 1] == obs0[b, s] + 1
        if env[b] == 0:
          assert obs0[b, s] != 9
  assert w.sum() > 0


def test_replay_stored_state_alignment():
  """tests/test_training.py::test_replay_stored_state_alignment on the
  port: start_state is the actor state stored with the window's FIRST
  transition."""
  cfg = replay.ReplayConfig(ring_len=32, batch_size=16, n_step=1)
  rep = replay.init(2, 3, cfg, 'cpu', actor_state_dim=4)
  assert tuple(rep.actor_state.shape) == (2, 32, 4)
  for t in range(20):
    rep = replay.add(
        rep, cfg, obs=torch.full((2, 3), float(t)),
        action=torch.zeros(2, dtype=torch.int32), reward=torch.zeros(2),
        terminal=torch.zeros(2, dtype=torch.bool),
        active=torch.ones(2, dtype=torch.bool),
        episode_step=torch.full((2,), t, dtype=torch.int32),
        actor_state=torch.full((2, 4), float(t)))
  batch = replay.sample_sequence(rep, cfg, torch.Generator().manual_seed(0),
                                 seq_len=6)
  assert tuple(batch['start_state'].shape) == (16, 4)
  np.testing.assert_array_equal(batch['start_state'][:, 0].numpy(),
                                batch['obs'][:, 0, 0].numpy())


def test_draw_sequence_is_uniform_on_the_generators_device():
  """draw_sequence takes env indices in [0, E) and start integers in
  [0, 2^31 - 1) from the generator, the same seed giving the same draws,
  prioritized ring or not."""
  for prioritized in (False, True):
    _, cfg = _configs(prioritized=prioritized, batch_size=4000)
    state = replay.init(E, OBS_DIM, cfg, 'cpu')
    a = replay.draw_sequence(state, cfg, torch.Generator().manual_seed(3))
    b = replay.draw_sequence(state, cfg, torch.Generator().manual_seed(3))
    assert set(a) == {'env_idx', 'time_draw'}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert set(a['env_idx'].tolist()) == set(range(E))
    assert 0 <= int(a['time_draw'].min()) and int(
        a['time_draw'].max()) < 2**31 - 1
