"""The port's MarcoPolo exploration (ble_tpu_torch/agents/marco_polo.py)
against ble_tpu.agents.marco_polo: the same phase sequence over 130 steps,
flips at 80 (RL) and 40 (exploratory) steps in exploratory episodes, the
RL action passed through in the others; with the random walk's normal
draw handed to both, the same actions and targets."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ble_tpu.agents import marco_polo as jax_mp
from ble_tpu.agents import random_walk as jax_rw
from ble_tpu_torch.agents import marco_polo
from ble_tpu_torch.agents import random_walk
from ble_tpu_torch.utils import constants

OBS_DIM = 1099
STEPS = 130


def _obs(rng, n):
  """Observations whose balloon pressure wanders over the walk's range."""
  obs = rng.uniform(0.0, 1.0, (n, OBS_DIM)).astype(np.float32)
  pressure = rng.uniform(6000.0, 12000.0, n)
  obs[:, 0] = ((pressure - constants.PERCIATELLI_PRESSURE_RANGE_MIN) /
               (constants.PERCIATELLI_PRESSURE_RANGE_MAX -
                constants.PERCIATELLI_PRESSURE_RANGE_MIN))
  return obs


def test_phases_and_actions_match_jax_over_130_steps(monkeypatch):
  exploratory = torch.tensor([True, True, False, True, False, True])
  n = exploratory.shape[0]
  gen = torch.Generator().manual_seed(0)
  state = marco_polo.begin_episode(n, gen)
  state.exploratory_episode = exploratory
  assert not bool(state.exploratory_phase.any())
  assert not bool(state.phase_steps.any())
  jstate = jax_mp.MarcoPoloState(
      exploratory_episode=jnp.asarray(exploratory.numpy()),
      exploratory_phase=jnp.zeros((n,), bool),
      phase_steps=jnp.zeros((n,), jnp.int32),
      rw=jax_rw.RandomWalkState(
          target_pressure=jnp.asarray(state.rw.target_pressure.numpy()),
          time_elapsed_s=jnp.zeros((n,), jnp.float32)))
  # ble_tpu's random walk takes its normal draw from its key: hand it the
  # port's draw instead.
  monkeypatch.setattr(jax.random, 'normal', lambda draw: draw)
  jstep = jax.jit(jax.vmap(jax_mp.step))
  rng = np.random.RandomState(0)
  phases = []
  for t in range(STEPS):
    obs = _obs(rng, n)
    rl = rng.randint(0, 3, n).astype(np.int32)
    draw = torch.randn((n,), generator=torch.Generator().set_state(
        gen.get_state()))
    state, action = marco_polo.step(state, torch.from_numpy(obs),
                                    torch.from_numpy(rl), gen)
    jstate, jaction = jstep(jstate, jnp.asarray(obs), jnp.asarray(rl),
                            jnp.asarray(draw.numpy()))
    np.testing.assert_array_equal(state.exploratory_phase.numpy(),
                                  np.asarray(jstate.exploratory_phase),
                                  err_msg=f'step {t}')
    np.testing.assert_array_equal(state.phase_steps.numpy(),
                                  np.asarray(jstate.phase_steps))
    np.testing.assert_array_equal(action.numpy(), np.asarray(jaction),
                                  err_msg=f'step {t}')
    np.testing.assert_allclose(state.rw.target_pressure.numpy(),
                               np.asarray(jstate.rw.target_pressure),
                               atol=1e-3)
    # Outside the exploratory phase the RL action passes through.
    off = ~state.exploratory_phase.numpy()
    np.testing.assert_array_equal(action.numpy()[off], rl[off])
    phases.append(state.exploratory_phase.numpy().copy())
  phases = np.array(phases)
  # Exploratory episodes: RL for steps 1-79, exploratory from step 80 to
  # 119, RL again from step 120; the others never leave the RL phase.
  want = np.zeros(STEPS, bool)
  want[jax_mp.RL_PHASE_STEPS - 1:
       jax_mp.RL_PHASE_STEPS + jax_mp.EXPLORATORY_PHASE_STEPS - 1] = True
  for env in range(n):
    np.testing.assert_array_equal(
        phases[:, env], want if bool(exploratory[env]) else False)
  assert marco_polo.RL_PHASE_STEPS == jax_mp.RL_PHASE_STEPS
  assert marco_polo.EXPLORATORY_PHASE_STEPS == jax_mp.EXPLORATORY_PHASE_STEPS


def test_marco_polo_phases():
  """tests/test_training.py::test_marco_polo_phases on the port: forced
  exploratory episodes flip after 80 steps and back after 40; with
  probability 0 the RL action passes through for 100 steps."""
  gen = torch.Generator().manual_seed(3)
  state = marco_polo.begin_episode(1, gen, probability=1.0)
  assert not bool(state.exploratory_phase[0])
  obs = torch.zeros((1, OBS_DIM))
  one = torch.ones((1,), dtype=torch.int32)
  for _ in range(marco_polo.RL_PHASE_STEPS):
    state, action = marco_polo.step(state, obs, one, gen)
  assert bool(state.exploratory_phase[0])
  for _ in range(marco_polo.EXPLORATORY_PHASE_STEPS):
    state, action = marco_polo.step(state, obs, one, gen)
  assert not bool(state.exploratory_phase[0])

  state = marco_polo.begin_episode(1, gen, probability=0.0)
  for _ in range(100):
    state, action = marco_polo.step(state, obs, 2 * one, gen)
    assert int(action[0]) == 2
  assert not bool(state.exploratory_phase[0])


def test_begin_episode_draws_on_the_generators_device():
  """Every leaf lives where the generator draws; about 80 % of episodes
  are exploratory."""
  state = marco_polo.begin_episode(4000, torch.Generator().manual_seed(0))
  frac = float(state.exploratory_episode.float().mean())
  assert abs(frac - marco_polo.EXPLORATORY_EPISODE_PROBABILITY) < 0.03
  for leaf in (state.exploratory_episode, state.exploratory_phase,
               state.phase_steps, state.rw.target_pressure,
               state.rw.time_elapsed_s):
    assert leaf.device == torch.device('cpu') and leaf.shape == (4000,)
  assert state.phase_steps.dtype == torch.int32
  walk = random_walk.init_from_generator(3, torch.Generator().manual_seed(0))
  assert walk.time_elapsed_s.dtype == torch.float32
