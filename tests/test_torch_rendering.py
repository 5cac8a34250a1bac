"""Flight-path rendering on the CPU: the port's MatplotlibRenderer, the gym
env's renderer hooks and the train CLI's --render_final, against ble_tpu's
renderer on the same keyed world.

ble_tpu's side is one compiled program (`jax_track`): its reset of the
arena key that BalloonEnv(seed=SEED) draws first, then one env.step, on
the static field; its renderer records both states."""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from ble_tpu.env import env as jax_env
from ble_tpu.env.rendering import renderer as jax_renderer
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.env import gym_env
from ble_tpu_torch.env.rendering import renderer as renderer_lib
from ble_tpu_torch.train import train as train_cli

SEED = 3
ACTION = 2


@pytest.fixture(scope='module')
def jax_track():
  """ble_tpu's renderer's track over BalloonEnv(seed=SEED)'s first reset
  and one step (ble_tpu/env/gym_env.py:64-91, one program for both)."""
  params = jax_env.EnvParams()
  reset = functools.partial(jax_env.reset, params=params,
                            field_fn=jax_env.make_field_fn('static'))

  @jax.jit
  def reset_and_step(arena):
    state, _ = reset(arena)
    return state, jax_env.step(params, state, ACTION)[0]

  arena = jax.random.split(jax.random.PRNGKey(SEED))[1]
  renderer = jax_renderer.MatplotlibRenderer()
  for state in reset_and_step(arena):
    renderer.step(state)
  return renderer


def _track(renderer):
  return np.array([renderer._xs, renderer._ys, renderer._pressures,
                   renderer._socs])


def _static_env(renderer=None):
  return gym_env.BalloonEnv(wind_field='static', seed=SEED, device='cpu',
                            renderer=renderer)


def test_gym_track_matches_jax_renderer(jax_track):
  """BalloonEnv(seed=SEED) with a renderer records, at its first reset and
  one step, ble_tpu's renderer's track on the same world: x and y in km,
  pressure and the state of charge within 1e-5 relative."""
  renderer = renderer_lib.MatplotlibRenderer()
  env = _static_env(renderer)
  env.step(ACTION)
  got, want = _track(renderer), _track(jax_track)
  assert got.shape == want.shape == (4, 2)
  np.testing.assert_allclose(got, want, rtol=1e-5)


def test_renderer_rgb_array_and_tensorboard():
  """As tests/test_misc_components.py checks ble_tpu's renderer: an RGB
  image, and the tensorboard mode's (1, H, W, 3) batch in [0, 1]."""
  state, _ = env_lib.reset(env_lib.EnvParams(), [0],
                           env_lib.make_field_fn('static'), 'cpu')
  r = renderer_lib.MatplotlibRenderer()
  r.reset()
  r.step(state)
  r.step(state)
  img = r.render('rgb_array')
  assert img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8
  tb = r.render('tensorboard')
  assert tb.shape == (1,) + img.shape and tb.dtype == np.float32
  assert 0.0 <= tb.min() and tb.max() <= 1.0
  assert 'human' in r.render_modes
  with pytest.raises(ValueError, match='Unsupported'):
    r.render('video')


def test_renderer_step_takes_one_env():
  state, _ = env_lib.reset(env_lib.EnvParams(), [0, 1],
                           env_lib.make_field_fn('static'), 'cpu')
  with pytest.raises(ValueError, match='one env'):
    renderer_lib.MatplotlibRenderer().step(state)


def test_gym_env_renderer_hooks_and_render():
  """metadata names the renderer's modes; reset restarts the track with
  the new state and each step adds the env's balloon; render returns the
  renderer's image, and None without a renderer."""
  renderer = renderer_lib.MatplotlibRenderer()
  env = _static_env(renderer)
  assert env.metadata == {'render.modes': renderer.render_modes}
  assert _static_env().metadata == {'render.modes': []}
  env.reset(seed=5)
  assert len(renderer._xs) == 1
  for action in (0, 1, 2):
    env.step(action)
  b = env.get_balloon_state()
  assert len(renderer._xs) == 4
  assert renderer._xs[-1] == float(b.x_m[0]) / 1000.0
  assert renderer._pressures[-1] == float(b.pressure_pa[0])
  image = env.render('rgb_array')
  assert image.ndim == 3 and image.shape[2] == 3
  assert _static_env().render('rgb_array') is None


def test_train_cli_render_final_writes_the_flight_path(tmp_path):
  """train.main --render_final on the CPU (static field, 4 envs, 2
  iterations of 8 steps) saves final_flight_path.png in base_dir."""
  base = tmp_path / 'run'
  args = ['--device', 'cpu', '--wind_field', 'static', '--base_dir',
          str(base), '--num_iterations', '2', '--max_episode_length', '8',
          '--render_final']
  for item in ['num_envs=4', 'replay.ring_len=64', 'replay.batch_size=8',
               'qrdqn.min_replay_history=8', 'qrdqn.num_layers=2',
               'qrdqn.hidden_units=32', 'qrdqn.num_atoms=11']:
    args += ['--set', item]
  ts = train_cli.main(args)
  assert ts.env_steps == 16
  import matplotlib.pyplot as plt
  image = plt.imread(base / 'final_flight_path.png')
  assert image.ndim == 3 and image.shape[2] in (3, 4)
  assert os.path.isdir(base / 'checkpoints')
