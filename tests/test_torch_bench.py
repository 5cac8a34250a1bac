"""The port's bench (python -m ble_tpu_torch.bench) on the CPU: its JSON
line, its two modes on the same actions, its variables, and the random
policy's generator on the envs' device."""

import json

import pytest
import torch

from ble_tpu_torch import bench
from ble_tpu_torch.agents import random_walk
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.train import eval_lib

E = 8
STEPS = 8
_CPU = {'BENCH_DEVICE': 'cpu', 'BENCH_NUM_ENVS': str(E),
        'BENCH_NUM_STEPS': str(STEPS), 'BENCH_WIND': 'static'}


@pytest.mark.parametrize('mode', bench.MODES)
def test_main_prints_one_json_line(mode, monkeypatch, capsys):
  for key, value in dict(_CPU, BENCH_MODE=mode).items():
    monkeypatch.setenv(key, value)
  result = bench.main()
  lines = capsys.readouterr().out.splitlines()
  assert len(lines) == 1
  assert json.loads(lines[0]) == result
  assert set(result) == {'metric', 'value', 'unit', 'vs_baseline'}
  assert result['value'] > 0 and result['unit'] == 'env-steps/s'
  assert result['vs_baseline'] == pytest.approx(
      result['value'] / bench.BASELINE_STEPS_PER_S, abs=0.1)
  assert (f'({E} envs, static winds, {mode}, cpu)' in result['metric'])


def _tape(actions):
  """draw(shape) handing out the rows of `actions` in order."""
  pos = [0]

  def draw(shape):
    rows = shape[0] if len(shape) == 2 else 1
    out = actions[pos[0]:pos[0] + rows]
    pos[0] += rows
    return out if len(shape) == 2 else out[0]

  return draw


def test_window_and_perstep_agree_on_the_same_actions():
  """Both modes' rollouts from one state on one action sequence: equal
  per-step values (rewards plus the consumed observation) up to the
  observation term's rounding, equal summed reward; the state handed in
  is not changed, so a second run repeats the first."""
  config = bench.config_from_env(dict(_CPU, BENCH_NUM_STEPS='16'))
  params = env_lib.EnvParams(field_cache=config.field_cache)
  state, _ = bench.reset_envs(params, config)
  x0 = state.balloon.x_m.clone()
  actions = torch.randint(0, 3, (16, E), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(3))
  values = {}
  for mode in bench.MODES:
    mode_config = bench.BenchConfig(**dict(vars(config), mode=mode))
    values[mode] = bench.rollout(params, mode_config, state, _tape(actions))
    again = bench.rollout(params, mode_config, state, _tape(actions))
    assert torch.equal(values[mode], again)
    assert values[mode].shape == (16, E)
  assert torch.equal(state.balloon.x_m, x0)
  torch.testing.assert_close(values['window'], values['perstep'], rtol=0,
                             atol=1e-6)
  assert float(values['window'].sum()) == pytest.approx(
      float(values['perstep'].sum()), abs=1e-5)


def test_bench_variables():
  config = bench.config_from_env({'BENCH_DEVICE': 'cpu'})
  assert (config.num_envs, config.num_steps, config.mode, config.wind,
          config.field_cache, config.reset_chunk, config.window) == (
              bench.CPU_MAX_ENVS, 32, 'window', 'generative', True, 512,
              env_lib.EnvParams().field_cache_every)
  # BENCH_WINDOW sets K only in window mode with the cache off.
  assert bench.config_from_env(dict(_CPU, BENCH_WINDOW='4')).window == 8
  assert bench.config_from_env(dict(
      _CPU, BENCH_WINDOW='4', BENCH_FIELD_CACHE='0')).window == 4
  with pytest.raises(ValueError, match='multiple'):
    bench.config_from_env(dict(_CPU, BENCH_NUM_STEPS='12'))
  with pytest.raises(ValueError, match='unknown'):
    bench.config_from_env(dict(_CPU, BENCH_MODE='scan'))


def test_bench_and_profile_step_default_to_cuda(monkeypatch):
  from ble_tpu_torch.examples import profile_step
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA'):
    bench.main({'BENCH_NUM_ENVS': '8', 'BENCH_WIND': 'static'})
  with pytest.raises(RuntimeError, match='CUDA'):
    profile_step.main(['--num_envs', '8', '--wind', 'static'])


def test_eval_policy_draws_on_the_envs_device():
  """build_eval_fn hands the policy its step's draws on the envs' device,
  one (E,) row a step, and the random policy acts there."""
  seen = []
  init, policy, draw = random_walk.random_policy(env_lib.NUM_ACTIONS)

  def step(state, obs, draws):
    seen.append((draws.device, tuple(draws.shape)))
    state, actions = policy(state, obs, draws)
    assert actions.device == obs.device and actions.dtype == torch.int32
    return state, actions

  fn = eval_lib.build_eval_fn(env_lib.EnvParams(),
                              env_lib.make_field_fn('static'), init, step,
                              max_steps=2, device='cpu', policy_draw=draw)
  fn([0, 1])
  assert seen == [(torch.device('cpu'), (2,))] * 3
