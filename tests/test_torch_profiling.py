"""The port's profiling helpers (ble_tpu_torch/utils/profiling.py): the
tracer's spans over a tiny training run, off and on, the timer, the
Chrome trace, and the examples that read them (profile_step, trace_train)
on the CPU."""

import json
import os
import time

import pytest
import torch

from ble_tpu_torch.examples import profile_step
from ble_tpu_torch.examples import trace_train
from ble_tpu_torch.utils import profiling


def test_step_timer():
  """tests/test_units_and_misc.py:test_step_timer on the port's timer."""
  timer = profiling.StepTimer()
  with timer.phase('a'):
    x = torch.ones((8,)) * 2
  with timer.phase('a', sync=x):
    x + 1
  s = timer.summary()
  assert 'a' in s and s['a'] >= 0.0
  assert 'a:' in timer.report()


def test_step_timer_means_by_phase():
  timer = profiling.StepTimer()
  for name in ('b', 'b', 'c'):
    with timer.phase(name, sync=3.0):
      pass
  s = timer.summary()
  assert set(s) == {'b', 'c'} and all(v >= 0.0 for v in s.values())
  assert timer.report().index('b:') < timer.report().index('c:')


def test_trace_writes_a_chrome_trace(tmp_path):
  with profiling.trace(str(tmp_path / 'run')) as path:
    torch.ones((64,)).cumsum(0).sum()
  assert os.path.dirname(path) == str(tmp_path / 'run')
  with open(path) as f:
    events = json.load(f)['traceEvents']
  assert any('cumsum' in e.get('name', '') for e in events)
  with profiling.trace(None) as nothing:
    torch.ones(2).sum()
  assert nothing is None


def test_profile_step_times_every_stage_on_cpu(capsys):
  per_step = profile_step.main(['--device', 'cpu', '--num_envs', '4',
                                '--steps', '8', '--wind', 'static'])
  assert set(per_step) == {'full step', 'window K=8', 'physics (B1)',
                           'wind column', 'noise', 'gp step (B2)',
                           'features', 'pressure range', 'epilogue'}
  assert all(ms > 0 for ms in per_step.values())
  last = capsys.readouterr().out.splitlines()[-1]
  assert json.loads(last)['ms_per_step'] == per_step


# ------------------------------------------------------------ the tracer --

_STEPS = 9  # Replay can sample from the 8th env step: two learning steps.
_TRAIN_TREE = {
    'learner.chunk': None,
    'wind_gp.refresh': 'learner.chunk',
    'learner.env_step': 'learner.chunk',
    'qrdqn.select_action': 'learner.env_step',
    'marco_polo.step': 'learner.env_step',
    'env.step_batched': 'learner.env_step',
    'env.slab': 'env.step_batched',
    'env.physics': 'env.step_batched',
    'env.wind': 'env.step_batched',
    'env.gp': 'env.step_batched',
    'env.features': 'env.step_batched',
    'env.outcome': 'env.step_batched',
    'replay.add': 'learner.env_step',
    'learner.learn': 'learner.env_step',
    'replay.sample': 'learner.learn',
    'qrdqn.loss': 'learner.learn',
    'optimizer.backward': 'learner.learn',
    'optimizer.step': 'learner.learn',
    'optimizer.target_sync': 'learner.learn',
}
# The one span that reads the thread's CPU clock too.
_CPU_CLOCKED = {'learner.learn'}
_SETUP_TREE = {
    'env.reset': None,
    'reset.draws': 'env.reset',
    'reset.decode': 'env.reset',
    'reset.init': 'env.reset',
    'env.gp': 'reset.init',
    'env.features': 'reset.init',
    'learner.init': None,
}


def _chunk(trace_on: bool):
  """A 4-env QR-DQN run at small widths on the static field, slab cache
  on: (set-up's take(), the chunk's take(), losses, observations, train
  steps, config)."""
  from ble_tpu_torch.agents import qrdqn
  from ble_tpu_torch.agents import replay
  from ble_tpu_torch.env import env as env_lib
  from ble_tpu_torch.train import learner
  config = learner.TrainConfig(
      num_envs=4, qrdqn=qrdqn.QrDqnConfig(
          num_layers=2, hidden_units=32, num_atoms=11, min_replay_history=8,
          target_update_period=4),
      replay=replay.ReplayConfig(ring_len=64, batch_size=8))
  params = env_lib.EnvParams(field_cache=True)
  if trace_on:
    profiling.enable()
  try:
    ts = learner.init_train_state(0, params, env_lib.make_field_fn('static'),
                                  config, device='cpu')
    setup = profiling.take()
    ts, metrics = learner.run_episode_chunk(config, params, ts, _STEPS)
    window = profiling.take()
  finally:
    profiling.disable()
  return (setup, window, metrics['loss'], ts.obs, ts.learner.train_steps,
          config)


@pytest.fixture(scope='module')
def runs():
  """The chunk with the tracer off (clocks and the profiler made to raise)
  and on."""
  def boom(*args, **kwargs):
    raise AssertionError('a disabled tracer took a clock or a range')
  with pytest.MonkeyPatch.context() as mp:
    for module, name in ((time, 'perf_counter_ns'), (time, 'thread_time_ns'),
                         (torch.profiler, 'record_function'),
                         (profiling, '_profiler_enabled')):
      mp.setattr(module, name, boom)
    off = _chunk(False)
  return off, _chunk(True)


def test_off_tracer_records_nothing_and_shares_one_span(runs):
  (setup, window, *_), _ = runs
  empty = {'spans': [], 'by_name': {}, 'counters': {}}
  assert setup == empty and window == empty
  assert profiling.span('a') is profiling.span('b')
  with profiling.span('a') as a:
    assert a is profiling.span('c')
  profiling.count('kernels_built')
  assert profiling.take() == empty


@pytest.mark.parametrize('part', ['setup', 'window'])
def test_on_tracer_records_the_span_tree(runs, part):
  _, (setup, window, _, _, train_steps, config) = runs
  taken, tree = (setup, _SETUP_TREE) if part == 'setup' else (window,
                                                              _TRAIN_TREE)
  spans, by_name = taken['spans'], taken['by_name']
  assert set(by_name) == set(tree)
  for s in spans:
    parent = spans[s.parent].name if s.parent >= 0 else None
    assert parent == tree[s.name], (s.name, parent)
    assert s.start_ns <= s.end_ns
    assert s.parent < spans.index(s)
  tick = 1e9 / os.sysconf('SC_CLK_TCK')
  for s in spans:
    if s.name in _CPU_CLOCKED:
      assert s.cpu_end_ns - s.cpu_start_ns <= s.end_ns - s.start_ns + tick
    else:
      assert s.cpu_start_ns is None and s.cpu_end_ns is None
  for name in set(by_name) & _CPU_CLOCKED:
    assert by_name[name]['cpu_s'] >= 0.0
  for name, entry in by_name.items():
    assert entry['self_s'] >= 0.0 and entry['self_s'] <= entry['wall_s']
  if part == 'setup':
    assert by_name['env.reset']['calls'] == 1
    assert by_name['reset.draws']['calls'] == 3
    return
  grad = config.grad_steps_per_env_step()
  assert by_name['learner.env_step']['calls'] == _STEPS
  assert by_name['learner.learn']['calls'] * grad == train_steps > 0
  for name in ('replay.sample', 'qrdqn.loss', 'optimizer.backward',
               'optimizer.step'):
    assert by_name[name]['calls'] == train_steps, name
  assert by_name['optimizer.target_sync']['calls'] == (
      train_steps // config.qrdqn.target_update_period)
  assert by_name['env.slab']['calls'] == 2  # Steps 0 and 8, cadence 8.
  # No kernel launches and no graphs on the CPU: every train step eager.
  assert taken['counters'] == {'qrdqn.graph_eager': train_steps,
                               'qrdqn.graph_eager.device': train_steps}


def test_tracing_leaves_the_chunk_bit_identical(runs):
  off, on = runs
  assert torch.equal(off[2], on[2]) and torch.equal(off[3], on[3])
  assert off[4] == on[4]


def test_take_reports_a_span_once_it_closes_and_counts():
  profiling.enable()
  try:
    with profiling.span('outer'):
      with profiling.span('inner'):
        pass
      profiling.count('kernels_built', 2)
      first = profiling.take()
      with profiling.span('late'):
        pass
    second = profiling.take()
  finally:
    profiling.disable()
  assert [(s.name, s.parent) for s in first['spans']] == [('inner', -1)]
  assert first['counters'] == {'kernels_built': 2}
  assert [(s.name, s.parent) for s in second['spans']] == [('outer', -1),
                                                          ('late', 0)]
  assert second['by_name']['outer']['self_s'] >= 0.0
  assert second['by_name']['outer']['cpu_s'] is None


def test_trace_exports_the_program_spans(tmp_path):
  with profiling.trace(str(tmp_path)) as path:
    with profiling.span('learner.learn'):
      torch.ones((64,)).cumsum(0).sum()
  with open(path) as f:
    names = {e.get('name') for e in json.load(f)['traceEvents']}
  assert 'ble.learner.learn' in names
  taken = profiling.take()
  assert [s.name for s in taken['spans']] == ['learner.learn']
  assert profiling.span('x') is profiling.span('y')  # Off again.


def test_trace_train_reads_the_tracer_on_cpu(tmp_path, capsys):
  report = trace_train.main([
      '--device', 'cpu', '--wind', 'static', '--num_envs', '4',
      '--steps', '1', '--profile', str(tmp_path), '--cost', '1',
      '--set', 'qrdqn.num_layers=2', '--set', 'qrdqn.hidden_units=32',
      '--set', 'qrdqn.num_atoms=11', '--set', 'qrdqn.min_replay_history=8',
      '--set', 'replay.ring_len=64', '--set', 'replay.batch_size=8'])
  assert json.loads(capsys.readouterr().out.splitlines()[-1]) == report
  assert all(s > 0 for s in report['setup_s'].values())
  window = report['window']['by_name']
  assert window['learner.env_step']['calls'] == 1
  assert window['learner.learn']['cpu_s'] is not None
  split = report['train_step_ms']
  assert set(split) == {'replay.sample', 'qrdqn.loss', 'optimizer.backward',
                        'adam', 'learner.learn self', 'covered'}
  assert 0.5 < split['covered'] <= 1.0
  assert report['train_steps'] == window['replay.sample']['calls'] > 0
  assert os.path.isfile(report['profile']['path'])
  assert report['profile']['busy_s'] == 0.0  # No device work on the CPU.
  assert all(len(v) == 1 for v in report['cost']['seconds'].values())
  cost = report['cost']
  assert cost['pairs_on_vs_off'] > -1.0
  assert cost['span_ns']['on'] > 0 and cost['span_ns']['off'] > 0
  assert cost['spans_per_step'] == sum(
      e['calls'] for e in window.values())


def test_chrome_trace_gaps_go_to_the_innermost_span():
  def event(cat, name, ts, dur):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}
  events = [
      event('user_annotation', 'ble.learner.learn', 0, 100),
      event('user_annotation', 'ble.qrdqn.loss', 10, 30),
      event('user_annotation', 'ble.optimizer.backward', 50, 40),
      event('user_annotation', 'pb.learn', 0, 200),
      event('gpu_user_annotation', 'ble.qrdqn.loss', 0, 130),
      event('kernel', 'a', 5, 5), event('kernel', 'b', 20, 5),
      event('gpu_memcpy', 'c', 60, 10), event('kernel', 'd', 120, 10),
      event('cuda_runtime', 'cudaLaunchKernel', 15, 1),
      event('cuda_runtime', 'cudaLaunchKernel', 55, 1),
      event('cuda_runtime', 'cudaLaunchKernel', 110, 1),
      event('cuda_runtime', 'cudaStreamSynchronize', 56, 1),
      {'ph': 'i', 'cat': 'kernel', 'name': 'marker', 'ts': 80},
  ]
  out = trace_train.read_chrome_trace(events)
  assert out['busy_s'] == pytest.approx(30e-6)
  assert out['idle_s'] == pytest.approx(95e-6)
  assert out['idle_gaps'] == pytest.approx({'optimizer.backward': 50e-6,
                                            'qrdqn.loss': 45e-6})
  assert list(out['idle_gaps']) == ['optimizer.backward', 'qrdqn.loss']
  assert out['launches'] == {'qrdqn.loss': 1, 'optimizer.backward': 1,
                             'none': 1}


def test_trace_train_reads_r2d2_spans_and_counters_on_cpu(capsys):
  """One traced R2D2 env step at small widths: the actor's span, one
  sample, loss and unroll a train step, and the counters the learner
  knows on the host (no sync): 2 x B x (L + 1) unrolled rows and one
  sequence sample a train step."""
  batch, seq_len = 8, 6
  report = trace_train.main([
      '--agent', 'r2d2', '--device', 'cpu', '--wind', 'static',
      '--num_envs', '4', '--steps', '1', '--set', 'r2d2.hidden_units=32',
      '--set', 'r2d2.lstm_units=8', '--set', 'r2d2.num_atoms=5',
      '--set', f'r2d2.seq_len={seq_len}', '--set', 'r2d2.burn_in=2',
      '--set', 'r2d2.min_replay_history=0', '--set', 'samples_per_insert=16',
      '--set', 'replay.ring_len=64', '--set', f'replay.batch_size={batch}'])
  assert json.loads(capsys.readouterr().out.splitlines()[-1]) == report
  assert report['agent'] == 'r2d2'
  window = report['window']
  by_name, steps = window['by_name'], report['train_steps']
  assert steps == 2  # 4 envs x 16 / (8 windows x 4 trainable steps).
  assert by_name['learner.env_step']['calls'] == 1
  assert by_name['r2d2.select_action']['calls'] == 1
  for name in ('replay.sample', 'r2d2.loss', 'r2d2.unroll',
               'optimizer.backward', 'optimizer.step'):
    assert by_name[name]['calls'] == steps, name
  assert 'qrdqn.loss' not in by_name
  assert window['counters'] == {
      'r2d2.unroll_rows': steps * 2 * batch * (seq_len + 1),
      'replay.sequence_samples': steps}
  assert set(report['train_step_ms']) == {
      'replay.sample', 'r2d2.loss', 'optimizer.backward', 'adam',
      'learner.learn self', 'covered'}
  assert 0.5 < report['train_step_ms']['covered'] <= 1.0
