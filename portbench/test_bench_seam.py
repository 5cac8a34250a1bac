"""A training configuration added as new files only, the way a later
change adds one: a copy of portbench/ and BENCHMARK.json gets a policy
module (QR-DQN's functions under a new name), a configuration, a traffic
mix, a limit file and BENCHMARK.json entries, and its cell runs on the
CPU from the copy, correct, with its per-layer metrics. No file that the
copy had is edited but BENCHMARK.json."""

import filecmp
import json
import os
import shutil
import subprocess
import sys

from portbench import harness

CELL = 'seam.train.e8'
POLICY = '''"""A policy added as a file: QR-DQN's, under another name."""

from portbench.policies.qrdqn import eval_policy  # noqa: F401
from portbench.policies.qrdqn import install  # noqa: F401
from portbench.policies.qrdqn import load  # noqa: F401
from portbench.policies.qrdqn import numbers  # noqa: F401
from portbench.policies.qrdqn import spans  # noqa: F401
from portbench.policies.qrdqn import train_config  # noqa: F401
from portbench.policies.qrdqn import weights  # noqa: F401
from portbench.policies.qrdqn import work  # noqa: F401
'''
RUN = '''
import json, sys, time
import torch
from portbench import harness
torch.set_num_threads(2)
result = harness.execute(harness.load_spec({cell!r}), 2**31 + 77, 0.0, True,
                         'cpu', time.perf_counter())
print(json.dumps({{'harness': harness.__file__, 'correct': result['correct'],
                  'checks': result['checks'],
                  'metrics': sorted(result['metrics'])}}))
'''


def _read(path):
  with open(path) as f:
    return json.load(f)


def _write(path, body):
  with open(path, 'w') as f:
    if isinstance(body, str):
      f.write(body)
    else:
      json.dump(body, f, indent=1)


def _add_cell(root):
  """The new configuration's files and entries, at the tiny size of
  test_bench_cells.tiny (8 envs, a target sync every 4 train steps)."""
  bench_dir = os.path.join(root, 'portbench')
  _write(os.path.join(bench_dir, 'policies', 'seam.py'), POLICY)
  config = _read(os.path.join(bench_dir, 'configs', 'qrdqn.json'))
  config.update(name='seam', policy='seam')
  config['qrdqn'].update(min_replay_history=0, samples_per_insert=32.0,
                         target_update_period=4)
  _write(os.path.join(bench_dir, 'configs', 'seam.json'), config)
  traffic = _read(os.path.join(bench_dir, 'traffic', 'train_e1024.json'))
  traffic.update(num_envs=8, check_rows=4)
  _write(os.path.join(bench_dir, 'traffic', 'train_e8.json'), traffic)
  shutil.copy(os.path.join(bench_dir, 'limits', 'qrdqn.train.e1024.json'),
              os.path.join(bench_dir, 'limits', f'{CELL}.json'))
  bench = _read(os.path.join(root, 'BENCHMARK.json'))
  bench['configs'].append({
      'name': 'seam', 'source': 'https://example.org/seam',
      'file': 'portbench/configs/seam.json', 'reduced': [],
      'why': 'a configuration added as files'})
  bench['workloads'].append({
      'name': CELL, 'config': 'seam', 'traffic': 'train_e8', 'chips': 1,
      'why': '8 envs'})
  for metric in bench['end_to_end'] + bench['per_layer']:
    if 'qrdqn.train.e1024' in metric.get('workloads', []):
      metric['workloads'].append(CELL)
  _write(os.path.join(root, 'BENCHMARK.json'), bench)


def _changed(a, b):
  """Files of directory a that differ in b, as paths under a."""
  cmp = filecmp.dircmp(a, b, ignore=['__pycache__'])
  out = [name for name in cmp.left_only + cmp.diff_files]
  for sub, inner in cmp.subdirs.items():
    out += [os.path.join(sub, name) for name in _changed(inner.left,
                                                          inner.right)]
  return out


def test_new_configuration_runs_from_new_files(tmp_path):
  root = str(tmp_path)
  shutil.copytree(harness.HERE, os.path.join(root, 'portbench'),
                  ignore=shutil.ignore_patterns('__pycache__'))
  shutil.copy(os.path.join(harness.ROOT, 'BENCHMARK.json'), root)
  _add_cell(root)
  assert _changed(harness.HERE, os.path.join(root, 'portbench')) == []
  assert not filecmp.cmp(os.path.join(harness.ROOT, 'BENCHMARK.json'),
                         os.path.join(root, 'BENCHMARK.json'), shallow=False)

  env = dict(os.environ, PYTHONPATH=harness.ROOT)
  out = subprocess.run([sys.executable, '-c', RUN.format(cell=CELL)],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=600)
  assert out.returncode == 0, out.stderr[-4000:]
  result = json.loads(out.stdout.strip().splitlines()[-1])
  assert result['harness'].startswith(root)
  assert result['correct'], result['checks']
  assert set(result['checks']) == set(
      _read(os.path.join(harness.HERE, 'limits', 'qrdqn.train.e1024.json')))
  assert {'env_step_host_ms.train', 'learner_host_ms.train'} <= set(
      result['metrics'])
