"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, limit file and per-layer metric loads by name; names and
units keep to their characters; every configuration's policy has its
module under policies/, and the runners and the check know no policy;
nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the port."""

import ast
import json
import os
import re

import pytest

from portbench import check
from portbench import harness
from portbench import policies

BENCH = json.load(open(os.path.join(harness.ROOT, 'BENCHMARK.json')))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'ble_tpu'}


def test_top_level_keys_and_limits():
  assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                        'workloads', 'end_to_end', 'per_layer'}
  assert 1 <= BENCH['run_seconds'] <= 51
  assert BENCH['paths'] == ['portbench']
  assert 1 <= len(BENCH['configs']) <= 24
  assert 1 <= len(BENCH['workloads']) <= 24
  assert any(m['name'] == 'setup_s' for m in BENCH['end_to_end'])
  for m in BENCH['end_to_end']:
    assert 0.01 <= m['bound'] <= 0.25
    assert m['source'] in ('host_clock', 'device_trace')
  assert os.path.getsize(os.path.join(harness.ROOT, 'BENCHMARK.json')) < 65536


def test_names_and_units():
  names = [c['name'] for c in BENCH['configs']]
  names += [w['name'] for w in BENCH['workloads']]
  names += [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
  names += [w['traffic'] for w in BENCH['workloads']]
  names += [k for c in BENCH['configs'] for k in c['reduced']]
  assert all(NAME.match(n) for n in names), names
  metrics = BENCH['end_to_end'] + BENCH['per_layer']
  assert len({m['name'] for m in metrics}) == len(metrics)
  assert all(UNIT.match(m['unit']) for m in metrics)
  assert all(m['better'] in ('lower', 'higher') for m in metrics)


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_cell_loads_from_its_files(cell):
  spec = harness.load_spec(cell)
  assert spec.traffic['kind'] in harness.RUNNERS
  assert spec.limits and all(isinstance(v, float) for v in
                             spec.limits.values())
  assert any(m['name'] == 'setup_s' for m in spec.end_to_end)
  assert len(spec.end_to_end) >= 2 and spec.per_layer
  e2e = {m['name'] for m in spec.end_to_end}
  for m in spec.per_layer:
    assert m['moves'] in e2e
    assert os.path.isfile(os.path.join(harness.HERE, 'metrics',
                                       f'{m["name"]}.py'))


@pytest.mark.parametrize('config', BENCH['configs'], ids=lambda c: c['name'])
def test_config_file_names_its_cuts(config):
  with open(os.path.join(harness.ROOT, config['file'])) as f:
    body = json.load(f)
  assert body['name'] == config['name']
  for key in config['reduced']:
    assert key in body and key in body['source_values']


METRICS = sorted(name[:-3] for name in os.listdir(os.path.join(harness.HERE,
                                                              'metrics'))
                 if name.endswith('.py'))


@pytest.mark.parametrize('metric', METRICS)
def test_metric_reads_nothing_from_an_empty_run(metric):
  for kind in ('eval', 'train'):
    assert harness.read_metric(metric, {'kind': kind}) is None


CONFIGS = sorted(n for n in os.listdir(os.path.join(harness.HERE, 'configs'))
                 if n.endswith('.json'))
POLICIES = sorted(n[:-3] for n in os.listdir(os.path.join(harness.HERE,
                                                           'policies'))
                  if n.endswith('.py') and n != '__init__.py')


@pytest.mark.parametrize('config', CONFIGS)
def test_config_policy_has_its_module(config):
  with open(os.path.join(harness.HERE, 'configs', config)) as f:
    policy = json.load(f)['policy']
  assert policy in POLICIES
  module = policies.load(policy)
  for name in policies.FUNCTIONS:
    assert callable(getattr(module, name, None)), (policy, name)


def _words(node):
  """The names and strings a node of a syntax tree spells."""
  if isinstance(node, ast.Constant) and isinstance(node.value, str):
    yield node.value
  elif isinstance(node, ast.Name):
    yield node.id
  elif isinstance(node, ast.Attribute):
    yield node.attr
  elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
    yield node.name
  elif isinstance(node, ast.arg):
    yield node.arg
  elif isinstance(node, ast.alias):
    yield node.name
    if node.asname:
      yield node.asname


@pytest.mark.parametrize('name', ['harness.py', 'check.py'])
def test_runners_and_check_know_no_policy(name):
  """What is a policy's sits in policies/<policy>.py: harness.py and
  check.py import none of the port's agents and spell no policy's name."""
  with open(os.path.join(harness.HERE, name)) as f:
    tree = ast.parse(f.read())
  for node in ast.walk(tree):
    if isinstance(node, ast.ImportFrom) and node.module:
      modules = [f'{node.module}.{a.name}' for a in node.names]
    elif isinstance(node, ast.Import):
      modules = [a.name for a in node.names]
    else:
      modules = []
    for module in modules:
      assert not module.startswith('ble_tpu_torch.agents'), (name, module)
    for word in _words(node):
      assert not any(p in word for p in POLICIES), (name, word)


def _imports(path):
  tree = ast.parse(open(path).read())
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module:
      yield node.module


def _python_files(top):
  for base, _, files in os.walk(top):
    for name in files:
      if name.endswith('.py'):
        yield os.path.join(base, name)


def test_no_module_imports_jax_or_the_jax_package():
  for path in _python_files(harness.HERE):
    tops = {m.split('.')[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
  for path in _python_files(os.path.join(harness.HERE, 'reference')):
    tops = {m.split('.')[0] for m in _imports(path)}
    assert 'ble_tpu_torch' not in tops, path
    assert tops <= {'portbench', 'torch', 'numpy', 'math', 'dataclasses',
                    'typing', 'concurrent', 'datetime', 'functools'}, (path, tops)


def test_decide_needs_a_limit_for_every_number():
  decided = check.decide({'a': 1.0, 'b': 0.0, 'c': 2.0},
                         {'a': 1.0, 'b': 0.0, 'd': 1.0})
  assert [(n, ok) for n, _, _, ok in decided] == [
      ('a', True), ('b', True), ('d', False), ('c', False)]
  assert not check.decide({'a': float('nan')}, {'a': 1.0})[0][3]
