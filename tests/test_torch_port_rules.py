"""Rules the PyTorch port keeps: it imports neither JAX nor the JAX package,
its entry points default to the card and raise without one, and its kernel
wrappers refuse tensors they cannot launch on instead of computing them
some other way."""

import ast
import os
import re

import numpy as np
import pytest
import torch

import ble_tpu_torch
from ble_tpu_torch.agents import base
from ble_tpu_torch.agents import station_seeker
from ble_tpu_torch.env import balloon
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.env import gym_env
from ble_tpu_torch.env import wind_field
from ble_tpu_torch.env import wind_gp
from ble_tpu_torch.env.rendering import renderer as renderer_lib
from ble_tpu_torch.generative import reservoir
from ble_tpu_torch.generative import train_vae
from ble_tpu_torch.generative import vae
from ble_tpu_torch.models import loader
from ble_tpu_torch.ops import cuda_build
from ble_tpu_torch.ops import gp_observe
from ble_tpu_torch.ops import gp_query
from ble_tpu_torch.ops import gp_window
from ble_tpu_torch.ops import physics
from ble_tpu_torch.train import eval as eval_cli
from ble_tpu_torch.train import eval_lib
from ble_tpu_torch.train import learner
from ble_tpu_torch.train import suites
from ble_tpu_torch.train import train as train_cli
from ble_tpu_torch.train import train_lib

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_ROOT, 'ble_tpu_torch')
_FORBIDDEN = re.compile(
    r'^\s*(import\s+jax\b|from\s+jax\b|import\s+ble_tpu\.|from\s+ble_tpu\.|'
    r'from\s+ble_tpu\s+import|import\s+ble_tpu\s*$|import\s+ble_tpu\s*,)')


def _port_sources():
  paths = [os.path.join(_ROOT, name)
           for name in ('chip_smoke.py', 'gp_kernel_times.py')]
  for root, _, files in os.walk(_PKG):
    paths += [os.path.join(root, f) for f in files if f.endswith('.py')]
  return sorted(paths)


def test_port_imports_no_jax_and_nothing_of_ble_tpu():
  sources = _port_sources()
  assert len(sources) > 20
  offending = []
  for path in sources:
    with open(path) as f:
      text = f.read()
    for i, line in enumerate(text.splitlines(), 1):
      if _FORBIDDEN.match(line):
        offending.append(f'{os.path.relpath(path, _ROOT)}:{i}: {line.strip()}')
    # Imports nested in functions or after other statements as well.
    for node in ast.walk(ast.parse(text)):
      names = []
      if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
      elif isinstance(node, ast.ImportFrom) and node.module:
        names = [node.module]
      for name in names:
        top = name.split('.')[0]
        if top in ('jax', 'jaxlib', 'flax', 'ble_tpu'):
          offending.append(f'{os.path.relpath(path, _ROOT)}: import {name}')
  assert not offending, '\n'.join(offending)


# What the port leaves out on purpose (ROADMAP A): the shims that let
# ble_tpu's own tests import the reference package, the interpolation the
# port replaces with a gather, and the Pallas kernels, which are CUDA C++
# here (ops/<kernel>.py beside csrc/).
_NOT_PORTED = re.compile(r'^(compat/.*|ops/interp\.py|ops/pallas_\w+\.py)$')


def _modules(package: str) -> set:
  root = os.path.join(_ROOT, package)
  return {os.path.relpath(os.path.join(d, f), root)
          for d, _, files in os.walk(root) for f in files
          if f.endswith('.py')}


def test_port_has_every_module_of_ble_tpu():
  """Every module of ble_tpu but those left out on purpose has a module of
  the same name in the port."""
  missing = {m for m in _modules('ble_tpu') - _modules('ble_tpu_torch')
             if not _NOT_PORTED.match(m)}
  assert not missing, sorted(missing)


def _public_names(path: str) -> set:
  """The public top-level functions, classes and assigned names of a
  module."""
  with open(path) as f:
    tree = ast.parse(f.read())
  names = set()
  for node in tree.body:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
      names.add(node.name)
    elif isinstance(node, (ast.Assign, ast.AnnAssign)):
      targets = node.targets if isinstance(node, ast.Assign) else \
          [node.target]
      names |= {n.id for t in targets for n in ast.walk(t)
                if isinstance(n, ast.Name)}
  return {n for n in names if not n.startswith('_')}


# The only names of ble_tpu modules that the port's module of the same
# name lacks, and why. test_each_exception_is_absent_from_the_port keeps
# the table from going stale.
_NOT_IN_PORT = {
    'agents/dqn.py': {
        'DqnLearnerState': 'a flax state class; the port keeps the '
                           'network, target and torch optimizer in '
                           'qrdqn.LearnerState',
        'make_optimizer': 'an optax optimizer; dqn.init builds a '
                          'torch.optim.Adam',
    },
    'agents/mlp_agent.py': {
        'MlpOnlineState': 'a flax state class; the port\'s is OnlineState, '
                          'with the torch optimizer and train_steps',
    },
    'agents/r2d2.py': {
        'make_optimizer': 'an optax optimizer; r2d2.init builds a '
                          'torch.optim.Adam',
    },
    'env/features.py': {
        'PRESSURE_LEVELS': 'pressure_levels(device): a module-level tensor '
                           'would pin a device',
    },
    'parallel/distributed.py': {
        'ENV_AXIS': 'the name of a jax.sharding mesh axis; the port splits '
                    'envs by rank (shard_bounds)',
        'make_mesh': 'a jax.sharding mesh; the port\'s process group is '
                     'init_process_group and world',
        'shard_specs': 'jax.sharding partition specs; the port splits envs '
                       'and replay by rank (shard_bounds, local_config)',
    },
    'train/eval_lib.py': {
        'seed_to_key': 'env.seed_keys, the keys of a batch of seeds',
    },
}

_PORTED_MODULES = sorted(m for m in _modules('ble_tpu')
                         if not _NOT_PORTED.match(m))


@pytest.mark.parametrize('module', _PORTED_MODULES)
def test_last_ported_modules_have_every_function_and_class(module):
  """Each public function, class and module-level name of every ported
  ble_tpu module (once only the last four ported) has one of the same
  name in the port's module, but those of _NOT_IN_PORT."""
  theirs = _public_names(os.path.join(_ROOT, 'ble_tpu', module))
  ours = _public_names(os.path.join(_PKG, module))
  missing = theirs - ours - set(_NOT_IN_PORT.get(module, {}))
  assert not missing, sorted(missing)


def test_each_exception_is_absent_from_the_port():
  """Every entry of _NOT_IN_PORT names a ble_tpu module's public name
  that the port's module really lacks."""
  for module, names in _NOT_IN_PORT.items():
    assert module in _PORTED_MODULES, module
    theirs = _public_names(os.path.join(_ROOT, 'ble_tpu', module))
    ours = _public_names(os.path.join(_PKG, module))
    assert set(names) <= theirs - ours, (module, sorted(set(names) & ours))


# Parameters and config fields: every parameter of a public function or of
# a public method of a public class in a ported ble_tpu module is a
# parameter of the port's counterpart, and every field of its dataclasses,
# NamedTuples and flax modules is a field or constructor argument of the
# port's class, with the same default where ble_tpu's is a literal. Names
# and classes the port lacks altogether are the name test's (_NOT_IN_PORT).

_FLAX_PARAMS = ('flax params-first: the port\'s nn.Module (or its '
                'LearnerState) holds the weights')
_FLAX_STATE = ('a flax state field: the port keeps the nn.Module and its '
               'torch optimizer')
_GENERATOR = ('a jax.random key: the port draws training\'s randomness from '
              'a torch.Generator (ROADMAP, RNG)')
_KEYS = 'batch-first: the port takes keys (E, 2), one row an env'
_MESH = ('a jax.sharding mesh: the port splits envs by rank '
         '(parallel/distributed.py)')
_XLA = 'XLA-only: the port has one physics route, B1 or its plain version'
_NO_CALLER = 'no caller in ble_tpu passes it: an option with no user'

_PARAMS_NOT_IN_PORT = {
    'agents/dqn.py': {
        'init.key': _GENERATOR,
        'select_action.params': _FLAX_PARAMS,
        'select_action.key': _GENERATOR,
        'mse_loss.params': _FLAX_PARAMS,
        'mse_loss.target_params': _FLAX_PARAMS,
    },
    'agents/marco_polo.py': {
        'begin_episode.key': _GENERATOR,
        'step.key': _GENERATOR,
    },
    'agents/mlp_agent.py': {
        'init.key': _GENERATOR,
        'step.key': 'unused by ble_tpu\'s step, which acts greedily',
        'online_init.key': _GENERATOR,
        'online_select.params': _FLAX_PARAMS,
        'online_select.key': _GENERATOR,
        'MLPAgentState.params': _FLAX_STATE,
        'MLPAgentState.opt_state': _FLAX_STATE,
    },
    'agents/networks.py': {
        'LstmQuantileNetwork.initial_state.rng': 'flax RNG: the zero carry '
                                                 'draws nothing',
        'LstmQuantileNetwork.initial_state.batch_shape': 'batch-first: '
                                                         'initial_state(n, '
                                                         'device)',
    },
    'agents/perciatelli44.py': {
        'make_policy.params': _FLAX_PARAMS,
    },
    'agents/qrdqn.py': {
        'init.key': _GENERATOR,
        'q_values.config': 'the network carries the config\'s widths',
        'q_values.params': _FLAX_PARAMS,
        'select_action.params': _FLAX_PARAMS,
        'select_action.key': _GENERATOR,
        'quantile_loss.params': _FLAX_PARAMS,
        'quantile_loss.target_params': _FLAX_PARAMS,
        'LearnerState.params': _FLAX_STATE,
        'LearnerState.target_params': _FLAX_STATE,
        'LearnerState.opt_state': _FLAX_STATE,
        'QrDqnConfig.update_period': 'read nowhere in ble_tpu: the learner '
                                     'takes TrainConfig\'s samples_per_'
                                     'insert cadence',
    },
    'agents/r2d2.py': {
        'init.key': _GENERATOR,
        'actor_init.config': 'the network carries the config\'s widths: '
                             'actor_init(network, num_envs, device)',
        'actor_init.batch_shape': 'batch-first: actor_init(network, '
                                  'num_envs, device)',
        'actor_select.params': _FLAX_PARAMS,
        'actor_select.key': _GENERATOR,
        'sequence_loss.params': _FLAX_PARAMS,
        'sequence_loss.target_params': _FLAX_PARAMS,
    },
    'agents/random_walk.py': {
        'init.key': _KEYS,
        'step.key': 'batch-first: step takes the normals z (E,) drawn from '
                    'the step keys by the eval (draw)',
    },
    'agents/replay.py': {
        'init.obs_dtype': _NO_CALLER,
        'sample.key': _GENERATOR,
        'sample_sequence.key': _GENERATOR,
    },
    'env/atmosphere.py': {
        'reset.key': _KEYS,
    },
    'env/balloon.py': {
        'substep_math.at_pressure_fn': 'the port passes the atmosphere and '
                                       'looks the pressure up itself',
    },
    'env/env.py': {
        'reset.key': 'batch-first: reset takes integer seeds (reset_keys '
                     'takes keys)',
        'reset_from_field.key': _KEYS,
        'step.action': 'batch-first: actions (E,)',
        'step_batched.physics': _XLA,
        'rollout_window.physics': _XLA,
        'make_field_fn.decoder_params': 'the decoder is an nn.Module '
                                        'holding its weights (decoder)',
    },
    'env/parity_reset.py': {
        'parity_reset.field': _NO_CALLER,
        'parity_reset.field_dtype': _NO_CALLER,
        'parity_reset.exact_noise': _NO_CALLER,
    },
    'env/simplex_noise.py': {
        'simplex4d.x': 'batch-first: one coords tensor (..., 4)',
        'simplex4d.y': 'batch-first: one coords tensor (..., 4)',
        'simplex4d.z': 'batch-first: one coords tensor (..., 4)',
        'simplex4d.w': 'batch-first: one coords tensor (..., 4)',
    },
    'env/wind_field.py': {
        'reset_noise.key': _KEYS,
        'reset_noise_exact.noise_key': _KEYS,
        'make_state.key': _KEYS,
    },
    'generative/train_vae.py': {
        'evaluate.params': 'the model is an nn.Module holding its weights '
                           '(model)',
    },
    'generative/vae.py': {
        'sample_field.params': 'the decoder is an nn.Module holding its '
                               'weights (decoder)',
        'sample_field.key': _KEYS,
        'WindFieldVAE.setup': 'flax\'s submodule hook: the port builds them '
                              'in __init__',
    },
    'parallel/distributed.py': {
        'build_distributed_step.mesh': _MESH,
        'build_distributed_reset.mesh': _MESH,
        'init_distributed_train_state.key': 'an integer seed, as '
                                            'learner.init_train_state',
        'init_distributed_train_state.mesh': _MESH,
    },
    'parallel/tensor_parallel.py': {
        'param_specs.params': _FLAX_PARAMS,
        'shard_params.params': _FLAX_PARAMS,
    },
    'train/eval_lib.py': {
        'build_eval_fn.mesh': _MESH,
        'build_eval_fn._parametric': 'the port has build_parametric_eval_fn '
                                     'for it',
    },
    'train/learner.py': {
        'init_train_state.key': 'an integer seed: worlds by seed, the '
                                'learner\'s draws from a torch.Generator',
        'selective_reset.fields': 'fresh worlds from field_fn, by the '
                                  'world-seed counter',
        'run_episode_chunk.unroll': 'lax.scan\'s unroll: eager PyTorch has '
                                    'no scan',
        'make_eval_policy.learner_params': _FLAX_PARAMS,
        'TrainState.key': _GENERATOR,
    },
    'utils/sampling.py': {
        'sample_location.key': _KEYS,
        'sample_time.key': _KEYS,
        'sample_pressure.key': _KEYS,
        'sample_upwelling_infrared.key': _KEYS,
        'sample_initial_offset.key': _KEYS,
    },
}


def _arg_names(fn) -> list:
  a = fn.args
  return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
          if x.arg not in ('self', 'cls')]


def _is_config_class(node) -> bool:
  """A dataclass (dataclasses or flax.struct), a NamedTuple or a flax /
  torch module, whose annotated names are its fields."""
  marks = [ast.unparse(d) for d in node.decorator_list]
  marks += [ast.unparse(b) for b in node.bases]
  return any('dataclass' in m or m.endswith('NamedTuple') or
             m.endswith('Module') for m in marks)


_NO_DEFAULT = object()
_NOT_LITERAL = object()


def _default(value):
  """A field's default: the literal, _NOT_LITERAL, or _NO_DEFAULT."""
  if value is None:
    return _NO_DEFAULT
  if isinstance(value, ast.Call):  # struct.field / dataclasses.field
    kw = {k.arg: k.value for k in value.keywords}
    if 'default' not in kw:
      return _NOT_LITERAL
    value = kw['default']
  try:
    return ast.literal_eval(value)
  except ValueError:
    return _NOT_LITERAL


def _api(source: str):
  """(signatures, fields, configs) of a module's source: {'fn' or
  'Class.method': parameter names} over its public functions and its
  public classes' public methods (and __init__), {'Class': {field:
  default}} over its public classes, a constructor's parameters counting
  as fields, and the names of its config classes."""
  tree = ast.parse(source)
  signatures, fields, configs = {}, {}, set()
  for node in tree.body:
    if (not isinstance(node, (ast.FunctionDef, ast.ClassDef)) or
        node.name.startswith('_')):
      continue
    if isinstance(node, ast.FunctionDef):
      signatures[node.name] = _arg_names(node)
    else:
      own = fields[node.name] = {}
      for item in node.body:
        if isinstance(item, ast.FunctionDef) and (
            not item.name.startswith('_') or item.name == '__init__'):
          signatures[f'{node.name}.{item.name}'] = _arg_names(item)
          if item.name == '__init__':
            a = item.args
            args = a.posonlyargs + a.args
            defaults = [None] * (len(args) - len(a.defaults)) + a.defaults
            own.update({x.arg: _default(d) for x, d in
                        zip(args + a.kwonlyargs,
                            defaults + a.kw_defaults)
                        if x.arg != 'self'})
        elif (isinstance(item, ast.AnnAssign) and
              isinstance(item.target, ast.Name)):
          own[item.target.id] = _default(item.value)
      if _is_config_class(node):
        configs.add(node.name)
  return signatures, fields, configs


def _gaps(theirs: str, ours: str):
  """(parameters, fields) of ble_tpu's module source `theirs` that the
  port's `ours` lacks, as 'fn.param' / 'Class.method' names and
  'Class.field' names, the latter with ' default' where both have the
  field and ble_tpu's literal default differs."""
  jsig, jfields, jconfigs = _api(theirs)
  psig, pfields, _ = _api(ours)
  params = set()
  for name, args in jsig.items():
    if name.endswith('.__init__'):
      continue  # Constructors' parameters are fields.
    if name in psig:
      params |= {f'{name}.{a}' for a in args if a not in psig[name]}
    elif '.' in name and name.split('.')[0] in pfields:
      params.add(name)  # A method the port's class lacks.
  fields = set()
  for cls in jconfigs & set(pfields):
    for field, default in jfields[cls].items():
      if field not in pfields[cls]:
        fields.add(f'{cls}.{field}')
      elif (default not in (_NO_DEFAULT, _NOT_LITERAL) and
            pfields[cls][field] != default):
        fields.add(f'{cls}.{field} default')
  return params, fields


def _api_gaps(module: str):
  sources = []
  for root in (os.path.join(_ROOT, 'ble_tpu'), _PKG):
    with open(os.path.join(root, module)) as f:
      sources.append(f.read())
  return _gaps(*sources)


@pytest.mark.parametrize('module', _PORTED_MODULES)
def test_port_takes_every_parameter(module):
  """Each parameter of ble_tpu's public functions and methods is one of
  the port counterpart's, but those of _PARAMS_NOT_IN_PORT."""
  params, _ = _api_gaps(module)
  missing = params - set(_PARAMS_NOT_IN_PORT.get(module, {}))
  assert not missing, sorted(missing)


@pytest.mark.parametrize('module', _PORTED_MODULES)
def test_port_has_every_config_field_and_default(module):
  """Each field of ble_tpu's dataclasses, NamedTuples and modules is one
  of the port class's, with an equal default where ble_tpu's is a literal,
  but those of _PARAMS_NOT_IN_PORT."""
  _, fields = _api_gaps(module)
  missing = fields - set(_PARAMS_NOT_IN_PORT.get(module, {}))
  assert not missing, sorted(missing)


def test_each_parameter_exception_is_absent_from_the_port():
  """Every entry of _PARAMS_NOT_IN_PORT names a parameter, method or field
  of ble_tpu that the port really lacks."""
  for module, names in _PARAMS_NOT_IN_PORT.items():
    assert module in _PORTED_MODULES, module
    params, fields = _api_gaps(module)
    assert set(names) <= params | fields, (
        module, sorted(set(names) - params - fields))


def test_parameter_scan_sees_what_it_should():
  """The scan on known gaps: a missing parameter, method, field and a
  changed literal default; a flax field's default read through
  struct.field; a constructor's parameters counted as fields."""
  jax_src = (
      'import flax.struct as struct\n'
      '@struct.dataclass\n'
      'class Config:\n'
      '  a: int = 1\n'
      '  b: int = struct.field(pytree_node=False, default=8)\n'
      '  c: float = 0.5\n'
      'class Net(nn.Module):\n'
      '  width: int = 4\n'
      '  def setup(self): pass\n'
      'def f(x, y=2, *, z=None): pass\n'
      'def _private(q): pass\n')
  port_src = (
      'import dataclasses\n'
      '@dataclasses.dataclass\n'
      'class Config:\n'
      '  a: int = 1\n'
      '  b: int = 7\n'
      'class Net(torch.nn.Module):\n'
      '  def __init__(self, width: int = 4): pass\n'
      'def f(x, y=2): pass\n')
  params, fields = _gaps(jax_src, port_src)
  assert params == {'f.z', 'Net.setup'}
  assert fields == {'Config.b default', 'Config.c'}


def test_agents_package_reexports_the_registry():
  """from ble_tpu_torch.agents import create_agent, available_agents works
  as the JAX package's import does, and both registries list the same
  agents."""
  from ble_tpu import agents as jax_agents
  from ble_tpu_torch.agents import available_agents, create_agent
  assert create_agent is base.create_agent
  assert available_agents() == jax_agents.available_agents()


def test_forbidden_pattern_matches_what_it_should():
  for line in ('import jax', 'from jax import numpy', 'import ble_tpu.env',
               'from ble_tpu.env import env', 'from ble_tpu import ops',
               '  import jax.numpy as jnp'):
    assert _FORBIDDEN.match(line), line
  for line in ('import ble_tpu_torch', 'from ble_tpu_torch.env import env',
               'import jaxtyping_free_module', '# import jax'):
    assert not _FORBIDDEN.match(line), line


def test_strata_seeds_are_the_packages_own_copy():
  assert os.path.dirname(suites._STRATA_PATH) == os.path.join(_PKG, 'train')
  assert len(suites.get_eval_suite('hardest_strata').seeds) > 0


def test_precision_policy_is_full_float32():
  assert not torch.backends.cuda.matmul.allow_tf32
  assert not torch.backends.cudnn.allow_tf32
  assert torch.get_float32_matmul_precision() == 'highest'


@pytest.fixture
def no_cuda(monkeypatch):
  """The card reported absent, whatever this machine has."""
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
  assert ble_tpu_torch.default_device() == torch.device('cuda')
  with pytest.raises(RuntimeError, match='CUDA'):
    ble_tpu_torch.resolve_device()
  with pytest.raises(RuntimeError, match='CUDA'):
    env_lib.reset_from_field(env_lib.seed_keys([0]), env_lib.EnvParams(),
                             wind_field.simple_static_field())
  with pytest.raises(RuntimeError, match='CUDA'):
    env_lib.reset(env_lib.EnvParams(), [0], env_lib.make_field_fn('static'))
  policy = (lambda n, g: (),
            lambda st, obs, g: (st, station_seeker.pick_action(obs)))
  with pytest.raises(RuntimeError, match='CUDA'):
    eval_lib.build_eval_fn(env_lib.EnvParams(),
                           env_lib.make_field_fn('static'), *policy)
  with pytest.raises(RuntimeError, match='CUDA'):
    eval_lib.build_parametric_eval_fn(
        env_lib.EnvParams(), env_lib.make_field_fn('static'),
        lambda params, keys, device: (),
        lambda params, st, obs, draws: (st, station_seeker.pick_action(obs)))
  with pytest.raises(RuntimeError, match='CUDA'):
    eval_cli.main(['--suite', 'micro_eval'])
  with pytest.raises(RuntimeError, match='CUDA'):
    loader.load_offlineskies22()
  with pytest.raises(RuntimeError, match='CUDA'):
    gym_env.BalloonEnv(wind_field='static')
  config = learner.TrainConfig(num_envs=2)
  with pytest.raises(RuntimeError, match='CUDA'):
    learner.init_train_state(0, env_lib.EnvParams(),
                             env_lib.make_field_fn('static'), config)
  with pytest.raises(RuntimeError, match='CUDA'):
    train_lib.run_training_loop(None, env_lib.EnvParams(),
                                env_lib.make_field_fn('static'), config,
                                num_iterations=1)
  with pytest.raises(RuntimeError, match='CUDA'):
    train_cli.main(['--wind_field', 'static', '--num_iterations', '1'])
  # Asked for explicitly, the CPU is used.
  assert ble_tpu_torch.resolve_device('cpu') == torch.device('cpu')


def test_vae_trainer_and_renderer_callers_raise_without_a_card(no_cuda,
                                                                tmp_path):
  """The VAE trainer, its CLI, the reservoirs and make_vae default to the
  card, as do the gym env and the train CLI that drive a renderer."""
  with pytest.raises(RuntimeError, match='CUDA'):
    train_vae.train(reservoir.SyntheticWindFieldReservoir(device='cpu'),
                    num_epochs=1, batches_per_epoch=1)
  with pytest.raises(RuntimeError, match='CUDA'):
    train_vae.main(['--synthetic', '--epochs', '1'])
  with pytest.raises(RuntimeError, match='CUDA'):
    reservoir.SyntheticWindFieldReservoir()
  with pytest.raises(RuntimeError, match='CUDA'):
    reservoir.DatasetWindFieldReservoir(str(tmp_path))
  with pytest.raises(RuntimeError, match='CUDA'):
    vae.make_vae({})
  with pytest.raises(RuntimeError, match='CUDA'):
    gym_env.BalloonEnv(wind_field='static',
                       renderer=renderer_lib.MatplotlibRenderer())
  with pytest.raises(RuntimeError, match='CUDA'):
    train_cli.main(['--wind_field', 'static', '--num_iterations', '1',
                    '--render_final', '--base_dir', str(tmp_path)])


@pytest.mark.parametrize('agent', learner.TRAINABLE_AGENTS)
def test_train_cli_raises_without_a_card_for_each_agent(no_cuda, agent):
  with pytest.raises(RuntimeError, match='CUDA'):
    train_cli.main(['--agent', agent, '--wind_field', 'static',
                    '--num_iterations', '1'])


@pytest.mark.parametrize('agent', eval_cli.AGENTS)
def test_eval_cli_raises_without_a_card_for_each_agent(no_cuda, agent,
                                                       tmp_path):
  for field in ('generative', 'static'):
    with pytest.raises(RuntimeError, match='CUDA'):
      eval_cli.main(['--agent', agent, '--suite', 'micro_eval',
                     '--wind_field', field, '--checkpoint_dir',
                     str(tmp_path)])


def test_agents_and_perciatelli_loader_raise_without_a_card(no_cuda):
  """load_perciatelli44 and every registered agent default to the card:
  without one they raise before looking for a blob or drawing weights,
  the host-side agents (StationSeeker, random, random walk) too."""
  with pytest.raises(RuntimeError, match='CUDA'):
    loader.load_perciatelli44()
  for name in ('perciatelli44', 'quantile', 'finetune_perciatelli', 'dqn',
               'mlp', 'station_seeker', 'random', 'random_walk'):
    with pytest.raises(RuntimeError, match='CUDA'):
      base.create_agent(name, num_actions=3, observation_shape=(1099,))


def test_kernel_launchers_refuse_cpu_tensors():
  """The launchers check their buffers before touching nvcc or the card."""
  n = 4
  obs = torch.zeros((1, n, 8))
  gp = wind_gp.init(n, 'cpu')
  with pytest.raises(ValueError, match='obs_seq'):
    gp_window.launch(obs, gp.locations, gp.errors,
                     gp.active.to(torch.float32), gp.kinv, gp.alpha, gp.count)
  f32 = torch.zeros((16, n))
  i32 = torch.zeros((3, n), dtype=torch.int32)
  with pytest.raises(ValueError, match='f32'):
    physics.launch(f32, i32, torch.zeros((23, n)), torch.zeros((2, n)),
                   torch.zeros(n, dtype=torch.int32), f32.clone(),
                   i32.clone(), 18, 10,
                   physics.uniform_params(balloon.BalloonParams()))
  with pytest.raises(ValueError, match='obs'):
    gp_observe.launch(obs[0], gp.locations, gp.errors,
                      gp.active.to(torch.float32), gp.kinv, gp.alpha,
                      gp.count)
  with pytest.raises(ValueError, match='locations'):
    gp_query.launch(gp.locations, gp.active.to(torch.float32), gp.alpha,
                    gp.kinv, torch.zeros((n, 4)), torch.zeros(181))
  assert gp_window.launch.launches == 0
  assert physics.launch.launches == 0
  assert gp_observe.launch.launches == 0
  assert gp_query.launch.launches == 0


def test_fused_physics_refuses_per_env_params():
  params = balloon.BalloonParams(payload_mass=torch.full((4,), 92.5))
  with pytest.raises(ValueError, match='fleet-uniform'):
    physics.uniform_params(params)
  values = np.array(physics.uniform_params(balloon.BalloonParams()))
  assert values.shape == (11,) and np.all(np.isfinite(values))


def test_build_names_each_source_for_sm_90a():
  assert set(cuda_build.SOURCES) == {'physics', 'gp_window', 'gp_observe',
                                     'gp_query'}
  assert 'arch=compute_90a,code=sm_90a' in cuda_build._COMMON_FLAGS
  assert '--use_fast_math' not in cuda_build._COMMON_FLAGS
  for name in cuda_build.SOURCES:
    assert os.path.isfile(os.path.join(cuda_build.CSRC_DIR, f'{name}.cu'))
    path = cuda_build.library_path(name)
    assert path.startswith(cuda_build.BUILD_DIR) and path.endswith('.so')
