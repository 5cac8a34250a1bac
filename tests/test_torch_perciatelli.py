"""Perciatelli44 in the port: the offline converter
(ble_tpu_torch/models/convert_perciatelli44.py) on a synthetic frozen TF1
graph with the reference's naming, the loader
(models/loader.load_perciatelli44) on its output and on a msgpack that
flax writes, the Perciatelli44 policy and agent, finetune_perciatelli's
init from the blob and without it, and the agent registry. The trained
blob is not in the repository, so every network here is synthetic."""

import logging
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ble_tpu.agents import base as jax_base
from ble_tpu.agents import networks as jax_networks
from ble_tpu.agents import perciatelli44 as jax_perciatelli44
from ble_tpu.agents import qrdqn as jax_qrdqn
from ble_tpu.models import loader as jax_loader
from ble_tpu.train import learner as jax_learner
from ble_tpu_torch import bridge
from ble_tpu_torch.agents import base
from ble_tpu_torch.agents import perciatelli44
from ble_tpu_torch.agents import qrdqn
from ble_tpu_torch.models import convert_perciatelli44
from ble_tpu_torch.models import loader
from ble_tpu_torch.train import learner

SMALL = dict(num_layers=2, hidden_units=32, num_atoms=11)


def _frozen_graph(obs_dim, hidden, num_layers, out_dim, seed=0):
  """A frozen TF1 graph with perciatelli44's online tower naming,
  Online/fully_connected[_k]/{weights,biases} (reference
  quantile_agent.py:216-252), a probe batch and the graph's outputs."""
  tf = pytest.importorskip('tensorflow')
  tf1 = tf.compat.v1
  rng = np.random.RandomState(seed)
  graph = tf1.Graph()
  with graph.as_default():
    x = tf1.placeholder(tf.float32, [None, obs_dim], name='observation')
    h = x
    dims = [obs_dim] + [hidden] * (num_layers - 1) + [out_dim]
    with tf1.variable_scope('Online'):
      for i in range(num_layers):
        with tf1.variable_scope('fully_connected' + ('' if i == 0
                                                     else f'_{i}')):
          w = tf1.get_variable('weights', initializer=rng.randn(
              dims[i], dims[i + 1]).astype(np.float32) * 0.1)
          b = tf1.get_variable('biases', initializer=rng.randn(
              dims[i + 1]).astype(np.float32) * 0.1)
        h = tf1.matmul(h, w) + b
        if i < num_layers - 1:
          h = tf.nn.relu(h)
      out = tf1.identity(h, name='q_values')
    with tf1.Session(graph=graph) as sess:
      sess.run(tf1.global_variables_initializer())
      frozen = tf1.graph_util.convert_variables_to_constants(
          sess, graph.as_graph_def(), ['Online/q_values'])
      probe = rng.randn(4, obs_dim).astype(np.float32)
      expected = sess.run(out, {x: probe})
  return frozen, probe, expected


def test_converter_roundtrip_matches_the_tf_graph(tmp_path):
  """tests/test_model_converters.py::test_perciatelli_converter_roundtrip
  for the port: the 8-layer tower converted by the port's converter and
  read by the port's loader reproduces the TF graph's logits and their
  atom means within 1e-5; ble_tpu's loader reads the same file to the
  same values."""
  num_layers, hidden, num_atoms, obs_dim = 8, 32, 5, 24
  frozen, probe, expected = _frozen_graph(obs_dim, hidden, num_layers,
                                          3 * num_atoms)
  pb = tmp_path / 'perciatelli44.pb'
  out = str(tmp_path / 'perciatelli44.msgpack')
  pb.write_bytes(frozen.SerializeToString())
  convert_perciatelli44.convert(str(pb), out)
  network = loader.load_perciatelli44(out, device='cpu')
  assert len(network.layers) == 8 and network.num_atoms == num_atoms
  with torch.no_grad():
    q, logits = network(torch.from_numpy(probe))
  tol = dict(rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(logits.reshape(4, -1).numpy(), expected, **tol)
  np.testing.assert_allclose(
      q.numpy(), expected.reshape(-1, 3, num_atoms).mean(-1), **tol)
  jparams = jax_loader.load_perciatelli44(out)
  for name, value in bridge.quantile_params_from_flax(jparams).items():
    np.testing.assert_array_equal(network.state_dict()[name].numpy(),
                                  value.numpy(), err_msg=name)


def _flax_blob(tmp_path, params, name='perciatelli44.msgpack'):
  path = tmp_path / name
  path.write_bytes(flax.serialization.msgpack_serialize(
      jax.tree.map(np.asarray, params)))
  return str(path)


def test_loader_resolves_a_flax_blob_and_raises_without_one(tmp_path,
                                                            monkeypatch):
  """A msgpack that flax writes loads through the explicit path and
  through $BLE_TPU_MODELS, with flax's weights; with neither, the loader
  raises FileNotFoundError naming the port's converter, as ble_tpu's
  raises."""
  jparams = jax_qrdqn.init(jax.random.PRNGKey(0),
                           jax_qrdqn.QrDqnConfig(**SMALL), 1099).params
  path = _flax_blob(tmp_path, jparams)
  want = bridge.quantile_params_from_flax(jax.tree.map(np.asarray, jparams))
  monkeypatch.setenv('BLE_TPU_MODELS', str(tmp_path))
  for network in (loader.load_perciatelli44(path, device='cpu'),
                  loader.load_perciatelli44(device='cpu')):
    got = network.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
  monkeypatch.setenv('BLE_TPU_MODELS', str(tmp_path / 'empty'))
  with pytest.raises(FileNotFoundError,
                     match='ble_tpu_torch.models.convert_perciatelli44'):
    loader.load_perciatelli44(device='cpu')
  with pytest.raises(FileNotFoundError):
    jax_loader.load_perciatelli44()


def test_make_policy_and_agent_match_jax():
  """make_policy over the same synthetic 8 x 600, 51-atom parameters
  gives ble_tpu's greedy actions on 64 observations, and the registered
  Perciatelli44 agent the same actions one observation at a time; it
  refuses anything but 3 actions and 1099-d observations."""
  jparams = jax_qrdqn.init(jax.random.PRNGKey(1), jax_qrdqn.QrDqnConfig(),
                           1099).params
  params = bridge.quantile_params_from_flax(jax.tree.map(np.asarray, jparams))
  obs = np.random.RandomState(2).rand(64, 1099).astype(np.float32)
  want = np.asarray(jax_perciatelli44.make_policy(jparams)(jnp.asarray(obs)))
  network = qrdqn.network_from_params(params, device='cpu')
  got = perciatelli44.make_policy(network)(torch.from_numpy(obs))
  assert got.dtype == torch.int32
  np.testing.assert_array_equal(got.numpy(), want)
  assert len(set(want.tolist())) > 1
  agent = base.create_agent('perciatelli44', num_actions=3,
                            observation_shape=(1099,), params=params,
                            device='cpu')
  jagent = jax_perciatelli44.Perciatelli44(3, (1099,), params=jparams)
  acts = [agent.begin_episode(obs[0])] + [agent.step(0.0, o)
                                          for o in obs[1:6]]
  jacts = [jagent.begin_episode(obs[0])] + [jagent.step(0.0, o)
                                            for o in obs[1:6]]
  assert acts == jacts == want[:6].tolist()
  with pytest.raises(ValueError, match='3 actions'):
    perciatelli44.Perciatelli44(4, (1099,), params=params, device='cpu')
  with pytest.raises(ValueError, match='1099'):
    perciatelli44.Perciatelli44(3, (1098,), params=params, device='cpu')


def test_finetune_init_loads_the_blob_or_warns(tmp_path, monkeypatch,
                                               caplog):
  """finetune_perciatelli's learner starts from the blob in
  $BLE_TPU_MODELS, online and target networks both, as ble_tpu's
  _finetune_init; without a blob it logs ble_tpu's warning and starts from
  QR-DQN's random init. FinetunePerciatelliAgent acts from the blob."""
  jcfg = jax_learner.TrainConfig(agent='finetune_perciatelli',
                                 qrdqn=jax_qrdqn.QrDqnConfig(**SMALL))
  cfg = learner.TrainConfig(agent='finetune_perciatelli',
                            qrdqn=qrdqn.QrDqnConfig(**SMALL))
  jparams = jax_qrdqn.init(jax.random.PRNGKey(2), jcfg.qrdqn, 1099).params
  _flax_blob(tmp_path, jparams)
  monkeypatch.setenv('BLE_TPU_MODELS', str(tmp_path))
  want = bridge.quantile_params_from_flax(jax.tree.map(np.asarray, jparams))
  jstate = jax_learner.make_agent_core(jcfg).init(jax.random.PRNGKey(0), 1099)
  state = learner.make_agent_core(cfg).init(torch.Generator().manual_seed(0),
                                            1099, 'cpu')
  for net in (state.network, state.target_network):
    got = net.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
  jwant = bridge.quantile_params_from_flax(
      jax.tree.map(np.asarray, jstate.target_params))
  assert all(torch.equal(jwant[k], want[k]) for k in want)
  agent = base.create_agent('finetune_perciatelli', num_actions=3,
                            observation_shape=(1099,), device='cpu')
  assert all(torch.equal(agent.network.state_dict()[k], want[k])
             for k in want)

  monkeypatch.setenv('BLE_TPU_MODELS', str(tmp_path / 'empty'))
  with caplog.at_level(logging.WARNING):
    state = learner.make_agent_core(cfg).init(
        torch.Generator().manual_seed(0), 1099, 'cpu')
  assert 'perciatelli44.msgpack missing' in caplog.text
  fresh = qrdqn.init(torch.Generator().manual_seed(0), cfg.qrdqn, 1099, 'cpu')
  assert all(torch.equal(a, b) for a, b in zip(
      state.network.parameters(), fresh.network.parameters()))
  assert not os.path.exists(tmp_path / 'empty')


def test_create_agent_knows_every_name_of_the_jax_registry():
  """base.create_agent and available_agents know every agent ble_tpu
  registers."""
  assert set(base.available_agents()) == set(jax_base.available_agents())
  assert set(base.available_agents()) >= {
      'perciatelli44', 'quantile', 'finetune_perciatelli', 'dqn', 'mlp',
      'station_seeker', 'random', 'random_walk'}
  agent = base.create_agent('quantile', num_actions=3,
                            observation_shape=(1099,), seed=0, device='cpu')
  assert len(agent.network.layers) == jax_networks.NUM_LAYERS
