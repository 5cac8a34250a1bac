"""The port's networks (ble_tpu_torch/agents/networks.py) against the JAX
package's flax modules: the same parameters, carried across with
bridge.quantile_params_from_flax / mlp_params_from_flax, give the same
outputs; the port's own initialization draws from the same distributions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ble_tpu.agents import networks as jax_networks
from ble_tpu_torch import bridge
from ble_tpu_torch.agents import networks

OBS_DIM = 1099


def _flax_params(module, seed=0):
  params = module.init(jax.random.PRNGKey(seed), jnp.zeros((OBS_DIM,)))
  return jax.tree.map(np.asarray, params)


def _obs(batch=8, seed=0):
  return np.random.RandomState(seed).rand(batch, OBS_DIM).astype(np.float32)


@pytest.mark.parametrize('layers,hidden,atoms', [(2, 32, 11), (8, 600, 51)])
def test_quantile_network_matches_flax(layers, hidden, atoms):
  """q and logits within 1e-5 of flax's apply on a batch of 8, at a small
  width and at the full 8 x 600, 51-atom width."""
  module = jax_networks.QuantileNetwork(num_layers=layers,
                                        hidden_units=hidden, num_atoms=atoms)
  params = _flax_params(module)
  obs = _obs()
  want_q, want_logits = module.apply(params, obs)
  net = networks.QuantileNetwork(OBS_DIM, num_layers=layers,
                                 hidden_units=hidden, num_atoms=atoms)
  net.load_state_dict(bridge.quantile_params_from_flax(params))
  with torch.no_grad():
    q, logits = net(torch.from_numpy(obs))
  assert tuple(q.shape) == (8, 3) and tuple(logits.shape) == (8, 3, atoms)
  np.testing.assert_allclose(q.numpy(), np.asarray(want_q), atol=1e-5,
                             rtol=1e-5)
  np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                             atol=1e-5, rtol=1e-5)


def test_mlp_network_matches_flax():
  module = jax_networks.MLPNetwork(num_layers=3, hidden_units=32)
  params = _flax_params(module)
  obs = _obs()
  want = module.apply(params, obs)
  net = networks.MLPNetwork(OBS_DIM, num_layers=3, hidden_units=32)
  net.load_state_dict(bridge.mlp_params_from_flax(params))
  with torch.no_grad():
    got = net(torch.from_numpy(obs))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                             rtol=1e-5)


def _port_net(kind, seed, layers, hidden):
  gen = torch.Generator().manual_seed(seed)
  if kind == 'quantile':
    return networks.QuantileNetwork(OBS_DIM, num_layers=layers,
                                    hidden_units=hidden, num_atoms=51,
                                    generator=gen)
  return networks.MLPNetwork(OBS_DIM, num_layers=layers, hidden_units=hidden,
                             generator=gen)


@pytest.mark.parametrize('kind', ['quantile', 'mlp'])
def test_initialization_draws_the_reference_distributions(kind):
  """Kernels uniform in the same +-limit as flax's initializers
  (variance_scaling(1/sqrt(3), fan_in, uniform) for the quantile network,
  glorot_uniform for the MLP): each layer's max |w| within 1 % of flax's
  and of the limit; both packages' standard deviations within five
  standard errors (0.447 / sqrt(count) relative, for a uniform) of the
  limit / sqrt(3); biases zero; the same seed gives the same parameters."""
  if kind == 'quantile':
    module = jax_networks.QuantileNetwork(num_layers=4, hidden_units=200,
                                          num_atoms=51)
    limit = lambda fan_in, fan_out: np.sqrt(np.sqrt(3.0) / fan_in)
  else:
    module = jax_networks.MLPNetwork(num_layers=4, hidden_units=200)
    limit = lambda fan_in, fan_out: np.sqrt(6.0 / (fan_in + fan_out))
  net = _port_net(kind, 0, 4, 200)
  params = _flax_params(module)['params']
  for i, layer in enumerate(net.layers):
    w = layer.weight.detach().numpy()
    k = params[f'Dense_{i}']['kernel']
    assert w.shape == k.T.shape
    bound = limit(*k.shape)
    assert np.abs(w).max() <= bound
    np.testing.assert_allclose(np.abs(w).max(), bound, rtol=1e-2)
    np.testing.assert_allclose(np.abs(k).max(), bound, rtol=1e-2)
    spread = 5 * 0.447 / np.sqrt(w.size)
    np.testing.assert_allclose(w.std(), bound / np.sqrt(3), rtol=spread)
    np.testing.assert_allclose(k.std(), bound / np.sqrt(3), rtol=spread)
    assert not layer.bias.detach().numpy().any()
  twin = _port_net(kind, 0, 4, 200)
  for a, b in zip(net.parameters(), twin.parameters()):
    assert torch.equal(a, b)
