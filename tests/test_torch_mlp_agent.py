"""The port's online SARSA MLP agent (ble_tpu_torch/agents/mlp_agent.py)
against ble_tpu.agents.mlp_agent on the same parameters and inputs: the
batched learner's online_train and online_invalidate over a few steps, the
stateful agent's step, and the registered MLPAgent. Parameters cross with
bridge.mlp_params_from_flax; tolerances rtol 1e-5 / atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ble_tpu.agents import mlp_agent as jax_mlp
from ble_tpu_torch import bridge
from ble_tpu_torch.agents import base
from ble_tpu_torch.agents import mlp_agent

E, OBS_DIM = 6, 20
TOL = dict(rtol=1e-5, atol=1e-6)


def _params(tree):
  return bridge.mlp_params_from_flax(jax.tree.map(np.asarray, tree))


def _assert_network_close(network, flax_params):
  want = _params(flax_params)
  got = network.state_dict()
  assert set(got) == set(want)
  for name in want:
    np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                               err_msg=name, **TOL)


def test_network_is_one_linear_layer():
  """MLPNetwork(num_layers=1, hidden_units=256) is a single linear layer
  1099 -> 3, as ble_tpu's; SGD at 3e-4 and gamma 0.9."""
  state = mlp_agent.online_init(torch.Generator().manual_seed(0), 1099, 2)
  assert len(state.network.layers) == 1
  assert tuple(state.network.layers[0].weight.shape) == (3, 1099)
  assert state.optimizer.param_groups[0]['lr'] == 3e-4 == mlp_agent.LEARNING_RATE
  assert mlp_agent.GAMMA == jax_mlp.GAMMA == 0.9
  jparams = jax_mlp.online_init(jax.random.PRNGKey(0), 1099, 2).params
  assert jparams['params']['Dense_0']['kernel'].shape == (1099, 3)


def test_online_train_and_invalidate_match_jax():
  """Six batched SARSA steps over E = 6 envs with terminals, inactive
  envs, and an online_invalidate of envs 1 and 4 after step 3: the loss of
  each step, the network after it and the pending lanes (p_obs, p_action,
  p_reward, p_boot, p_valid) as ble_tpu's. The first step has no valid
  pending lane, so its loss is 0 and the parameters stay."""
  rng = np.random.RandomState(0)
  jstate = jax_mlp.online_init(jax.random.PRNGKey(1), OBS_DIM, E)
  state = mlp_agent.online_init(torch.Generator().manual_seed(0), OBS_DIM, E)
  state.network.load_state_dict(_params(jstate.params))
  start = {k: v.clone() for k, v in state.network.state_dict().items()}
  jtrain = jax.jit(jax_mlp.online_train)
  for t in range(6):
    obs = rng.randn(E, OBS_DIM).astype(np.float32)
    action = rng.randint(0, 3, E).astype(np.int32)
    reward = rng.rand(E).astype(np.float32)
    done = rng.rand(E) < 0.2
    active = rng.rand(E) < 0.8
    args = (obs, action, reward, done, active)
    jstate, jloss = jtrain(jstate, *map(jnp.asarray, args))
    state, loss = mlp_agent.online_train(state, *map(torch.from_numpy, args))
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    _assert_network_close(state.network, jstate.params)
    if t == 0:
      assert float(loss) == 0.0
      assert all(torch.equal(v, start[k])
                 for k, v in state.network.state_dict().items())
    if t == 3:
      mask = np.zeros(E, bool)
      mask[[1, 4]] = True
      jstate = jax_mlp.online_invalidate(jstate, jnp.asarray(mask))
      state = mlp_agent.online_invalidate(state, torch.from_numpy(mask))
    for name in ('p_obs', 'p_action', 'p_reward', 'p_boot', 'p_valid'):
      np.testing.assert_allclose(getattr(state, name).numpy(),
                                 np.asarray(getattr(jstate, name)),
                                 err_msg=name, **TOL)
    assert state.train_steps == t + 1
  assert not all(torch.equal(v, start[k])
                 for k, v in state.network.state_dict().items())


def test_stateful_step_matches_jax():
  """The stateful agent's step, five observations with rewards: ble_tpu's
  actions, and its network after each TD step (the first step has no
  previous transition and leaves it)."""
  rng = np.random.RandomState(1)
  jstate = jax_mlp.init(jax.random.PRNGKey(2), OBS_DIM)
  state = mlp_agent.init(torch.Generator().manual_seed(0), OBS_DIM)
  state.network.load_state_dict(_params(jstate.params))
  jstep = jax.jit(jax_mlp.step)
  for t in range(5):
    obs = rng.randn(OBS_DIM).astype(np.float32)
    reward = float(rng.rand())
    jstate, jaction = jstep(jstate, jnp.float32(reward), jnp.asarray(obs),
                            jax.random.PRNGKey(t))
    state, action = mlp_agent.step(state, reward, torch.from_numpy(obs)[None])
    assert int(action[0]) == int(jaction)
    _assert_network_close(state.network, jstate.params)
  assert state.has_last and bool(jstate.has_last)


def test_registered_mlp_agent_runs_an_episode():
  """create_agent('mlp') on the CPU: actions in {0, 1, 2} over an
  episode, the network moving with each step's TD update."""
  agent = base.create_agent('mlp', num_actions=3, observation_shape=(1099,),
                            seed=0, device='cpu')
  obs = np.random.RandomState(3).rand(4, 1099).astype(np.float32)
  actions = [agent.begin_episode(obs[0])]
  before = agent._state.network.layers[0].weight.clone()
  actions += [agent.step(1.0, o) for o in obs[1:]]
  agent.end_episode(1.0)
  assert set(actions) <= {0, 1, 2}
  assert not torch.equal(agent._state.network.layers[0].weight, before)
