"""The wind VAE's training side on the CPU, at full width (88 M
parameters), against ble_tpu: the encoder and WindFieldVAE on the same
parameters (bridge.vae_params_from_flax), init_vae_params leaf by leaf, the
reservoirs, three sigma-VAE train steps, train(seed=0) with its evaluation,
the schedules and the CLI.

ble_tpu's side is one run of its own train() on the synthetic reservoir
(seed 0, one epoch of 3 batches of 2), with its train step and evaluate
wrapped to record what they see and return: made once for the module
(`jax_side`). The port's train() runs once too (`port_run`), through
chip_smoke.vae_fixture_run, which phase `vae` runs on the card against
`torch_jax_vae.json`: ble_tpu's metrics of that run.
`python tests/test_torch_vae_train.py` rewrites the fixture;
test_fixture_is_current recomputes it. The port draws the run's initial
parameters once (`port_init`, ~6 s of host draws); the port's train()
runs, here and in the CLI test, read them from there for that key.

Tolerances. XLA's float32 sum over a grid's 79,380 squared errors reads up
to ~4e-5 from the exact sum where torch's reads ~4e-8
(test_jax_float32_sum_is_the_mse_limit), so the MSE and the loss built
on it are held to 1e-4 relative; the KLD, sigma and the forward passes to
1e-5.
"""

import json
import os
import pickle
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ble_tpu.generative import reservoir as jax_reservoir
from ble_tpu.generative import train_vae as jax_train_vae
from ble_tpu.generative import vae as jax_vae
from ble_tpu_torch import bridge
from ble_tpu_torch.generative import reservoir
from ble_tpu_torch.generative import train_vae
from ble_tpu_torch.generative import vae
from ble_tpu_torch.utils import prng

FIXTURE = os.path.join(os.path.dirname(__file__), 'torch_jax_vae.json')
RUN = chip_smoke.VAE_FIXTURE_RUN  # seed 0, 1 epoch x 3 batches of 2.
MSE_RTOL = 1e-4
RTOL = 1e-5
# Parameters after the three steps: |port - jax| over |jax after - before|
# in norm, per tensor. Adam's first steps are ~lr * sign(g), so a gradient
# element within its rounding of zero flips a whole step: the port read
# up to 3.3e-3 (encoder.logvar.weight, 1 of 64,000 elements flipped),
# the same steps at 1.1 times the rate 0.0998 and more on every tensor.
UPDATE_RTOL = 1e-2


def _np_tree(tree):
  return jax.tree.map(np.asarray, tree)


def compute_jax_side() -> dict:
  """ble_tpu's train() on its synthetic reservoir, recording each train
  step's parameters in, batch, key, KL weight and metrics, the evaluation's
  metrics and the final parameters."""
  rec = {'steps': [], 'batches': [], 'keys': [], 'kl_weights': []}
  make_train_step, evaluate = (jax_train_vae.make_train_step,
                               jax_train_vae.evaluate)

  def recording_make_train_step(optimizer):
    step = make_train_step(optimizer)

    def recording_step(params, opt_state, batch, rng, kl_weight):
      if 'init' not in rec:
        rec['init'] = _np_tree(params)
      rec['batches'].append(np.array(batch))
      rec['keys'].append(np.asarray(rng))
      rec['kl_weights'].append(float(kl_weight))
      out = step(params, opt_state, batch, rng, kl_weight)
      rec['steps'].append({k: float(v) for k, v in out[2].items()})
      return out
    return recording_step

  def recording_evaluate(params, fields, key):
    out = evaluate(params, fields, key)
    rec['eval'] = {k: float(v) for k, v in out.items()}
    return out

  with mock.patch.object(jax_train_vae, 'make_train_step',
                         recording_make_train_step), \
      mock.patch.object(jax_train_vae, 'evaluate', recording_evaluate):
    rec['final'] = _np_tree(jax_train_vae.train(
        jax_reservoir.SyntheticWindFieldReservoir(RUN['seed']),
        num_epochs=1, batches_per_epoch=RUN['batches'],
        batch_size=RUN['batch_size'], seed=RUN['seed']))
  return rec


def jax_fixture(side: dict) -> dict:
  """The values of torch_jax_vae.json."""
  return {'run': RUN, 'steps': side['steps'], 'eval': side['eval']}


@pytest.fixture(scope='module')
def jax_side():
  return compute_jax_side()


# train(seed=RUN['seed'])'s init key: split(key(seed))[0].
INIT_KEY = prng.split(prng.key(RUN['seed']))[0]


@pytest.fixture(scope='module')
def port_init():
  return vae.init_vae_params(INIT_KEY)


@pytest.fixture(scope='module')
def drawn_once(port_init):
  """Inside the block, vae.init_vae_params(INIT_KEY) is port_init
  (make_vae copies it into the model)."""
  draw = vae.init_vae_params

  def init_vae_params(key):
    return port_init if torch.equal(key, INIT_KEY) else draw(key)
  return mock.patch.object(vae, 'init_vae_params', init_vae_params)


@pytest.fixture(scope='module')
def port_run(drawn_once):
  with drawn_once:
    return chip_smoke.vae_fixture_run('cpu')


@pytest.fixture(scope='module')
def fixture():
  with open(FIXTURE) as f:
    return json.load(f)


def _rel(got, want) -> float:
  got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
  return float(np.abs(got - want).max() / np.abs(want).max())


def test_init_vae_params_matches_flax(jax_side, port_init):
  """init_vae_params of train(seed 0)'s init key against the flax init
  ble_tpu's train() drew from the same key: the same leaves
  (bridge.vae_params_from_flax maps every one), each weight within 1e-6
  relative (its normals sit within a few ulp, as the decoder's init test
  allows), the biases zero and sigma 1.0."""
  want = bridge.vae_params_from_flax(jax_side['init'])
  got = port_init
  with torch.device('meta'):
    names = set(vae.WindFieldVAE().state_dict())
  assert set(got) == set(want) == names
  for name, value in got.items():
    assert value.shape == want[name].shape and value.dtype == torch.float32
    if name.endswith('.weight'):
      np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                 rtol=1e-6, atol=0.0, err_msg=name)
    else:
      assert torch.equal(value, want[name]), name
  assert float(got['sigma']) == 1.0


@pytest.fixture(scope='module')
def flax_and_port(jax_side):
  """The run's initial flax parameters and the port's VAE holding them."""
  params = jax_side['init']
  return params, vae.make_vae(bridge.vae_params_from_flax(params), 'cpu')


def _grids(batch):
  rs = np.random.RandomState(3)
  return (rs.normal(size=batch + (21, 21, 10, 9, 2)) * 15).astype(np.float32)


@pytest.mark.parametrize('batch', [(), (3,)])
def test_encoder_matches_flax(flax_and_port, batch):
  """The encoder on one grid and on a batch: the flatten in C order, the
  squash and the layers give flax's mean and logvar within 1e-5."""
  params, model = flax_and_port
  x = _grids(batch)
  mean, logvar = jax_vae.Encoder().apply(
      {'params': params['params']['encoder']}, x)
  with torch.no_grad():
    got_mean, got_logvar = model.encoder(torch.from_numpy(x))
  assert got_mean.shape == batch + (64,) == mean.shape
  assert _rel(got_mean, mean) < RTOL
  assert _rel(got_logvar, logvar) < RTOL
  np.testing.assert_allclose(
      vae._squash(torch.from_numpy(x)).numpy(), jax_vae._squash(x),
      rtol=1e-6)


@pytest.mark.parametrize('reparameterize', [False, True])
def test_vae_forward_matches_flax(flax_and_port, reparameterize):
  """WindFieldVAE(reparameterize) on a batch of 2 with the latent noise
  drawn from PRNGKey(5) and prng.key(5): the reconstruction, mean, logvar
  and sigma within 1e-5; generate(z) is the decoder's output."""
  params, model = flax_and_port
  x = _grids((2,))
  recon, (mean, logvar), sigma = jax_vae.WindFieldVAE(
      reparameterize=reparameterize).apply(params, x,
                                           jax.random.PRNGKey(5))
  model.reparameterize = reparameterize
  with torch.no_grad():
    got, (got_mean, got_logvar), got_sigma = model(torch.from_numpy(x),
                                                   prng.key(5))
    z = torch.from_numpy(np.array(mean))
    assert torch.equal(model.generate(z), model.decoder(z))
  model.reparameterize = True
  assert got.shape == (2, 21, 21, 10, 9, 2)
  assert _rel(got, recon) < RTOL
  assert _rel(got_mean, mean) < RTOL and _rel(got_logvar, logvar) < RTOL
  assert float(got_sigma.detach()) == float(sigma) == 1.0


def test_synthetic_reservoir_matches_jax():
  """get_batch(key) and get_eval_batch against ble_tpu's within 1e-5 of
  the batch's largest wind (the sine's ulps), and incompressible as
  tests/test_misc_components.py checks ble_tpu's."""
  ours = reservoir.SyntheticWindFieldReservoir(2, device='cpu')
  theirs = jax_reservoir.SyntheticWindFieldReservoir(2)
  got = ours.get_batch(3, prng.key(11))
  want = np.asarray(theirs.get_batch(3, jax.random.PRNGKey(11)))
  assert got.shape == (3, 21, 21, 10, 9, 2) and got.device.type == 'cpu'
  assert _rel(got, want) < RTOL
  assert _rel(ours.get_eval_batch(4), theirs.get_eval_batch(4)) < RTOL
  f = got[0].numpy()
  du_d1 = (f[1:-1, 2:, :, :, 0] - f[1:-1, :-2, :, :, 0]) / 2.0
  dv_d0 = (f[2:, 1:-1, :, :, 1] - f[:-2, 1:-1, :, :, 1]) / 2.0
  assert np.abs(du_d1 + dv_d0)[1:-1, 1:-1].max() < 1e-3


def test_dataset_reservoir_matches_jax(tmp_path):
  """Three pickle shards written here: the same training draws (indices
  by jax.random.choice) and eval batch as ble_tpu's reservoir, exactly;
  a directory without shards raises."""
  rs = np.random.RandomState(0)
  for i, n in enumerate((5, 7, 6)):
    with open(tmp_path / f'batch{i:04d}.pickle', 'wb') as f:
      pickle.dump(rs.normal(size=(n, 21, 21, 10, 9, 2)).astype(np.float32),
                  f)
  ours = reservoir.DatasetWindFieldReservoir(str(tmp_path),
                                             eval_batch_size=4,
                                             device='cpu')
  theirs = jax_reservoir.DatasetWindFieldReservoir(str(tmp_path),
                                                   eval_batch_size=4)
  assert ours.data.shape[0] == 18
  for seed in range(3):
    got = ours.get_batch(6, prng.key(seed))
    want = np.asarray(theirs.get_batch(6, jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(got.numpy(), want)
  np.testing.assert_array_equal(ours.get_eval_batch(4).numpy(),
                                np.asarray(theirs.get_eval_batch(4)))
  with pytest.raises(FileNotFoundError):
    reservoir.DatasetWindFieldReservoir(str(tmp_path / 'none'), device='cpu')


def test_kl_divergence_and_schedules_match_jax():
  rs = np.random.RandomState(1)
  mean, logvar = (rs.normal(size=(3, 64)).astype(np.float32)
                  for _ in range(2))
  np.testing.assert_allclose(
      train_vae.kl_divergence(torch.from_numpy(mean),
                              torch.from_numpy(logvar)).numpy(),
      jax_train_vae.kl_divergence(mean, logvar), rtol=1e-6)
  schedules = [(train_vae.constant_schedule(512.0),
                jax_train_vae.constant_schedule(512.0)),
               (train_vae.step_schedule(1.0, 2.0, 3, 20.0),
                jax_train_vae.step_schedule(1.0, 2.0, 3, 20.0))]
  for ours, theirs in schedules:
    assert [ours(i) for i in range(20)] == [theirs(i) for i in range(20)]


def test_jax_float32_sum_is_the_mse_limit(jax_side):
  """Why MSE_RTOL is 1e-4: on the run's first batch, ble_tpu's float32
  sum of squares over a grid reads more than 1e-6 from the exact sum,
  the port's less; both within MSE_RTOL."""
  batch = jax_side['batches'][0]
  exact = np.sum(batch.astype(np.float64) ** 2, axis=(1, 2, 3, 4, 5))
  theirs = np.asarray(jax.jit(
      lambda x: jnp.sum(x ** 2, axis=(1, 2, 3, 4, 5)))(batch))
  ours = torch.sum(torch.from_numpy(batch) ** 2, dim=(1, 2, 3, 4, 5))
  assert 1e-6 < _rel(theirs, exact) < MSE_RTOL
  assert _rel(ours, exact) < 1e-6


def _metrics_close(got: dict, want: dict) -> list:
  bad = []
  for key, value in want.items():
    limit = MSE_RTOL if key in ('loss', 'mse', 'eval_mse') else RTOL
    err = abs(got[key] - value) / abs(value)
    if not err <= limit:
      bad.append(f'{key}: {got[key]} vs {value} ({err:.3g} > {limit})')
  return bad


def test_train_steps_match_jax(jax_side):
  """ble_tpu's three train steps of the run, from its initial parameters
  and on its batches, keys and KL weight, through make_train_step and
  make_optimizer (Adam): each step's metrics, and every parameter tensor
  after the three, within UPDATE_RTOL of the update in norm."""
  init = bridge.vae_params_from_flax(jax_side['init'])
  model = vae.make_vae(init, 'cpu')
  step = train_vae.make_train_step(model, train_vae.make_optimizer(model,
                                                                   1e-4))
  for i, want in enumerate(jax_side['steps']):
    got = step(torch.from_numpy(jax_side['batches'][i]),
               torch.from_numpy(jax_side['keys'][i].astype(np.int64)),
               jax_side['kl_weights'][i])
    assert not _metrics_close({k: float(v) for k, v in got.items()}, want)
  final = bridge.vae_params_from_flax(jax_side['final'])
  for name, value in model.state_dict().items():
    update = (final[name].double() - init[name].double()).norm()
    assert update > 0, name
    err = float((value.double() - final[name].double()).norm() / update)
    assert err < UPDATE_RTOL, (name, err)


def test_train_matches_jax(jax_side, port_run):
  """train(synthetic seed 0, 1 epoch x 3 batches of 2, seed=0) on the
  CPU: ble_tpu's run, step by step and in its evaluation, from the port's
  own init, keys and batches."""
  assert len(port_run['steps']) == len(jax_side['steps']) == 3
  for got, want in zip(port_run['steps'], jax_side['steps']):
    assert not _metrics_close(got, want)
  assert not _metrics_close(port_run['eval'], jax_side['eval'])
  assert port_run['line'].startswith('epoch 0: kld=')


def test_fixture_is_current(jax_side, fixture):
  """The committed fixture is ble_tpu's run now, within 1e-6 relative
  (XLA's threads may sum in another order on another machine)."""
  want = jax_fixture(jax_side)
  assert fixture['run'] == want['run']
  for got, ref in zip(fixture['steps'] + [fixture['eval']],
                      want['steps'] + [want['eval']]):
    assert set(got) == set(ref)
    for key in ref:
      assert abs(got[key] - ref[key]) <= 1e-6 * abs(ref[key]), key


def test_port_matches_the_fixture(port_run, fixture):
  """chip_smoke's phase `vae` (b) on the CPU: the port's run against the
  fixture at chip_smoke.compare_vae_run's tolerances."""
  assert chip_smoke.compare_vae_run(port_run, fixture) == []


def test_cli_writes_checkpoints_that_read_back(drawn_once, tmp_path,
                                               capsys):
  """python -m ble_tpu_torch.generative.train_vae --device cpu --synthetic
  for 2 epochs of 1 batch of 2: an epoch line each, vae_0.pt and vae_1.pt
  written, the last one equal in bits to the trained model's state dict,
  and a VAE loaded from it evaluates as the trained one does."""
  with drawn_once:
    model = train_vae.main(['--device', 'cpu', '--synthetic', '--epochs',
                            '2', '--batches_per_epoch', '1', '--batch_size',
                            '2', '--checkpoint_dir', str(tmp_path)])
  lines = capsys.readouterr().out.splitlines()
  assert [line.split(':')[0] for line in lines] == ['epoch 0', 'epoch 1']
  assert sorted(os.listdir(tmp_path)) == ['vae_0.pt', 'vae_1.pt']
  state = torch.load(tmp_path / 'vae_1.pt', weights_only=True)
  assert set(state) == set(model.state_dict())
  for name, value in model.state_dict().items():
    assert torch.equal(state[name], value), name
  loaded = vae.make_vae(state, 'cpu')
  fields = reservoir.SyntheticWindFieldReservoir(
      device='cpu').get_eval_batch(2)
  got = train_vae.evaluate(loaded, fields, prng.key(3))
  want = train_vae.evaluate(model, fields, prng.key(3))
  assert all(torch.equal(got[k], want[k]) for k in want)


if __name__ == '__main__':
  with open(FIXTURE, 'w') as f:
    json.dump(jax_fixture(compute_jax_side()), f, indent=1)
    f.write('\n')
  print(f'wrote {FIXTURE}')
