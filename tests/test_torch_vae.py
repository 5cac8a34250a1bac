"""The port's VAE wind decoder, its loader and the generative eval CLI on
the CPU, against the JAX package's decoder with the same parameters carried
across by bridge.decoder_params_from_flax."""

import json
import os

import flax
import jax
import numpy as np
import pytest
import torch

from ble_tpu.generative import vae as jax_vae
from ble_tpu_torch import bridge
from ble_tpu_torch.env import env as env_lib
from ble_tpu_torch.generative import vae
from ble_tpu_torch.models import loader
from ble_tpu_torch.train import eval as eval_cli
from ble_tpu_torch.train import suites
from ble_tpu_torch.utils import prng


@pytest.fixture(scope='module')
def jax_params():
  return jax_vae.init_decoder_params(jax.random.PRNGKey(0))


def _port_decoder(jax_params):
  decoder = vae.Decoder()
  decoder.load_state_dict(bridge.decoder_params_from_flax(
      jax.tree.map(np.asarray, jax_params)))
  return decoder.eval()


@pytest.mark.parametrize('batch', [(), (2,)])
def test_decoder_matches_jax(jax_params, batch):
  """Same z, same grid: the dense layers, the half-pixel bilinear upsample
  (jax.image.resize 'linear') and the curl, to atol 1e-5."""
  z = np.random.RandomState(0).normal(size=batch + (64,)).astype(np.float32)
  want = np.asarray(jax_vae.Decoder().apply(jax_params, z))
  with torch.no_grad():
    got = _port_decoder(jax_params)(torch.from_numpy(z)).numpy()
  assert got.shape == batch + (21, 21, 10, 9, 2) == want.shape
  np.testing.assert_allclose(got, want, atol=1e-5)


def test_loader_reads_flax_msgpack(jax_params, tmp_path, monkeypatch):
  """A flax msgpack blob, found by explicit path and by $BLE_TPU_MODELS,
  decodes what JAX decodes from the same parameters."""
  blob = tmp_path / 'offlineskies22_decoder.msgpack'
  blob.write_bytes(flax.serialization.to_bytes(jax_params))
  z = np.random.RandomState(1).normal(size=(64,)).astype(np.float32)
  want = np.asarray(jax_vae.Decoder().apply(jax_params, z))
  monkeypatch.setenv('BLE_TPU_MODELS', str(tmp_path))
  for path in (str(blob), None):
    decoder = loader.load_offlineskies22(path, device='cpu')
    with torch.no_grad():
      got = decoder(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_loader_raises_on_unreadable_blob(tmp_path, monkeypatch):
  """A blob that is found but cannot be read raises; the loader never
  falls back to the untrained decoder then."""
  monkeypatch.delenv('BLE_TPU_MODELS', raising=False)
  blob = tmp_path / 'broken.msgpack'
  blob.write_bytes(b'\xc1 not msgpack')
  with pytest.raises(ValueError):
    loader.load_offlineskies22(str(blob), device='cpu')


def test_loader_fallback_is_deterministic(monkeypatch):
  """No blob: the JAX package's PRNGKey(0) init, the same across calls,
  decoding finite grids; a seed's field comes from its own forecast key
  and equals, to the bit, its field decoded in any batch (decoder calls
  of env.DECODE_BLOCK latents: here across a block's edge)."""
  monkeypatch.delenv('BLE_TPU_MODELS', raising=False)
  assert not os.path.exists(os.path.join(os.path.dirname(loader.__file__),
                                         loader._OFFLINESKIES_FILENAME))
  a = loader.load_offlineskies22(device='cpu')
  b = loader.load_offlineskies22(device='cpu')
  for (name, wa), wb in zip(a.state_dict().items(), b.state_dict().values()):
    assert torch.equal(wa, wb), name
  w0 = a.state_dict()['layers.0.weight']
  assert abs(float(w0.std()) - 1 / 8) < 5e-3  # lecun_normal, fan_in 64.
  field = vae.sample_field(a, prng.key(3)[None])[0]
  assert field.shape == (21, 21, 10, 9, 2)
  assert bool(torch.isfinite(field).all()) and float(field.abs().max()) > 0
  field_fn = env_lib.make_field_fn('generative', a)
  keys = env_lib.forecast_keys(
      env_lib.seed_keys(range(env_lib.DECODE_BLOCK + 4)))
  both = field_fn(keys[[5, 3]], 'cpu')
  alone = field_fn(keys[[3]], 'cpu')
  assert torch.equal(both[1], alone[0])
  assert not torch.equal(both[0], both[1])
  many = field_fn(keys, 'cpu')
  assert many.shape[0] == env_lib.DECODE_BLOCK + 4
  last = env_lib.DECODE_BLOCK + 3
  assert torch.equal(many[last], field_fn(keys[[last]], 'cpu')[0])
  assert torch.equal(many[3], alone[0])


@pytest.mark.parametrize('agent', ['station_seeker', 'random', 'random_walk'])
def test_eval_cli_generative_on_cpu(agent, tmp_path, monkeypatch):
  """`--wind_field generative` (the default) with each agent, cut to two
  seeds of 4 steps."""
  monkeypatch.delenv('BLE_TPU_MODELS', raising=False)
  monkeypatch.setattr(suites, 'get_eval_suite',
                      lambda name: suites.EvaluationSuite([0, 1], 4))
  eval_cli.main(['--agent', agent, '--suite', 'micro_eval', '--device',
                 'cpu', '--output_dir', str(tmp_path)])
  with open(tmp_path / f'{agent}_micro_eval.json') as f:
    results = json.load(f)['results']
  assert [r['seed'] for r in results] == [0, 1]
  for r in results:
    assert r['final_timestep'] == 4
    assert 0.0 <= r['time_within_radius'] <= 1.0
