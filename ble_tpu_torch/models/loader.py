"""Trained-model loading (the port of ble_tpu/models/loader.py; reference
models/models.py:33-130).

Neither trained blob ships with the repository, so loading resolves in the
JAX package's order: an explicit path, then $BLE_TPU_MODELS/<file>, then
the file beside this module, and then

  offlineskies22_decoder.msgpack (the flax msgpack of the VAE wind
    decoder): the JAX package's untrained fallback,
    vae.init_decoder_params(PRNGKey(0)), drawn here with the port's
    threefry (utils/prng.py);
  perciatelli44.msgpack (the Nature-paper QR-DQN, converted offline from
    perciatelli44.pb by models/convert_perciatelli44.py): FileNotFoundError.
"""

import functools
import os
from typing import Optional

import numpy as np

from ble_tpu_torch import bridge
from ble_tpu_torch import resolve_device
from ble_tpu_torch.agents import qrdqn
from ble_tpu_torch.generative import vae
from ble_tpu_torch.utils import prng

_OFFLINESKIES_FILENAME = 'offlineskies22_decoder.msgpack'
_PERCIATELLI_FILENAME = 'perciatelli44.msgpack'
# flax.serialization's msgpack extension code for an ndarray.
_EXT_NDARRAY = 1


def _candidate_paths(filename: str, explicit: Optional[str]):
  if explicit:
    yield explicit
  env_dir = os.environ.get('BLE_TPU_MODELS')
  if env_dir:
    yield os.path.join(env_dir, filename)
  yield os.path.join(os.path.dirname(__file__), filename)


def read_flax_msgpack(data: bytes):
  """The nested dict of numpy arrays in flax.serialization's msgpack
  format (an ndarray leaf is extension 1 holding (shape, dtype name,
  bytes)). Needs the `msgpack` module."""
  import msgpack

  def ext_hook(code, payload):
    if code != _EXT_NDARRAY:
      raise ValueError(f'unsupported msgpack extension {code}')
    shape, dtype, buf = msgpack.unpackb(payload, raw=True)
    return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)

  return msgpack.unpackb(data, ext_hook=ext_hook, raw=False)


@functools.lru_cache(maxsize=1)
def _fallback_decoder_params() -> dict:
  return vae.init_decoder_params(prng.key(0))


def fallback_decoder_params() -> dict:
  """vae.init_decoder_params(key(0)) on the CPU, drawn once a process; each
  call returns its own copy."""
  return {k: v.clone() for k, v in _fallback_decoder_params().items()}


def load_offlineskies22(path: Optional[str] = None,
                        device=None) -> vae.Decoder:
  """The VAE wind decoder on `device` (default: cuda), in eval mode.

  A blob that is found is read with the `msgpack` module; one that cannot
  be read raises, it never falls back. With no blob the decoder is the
  JAX package's fallback, vae.init_decoder_params(PRNGKey(0)), to a few
  float32 ulp (its normals go through torch's log1p): both packages decode
  the same fields from it. Its 6.5 M draws run once a process
  (fallback_decoder_params).
  """
  device = resolve_device(device)
  decoder = vae.Decoder()
  for candidate in _candidate_paths(_OFFLINESKIES_FILENAME, path):
    if os.path.exists(candidate):
      with open(candidate, 'rb') as f:
        params = bridge.decoder_params_from_flax(read_flax_msgpack(f.read()))
      break
  else:
    params = fallback_decoder_params()
  decoder.load_state_dict(params)
  return decoder.to(device).eval()


def load_perciatelli44(path: Optional[str] = None, device=None):
  """The converted Perciatelli44 QuantileNetwork (8 x 600, 51 atoms, 3
  actions) on `device` (default: cuda), its widths read from the blob.
  Raises FileNotFoundError if no blob is found."""
  device = resolve_device(device)
  for candidate in _candidate_paths(_PERCIATELLI_FILENAME, path):
    if os.path.exists(candidate):
      with open(candidate, 'rb') as f:
        params = bridge.quantile_params_from_flax(read_flax_msgpack(f.read()))
      return qrdqn.network_from_params(params, device=device)
  raise FileNotFoundError(
      'perciatelli44.msgpack not found. Obtain perciatelli44.pb and run '
      'python -m ble_tpu_torch.models.convert_perciatelli44 <pb> '
      '<out.msgpack> once, then set $BLE_TPU_MODELS to its directory.')
