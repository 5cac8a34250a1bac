"""Wind-field training datasets ("reservoirs"), the port of
ble_tpu/generative/reservoir.py (reference
generative/wind_field_reservoir.py and dataset_wind_field_reservoir.py).

A reservoir hands the VAE trainer batches of (21, 21, 10, 9, 2) grids as
tensors on its device (default cuda). Every draw comes from a key through
utils/prng.py, as the JAX package's does from jax.random, so one key gives
the same batch in both packages: the dataset's indices exactly, the
synthetic fields within the sine's ulps.
"""

import abc
import math
import os
import pickle

import numpy as np
import torch

from ble_tpu_torch import resolve_device
from ble_tpu_torch.env import wind_field
from ble_tpu_torch.utils import prng


class WindFieldReservoir(abc.ABC):
  """Supplies batches of (21, 21, 10, 9, 2) wind fields."""

  @abc.abstractmethod
  def get_batch(self, batch_size: int, key) -> torch.Tensor:
    ...

  @abc.abstractmethod
  def get_eval_batch(self, batch_size: int) -> torch.Tensor:
    ...


class DatasetWindFieldReservoir(WindFieldReservoir):
  """In-memory dataset loaded from the pickle shards `batch%04d.pickle`
  (reference dataset_wind_field_reservoir.py:28-81), held on the host; a
  batch is copied to `device`. The last `eval_batch_size` fields are kept
  out of the training draws. Shards are unpickled, so read only shards
  that a trusted program wrote."""

  def __init__(self, data_path: str, num_shards: int = 200,
               eval_batch_size: int = 128, device=None):
    self._device = resolve_device(device)
    shards = []
    for i in range(num_shards):
      path = os.path.join(data_path, f'batch{i:04d}.pickle')
      if not os.path.exists(path):
        break
      with open(path, 'rb') as f:
        shards.append(pickle.load(f))
    if not shards:
      raise FileNotFoundError(f'No batch****.pickle shards in {data_path}')
    self.data = np.concatenate(shards, axis=0)
    self._eval_batch_size = eval_batch_size

  def get_batch(self, batch_size: int, key) -> torch.Tensor:
    """Fields at jax.random.choice(key, n - eval_batch_size, (batch_size,))
    (with replacement)."""
    idx = prng.choice(key, self.data.shape[0] - self._eval_batch_size,
                      (batch_size,))
    return torch.from_numpy(self.data[idx.numpy()]).to(self._device)

  def get_eval_batch(self, batch_size: int) -> torch.Tensor:
    return torch.from_numpy(self.data[-batch_size:].copy()).to(self._device)


_NUM_MODES = 4


class SyntheticWindFieldReservoir(WindFieldReservoir):
  """Procedurally generated incompressible wind fields for smoke training
  (ble_tpu/generative/reservoir.py:59-95).

  Each field's stream function, per pressure/time slice, is a sum of the
  4 x 4 lowest sine modes on a 23 x 23 grid (a halo of 1), mode (kx, ky)
  weighted by 40 / (1 + kx + ky) and a normal(key, (4, 4, 90)) amplitude;
  its curl on the inner 21 x 21 points is the field. The amplitudes are
  drawn on the host; the sum is one contraction over the modes for the
  whole batch, on `device`."""

  def __init__(self, seed: int = 0, device=None):
    self._device = resolve_device(device)
    self._base_key = prng.key(seed)
    n = wind_field.LATLNG_SLICES + 2
    fx = (torch.arange(n) / n)[:, None]
    fy = (torch.arange(n) / n)[None, :]
    basis = []
    for kx in range(_NUM_MODES):
      for ky in range(_NUM_MODES):
        basis.append(torch.sin(2 * math.pi * (kx + 1) * fx) *
                     torch.sin(2 * math.pi * (ky + 1) * fy) * 40.0 /
                     (1 + kx + ky))
    self._basis = torch.stack(basis).to(self._device)  # (16, 23, 23)

  def _sample(self, keys) -> torch.Tensor:
    """The fields of keys (B, 2), (B, 21, 21, 10, 9, 2)."""
    num_ff = wind_field.PRESSURE_SLICES * wind_field.TIME_SLICES
    modes = prng.normal(keys, (_NUM_MODES, _NUM_MODES, num_ff))
    modes = modes.reshape(-1, _NUM_MODES * _NUM_MODES, num_ff)
    psi = torch.einsum('bkf,kij->bijf', modes.to(self._device), self._basis)
    du = (psi[:, 2:, 1:-1] - psi[:, :-2, 1:-1]) / 2.0
    dv = (psi[:, 1:-1, 2:] - psi[:, 1:-1, :-2]) / 2.0
    shape = (-1,) + wind_field.GRID_SHAPE[:-1]
    return torch.stack([du.reshape(shape), -dv.reshape(shape)], dim=-1)

  def get_batch(self, batch_size: int, key) -> torch.Tensor:
    return self._sample(prng.split(key, batch_size))

  def get_eval_batch(self, batch_size: int) -> torch.Tensor:
    return self._sample(prng.split(self._base_key, batch_size))
