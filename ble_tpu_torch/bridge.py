"""Conversion between nested dicts of numpy arrays and the port's
dataclasses of tensors.

A dict is keyed by dataclass field names, nested where a field is itself a
dataclass; this is how the JAX package's states and params cross into the
port (the caller flattens its own pytrees to such dicts). bfloat16 arrays
(numpy dtype 'bfloat16', from ml_dtypes) keep their bits.
"""

import dataclasses
import typing

import numpy as np
import torch


def _is_bf16(dtype) -> bool:
  return getattr(dtype, 'name', '') == 'bfloat16'


def tensor_from_numpy(array, device=None) -> torch.Tensor:
  """A tensor holding exactly the array's values (bf16 bit-for-bit)."""
  array = np.asarray(array)
  if _is_bf16(array.dtype):
    bits = torch.from_numpy(array.view(np.int16).copy())
    return bits.view(torch.bfloat16).to(device)
  return torch.from_numpy(array.copy()).to(device)


def numpy_from_tensor(tensor: torch.Tensor):
  """The inverse of tensor_from_numpy (bf16 as ml_dtypes.bfloat16)."""
  tensor = tensor.detach().cpu()
  if tensor.dtype == torch.bfloat16:
    import ml_dtypes
    return tensor.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
  return tensor.numpy()


def from_dict(cls, data: dict, device=None):
  """Builds dataclass `cls` from a nested dict of numpy arrays. Tensor
  fields get tensors on `device`; float/bool fields (parameters) get
  Python scalars; None stays None."""
  hints = typing.get_type_hints(cls)
  kwargs = {}
  for field in dataclasses.fields(cls):
    if field.name not in data:
      continue
    value = data[field.name]
    hint = hints[field.name]
    if dataclasses.is_dataclass(hint):
      kwargs[field.name] = from_dict(hint, value, device)
    elif value is None:
      kwargs[field.name] = None
    elif hint in (float, bool, int):
      kwargs[field.name] = hint(np.asarray(value).item())
    else:
      kwargs[field.name] = tensor_from_numpy(value, device)
  return cls(**kwargs)


def to_dict(obj) -> dict:
  """The nested dict of numpy arrays for a dataclass of tensors."""
  out = {}
  for field in dataclasses.fields(obj):
    value = getattr(obj, field.name)
    if dataclasses.is_dataclass(value):
      out[field.name] = to_dict(value)
    elif isinstance(value, torch.Tensor):
      out[field.name] = numpy_from_tensor(value)
    else:
      out[field.name] = value
  return out


def _dense_stack_from_flax(params) -> dict:
  """The state dict of a module whose parameters are `layers.i` nn.Linear
  from a flax tree of numpy arrays, {'params': {'Dense_i': {'kernel',
  'bias'}}}: each (in, out) kernel becomes an (out, in) weight, by
  transpose; each bias carries across as it is."""
  dense = params['params']
  out = {}
  for i in range(len(dense)):
    layer = dense[f'Dense_{i}']
    out[f'layers.{i}.weight'] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(layer['kernel'], np.float32).T))
    out[f'layers.{i}.bias'] = torch.from_numpy(
        np.array(layer['bias'], np.float32))
  return out


def decoder_params_from_flax(params) -> dict:
  """The VAE decoder's state dict (generative/vae.Decoder)."""
  return _dense_stack_from_flax(params)


def quantile_params_from_flax(params) -> dict:
  """agents/networks.QuantileNetwork's state dict: the weights every
  learner parity test carries across from the JAX package."""
  return _dense_stack_from_flax(params)


def mlp_params_from_flax(params) -> dict:
  """agents/networks.MLPNetwork's state dict."""
  return _dense_stack_from_flax(params)
