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
  transpose; each bias carries across as it is. Other entries of the tree
  are left out."""
  dense = params['params']
  out = {}
  for i in range(sum(1 for k in dense if k.startswith('Dense_'))):
    layer = dense[f'Dense_{i}']
    out[f'layers.{i}.weight'] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(layer['kernel'], np.float32).T))
    out[f'layers.{i}.bias'] = torch.from_numpy(
        np.array(layer['bias'], np.float32))
  return out


def decoder_params_from_flax(params) -> dict:
  """The VAE decoder's state dict (generative/vae.Decoder)."""
  return _dense_stack_from_flax(params)


def vae_params_from_flax(params) -> dict:
  """generative/vae.WindFieldVAE's state dict from the flax tree of the JAX
  package's WindFieldVAE: encoder/Dense_0..2, encoder/mean and
  encoder/logvar, decoder/Dense_0..3 (each kernel transposed, as
  _dense_stack_from_flax does) and the scalar sigma."""
  tree = params['params']
  out = {f'decoder.{k}': v for k, v in
         _dense_stack_from_flax({'params': tree['decoder']}).items()}
  encoder = tree['encoder']
  out.update({f'encoder.{k}': v for k, v in
              _dense_stack_from_flax({'params': encoder}).items()})
  for head in ('mean', 'logvar'):
    dense = _dense_stack_from_flax({'params': {'Dense_0': encoder[head]}})
    out[f'encoder.{head}.weight'] = dense['layers.0.weight']
    out[f'encoder.{head}.bias'] = dense['layers.0.bias']
  out['sigma'] = torch.tensor(float(np.asarray(tree['sigma'], np.float32)))
  return out


def quantile_params_from_flax(params) -> dict:
  """agents/networks.QuantileNetwork's state dict: the weights every
  learner parity test carries across from the JAX package."""
  return _dense_stack_from_flax(params)


def mlp_params_from_flax(params) -> dict:
  """agents/networks.MLPNetwork's state dict."""
  return _dense_stack_from_flax(params)


def lstm_quantile_params_from_flax(params, torso_layers: int = 2) -> dict:
  """agents/networks.LstmQuantileNetwork's state dict from flax's
  LstmQuantileNetwork tree: Dense_0 .. Dense_{torso_layers - 1} are the
  torso, the Dense layers after them the head (hidden, value and advantage
  when duelling). OptimizedLSTMCell_0's per-gate kernels ii/if/ig/io
  (input, no bias) and hi/hf/hg/ho (recurrent, with bias) stack,
  transposed, into nn.LSTM's rows in its gate order i, f, g, o; the
  recurrent biases go to bias_hh, and bias_ih is zero."""
  tree = params['params']
  cell = tree['OptimizedLSTMCell_0']
  dense = _dense_stack_from_flax(params)
  out = {}
  for key, value in dense.items():
    i = int(key.split('.')[1])
    prefix, j = ('torso', i) if i < torso_layers else (
        'head', i - torso_layers)
    out[f'{prefix}.{j}.{key.split(".")[2]}'] = value
  stack = lambda kind: torch.from_numpy(np.ascontiguousarray(np.concatenate(
      [np.asarray(cell[kind + g]['kernel'], np.float32).T for g in 'ifgo'])))
  out['lstm.weight_ih_l0'] = stack('i')
  out['lstm.weight_hh_l0'] = stack('h')
  out['lstm.bias_hh_l0'] = torch.from_numpy(np.concatenate(
      [np.asarray(cell['h' + g]['bias'], np.float32) for g in 'ifgo']))
  out['lstm.bias_ih_l0'] = torch.zeros_like(out['lstm.bias_hh_l0'])
  return out
