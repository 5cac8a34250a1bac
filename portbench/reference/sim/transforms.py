"""Feature transforms (reference utils/transforms.py:45-94), on tensors."""

import torch


def linear_rescale_with_extrapolation(x, vmin: float, vmax: float):
  """(x - vmin) / (vmax - vmin), may leave [0, 1]."""
  return (x - vmin) / (vmax - vmin)


def undo_linear_rescale_with_extrapolation(x, vmin: float, vmax: float):
  return vmin + x * (vmax - vmin)


def linear_rescale_with_saturation(x, vmin: float, vmax: float):
  """Rescale then clip into [0, 1]."""
  return torch.clamp(linear_rescale_with_extrapolation(x, vmin, vmax), 0.0,
                     1.0)


def squash_to_unit_interval(x, constant: float):
  """x / (x + c) for non-negative x."""
  return x / (x + constant)


def undo_squash_to_unit_interval(x, constant: float):
  return (x * constant) / (1.0 - x)
