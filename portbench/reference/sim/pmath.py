"""Elementary functions built from sin/cos/exp/log/sqrt and arithmetic.

The port's copy of ble_tpu/ops/pmath.py:19-83. The JAX package computes
atan/atan2/asin/acos/tan/fmod/powf with these polynomials on every path,
so its golden fixtures depend on them; csrc/physics.cu carries the same
functions as __device__ code.
"""

import math

import torch

PI = math.pi


def ipow(x, n: int):
  """x**n for a small positive int n by binary exponentiation, in the
  order XLA's integer_pow uses (x**4 = (x*x)*(x*x), x**5 = x*x**4)."""
  acc = None
  while n > 0:
    if n & 1:
      acc = x if acc is None else acc * x
    n >>= 1
    if n > 0:
      x = x * x
  return acc


def _atan_poly(x):
  """atan on [-1, 1] (odd polynomial, single-precision minimax)."""
  t = x * x
  p = -0.0040540580
  p = p * t + 0.0218612288
  p = p * t - 0.0559098861
  p = p * t + 0.0964200441
  p = p * t - 0.1390853351
  p = p * t + 0.1994653599
  p = p * t - 0.3332985605
  p = p * t + 0.9999993329
  return x * p


def atan(x):
  big = torch.abs(x) > 1.0
  inv = 1.0 / torch.where(x == 0, torch.ones_like(x), x)
  outer = torch.sign(x) * (PI / 2.0) - _atan_poly(inv)
  return torch.where(big, outer, _atan_poly(x))


def atan2(y, x):
  """Four-quadrant arctangent with jnp.arctan2's conventions."""
  safe_x = torch.where(x == 0, torch.ones_like(x), x)
  base = atan(y / safe_x)
  result = torch.where(x > 0, base,
                       torch.where(y >= 0, base + PI, base - PI))
  zero = torch.zeros_like(y)
  on_axis = torch.where(y > 0, zero + PI / 2.0,
                        torch.where(y < 0, zero - PI / 2.0, zero))
  return torch.where(x == 0, on_axis, result)


def asin(x):
  x = torch.clamp(x, -1.0, 1.0)
  return atan2(x, torch.sqrt(torch.clamp_min((1.0 - x) * (1.0 + x), 0.0)))


def acos(x):
  return PI / 2.0 - asin(x)


def tan(x):
  return torch.sin(x) / torch.cos(x)


def fmod(a, b):
  """C-style fmod (sign of the dividend), as a - trunc(a/b)*b."""
  return a - torch.trunc(a / b) * b


def powf(x, p):
  """x**p for positive x via exp(p*log(x)); x <= 0 maps to 0."""
  x = torch.as_tensor(x, dtype=torch.float32)
  safe = torch.clamp_min(x, 1e-30)
  return torch.where(x > 0, torch.exp(p * torch.log(safe)),
                     torch.zeros_like(x))
