"""jax.random's threefry2x32 streams in torch integer ops, on the host.

The JAX package draws every world and every eval policy's randomness from
`jax.random` keys. This module reproduces the functions it uses, so that
one integer seed gives the same world and the same policy draws in both
packages. It follows jax 0.9.0 with `jax_threefry_partitionable = True`
(the default there); the line numbers below are those of
jax/_src/prng.py and jax/_src/random.py of that release.

A key is an int64 tensor whose last axis holds the two 32-bit words
(hi, lo); a batch of keys is (..., 2). Every 32-bit word is held in int64
and masked with `& MASK32`, since torch's uint32 lacks most kernels.
Integer draws and uniforms equal jax.random's bits. Normal draws go
through the single-precision erf_inv polynomial XLA uses (`erf_inv32`);
the log1p under it is torch's, so a normal sits within a few ulp of
JAX's. All of it runs on the CPU: callers move the draws to their device
once, so a seed's draws are the same bits on the card and on the CPU.
"""

import concurrent.futures
import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
# prng.py:912-913: the rotations of the two alternating round groups.
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# random.py:869: the normal's uniform runs on (nextafter(-1, 0), 1).
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
# random.py:1011-1012 for the truncation at +-2 (flax's lecun_normal):
# XLA's float32 erf of -2/sqrt(2) and 2/sqrt(2). Their bits are held
# against jax.lax.erf in tests/test_torch_prng.py.
_ERF_MINUS_SQRT2 = float(np.frombuffer(np.uint32(0xBF745A18).tobytes(),
                                       np.float32)[0])
_ERF_SQRT2 = float(np.frombuffer(np.uint32(0x3F745A18).tobytes(),
                                 np.float32)[0])

# XLA's ErfInv32 (xla/hlo/builder/lib/math.cc; M. Giles, "Approximating
# the erfinv function"): one 9-coefficient Horner chain for w < 5 and one
# for w >= 5, w = -log1p(-x * x).
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def keys(seeds) -> torch.Tensor:
  """jax.random.PRNGKey(seed) of each seed, (E, 2) int64: the seed's high
  and low 32 bits (prng.py:815-830), so a 64-bit seed keeps both halves
  (JAX does so under x64; without it, it keeps the low half)."""
  return torch.tensor([[(int(s) >> 32) & MASK32, int(s) & MASK32]
                       for s in seeds], dtype=torch.int64).reshape(-1, 2)


def key(seed: int) -> torch.Tensor:
  """keys([seed])[0], (2,)."""
  return keys([seed])[0]


def _rotl_(x, d: int):
  """x rotated left by d bits, in place."""
  high = x >> (32 - d)
  return x.bitwise_left_shift_(d).bitwise_and_(MASK32).bitwise_or_(high)


def threefry2x32(k1, k2, x1, x2):
  """The Threefry-2x32 hash of counts (x1, x2) under keys (k1, k2), all
  int64 tensors of 32-bit words that broadcast together (prng.py:888-930,
  the unrolled lowering: 5 groups of 4 rounds with a key injection after
  each group)."""
  shape = torch.broadcast_shapes(k1.shape, k2.shape, x1.shape, x2.shape)
  ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
  x1 = ((x1 + ks[0]) & MASK32).expand(shape).clone()
  x2 = ((x2 + ks[1]) & MASK32).expand(shape).clone()
  for i in range(5):
    for r in _ROTATIONS[i % 2]:
      x1.add_(x2).bitwise_and_(MASK32)
      _rotl_(x2, r).bitwise_xor_(x1)
    x1.add_(ks[(i + 1) % 3]).bitwise_and_(MASK32)
    x2.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(MASK32)
  return x1, x2


def _hash_counts(keys_, shape, start: int = 0):
  """threefry2x32 of every key in `keys_` (..., 2) with the counts
  start .. start + prod(shape) - 1 laid out in `shape` (iota_2x32_shape,
  prng.py:1003; the high count word is 0 below 2**32 draws). Returns
  (bits1, bits2), each (...,) + shape."""
  n = math.prod(shape)
  if start + n > 1 << 32:
    raise ValueError('more than 2**32 draws from one key')
  lead = keys_.shape[:-1]
  pad = (1,) * len(shape)
  k1 = keys_[..., 0].reshape(lead + pad)
  k2 = keys_[..., 1].reshape(lead + pad)
  counts = torch.arange(start, start + n, dtype=torch.int64).reshape(shape)
  return threefry2x32(k1, k2, torch.zeros_like(counts), counts)


def split(keys_, num: int = 2, start: int = 0) -> torch.Tensor:
  """jax.random.split(key, num) over a batch of keys (..., 2) ->
  (..., num - start, 2): the fold-like split of partitionable threefry
  (prng.py:1156-1161), from its key `start` on. Key i of it depends on i
  alone, so split(k, n, start)[j] == split(k, m)[start + j] for any
  m >= n."""
  b1, b2 = _hash_counts(keys_, (num - start,), start)
  return torch.stack([b1, b2], dim=-1)


def fold_in(keys_, data: int) -> torch.Tensor:
  """jax.random.fold_in of the 32-bit `data` into keys (..., 2): the
  non-partitionable threefry_2x32(key, threefry_seed(data))
  (prng.py:1163-1170), i.e. the hash of counts (0, data)."""
  b1, b2 = threefry2x32(keys_[..., 0], keys_[..., 1],
                        torch.zeros((), dtype=torch.int64),
                        torch.tensor(int(data) & MASK32, dtype=torch.int64))
  return torch.stack([b1, b2], dim=-1)


def bits(keys_, shape=()) -> torch.Tensor:
  """32 random bits per element, (...,) + shape int64 in [0, 2**32):
  partitionable random_bits, bits1 ^ bits2 (prng.py:1184-1200)."""
  b1, b2 = _hash_counts(keys_, tuple(shape))
  return b1 ^ b2


# Counts a chunk of _by_chunks: the int64 and float64 temporaries of one
# chunk stay in the cache.
_CHUNK = 1 << 18


def _by_chunks(keys_, shape, from_bits) -> torch.Tensor:
  """from_bits(bits(keys_, shape)) for an elementwise `from_bits`, in
  chunks of _CHUNK counts when keys_ is one key (2,) and the draw is
  larger: count i of the flat shape is hashed as in bits either way.

  The chunks run on a pool of torch.get_num_threads() threads, each op on
  one thread (intra-op threads set to 1 for the draw, then restored): the
  hundreds of small ops a chunk would otherwise each open an OpenMP
  region, which costs ~25x when other processes share the cores (pytest
  workers). A draw of the VAE encoder's 79 M weights takes ~6 s on 8
  cores."""
  shape = tuple(shape)
  n = math.prod(shape)
  if keys_.dim() != 1 or n <= _CHUNK:
    return from_bits(bits(keys_, shape))
  out = torch.empty((n,), dtype=torch.float32)

  def fill(start):
    torch.set_num_threads(1)
    b1, b2 = _hash_counts(keys_, (min(_CHUNK, n - start),), start)
    out[start:start + b1.shape[0]] = from_bits(b1 ^ b2)

  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  try:
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
      list(pool.map(fill, range(0, n, _CHUNK)))
  finally:
    torch.set_num_threads(threads)
  return out.reshape(shape)


def _f32(v):
  return torch.as_tensor(v, dtype=torch.float32)


def fma32(a, b, c) -> torch.Tensor:
  """float32 a * b + c rounded once. XLA's CPU backend contracts a float32
  multiply and add into a fused multiply-add, so the JAX package's draws
  round once where torch's a * b + c rounds twice. The product is exact in
  float64; the sum is rounded to odd there (TwoSum gives its error, and an
  inexact even result steps one ulp toward it), after which one rounding
  to float32 is the correctly rounded fused result. Rounding to odd moves
  the result only where the float64 sum sits on a float32 tie (or in
  float32's subnormal range), so only those elements take that path."""
  a, b, c = (_f32(v).double() for v in (a, b, c))
  s = a * b + c
  out = s.float()
  word = s.view(torch.int64)
  slow = ((word & 0x1FFFFFFF) == 0x10000000) | (s.abs() < 2.0 ** -126)
  if bool(slow.any()):
    a, b, c = (v.expand(s.shape)[slow] for v in (a, b, c))
    out[slow] = _fma32_to_odd(a, b, c)
  return out


def _fma32_to_odd(a, b, c) -> torch.Tensor:
  """fma32 of float64 tensors by rounding to odd everywhere."""
  p = a * b
  s = p + c
  bp = s - p
  err = (p - (s - bp)) + (c - bp)
  word = s.view(torch.int64)
  step = torch.where((err > 0) == (s > 0), 1, -1)
  word = torch.where((err != 0) & ((word & 1) == 0), word + step, word)
  return word.view(torch.float64).float()


def uniform(keys_, shape=(), minval=0.0, maxval=1.0) -> torch.Tensor:
  """jax.random.uniform in float32 (random.py:435-477): 23 mantissa bits
  under the exponent of 1.0, minus 1, scaled (one fused multiply-add, see
  fma32), then max(minval, .)."""
  return _by_chunks(keys_, shape,
                    lambda b: _uniform_from_bits(b, minval, maxval))


def _uniform_from_bits(b, minval, maxval) -> torch.Tensor:
  floats = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
  lo, hi = _f32(minval), _f32(maxval)
  return torch.maximum(lo, fma32(floats, hi - lo, lo))


def _mul32(a, m: int):
  """(a * m) mod 2**32 for int64 tensors a in [0, 2**32) and an int m in
  [0, 2**32), without int64 overflow."""
  lo = a * (m & 0xFFFF)
  hi = ((a * (m >> 16)) & 0xFFFF) << 16
  return (lo + hi) & MASK32


def randint(keys_, shape, minval: int, maxval: int) -> torch.Tensor:
  """jax.random.randint with dtype int32 (random.py:581-657): two bit
  draws from a split of each key, combined modulo the span through the
  `multiplier` = 2**32 mod span path in uint32 wraparound."""
  ks = split(keys_)
  higher = bits(ks[..., 0, :], shape)
  lower = bits(ks[..., 1, :], shape)
  span = (maxval - minval) & MASK32 if maxval > minval else 1
  multiplier = (1 << 16) % span
  multiplier = ((multiplier * multiplier) & MASK32) % span
  offset = (_mul32(higher % span, multiplier) + lower % span) & MASK32
  return (minval + offset % span).to(torch.int32)


def choice(keys_, n: int, shape=()) -> torch.Tensor:
  """jax.random.choice(key, n, shape) with replacement and no weights:
  randint(key, shape, 0, n) in the default int dtype, int32
  (random.py:780-800)."""
  return randint(keys_, shape, 0, n)


def erf_inv32(x) -> torch.Tensor:
  """XLA's single-precision erf_inv polynomial (see _ERFINV_*), in
  float32; +-inf at +-1 as XLA gives."""
  x = _f32(x)
  w = -torch.log1p(-x * x)
  lt = w < 5.0
  if bool(lt.all()):  # Every truncated normal and most normals.
    w = w - 2.5
    coefficients = [_f32(c) for c in _ERFINV_W_LT_5]
  else:
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coefficients = [torch.where(lt, _f32(c_lt), _f32(c_ge))
                    for c_lt, c_ge in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5)]
  p = coefficients[0]
  for c in coefficients[1:]:
    p = fma32(p, w, c)
  return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(keys_, shape=()) -> torch.Tensor:
  """jax.random.normal in float32 (random.py:867-872): a uniform on
  (nextafter(-1, 0), 1) through sqrt(2) * erf_inv."""
  return _by_chunks(keys_, shape, lambda b: _SQRT2 * erf_inv32(
      _uniform_from_bits(b, _NORMAL_LO, 1.0)))


def truncated_normal(keys_, shape=()) -> torch.Tensor:
  """jax.random.truncated_normal(key, -2, 2, shape) in float32
  (random.py:1005-1025), the draw under flax's lecun_normal."""
  lo = float(np.nextafter(np.float32(-2.0), np.float32(np.inf)))
  hi = float(np.nextafter(np.float32(2.0), np.float32(-np.inf)))
  return _by_chunks(keys_, shape, lambda b: torch.clamp(_SQRT2 * erf_inv32(
      _uniform_from_bits(b, _ERF_MINUS_SQRT2, _ERF_SQRT2)), lo, hi))


def loggamma(keys_, alpha: float) -> torch.Tensor:
  """jax.random.loggamma(key, alpha) of shape () for each key of a batch
  (..., 2), float32: Marsaglia-Tsang with log-space boost
  (random.py:1298-1374). Each element runs its own rejection loops; the
  sample's key is split(key, 1)[0] as _gamma_impl makes it
  (random.py:1398-1413). Rejection steps repeat only for the elements that
  still reject, and the boost's key is drawn whatever alpha is."""
  lead = keys_.shape[:-1]
  k = split(keys_.reshape(-1, 2), 1)[:, 0]
  n = k.shape[0]
  alpha_orig = _f32(alpha)
  boost_mask = bool(alpha_orig >= 1.0)
  a = alpha_orig if boost_mask else alpha_orig + 1.0
  one_third = _f32(1.0 / 3.0)
  d = a - one_third
  c = one_third / torch.sqrt(d)
  pair = split(k)
  k, subkey = pair[:, 0], pair[:, 1]
  big_x = torch.zeros((n,), dtype=torch.float32)
  big_v = torch.ones((n,), dtype=torch.float32)
  big_u = torch.full((n,), 2.0, dtype=torch.float32)

  def rejects(x2, v3, u):
    return (u >= 1.0 - _f32(0.0331) * (x2 * x2)) & (
        torch.log(u) >= x2 * 0.5 + d * ((1.0 - v3) + torch.log(v3)))

  todo = torch.arange(n)
  while todo.numel():
    three = split(k[todo], 3)
    k[todo] = three[:, 0]
    x_key, u_key = three[:, 1], three[:, 2]
    x = torch.zeros((todo.numel(),), dtype=torch.float32)
    v = torch.full((todo.numel(),), -1.0, dtype=torch.float32)
    inner = torch.arange(todo.numel())
    while inner.numel():
      pair = split(x_key[inner])
      x_key[inner] = pair[:, 0]
      xi = normal(pair[:, 1])
      x[inner] = xi
      v[inner] = 1.0 + xi * c
      inner = inner[v[inner] <= 0.0]
    big_x[todo] = x * x
    big_v[todo] = (v * v) * v
    big_u[todo] = uniform(u_key)
    todo = todo[rejects(big_x[todo], big_v[todo], big_u[todo])]
  log_boost = torch.zeros((n,), dtype=torch.float32)
  if not boost_mask:
    log_samples = torch.log1p(-uniform(subkey))
    log_boost = torch.where(log_samples == 0.0, log_boost,
                            log_samples * (1.0 / alpha_orig))
  return (torch.log(d) + torch.log(big_v) + log_boost).reshape(lead)


def beta(keys_, a: float, b: float) -> torch.Tensor:
  """jax.random.beta(key, a, b) of shape () for each key (...,2), float32
  (random.py:1133-1153): the ratio of two log-gamma draws."""
  ks = split(keys_)
  log_a = loggamma(ks[..., 0, :], a)
  log_b = loggamma(ks[..., 1, :], b)
  log_max = torch.maximum(log_a, log_b)
  ga = torch.exp(log_a - log_max)
  gb = torch.exp(log_b - log_max)
  return ga / (ga + gb)
