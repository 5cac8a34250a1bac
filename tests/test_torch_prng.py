"""The port's threefry streams (ble_tpu_torch/utils/prng.py) against
jax.random on the CPU: keys, split, fold_in and random bits, the integer
draws and uniforms bit for bit; normals within 4 float32 ulp; beta within
1e-6 absolute, with any gamma acceptance flip counted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ble_tpu_torch.utils import prng

# 64 seeds: 0, 1, 2**31 - 1 and 61 drawn with numpy.
SEEDS = [0, 1, 2**31 - 1] + np.random.RandomState(0).randint(
    0, 2**31 - 1, 61).tolist()
# Seeds past 32 bits, as the port's training worlds use (>= 2**40).
WIDE_SEEDS = [2**33 + 5, 2**40 + 7, (1 << 40) + (3 << 33) + 11, 2**63 - 1]


def _jkeys(seeds=SEEDS):
  return jnp.stack([jax.random.PRNGKey(s) for s in seeds])


def _ulps(a, b):
  a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
  b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
  return np.abs(a - b)


def test_jax_follows_the_partitionable_threefry():
  """The port reproduces partitionable threefry (split, random_bits); a
  JAX that turned it off would draw other streams."""
  assert jax.config.jax_threefry_partitionable is True
  assert jax.random.key_impl(jax.random.key(0)) == 'threefry2x32'


def test_keys_match_jax():
  """key(seed) equals PRNGKey(seed) for 32-bit seeds, and for wider seeds
  the [hi, lo] JAX builds for them under x64 (without x64 JAX keeps only
  the low 32 bits of a Python int seed)."""
  np.testing.assert_array_equal(prng.keys(SEEDS).numpy(),
                                np.asarray(_jkeys()).astype(np.int64))
  with jax.enable_x64(True):
    want = np.stack([np.asarray(jax.random.key_data(jax.random.PRNGKey(s)))
                     for s in WIDE_SEEDS]).astype(np.int64)
  np.testing.assert_array_equal(prng.keys(WIDE_SEEDS).numpy(), want)
  assert [(int(k[0]) << 32) | int(k[1])
          for k in prng.keys(WIDE_SEEDS)] == WIDE_SEEDS


SPLITS = [1, 2, 3, 7, 64]
FOLDS = [0, 1, 2, 12345, 2**32 - 1]
SHAPES = [(), (5,), (3, 4), (2, 5, 4)]
RANDINTS = [((), 0, 3), ((2, 5), 0, 2**31 - 1), ((7,), -5, 1000),
            ((), 3, 3)]
CHOICES = [3, 1634753849, 126057600]
UNIFORMS = [(0.0, 1.0), (-10.0, 10.0), (-175.0, 175.0), (6500.0, 11400.0),
            (0.0, 2.0 * np.pi)]
NORMALS = [(), (16,), (64,)]
BETAS = [(1.2, 2.0), (0.5, 3.0)]
# Bounds a key for the pressure draw, whose maximum is each env's own.
HI = np.random.RandomState(1).uniform(10000.0, 12000.0,
                                      len(SEEDS)).astype(np.float32)


def _draws(k, hi):
  """Every jax.random value these tests hold the port to, for one key."""
  r = jax.random
  return {
      'split': [r.split(k, n) for n in SPLITS],
      'fold_in': [r.fold_in(k, d) for d in FOLDS],
      'bits': [r.bits(k, shape) for shape in SHAPES],
      'randint': [r.randint(k, shape, lo, h, jnp.int32)
                  for shape, lo, h in RANDINTS],
      'choice': [r.choice(k, n) for n in CHOICES],
      'uniform': [r.uniform(k, (3, 7), minval=lo, maxval=h)
                  for lo, h in UNIFORMS],
      'uniform_hi': r.uniform(k, (), minval=6500.0, maxval=hi),
      'normal': [r.normal(k, shape) for shape in NORMALS],
      'truncated_normal': r.truncated_normal(k, -2.0, 2.0, (1000,)),
  }


@pytest.fixture(scope='module')
def want():
  """jax.random's draws for the 64 seeds' keys, one compiled program; and
  beta's over 256 keys."""
  out = jax.jit(jax.vmap(_draws))(_jkeys(), jnp.asarray(HI))
  beta_keys = jax.random.split(jax.random.PRNGKey(7), 256)
  out['beta_keys'] = beta_keys
  out['beta'] = [jax.jit(jax.vmap(lambda k: jax.random.beta(k, a, b)))(
      beta_keys) for a, b in BETAS]
  return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize('i', range(len(SPLITS)))
def test_split_matches_jax(want, i):
  num = SPLITS[i]
  got = prng.split(prng.keys(SEEDS), num).numpy()
  np.testing.assert_array_equal(got, want['split'][i].astype(np.int64))
  # A tail of the split is the same keys drawn alone.
  np.testing.assert_array_equal(prng.split(prng.keys(SEEDS), num, num // 2),
                                got[:, num // 2:])


@pytest.mark.parametrize('i', range(len(FOLDS)))
def test_fold_in_matches_jax(want, i):
  np.testing.assert_array_equal(
      prng.fold_in(prng.keys(SEEDS), FOLDS[i]).numpy(),
      want['fold_in'][i].astype(np.int64))


@pytest.mark.parametrize('i', range(len(SHAPES)))
def test_bits_match_jax(want, i):
  got = prng.bits(prng.keys(SEEDS), SHAPES[i]).numpy()
  assert got.shape == (len(SEEDS),) + SHAPES[i]
  np.testing.assert_array_equal(got, want['bits'][i].astype(np.int64))


@pytest.mark.parametrize('i', range(len(RANDINTS)))
def test_randint_matches_jax(want, i):
  shape, lo, hi = RANDINTS[i]
  got = prng.randint(prng.keys(SEEDS), shape, lo, hi)
  assert got.dtype == torch.int32
  np.testing.assert_array_equal(got.numpy(), want['randint'][i])


@pytest.mark.parametrize('i', range(len(CHOICES)))
def test_choice_matches_jax(want, i):
  """choice with replacement: the noise seeds' 1634753849, the start
  time's span of 4 years of seconds."""
  np.testing.assert_array_equal(
      prng.choice(prng.keys(SEEDS), CHOICES[i]).numpy(), want['choice'][i])


@pytest.mark.parametrize('i', range(len(UNIFORMS)))
def test_uniform_matches_jax_bit_for_bit(want, i):
  lo, hi = UNIFORMS[i]
  got = prng.uniform(prng.keys(SEEDS), (3, 7), lo, hi).numpy()
  np.testing.assert_array_equal(got.view(np.int32),
                                want['uniform'][i].view(np.int32))


def test_uniform_with_a_bound_per_key_matches_jax(want):
  """The pressure draw's maximum is each env's own (sampling.py)."""
  got = prng.uniform(prng.keys(SEEDS), (), 6500.0, torch.from_numpy(HI))
  np.testing.assert_array_equal(got.numpy(), want['uniform_hi'])


@pytest.mark.parametrize('i', range(len(NORMALS)))
def test_normal_within_4_ulp(want, i):
  """Within 4 float32 ulp of jax.random.normal: the draws' uniforms are
  equal and erf_inv is XLA's polynomial; what is left is log1p's."""
  got = prng.normal(prng.keys(SEEDS), NORMALS[i]).numpy()
  assert got.shape == want['normal'][i].shape and got.dtype == np.float32
  assert _ulps(got, want['normal'][i]).max() <= 4


def test_truncated_normal_within_4_ulp(want):
  """flax's lecun_normal draw: truncated at +-2, its erf bounds held to
  XLA's float32 erf, within 4 ulp of JAX over 64 x 1000 draws."""
  sqrt2 = np.float32(np.sqrt(2.0))
  for bound, const in ((-2.0, prng._ERF_MINUS_SQRT2),
                       (2.0, prng._ERF_SQRT2)):
    assert np.float32(const) == np.asarray(
        jax.lax.erf(jnp.float32(bound) / sqrt2))
  got = prng.truncated_normal(prng.keys(SEEDS), (1000,)).numpy()
  assert _ulps(got, want['truncated_normal']).max() <= 4
  assert got.min() > -2.0 and got.max() < 2.0


@pytest.mark.parametrize('i', range(len(BETAS)))
def test_beta_within_1e6(want, i):
  """beta(a, b) over 256 keys within 1e-6 absolute: (1.2, 2.0) is the
  initial offset's, (0.5, 3.0) takes the boost's log-space branch. A gamma
  acceptance test decided otherwise by an ulp would show as a draw far
  apart: such flips are counted and printed, and none occurs on these
  keys."""
  a, b = BETAS[i]
  got = prng.beta(torch.from_numpy(want['beta_keys'].astype(np.int64)), a,
                  b).numpy()
  err = np.abs(got - want['beta'][i])
  flips = int((err > 1e-4).sum())
  print(f'beta({a}, {b}): {flips} acceptance flips of 256, '
        f'max error elsewhere {err[err <= 1e-4].max():.3g}')
  assert flips == 0
  assert err.max() <= 1e-6


def test_fma32_rounds_once_at_float32_ties():
  """Where the float64 sum of a * b + c sits on a float32 tie, the fused
  result rounds by the exact value's side of it (the round-to-odd path):
  1 + 2**-24 + 2**-60 rounds up, 1 + 2**-24 - 2**-60 down; torch's
  unfused float32 a * b + c gives 1.0 for both."""
  a = torch.tensor([-2.0**-24 * (1 + 2.0**-18), 2.0**-24 * (1 + 2.0**-18)])
  b = torch.tensor([1 - 2.0**-18] * 2)
  c = torch.tensor([1 + 2.0**-23, 1.0])
  np.testing.assert_array_equal(prng.fma32(a, b, c).numpy(),
                                np.float32([1 + 2.0**-23, 1.0]))
  assert torch.equal(a * b + c, torch.ones(2))


def test_large_draws_by_chunks_equal_one_pass(monkeypatch):
  """A draw larger than prng._CHUNK from one key is computed in chunks of
  counts; it equals the same draw in one pass, bit for bit."""
  key = prng.key(7)
  shape = (3, 1000)
  chunked = {}
  monkeypatch.setattr(prng, '_CHUNK', 512)
  for name in ('uniform', 'normal', 'truncated_normal'):
    chunked[name] = getattr(prng, name)(key, shape)
  monkeypatch.setattr(prng, '_CHUNK', 1 << 20)
  for name, got in chunked.items():
    assert got.shape == shape
    assert torch.equal(got, getattr(prng, name)(key, shape)), name
