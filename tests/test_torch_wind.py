"""The PyTorch port's wind field and simplex noise against the JAX
package, on the CPU, for the bf16 and the float32 grid."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ble_tpu.env import simplex_noise as jax_noise
from ble_tpu.env import wind_field as jax_wind
from ble_tpu_torch import bridge
from ble_tpu_torch.env import simplex_noise
from ble_tpu_torch.env import wind_field

E = 8
# ble_tpu vs the reference wind column in float32: 2e-5 max
# (docs/benchmarks.md "Reference parity"); the port is held to the same.
_ATOL = 2e-5


def _field(dtype_name):
  rng = np.random.RandomState(0)
  grid = rng.normal(0.0, 10.0, (E,) + jax_wind.GRID_SHAPE).astype(np.float32)
  jdtype = jnp.float32 if dtype_name == 'f32' else jax_wind.FIELD_DTYPE
  jfield = jnp.asarray(grid).astype(jdtype)
  seeds = rng.randint(0, 2**31 - 1, (E, 2, 5)).astype(np.int32)
  offsets = rng.uniform(-1, 1, (E, 2, 5, 4)).astype(np.float32)
  jstate = jax_wind.WindFieldState(field=jfield, noise_seeds=jnp.asarray(seeds),
                                   noise_offsets=jnp.asarray(offsets))
  tstate = wind_field.WindFieldState(
      field=bridge.tensor_from_numpy(np.asarray(jfield)),
      noise_seeds=torch.from_numpy(seeds), noise_offsets=torch.from_numpy(
          offsets))
  return jstate, tstate


def _points(seed):
  """Balloon points inside and beyond the grid, times across the 48 h
  boomerang."""
  rng = np.random.RandomState(seed)
  x = rng.uniform(-600e3, 600e3, E).astype(np.float32)
  y = rng.uniform(-600e3, 600e3, E).astype(np.float32)
  p = rng.uniform(4000, 15000, E).astype(np.float32)
  t = rng.randint(0, 200 * 3600, E).astype(np.int32)
  return x, y, p, t


@pytest.mark.parametrize('grid', ['bf16', 'f32'])
def test_effective_column_and_forecast(grid):
  jstate, tstate = _field(grid)
  x, y, p, t = _points(1)
  want = jax.vmap(jax_wind.effective_column)(jstate, x, y,
                                             t.astype(np.float32))
  got = wind_field.effective_column(tstate, torch.from_numpy(x),
                                    torch.from_numpy(y), torch.from_numpy(t))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_ATOL)
  ju, jv = jax.vmap(jax_wind.get_forecast)(jstate, x, y, p,
                                           t.astype(np.float32))
  tu, tv = wind_field.get_forecast(tstate, *map(torch.from_numpy, (x, y, p, t)))
  np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=_ATOL)
  np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=_ATOL)


@pytest.mark.parametrize('grid', ['bf16', 'f32'])
def test_slab_cache_matches_jax(grid):
  jstate, tstate = _field(grid)
  x, y, p, t = _points(2)
  jslab = jax.vmap(jax_wind.refresh_slab)(jstate, x, y)
  tslab = wind_field.refresh_slab(tstate, torch.from_numpy(x),
                                  torch.from_numpy(y))
  # The slab is a gather: bit-identical to the grid's entries.
  np.testing.assert_array_equal(
      bridge.numpy_from_tensor(tslab.slab).astype(np.float32),
      np.asarray(jslab.slab).astype(np.float32))
  np.testing.assert_array_equal(tslab.slab_x0.numpy(),
                                np.asarray(jslab.slab_x0))
  np.testing.assert_array_equal(tslab.slab_y0.numpy(),
                                np.asarray(jslab.slab_y0))
  # Move the balloons up to ~1.5 cells, some past the window.
  rng = np.random.RandomState(3)
  x2 = (x + rng.uniform(-75e3, 75e3, E)).astype(np.float32)
  y2 = (y + rng.uniform(-75e3, 75e3, E)).astype(np.float32)
  want = jax.vmap(jax_wind.effective_column)(jslab, x2, y2,
                                             t.astype(np.float32))
  got = wind_field.effective_column(tslab, torch.from_numpy(x2),
                                    torch.from_numpy(y2), torch.from_numpy(t))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_ATOL)
  np.testing.assert_array_equal(
      wind_field.slab_oob(tslab, torch.from_numpy(x2),
                          torch.from_numpy(y2)).numpy(),
      np.asarray(jax.vmap(jax_wind.slab_oob)(jslab, x2, y2)))


def test_noise_matches_jax():
  jstate, tstate = _field('f32')
  x, y, p, t = _points(4)
  ju, jv = jax.vmap(jax_wind.get_noise)(jstate, x, y, p, t.astype(np.float32))
  tu, tv = wind_field.get_noise(tstate, *map(torch.from_numpy, (x, y, p, t)))
  # Noise of ~1 m/s from float32 sums taken in another order.
  np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-5)
  np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
  ju, jv = jax.vmap(jax_wind.get_ground_truth)(jstate, x, y, p,
                                               t.astype(np.float32))
  tu, tv = wind_field.get_ground_truth(tstate,
                                       *map(torch.from_numpy, (x, y, p, t)))
  np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=_ATOL + 1e-5)
  np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=_ATOL + 1e-5)


def test_simplex_hash_wraps_like_uint32():
  """Edge seeds and coordinates: the int64 emulation equals JAX's uint32
  arithmetic bit for bit."""
  seeds = np.asarray([0, 1, 2**31 - 1, -1, -2**31, 12345, 0x7FFF0000,
                      -987654321], np.int32)
  coords = np.asarray([0, -1, 2**31 - 1, -2**31, 77, -123456, 1 << 20,
                       -(1 << 24)], np.int32)
  ix, iy, iz, iw = np.meshgrid(coords, coords[::-1], coords[2:], coords[:3],
                               indexing='ij')
  for seed in seeds:
    want = jax_noise._hash_gradient_index(
        jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(iz), jnp.asarray(iw),
        jnp.int32(seed))
    got = simplex_noise.hash_gradient_index(
        torch.from_numpy(ix), torch.from_numpy(iy), torch.from_numpy(iz),
        torch.from_numpy(iw), torch.tensor(seed))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_static_field_and_boomerang():
  np.testing.assert_array_equal(wind_field.simple_static_field().numpy(),
                                np.asarray(jax_wind.simple_static_field()))
  t = np.arange(0, 300 * 3600, 1237, dtype=np.int32)
  np.testing.assert_array_equal(
      wind_field._boomerang_hours(torch.from_numpy(t)).numpy(),
      np.asarray(jax_wind._boomerang_hours(t.astype(np.float32))))


@pytest.mark.parametrize('exact_noise', [False, True])
@pytest.mark.parametrize('grid', ['bf16', 'f32'])
def test_make_state_matches_jax(grid, exact_noise):
  """make_state over 8 keys against ble_tpu's make_state of each key
  (jax.vmap on the fast path; the parity mode's noise reset runs on the
  host, one key a call): noise seeds, offsets and OpenSimplex tables
  equal in bits, the grid equal after the dtype cast, and no slab."""
  rng = np.random.RandomState(5)
  grid_np = rng.normal(0.0, 10.0, (E,) + jax_wind.GRID_SHAPE).astype(
      np.float32)
  jkeys = jnp.stack([jax.random.PRNGKey(100 + s) for s in range(E)])
  jdtype = jnp.float32 if grid == 'f32' else None
  make = functools.partial(jax_wind.make_state, exact_noise=exact_noise,
                           field_dtype=jdtype)
  if exact_noise:
    want = jax.tree.map(lambda *xs: np.stack(xs),
                        *(make(jnp.asarray(g), k)
                          for g, k in zip(grid_np, jkeys)))
  else:
    want = jax.vmap(make)(jnp.asarray(grid_np), jkeys)
  got = wind_field.make_state(
      torch.from_numpy(grid_np),
      torch.from_numpy(np.asarray(jkeys).astype(np.int64)), exact_noise,
      torch.float32 if grid == 'f32' else None)
  assert got.field.dtype == (torch.float32 if grid == 'f32' else
                             wind_field.FIELD_DTYPE)
  np.testing.assert_array_equal(
      bridge.numpy_from_tensor(got.field).astype(np.float32),
      np.asarray(want.field).astype(np.float32))
  np.testing.assert_array_equal(got.noise_seeds.numpy(),
                                np.asarray(want.noise_seeds))
  np.testing.assert_array_equal(
      got.noise_offsets.numpy().view(np.uint32),
      np.asarray(want.noise_offsets, np.float32).view(np.uint32))
  if exact_noise:
    np.testing.assert_array_equal(got.noise_perms.numpy(),
                                  np.asarray(want.noise_perms))
  else:
    assert got.noise_perms is None and want.noise_perms is None
  assert got.slab is None


def test_make_state_copies_a_shared_grid_to_each_env():
  grid = torch.from_numpy(np.random.RandomState(6).normal(
      0.0, 10.0, jax_wind.GRID_SHAPE).astype(np.float32))
  keys = torch.from_numpy(np.asarray(jnp.stack(
      [jax.random.PRNGKey(s) for s in range(3)])).astype(np.int64))
  state = wind_field.make_state(grid, keys)
  assert state.field.shape == (3,) + jax_wind.GRID_SHAPE
  assert torch.equal(state.field[2], grid.to(wind_field.FIELD_DTYPE))


@pytest.mark.parametrize('component', ['u', 'v'])
def test_harmonic_noise_matches_jax(component):
  """harmonic_noise at 1024 random points (each its own seeds and
  offsets) against jax.vmap of ble_tpu's, within test_noise_matches_jax's
  1e-5, and equal to uv_noise's component within the same."""
  n = 1024
  rng = np.random.RandomState(7)
  x, y = rng.uniform(-3000.0, 3000.0, (2, n)).astype(np.float32)
  p = rng.uniform(5000.0, 14000.0, n).astype(np.float32)
  t = rng.uniform(0.0, 240.0, n).astype(np.float32)
  seeds = rng.randint(0, 2**31 - 1, (n, 2, 5)).astype(np.int32)
  offsets = rng.uniform(-1.0, 1.0, (n, 2, 5, 4)).astype(np.float32)
  c = 'uv'.index(component)
  harmonics = (simplex_noise.U_HARMONICS, simplex_noise.V_HARMONICS)[c]
  assert harmonics == (jax_noise.U_HARMONICS, jax_noise.V_HARMONICS)[c]
  want = jax.vmap(lambda *a: jax_noise.harmonic_noise(*a, harmonics))(
      x, y, p, t, seeds[:, c], offsets[:, c])
  tx, ty, tp, tt = (torch.from_numpy(a) for a in (x, y, p, t))
  got = simplex_noise.harmonic_noise(tx, ty, tp, tt,
                                     torch.from_numpy(seeds[:, c]),
                                     torch.from_numpy(offsets[:, c]),
                                     harmonics)
  assert got.shape == (n,) and got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
  both = simplex_noise.uv_noise(tx, ty, tp, tt, torch.from_numpy(seeds),
                                torch.from_numpy(offsets))
  np.testing.assert_allclose(got.numpy(), both[c].numpy(), atol=1e-5)
  assert np.abs(np.asarray(want)).max() > 1.0
