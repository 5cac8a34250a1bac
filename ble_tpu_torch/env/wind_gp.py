"""Gaussian-process wind estimator with an incrementally updated inverse
(the port of ble_tpu/env/wind_gp.py; reference env/wind_gp.py:33-215).

Kernel: Matern nu=0.5, k(a, b) = sigma_f^2 exp(-||(a-b)/ls||) with
ls = (357 km, 357 km, 326 Pa, 34560 s), plus sigma_n^2 = 0.05 on the
diagonal. Inactive slots are identity rows with zero targets. Every state
leaf leads with the env axis.

`observe` and `query_column` choose their route by the tensors' device,
as the JAX functions choose theirs by backend: CUDA tensors go to the
kernels of ops/gp_observe.py and ops/gp_query.py, CPU tensors take the JAX
package's CPU route (the 9-d coordinate form of the observe, `query` for
the column). The batched env step uses the fused observe + query of
ops/gp_window.py instead. `refresh` is the exact inverse by Cholesky (a
library call, as in the JAX package, outside any kernel).
"""

import dataclasses

import torch

from ble_tpu_torch.utils import profiling

CAPACITY = 128
TIME_HORIZON_S = 6 * 3600
LENGTH_SCALES = (357000.0, 357000.0, 326.0, 34560.0)
SIGMA_EXP_SQUARED = 3.6 ** 2
SIGMA_NOISE_SQUARED = 0.05
# Exact-inverse refresh cadence (steps); bounds float32 drift.
REFRESH_PERIOD = 64


@dataclasses.dataclass
class WindGPState:
  locations: torch.Tensor  # (E, CAP, 4): x_m, y_m, pressure_pa, time_s.
  errors: torch.Tensor  # (E, CAP, 2): measured - forecast (u, v).
  active: torch.Tensor  # (E, CAP) bool.
  kinv: torch.Tensor  # (E, CAP, CAP) inverse of the masked kernel.
  alpha: torch.Tensor  # (E, CAP, 2) = kinv @ masked targets.
  count: torch.Tensor  # (E,) int32 observations ever written.


def init(n: int, device=None) -> WindGPState:
  f32 = dict(dtype=torch.float32, device=device)
  return WindGPState(
      locations=torch.zeros((n, CAPACITY, 4), **f32),
      errors=torch.zeros((n, CAPACITY, 2), **f32),
      active=torch.zeros((n, CAPACITY), dtype=torch.bool, device=device),
      kinv=torch.eye(CAPACITY, **f32).expand(n, CAPACITY, CAPACITY).clone(),
      alpha=torch.zeros((n, CAPACITY, 2), **f32),
      count=torch.zeros((n,), dtype=torch.int32, device=device))


def _length_scales(like):
  return torch.tensor(LENGTH_SCALES, dtype=torch.float32, device=like.device)


def kernel(a, b):
  """(..., N, 4) x (..., M, 4) -> (..., N, M)."""
  diff = (a[..., :, None, :] - b[..., None, :, :]) / _length_scales(a)
  d = torch.sqrt((diff * diff).sum(dim=-1) + 1e-12)
  return SIGMA_EXP_SQUARED * torch.exp(-d)


def _first_true(mask):
  """One-hot (float32) of the first True entry of each row; zero rows
  where there is none."""
  iota = torch.arange(mask.shape[-1], device=mask.device)
  first = torch.where(mask, iota, mask.shape[-1]).min(dim=-1).values
  return (iota == first[:, None]).to(torch.float32)


def observe(state: WindGPState, x_m, y_m, pressure_pa, elapsed_s,
            error_u, error_v, enabled=None) -> WindGPState:
  """Adds one (location, forecast-error) measurement per env and expires
  stale ones (wind_gp.observe, the 9-d coordinate form).

  All of a step's inverse modifications (<= 2 window expiries, ring-slot
  eviction, one insert) are clamped rank-1 updates whose vectors live in
  the span of B = [kinv U | U[:, :4]]; the sequence runs in those 9-d
  coordinates and is applied as one rank-8 update. `enabled` (E,) bool
  makes the call a no-op for envs where it is False.

  CUDA tensors go to the observe kernel (ops/gp_observe.py), which applies
  the same sequential updates directly to the inverse.
  """
  n = x_m.shape[0]
  if x_m.is_cuda:
    from ble_tpu_torch.ops import gp_observe
    from ble_tpu_torch.ops import gp_window
    if enabled is None:
      enabled = torch.ones((n,), dtype=torch.bool, device=x_m.device)
    return gp_observe.observe_kernel(state, gp_window.pack_obs(
        x_m, y_m, pressure_pa, elapsed_s, error_u, error_v, enabled))
  dev = x_m.device
  t = elapsed_s.to(torch.float32)
  loc = torch.stack([x_m, y_m, pressure_pa, t], dim=-1)  # (E, 4)
  err = torch.stack([error_u, error_v], dim=-1)  # (E, 2)
  kinv, active = state.kinv, state.active
  iota = torch.arange(CAPACITY, device=dev)

  stale = active & ((t[:, None] - state.locations[..., 3]) >= TIME_HORIZON_S)
  e1 = _first_true(stale)
  e2 = _first_true(stale & (e1 < 0.5))

  slot = (state.count % CAPACITY).to(torch.int64)
  slot_e = (iota == slot[:, None]).to(torch.float32)
  removed12 = (e1 > 0.5) | (e2 > 0.5)
  active_after_rm = active & ~removed12
  slot_active = torch.gather(active_after_rm, 1, slot[:, None])
  eo = torch.where(slot_active, slot_e, torch.zeros_like(slot_e))
  active_pre_insert = active_after_rm & (eo < 0.5)

  sm = slot_e[..., None] > 0.5
  locations = torch.where(sm, loc[:, None, :], state.locations)
  errors = torch.where(sm, err[:, None, :], state.errors)
  active_final = active_pre_insert | (slot_e > 0.5)
  targets = torch.where(active_final[..., None], errors,
                        torch.zeros_like(errors))

  v = torch.where(active_pre_insert,
                  kernel(loc[:, None, :], state.locations)[:, 0],
                  torch.zeros_like(slot_e))
  u_mat = torch.stack([e1, e2, eo, slot_e, v], dim=-1)  # (E, CAP, 5)

  m_mat = kinv @ u_mat  # (E, CAP, 5)
  s_mat = u_mat.transpose(1, 2) @ m_mat  # (E, 5, 5)
  t_mat = u_mat[..., :4].transpose(1, 2) @ u_mat  # (E, 4, 5)

  d0 = SIGMA_EXP_SQUARED + SIGMA_NOISE_SQUARED
  eye9 = torch.eye(9, dtype=torch.float32, device=dev)
  gs, cs = [], []

  def q_of(col):  # B^T U[:, col] in basis coordinates, (E, 9).
    return torch.cat([s_mat[:, :, col], t_mat[:, :, col]], dim=-1)

  def z_matvec(q):
    r = torch.zeros((n, 9), dtype=torch.float32, device=dev)
    for g, c in zip(gs, cs):
      r = r + c[:, None] * g * (g * q).sum(dim=-1, keepdim=True)
    return r

  def downdate(col_e, removing):
    q = q_of(col_e)
    g_col = eye9[col_e] + z_matvec(q)
    d = (q * g_col).sum(dim=-1)
    d_min = 1.0 / d0
    fallback = torch.where(removing, d_min, 1.0)
    safe_d = torch.where(torch.abs(d) > d_min, d, fallback)
    gs.append(torch.where(removing[:, None], g_col, torch.zeros_like(g_col)))
    cs.append(-1.0 / safe_d)
    gs.append(eye9[5 + col_e].expand(n, 9))
    cs.append(torch.ones((n,), device=dev))

  downdate(0, e1.sum(dim=-1) > 0)
  downdate(1, e2.sum(dim=-1) > 0)
  downdate(2, eo.sum(dim=-1) > 0)

  q_v = q_of(4)
  g_u = eye9[4] + z_matvec(q_v)
  schur = torch.clamp_min(d0 - (q_v * g_u).sum(dim=-1), SIGMA_NOISE_SQUARED)
  gs.append(g_u - eye9[8])
  cs.append(1.0 / schur)
  gs.append(eye9[8].expand(n, 9))
  cs.append(-torch.ones((n,), device=dev))

  g_mat = torch.stack(gs, dim=-1)  # (E, 9, 8)
  c_vec = torch.stack(cs, dim=-1)  # (E, 8)
  b_mat = torch.cat([m_mat, u_mat[..., :4]], dim=-1)  # (E, CAP, 9)
  w_mat = b_mat @ g_mat  # (E, CAP, 8)
  kinv_new = kinv + (w_mat * c_vec[:, None, :]) @ w_mat.transpose(1, 2)
  alpha = kinv_new @ targets

  new = WindGPState(locations=locations, errors=errors, active=active_final,
                    kinv=kinv_new, alpha=alpha, count=state.count + 1)
  if enabled is None:
    return new
  return select(enabled, new, state)


def select(cond, a: WindGPState, b: WindGPState) -> WindGPState:
  """Per-env choice between two GP states: a where cond (E,) else b."""
  def pick(x, y):
    return torch.where(cond.reshape((-1,) + (1,) * (x.ndim - 1)), x, y)
  return WindGPState(**{f.name: pick(getattr(a, f.name), getattr(b, f.name))
                        for f in dataclasses.fields(WindGPState)})


def exact_inverse(locations, active):
  """Exact masked-kernel inverse (identity rows on inactive slots)."""
  k = kernel(locations, locations)
  mask2 = active[..., :, None] & active[..., None, :]
  k = torch.where(mask2, k, torch.zeros_like(k))
  eye = torch.eye(CAPACITY, dtype=torch.float32, device=locations.device)
  diag = torch.where(active, SIGMA_NOISE_SQUARED, 1.0)
  k_diag = torch.diagonal(k, dim1=-2, dim2=-1)
  k = k * (1.0 - eye) + eye * (
      torch.where(active, k_diag, torch.zeros_like(k_diag)) + diag)[..., None]
  chol = torch.linalg.cholesky(k)
  return torch.cholesky_solve(eye.expand_as(k), chol)


def refresh(state: WindGPState) -> WindGPState:
  """Recomputes the inverse and alpha exactly."""
  with profiling.span('wind_gp.refresh'):
    kinv = exact_inverse(state.locations, state.active)
    targets = torch.where(state.active[..., None], state.errors,
                          torch.zeros_like(state.errors))
    return dataclasses.replace(state, kinv=kinv, alpha=kinv @ targets)


def query(state: WindGPState, query_locations):
  """GP posterior at (E, N, 4) query points -> (means (E, N, 2),
  deviations (E, N)); both zero for envs with no valid observation."""
  any_valid = state.active.any(dim=-1)
  k_star = kernel(query_locations, state.locations)  # (E, N, CAP)
  k_star = torch.where(state.active[:, None, :], k_star,
                       torch.zeros_like(k_star))
  means = k_star @ state.alpha
  v = k_star @ state.kinv
  var = SIGMA_EXP_SQUARED - (k_star * v).sum(dim=-1)
  deviations = torch.clamp(var / SIGMA_EXP_SQUARED, 0.0, 1.0)
  means = torch.where(any_valid[:, None, None], means,
                      torch.zeros_like(means))
  deviations = torch.where(any_valid[:, None], deviations,
                           torch.zeros_like(deviations))
  return means, deviations


def query_column(state: WindGPState, x_m, y_m, elapsed_s, pressures):
  """GP posterior at a pressure column (L,) sharing each env's (x, y, t);
  CUDA tensors go to the column-query kernel (ops/gp_query.py)."""
  if x_m.is_cuda:
    from ble_tpu_torch.ops import gp_query
    return gp_query.query_kernel(state, x_m, y_m, elapsed_s, pressures)
  n, levels = x_m.shape[0], pressures.shape[0]
  bc = lambda v: v.to(torch.float32)[:, None].expand(n, levels)
  queries = torch.stack([bc(x_m), bc(y_m), pressures.expand(n, levels),
                         bc(elapsed_s)], dim=-1)
  return query(state, queries)
