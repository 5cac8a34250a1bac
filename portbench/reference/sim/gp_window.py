"""Fused K-step GP observe + 181-level query, plain: `window_plain`
runs K steps of (observe, query) on any device; `step` is the K = 1 entry
the env step uses. The reference of the port's GP window kernel.
"""

import torch

from portbench.reference.sim import wind_gp

CAP = wind_gp.CAPACITY
NUM_LEVELS = 181
PRES_MIN = 5000.0
PRES_MAX = 14000.0
_LS = wind_gp.LENGTH_SCALES


def pressure_levels(device=None):
  """The 181 query pressures (features.PRESSURE_LEVELS)."""
  return torch.linspace(PRES_MIN, PRES_MAX, NUM_LEVELS, dtype=torch.float32,
                        device=device)


def pack_obs(x_m, y_m, pressure_pa, elapsed_s, error_u, error_v, enabled):
  """(E, 8) [x, y, p, t, err_u, err_v, enabled, 0] float32 rows."""
  cols = [x_m, y_m, pressure_pa, elapsed_s, error_u, error_v, enabled]
  cols = [c.to(torch.float32) for c in cols]
  return torch.stack(cols + [torch.zeros_like(cols[0])], dim=-1)


def _first_index(mask, iota_f):
  """Float index of the first True of each row, CAP where there is none."""
  return torch.where(mask, iota_f, float(CAP)).min(dim=-1).values


def _observe_core(x, y, p, t, enabled, loc_in, active, kinv, count,
                  n_slices=1):
  """Every env's bordered-inverse update (pallas_gp_window._observe_core):
  the clamped Gram-chain pivots from the 4x4 U^T kinv U, applied as one
  rank-8 update. With `n_slices` > 1, U^T kinv U is summed from the
  partials of that many contiguous row slices in slice order, as the
  cluster observe (csrc/gp_observe.cu) sums its CTAs'. Returns (locations,
  active_final, kinv_new, slot mask, count_new)."""
  n = x.shape[0]
  dev = x.device
  iota = torch.arange(CAP, device=dev)
  iota_f = iota.to(torch.float32)

  stale = (active > 0.5) & ((t[:, None] - loc_in[..., 3]) >=
                            wind_gp.TIME_HORIZON_S)
  e1 = (iota_f == _first_index(stale, iota_f)[:, None]).to(torch.float32)
  stale2 = stale & (e1 < 0.5)
  e2 = (iota_f == _first_index(stale2, iota_f)[:, None]).to(torch.float32)

  slot = (count % CAP).to(torch.int64)
  slot_e = (iota == slot[:, None]).to(torch.float32)
  zero = torch.zeros_like(slot_e)
  removed12 = (e1 > 0.5) | (e2 > 0.5)
  active_after_rm = torch.where(removed12, zero, active)
  slot_active = (slot_e * active_after_rm).sum(dim=-1) > 0.5
  eo = torch.where(slot_active[:, None], slot_e, zero)
  active_pre_insert = torch.where(eo > 0.5, zero, active_after_rm)
  active_final = torch.maximum(active_pre_insert, slot_e)

  sm = slot_e[..., None]
  new_row = torch.stack([x, y, p, t], dim=-1)[:, None, :]
  locations = torch.where(sm > 0.5, new_row, loc_in)

  lsx, lsy, lsp, lst = _LS
  dx = (x[:, None] - loc_in[..., 0]) / lsx
  dy = (y[:, None] - loc_in[..., 1]) / lsy
  dp = (p[:, None] - loc_in[..., 2]) / lsp
  dt = (t[:, None] - loc_in[..., 3]) / lst
  d = torch.sqrt(dx * dx + dy * dy + dp * dp + dt * dt + 1e-12)
  v = (wind_gp.SIGMA_EXP_SQUARED * torch.exp(-d)) * active_pre_insert

  d0 = wind_gp.SIGMA_EXP_SQUARED + wind_gp.SIGMA_NOISE_SQUARED

  u_mat = torch.stack([e1, e2, eo, v], dim=-1)  # (E, CAP, 4)
  m_mat = kinv @ u_mat  # (E, CAP, 4)
  rows = CAP // n_slices
  s_mat = None  # (E, 4, 4)
  for r0 in range(0, CAP, rows):
    part = u_mat[:, r0:r0 + rows].transpose(1, 2) @ m_mat[:, r0:r0 + rows]
    s_mat = part if s_mat is None else s_mat + part

  removing = [e1.sum(-1) > 0.5, e2.sum(-1) > 0.5, eo.sum(-1) > 0.5]
  d_min = 1.0 / d0
  tc = {}
  safe = []
  for j in range(3):
    dj = s_mat[:, j, j]
    for q in range(j):
      acc = 0
      for r in range(q):
        acc = acc + (tc[(r, q)] / safe[r]) * tc[(r, j)]
      tc[(q, j)] = s_mat[:, j, q] - acc
      dj = dj - tc[(q, j)] * tc[(q, j)] / safe[q]
    fallback = torch.where(removing[j], d_min, 1.0)
    safe.append(torch.where(torch.abs(dj) > d_min, dj, fallback))
  for q in range(3):
    acc = 0
    for r in range(q):
      acc = acc + (tc[(r, q)] / safe[r]) * tc[(r, 3)]
    tc[(q, 3)] = s_mat[:, 3, q] - acc
  acc = 0
  for q in range(3):
    acc = acc + tc[(q, 3)] * tc[(q, 3)] / safe[q]
  d_v = s_mat[:, 3, 3] - acc
  schur = torch.clamp_min(d0 - d_v, wind_gp.SIGMA_NOISE_SQUARED)

  w = []
  for j in range(4):
    wj = m_mat[..., j]
    for q in range(j):
      wj = wj - (tc[(q, j)] / safe[q])[:, None] * w[q]
    w.append(wj)
  yv = w[3] - slot_e

  w_mat = torch.stack([w[0], w[1], w[2], e1, e2, eo, yv, slot_e], dim=-1)
  ones = torch.ones((n,), device=dev)
  c_vec = torch.stack([-1.0 / safe[0], -1.0 / safe[1], -1.0 / safe[2], ones,
                       ones, ones, 1.0 / schur, -ones], dim=-1)  # (E, 8)
  kinv_new = kinv + (w_mat * c_vec[:, None, :]) @ w_mat.transpose(1, 2)
  count_new = torch.where(enabled, count + 1, count)
  return locations, active_final, kinv_new, sm, count_new


def observe_one(obs, loc_in, err_in, active, kinv, alpha_in, count,
                n_slices=1):
  """Every env's observe of one (E, 8) observation row
  (pallas_gp_observe._run_one): `_observe_core` (with `n_slices`), then the
  error-row insert, alpha = kinv' targets and the enabled select of
  pallas_gp_observe._finish. Returns the new (locations, errors, active as
  0/1 float32, kinv, alpha, count)."""
  x, y, p, t = obs[:, 0], obs[:, 1], obs[:, 2], obs[:, 3]
  eu, ev = obs[:, 4], obs[:, 5]
  enabled = obs[:, 6] > 0.5

  loc_mid, active_final, kinv_new, sm, count_new = _observe_core(
      x, y, p, t, enabled, loc_in, active, kinv, count, n_slices)

  err_new = torch.stack([eu, ev], dim=-1)[:, None, :]
  errors = torch.where(sm > 0.5, err_new, err_in)
  targets = errors * active_final[..., None]
  alpha = kinv_new @ targets

  en2 = enabled[:, None]
  en3 = enabled[:, None, None]
  return (torch.where(en3, loc_mid, loc_in), torch.where(en3, errors, err_in),
          torch.where(en2, active_final, active),
          torch.where(en3, kinv_new, kinv), torch.where(en3, alpha, alpha_in),
          count_new)


def _step_one(obs, loc_in, err_in, active, kinv, alpha_in, count, pres):
  """Every env, one step: observe, then query the updated state at the
  181 levels (pallas_gp_window._step_one). Returns the new state tensors
  and level (E, 181, 3) = [mean_u, mean_v, deviation]."""
  loc, err, act, kv, al, count_new = observe_one(obs, loc_in, err_in, active,
                                                 kinv, alpha_in, count)
  x, y, t = obs[:, 0], obs[:, 1], obs[:, 3]

  lsx, lsy, lsp, lst = _LS
  qdx = (x[:, None] - loc[..., 0]) / lsx
  qdy = (y[:, None] - loc[..., 1]) / lsy
  qdt = (t[:, None] - loc[..., 3]) / lst
  qc = (qdx * qdx + qdy * qdy + qdt * qdt + 1e-12)[..., None]  # (E, CAP, 1)
  any_valid = (act.amax(dim=-1) > 0.0).to(torch.float32)[:, None]

  qdp = (pres[None, None, :] - loc[..., 2:3]) / lsp  # (E, CAP, L)
  qd = torch.sqrt(qc + qdp * qdp)
  k_star = (wind_gp.SIGMA_EXP_SQUARED * torch.exp(-qd)) * act[..., None]
  means = k_star.transpose(1, 2) @ al  # (E, L, 2)
  vv = kv @ k_star  # (E, CAP, L)
  var = wind_gp.SIGMA_EXP_SQUARED - (k_star * vv).sum(dim=1)  # (E, L)
  dev = torch.clamp(var / wind_gp.SIGMA_EXP_SQUARED, 0.0, 1.0)
  level = torch.cat([means * any_valid[..., None],
                     (dev * any_valid)[..., None]], dim=-1)
  return loc, err, act, kv, al, count_new, level


def window_plain(state: wind_gp.WindGPState, obs_seq):
  """The plain version of the window kernel (any device)."""
  pres = pressure_levels(obs_seq.device)
  loc, err = state.locations, state.errors
  act = state.active.to(torch.float32)
  kinv, alpha, count = state.kinv, state.alpha, state.count
  levels = []
  for k in range(obs_seq.shape[0]):
    loc, err, act, kinv, alpha, count, level = _step_one(
        obs_seq[k], loc, err, act, kinv, alpha, count, pres)
    levels.append(level)
  new_state = wind_gp.WindGPState(locations=loc, errors=err,
                                  active=act > 0.5, kinv=kinv, alpha=alpha,
                                  count=count)
  return new_state, torch.stack(levels)


def window(state: wind_gp.WindGPState, obs_seq):
  """K steps of fused observe + query.

  Args:
    state: WindGPState, leaves leading with (E,).
    obs_seq: (K, E, 8) float32 [x, y, p, t, err_u, err_v, enabled, 0].

  Returns:
    (new_state, level (K, E, 181, 3) [mean_u, mean_v, deviation]).
  """
  return window_plain(state, obs_seq)


def step(state: wind_gp.WindGPState, x_m, y_m, pressure_pa, elapsed_s,
         error_u, error_v, enabled):
  """K = 1: the env step's GP path. Returns (new_state, means
  (E, 181, 2), deviations (E, 181))."""
  obs = pack_obs(x_m, y_m, pressure_pa, elapsed_s, error_u, error_v, enabled)
  new_state, level = window(state, obs[None])
  return new_state, level[0, :, :, 0:2], level[0, :, :, 2]
