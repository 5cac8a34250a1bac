"""Altitude Control System lookup tables (reference env/balloon/acs.py;
the port of ble_tpu/env/acs.py). The 4x13 efficiency table is gathered by
cell index; csrc/physics.cu holds the same table in __constant__ memory."""

import torch

from portbench.reference.sim import constants

_PR_KNOTS = (1.0, 1.05, 1.2, 1.25, 1.35)
_POWER_KNOTS = (100.0, 100.0, 300.0, 400.0, 400.0)

# Rows: the 4 power levels (100..400 W), columns: the 13 pressure ratios
# (1.05..1.35), matching scipy interp2d's (y, x) z-layout (acs.py:31-41).
EFF_TABLE = (
    (0.4, 0.4, 0.3, 0.2, 0.2, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    (0.4, 0.3, 0.3, 0.30, 0.25, 0.23, 0.20, 0.15, 0.12, 0.10, 0.0, 0.0, 0.0),
    (0.0, 0.3, 0.25, 0.25, 0.25, 0.20, 0.20, 0.20, 0.2, 0.15, 0.13, 0.12,
     0.11),
    (0.0, 0.23, 0.23, 0.23, 0.23, 0.23, 0.20, 0.20, 0.20, 0.18, 0.16, 0.15,
     0.13),
)


def get_most_efficient_power(pressure_ratio):
  """Optimal ACS power [W]: piecewise-linear over the knot table."""
  pr = torch.clamp(pressure_ratio, _PR_KNOTS[0], _PR_KNOTS[-1])
  power = torch.full_like(pr, _POWER_KNOTS[0])
  for i in range(len(_PR_KNOTS) - 1):
    x0, x1 = _PR_KNOTS[i], _PR_KNOTS[i + 1]
    y0, y1 = _POWER_KNOTS[i], _POWER_KNOTS[i + 1]
    seg = y0 + (pr - x0) * ((y1 - y0) / (x1 - x0))
    power = torch.where(pr >= x0, seg, power)
  return torch.clamp_max(power, _POWER_KNOTS[-1])


def get_fan_efficiency(pressure_ratio, power_w):
  """Bilinear efficiency with edge-cell extrapolation."""
  pr, pw = pressure_ratio, power_w
  cj = torch.clamp(torch.floor((pr - 1.05) / 0.025), 0, 11)
  wj = (pr - (1.05 + cj * 0.025)) / 0.025
  ci = torch.clamp(torch.floor((pw - 100.0) / 100.0), 0, 2)
  wi = (pw - (100.0 + ci * 100.0)) / 100.0

  table = torch.tensor(EFF_TABLE, dtype=torch.float32, device=pr.device)
  ri = ci.to(torch.int64)
  cc = cj.to(torch.int64)
  z00 = table[ri, cc]
  z01 = table[ri, cc + 1]
  z10 = table[ri + 1, cc]
  z11 = table[ri + 1, cc + 1]
  return ((1 - wi) * ((1 - wj) * z00 + wj * z01) +
          wi * ((1 - wj) * z10 + wj * z11))


def get_mass_flow(power_w, efficiency):
  """Compressor mass flow [kg/s] (acs.py:67-68)."""
  return efficiency * power_w / constants.NUM_SECONDS_PER_HOUR
