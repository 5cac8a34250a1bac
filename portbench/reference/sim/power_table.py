"""(pressure_ratio, state_of_charge) -> ACS power budget (reference
env/balloon/power_table.py:21-38; the port of ble_tpu/env/power_table.py)."""

import math

import torch

PR_INTERVALS = (1.08, 1.11, 1.14, 1.17, 1.2, 1.23, 1.26)
# One row per pressure-ratio interval; soc thresholds padded with +inf and
# values padded by repeating the last entry so the lookup is rectangular.
SOC_THRESHOLDS = (
    (0.3, 0.4, 0.5),
    (0.3, 0.4, 0.7),
    (0.3, 0.4, 0.6),
    (0.3, 0.4, 0.5),
    (0.3, 0.4, 0.5),
    (0.4, 0.5, math.inf),
    (0.5, 0.6, math.inf),
    (0.5, 0.6, math.inf),
)
POWER_VALUES = (
    (0.0, 150.0, 175.0, 200.0),
    (0.0, 200.0, 200.0, 225.0),
    (0.0, 225.0, 225.0, 250.0),
    (0.0, 200.0, 225.0, 250.0),
    (0.0, 225.0, 250.0, 275.0),
    (0.0, 275.0, 300.0, 300.0),
    (0.0, 300.0, 325.0, 325.0),
    (0.0, 325.0, 350.0, 350.0),
)


def lookup(pressure_ratio, state_of_charge):
  """Power [W] the flight controller would budget for descending."""
  dev = pressure_ratio.device
  f32 = dict(dtype=torch.float32, device=dev)
  intervals = torch.tensor(PR_INTERVALS, **f32)
  pr_id = torch.searchsorted(intervals, pressure_ratio.contiguous(),
                             right=True)
  thresholds = torch.tensor(SOC_THRESHOLDS, **f32)[pr_id]
  soc_id = (state_of_charge[..., None] >= thresholds).sum(dim=-1)
  values = torch.tensor(POWER_VALUES, **f32)[pr_id]
  return torch.gather(values, -1, soc_id[..., None])[..., 0]
