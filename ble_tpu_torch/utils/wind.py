"""Wind utilities (the port of ble_tpu/utils/wind.py; reference
utils/wind.py:24-71).

`is_station_keeping_winds` decides whether a wind column permits station
keeping: the reference tests whether the origin lies inside the convex
hull of the (u, v) wind vectors with scipy.spatial.ConvexHull. With
nonzero winds that is the largest angular gap between wind directions
being less than pi, which works over a leading batch axis.
"""

import math

import torch


def is_station_keeping_winds(u: torch.Tensor, v: torch.Tensor,
                             magnitude_threshold: float = 1e-6
                             ) -> torch.Tensor:
  """True where winds at some altitudes can cancel winds at others.

  Args:
    u, v: (..., N) wind components across a column of altitudes.

  Returns:
    (...) bool: the origin inside the convex hull of the wind vectors.
  """
  angles = torch.atan2(v, u)  # (..., N) in (-pi, pi].
  magnitude_ok = torch.sqrt(u * u + v * v) > magnitude_threshold
  # Negligible winds become NaN, which sorts last, so they close no gap.
  angles = torch.where(magnitude_ok, angles, math.nan)
  sorted_angles = torch.sort(angles, dim=-1).values
  n_valid = magnitude_ok.sum(dim=-1)

  nan = torch.isnan(sorted_angles)
  wrapped = torch.where(nan, sorted_angles[..., :1], sorted_angles)
  gaps = torch.diff(wrapped, dim=-1)
  gaps = torch.where(torch.isnan(gaps) | (gaps < 0), 0.0, gaps)
  first = torch.where(nan[..., 0], 0.0, sorted_angles[..., 0])
  # The gap that wraps from the largest valid angle back to the first.
  max_valid = torch.where(nan, -math.inf, sorted_angles).amax(dim=-1)
  wrap_gap = 2 * math.pi - (max_valid - first)
  max_gap = torch.maximum(gaps.amax(dim=-1), wrap_gap)
  return (n_valid >= 3) & (max_gap < math.pi)


def mean_wind_speed(field: torch.Tensor) -> torch.Tensor:
  """Mean wind speed over a (..., 21, 21, 10, 9, 2) grid (reference
  utils/wind.py:44-71)."""
  return torch.sqrt((field ** 2).sum(dim=-1)).mean(dim=(-1, -2, -3, -4))
