"""Spherical-Earth offset -> lat/lng (reference utils/spherical_geometry.py:44-76)."""

import math

import torch

from portbench.reference.sim import pmath

EARTH_RADIUS_M = 6371.0 * 1000.0


def relative_distance(x_m, y_m):
  return torch.sqrt(x_m * x_m + y_m * y_m)


def latlng_from_offset(center_lat_rad, center_lng_rad, x_m, y_m):
  """Great-circle translation of (center lat, lng) by a local (x east,
  y north) offset in meters. Returns (lat_rad, lng_rad), lat clamped to
  +-pi/2 and lng wrapped to (-pi, pi]."""
  heading = pmath.atan2(x_m, y_m)  # 0 = North, increases East.
  angle = relative_distance(x_m, y_m) / EARTH_RADIUS_M

  cos_angle = torch.cos(angle)
  sin_angle = torch.sin(angle)
  sin_from_lat = torch.sin(center_lat_rad)
  cos_from_lat = torch.cos(center_lat_rad)

  sin_lat = cos_angle * sin_from_lat + sin_angle * cos_from_lat * torch.cos(
      heading)
  d_lng = pmath.atan2(sin_angle * cos_from_lat * torch.sin(heading),
                      cos_angle - sin_from_lat * sin_lat)

  new_lat = pmath.asin(torch.clamp(sin_lat, -1.0, 1.0))
  new_lat = torch.clamp(new_lat, -math.pi / 2.0, math.pi / 2.0)
  new_lng = center_lng_rad + d_lng
  new_lng = new_lng - torch.floor(
      (new_lng + math.pi) / (2.0 * math.pi)) * (2.0 * math.pi)
  return new_lat, new_lng
