"""Absolute time as int32 unix seconds (reference env/balloon/solar.py:66-79).

Calendar quantities come from Howard Hinnant's civil_from_days with
integer floor division (`//`, which rounds toward -inf for torch integer
tensors, as the JAX package's int32 `//` does).
"""

import datetime as dt

import torch


def unix_seconds_from_datetime(d: dt.datetime) -> int:
  if d.tzinfo is None:
    d = d.replace(tzinfo=dt.timezone.utc)
  return int(d.timestamp())


def datetime_from_unix_seconds(s: int) -> dt.datetime:
  """The UTC datetime of integer unix seconds (the inverse of
  unix_seconds_from_datetime)."""
  return dt.datetime.fromtimestamp(int(s), tz=dt.timezone.utc)


def civil_from_unix_seconds(time_s):
  """(year, month, day, second_of_day) int32 tensors from unix seconds."""
  time_s = time_s.to(torch.int32)
  days = time_s // 86400
  second_of_day = time_s - days * 86400

  z = days + 719468
  era = torch.where(z >= 0, z, z - 146096) // 146097
  doe = z - era * 146097  # [0, 146096]
  yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
  y = yoe + era * 400
  doy = doe - (365 * yoe + yoe // 4 - yoe // 100)  # [0, 365]
  mp = (5 * doy + 2) // 153  # [0, 11]
  day = doy - (153 * mp + 2) // 5 + 1  # [1, 31]
  month = torch.where(mp < 10, mp + 3, mp - 9)  # [1, 12]
  year = torch.where(month <= 2, y + 1, y)
  return year, month, day, second_of_day


def days_from_j2000(time_s):
  """(julian days since J2000, fraction of the UTC day), both float32.

  The integer julian-day-number terms are combined before the J2000
  offset is subtracted, so float32 only sees O(5000-day) magnitudes.
  """
  year, month, day, second_of_day = civil_from_unix_seconds(time_s)
  yf = year.to(torch.float32)
  mf = month.to(torch.float32)

  t1 = 367.0 * yf
  t2 = torch.floor(7.0 * (yf + torch.floor((mf + 9.0) / 12.0)) / 4.0)
  t3 = torch.floor(3.0 * (torch.floor((yf + (mf - 9.0) / 7.0) / 100.0) + 1.0)
                   / 4.0)
  t4 = torch.floor(275.0 * mf / 9.0)
  int_part = t1 - t2 - t3 + t4 + day.to(torch.float32)
  fraction_of_day = second_of_day.to(torch.float32) / 86400.0
  jd_minus_j2000 = (int_part - 730516.5) + fraction_of_day
  return jd_minus_j2000, fraction_of_day
