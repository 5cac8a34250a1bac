"""Host-side unit wrappers (the port's own copy of ble_tpu/utils/units.py;
reference utils/units.py:26-373).

On the device everything is raw SI floats (utils/constants.py gives the
conventions); these classes serve host-side code, notebooks and the
reference's API: `Distance`, `Velocity`, `Power` and `Energy` with the
same operator algebra (Power * timedelta -> Energy, and so on) and a
tz-aware `datetime` helper. Pure Python: no tensors.
"""

import datetime as dt
from typing import Union

Number = Union[int, float]


class Distance:
  """A distance, constructible from m/meters/km/kilometers/feet."""

  def __init__(self, *, m: Number = None, meters: Number = None,
               km: Number = None, kilometers: Number = None,
               feet: Number = None):
    values = [v for v in (m, meters, km, kilometers, feet) if v is not None]
    if len(values) != 1:
      raise ValueError('Specify exactly one distance unit.')
    if m is not None or meters is not None:
      self._meters = float(m if m is not None else meters)
    elif km is not None or kilometers is not None:
      self._meters = float(km if km is not None else kilometers) * 1000.0
    else:
      self._meters = float(feet) * 0.3048

  @property
  def meters(self) -> float:
    return self._meters

  m = meters

  @property
  def kilometers(self) -> float:
    return self._meters / 1000.0

  km = kilometers

  @property
  def feet(self) -> float:
    return self._meters / 0.3048

  def __add__(self, other: 'Distance') -> 'Distance':
    return Distance(m=self._meters + other.meters)

  def __sub__(self, other: 'Distance') -> 'Distance':
    return Distance(m=self._meters - other.meters)

  def __mul__(self, scalar: Number) -> 'Distance':
    return Distance(m=self._meters * scalar)

  __rmul__ = __mul__

  def __truediv__(self, other):
    if isinstance(other, Distance):
      return self._meters / other.meters
    if isinstance(other, dt.timedelta):
      return Velocity(mps=self._meters / other.total_seconds())
    return Distance(m=self._meters / other)

  def __neg__(self) -> 'Distance':
    return Distance(m=-self._meters)

  def __lt__(self, other):
    return self._meters < other.meters

  def __le__(self, other):
    return self._meters <= other.meters

  def __gt__(self, other):
    return self._meters > other.meters

  def __ge__(self, other):
    return self._meters >= other.meters

  def __eq__(self, other):
    return isinstance(other, Distance) and self._meters == other.meters

  def __hash__(self):
    return hash(('Distance', self._meters))

  def __repr__(self):
    return f'Distance({self._meters} m)'


class Velocity:
  """A velocity in meters/second."""

  def __init__(self, *, mps: Number = None,
               meters_per_second: Number = None, kmph: Number = None):
    values = [v for v in (mps, meters_per_second, kmph) if v is not None]
    if len(values) != 1:
      raise ValueError('Specify exactly one velocity unit.')
    if kmph is not None:
      self._mps = float(kmph) / 3.6
    else:
      self._mps = float(mps if mps is not None else meters_per_second)

  @property
  def meters_per_second(self) -> float:
    return self._mps

  mps = meters_per_second

  @property
  def kmph(self) -> float:
    return self._mps * 3.6

  def __add__(self, other: 'Velocity') -> 'Velocity':
    return Velocity(mps=self._mps + other.mps)

  def __sub__(self, other: 'Velocity') -> 'Velocity':
    return Velocity(mps=self._mps - other.mps)

  def __mul__(self, other):
    if isinstance(other, dt.timedelta):
      return Distance(m=self._mps * other.total_seconds())
    return Velocity(mps=self._mps * other)

  __rmul__ = __mul__

  def __eq__(self, other):
    return isinstance(other, Velocity) and self._mps == other.mps

  def __hash__(self):
    return hash(('Velocity', self._mps))

  def __repr__(self):
    return f'Velocity({self._mps} m/s)'


class Energy:
  """Stored energy in watt-hours/joules."""

  def __init__(self, *, watt_hours: Number = None, joules: Number = None):
    values = [v for v in (watt_hours, joules) if v is not None]
    if len(values) != 1:
      raise ValueError('Specify exactly one energy unit.')
    if watt_hours is not None:
      self._wh = float(watt_hours)
    else:
      self._wh = float(joules) / 3600.0

  @property
  def watt_hours(self) -> float:
    return self._wh

  @property
  def joules(self) -> float:
    return self._wh * 3600.0

  def __add__(self, other: 'Energy') -> 'Energy':
    return Energy(watt_hours=self._wh + other.watt_hours)

  def __sub__(self, other: 'Energy') -> 'Energy':
    return Energy(watt_hours=self._wh - other.watt_hours)

  def __mul__(self, scalar: Number) -> 'Energy':
    return Energy(watt_hours=self._wh * scalar)

  __rmul__ = __mul__

  def __truediv__(self, other):
    if isinstance(other, Energy):
      return self._wh / other.watt_hours
    if isinstance(other, dt.timedelta):
      return Power(watts=self.joules / other.total_seconds())
    return Energy(watt_hours=self._wh / other)

  def __lt__(self, other):
    return self._wh < other.watt_hours

  def __le__(self, other):
    return self._wh <= other.watt_hours

  def __gt__(self, other):
    return self._wh > other.watt_hours

  def __ge__(self, other):
    return self._wh >= other.watt_hours

  def __eq__(self, other):
    return isinstance(other, Energy) and self._wh == other.watt_hours

  def __hash__(self):
    return hash(('Energy', self._wh))

  def __repr__(self):
    return f'Energy({self._wh} Wh)'


class Power:
  """Power in watts; Power * timedelta -> Energy."""

  def __init__(self, *, watts: Number):
    self._watts = float(watts)

  @property
  def watts(self) -> float:
    return self._watts

  def __add__(self, other: 'Power') -> 'Power':
    return Power(watts=self._watts + other.watts)

  def __sub__(self, other: 'Power') -> 'Power':
    return Power(watts=self._watts - other.watts)

  def __mul__(self, other):
    if isinstance(other, dt.timedelta):
      return Energy(joules=self._watts * other.total_seconds())
    return Power(watts=self._watts * other)

  __rmul__ = __mul__

  def __truediv__(self, other):
    if isinstance(other, Power):
      return self._watts / other.watts
    return Power(watts=self._watts / other)

  def __lt__(self, other):
    return self._watts < other.watts

  def __gt__(self, other):
    return self._watts > other.watts

  def __eq__(self, other):
    return isinstance(other, Power) and self._watts == other.watts

  def __hash__(self):
    return hash(('Power', self._watts))

  def __repr__(self):
    return f'Power({self._watts} W)'


def relative_distance(x: Distance, y: Distance) -> Distance:
  return Distance(m=(x.meters ** 2 + y.meters ** 2) ** 0.5)


def datetime(*args, **kwargs) -> dt.datetime:
  """tz-aware (UTC) datetime constructor (reference utils/units.py)."""
  if 'tzinfo' not in kwargs:
    kwargs['tzinfo'] = dt.timezone.utc
  return dt.datetime(*args, **kwargs)


def timedelta_to_hours(delta: dt.timedelta) -> float:
  return delta.total_seconds() / 3600.0
