"""Configuration: dataclass configs and `key=value` overrides (the port of
ble_tpu/config.py, which replaces the reference's gin-config layer).

Every component takes a frozen dataclass config; CLIs accept repeated
`--set path.to.field=value` overrides applied with `apply_overrides`.
"""

import dataclasses
from typing import Any, Sequence


def _convert(value: str, current: Any):
  if isinstance(current, bool):
    return value.lower() in ('1', 'true', 'yes')
  if isinstance(current, int):
    return int(value)
  if isinstance(current, float):
    return float(value)
  return value


def apply_overrides(config: Any, overrides: Sequence[str]) -> Any:
  """Applies `a.b.c=value` overrides to a (nested) frozen dataclass."""
  for override in overrides:
    if '=' not in override:
      raise ValueError(f'Override must look like path=value: {override!r}')
    path, value = override.split('=', 1)
    config = _set_nested(config, path.split('.'), value)
  return config


def _set_nested(config: Any, keys: Sequence[str], value: str) -> Any:
  key = keys[0]
  if not hasattr(config, key):
    raise ValueError(f'{type(config).__name__} has no field {key!r}')
  current = getattr(config, key)
  if len(keys) == 1:
    new_value = _convert(value, current)
  else:
    new_value = _set_nested(current, keys[1:], value)
  return dataclasses.replace(config, **{key: new_value})
