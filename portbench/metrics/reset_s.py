"""Host seconds of the port's env.reset calls in set-up (after a
synchronise, so the device's share is in): the reset layer."""


def read(ctx):
  spans = ctx.get('setup_spans', {}).get('reset')
  return sum(spans) if spans else None
