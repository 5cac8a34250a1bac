"""The share of the eval's time in which no operation runs on the
device, in %: the traced steps' device busy time a step (unaffected by
the profiler's host overhead) against the untraced window's wall time a
step."""


def read(ctx):
  tr = ctx.get('trace')
  if ctx['kind'] != 'eval' or tr is None or tr['lost'] or not ctx['steps']:
    return None
  busy = tr['busy_s'] / tr['steps']
  return 100.0 * (1.0 - busy / (ctx['window_s'] / ctx['steps']))
