"""B2's share of its roofline in the eval's traced steps: the least time
its counted work needs (workcount.b2_bound_s: the observe and the
181-level query with the symmetric quadratic form, one step a launch)
over its device time, in %."""

from portbench import workcount


def read(ctx):
  tr = ctx.get('trace')
  if ctx['kind'] != 'eval' or tr is None or tr['lost']:
    return None
  count, seconds = tr['kernels']['b2']
  if not count or seconds <= 0:
    return None
  return 100.0 * count * workcount.b2_bound_s(ctx['envs']) / seconds
