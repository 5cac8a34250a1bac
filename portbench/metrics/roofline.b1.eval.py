"""B1's share of its roofline in the eval's traced steps: the least time
its counted work needs (workcount.b1_bound_s, E envs x 18 substeps) over
its device time, in %."""

from portbench import workcount


def read(ctx):
  tr = ctx.get('trace')
  if ctx['kind'] != 'eval' or tr is None or tr['lost']:
    return None
  count, seconds = tr['kernels']['b1']
  if not count or seconds <= 0:
    return None
  return 100.0 * count * workcount.b1_bound_s(ctx['envs']) / seconds
