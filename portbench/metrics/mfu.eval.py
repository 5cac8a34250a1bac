"""The eval window's counted float work over its time, as a share of the
card's fp32 peak (TF32 is off in the port), in %: B2's observe and
query a step, and the policy's work of one actor row over every env, as
its module counts it (policies/<policy>.py: work, in ctx['work']; none
for StationSeeker)."""

from portbench import workcount


def read(ctx):
  if (ctx['kind'] != 'eval' or ctx.get('device') != 'cuda' or
      not ctx.get('window_s')):
    return None
  per_step = workcount.b2_flops(ctx['envs'])
  per_step += ctx['envs'] * ctx['work']['actor_row']
  flops = per_step * ctx['steps']
  return 100.0 * flops / ctx['window_s'] / workcount.peaks()[
      'fp32_flops_per_s']
