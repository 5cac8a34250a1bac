"""The eval window's counted float work over its time, as a share of the
card's fp32 peak (TF32 is off in the port), in %: B2's observe and
query a step, and for a network policy its forward over every env."""

from portbench import workcount


def read(ctx):
  if (ctx['kind'] != 'eval' or ctx.get('device') != 'cuda' or
      not ctx.get('window_s')):
    return None
  per_step = workcount.b2_flops(ctx['envs'])
  if ctx['policy'] == 'qrdqn':
    per_step += ctx['envs'] * workcount.mlp_forward_flops(ctx['widths'])
  flops = per_step * ctx['steps']
  return 100.0 * flops / ctx['window_s'] / workcount.peaks()[
      'fp32_flops_per_s']
