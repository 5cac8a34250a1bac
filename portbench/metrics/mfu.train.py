"""The training window's counted network work over its time, as a share
of the card's fp32 peak, in %: each train step's online forward and
backward and target forward over the batch, and the actor's forward over
every env an env step."""

from portbench import workcount


def read(ctx):
  if (ctx['kind'] != 'train' or ctx.get('device') != 'cuda' or
      not ctx.get('window_s')):
    return None
  forward = workcount.mlp_forward_flops(ctx['widths'])
  flops = (ctx['grad_steps'] *
           workcount.qrdqn_grad_step_flops(ctx['widths'], ctx['batch']) +
           ctx['steps'] * ctx['envs'] * forward)
  return 100.0 * flops / ctx['window_s'] / workcount.peaks()[
      'fp32_flops_per_s']
