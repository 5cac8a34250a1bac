"""The training window's counted network work over its time, as a share
of the card's fp32 peak, in %: each train step's work and the actor's
work of one row over every env an env step, as the policy's module counts
them (policies/<policy>.py: work, in ctx['work'])."""

from portbench import workcount


def read(ctx):
  if (ctx['kind'] != 'train' or ctx.get('device') != 'cuda' or
      not ctx.get('window_s')):
    return None
  work = ctx['work']
  flops = (ctx['grad_steps'] * work['train_step'] +
           ctx['steps'] * ctx['envs'] * work['actor_row'])
  return 100.0 * flops / ctx['window_s'] / workcount.peaks()[
      'fp32_flops_per_s']
