"""Kernel launches the host makes inside learner.learn in the traced env
step, a train step: the dispatch a CUDA graph of the learner would
remove."""


def read(ctx):
  tr = ctx.get('trace')
  if ctx['kind'] != 'train' or tr is None or tr['lost']:
    return None
  launches, calls = tr['launches_in'].get('learn'), tr['span_calls'].get(
      'learn')
  if not launches or not calls:
    return None
  return launches / (calls * tr['grad_steps'])
