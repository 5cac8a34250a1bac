"""Mean host milliseconds of one env.step_batched call in the training
window: what the host spends dispatching the batched env step."""


def read(ctx):
  spans = ctx.get('window_spans', {}).get('env_step')
  if ctx['kind'] != 'train' or not spans:
    return None
  return 1e3 * sum(spans) / len(spans)
