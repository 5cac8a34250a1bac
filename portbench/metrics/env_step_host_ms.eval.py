"""Mean host milliseconds of one env.step_batched call in the eval
window: what the host spends dispatching the batched env step."""


def read(ctx):
  spans = ctx.get('window_spans', {}).get('env_step')
  if ctx['kind'] != 'eval' or not spans:
    return None
  return 1e3 * sum(spans) / len(spans)
