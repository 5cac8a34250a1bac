"""Host milliseconds of learner.learn an env step in the training window:
the replay samples, QR-DQN's train steps and Adam."""


def read(ctx):
  spans = ctx.get('window_spans', {}).get('learn')
  if ctx['kind'] != 'train' or not spans or not ctx.get('steps'):
    return None
  return 1e3 * sum(spans) / ctx['steps']
