"""Mean host milliseconds of one replay.sample_sequence call in the
training window, a train step: the sequence sample's draws and its
strided gather of the windows."""


def read(ctx):
  spans = ctx.get('window_spans', {}).get('seq_sample')
  if ctx['kind'] != 'train' or not spans:
    return None
  return 1e3 * sum(spans) / len(spans)
