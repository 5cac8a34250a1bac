"""Mean host milliseconds of one r2d2.sequence_loss call in the training
window, a train step: both networks' unrolls over the windows and the
quantile loss, before the backward."""


def read(ctx):
  spans = ctx.get('window_spans', {}).get('seq_loss')
  if ctx['kind'] != 'train' or not spans:
    return None
  return 1e3 * sum(spans) / len(spans)
