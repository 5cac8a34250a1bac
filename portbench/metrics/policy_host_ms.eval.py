"""Mean host milliseconds of one policy step in the eval window
(StationSeeker's scores, or the QR-DQN network's greedy action)."""


def read(ctx):
  spans = ctx.get('window_spans', {}).get('policy')
  if ctx['kind'] != 'eval' or not spans:
    return None
  return 1e3 * sum(spans) / len(spans)
