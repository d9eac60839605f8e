"""Host milliseconds a train step spends in its updates, from inside the
program: over the spans of `se3ds_torch.tracing` whose last part is
`clip`, `adam` or `ema` (`train.step.g_d.adam`, ...; each runs once a
step where two chunks make a step), the sum of each name's median host
duration. The warm-up and traced steps in the same rings are fewer than
the window's, so the medians are the window's. None where the program
keeps no such span."""

import statistics

PARTS = ('clip', 'adam', 'ema')


def read(record):
  try:
    from se3ds_torch import tracing
  except ImportError:
    return None
  spans = tracing.snapshot()['spans']
  parts = [s['host_ms'] for name, s in spans.items()
           if name.startswith('train.step.') and name.rsplit('.', 1)[1]
           in PARTS]
  if not parts:
    return None
  return sum(statistics.median(ms) for ms in parts)
