"""Host milliseconds of one served call, from inside the program: the
median host duration of the serving API's entry span that the run
called most (`serve.step` on the trajectory, `serve.poses` on the
poses), over its ring in `se3ds_torch.tracing`. The span runs from the
call's entry to its return: the input upload, the replay's launch, the
outputs' clones. The set-up and traced calls in the same ring are a
handful against the window's, so the median is the window's. None where
the program keeps no such span."""

import statistics

ENTRY_SPANS = ('serve.call', 'serve.step', 'serve.trajectory', 'serve.poses')


def read(record):
  try:
    from se3ds_torch import tracing
  except ImportError:
    return None
  spans = tracing.snapshot()['spans']
  entries = [spans[name] for name in ENTRY_SPANS if name in spans]
  if not entries:
    return None
  return statistics.median(max(entries, key=lambda s: s['count'])['host_ms'])
