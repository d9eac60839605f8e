"""Device milliseconds of one served panorama, from inside the program:
the median device duration of the entry span that `api_host_ms.serve`
reads (its CUDA events, from the device reaching the call's entry to its
last operation, gaps inside the call included; the program times one
call in ten of a served trajectory), over the panoramas of a
call (the traffic's `poses_per_call`, else 1). The ring holds the whole
run's calls; its median is the window's. None where the program keeps
no such span or no device time."""

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
  device = max(entries, key=lambda s: s['count'])['device_ms']
  if not device:
    return None
  return (statistics.median(device)
          / record.cell.traffic.get('poses_per_call', 1))
