"""Device milliseconds a train step spends in its updates, from inside
the program: the spans that `update_host_ms.train` reads, the sum of
each name's median device duration (its CUDA events: from the device
reaching the span's entry to its last operation, so the device's idle
while the host launches the updates counts). Against
`update_host_ms.train` it shows whether the host sets the pace there.
None where the program keeps no such span or no device time."""

import statistics

PARTS = ('clip', 'adam', 'ema')


def read(record):
  try:
    from se3ds_torch import tracing
  except ImportError:
    return None
  spans = tracing.snapshot()['spans']
  parts = [s['device_ms'] for name, s in spans.items()
           if name.startswith('train.step.') and name.rsplit('.', 1)[1]
           in PARTS]
  if not parts or not all(parts):
    return None
  return sum(statistics.median(ms) for ms in parts)
