"""Host milliseconds of each served call of the trajectory window: the
wall time of the benchmark's span around `model(...)` alone (the input
upload, the replay's launch, the outputs' clone; the device is idle when
a call starts, so nothing in it waits for earlier work), averaged."""


def read(record):
  wall = record.spans.wall.get('call')
  if not wall:
    return None
  return 1e3 * sum(wall) / len(wall)
