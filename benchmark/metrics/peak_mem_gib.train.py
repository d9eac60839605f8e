"""The device memory the train step holds at its peak over the window:
`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats` at the
window's start, in GiB."""


def read(record):
  peak = record.spans.counters.get('peak_bytes')
  if not peak:
    return None
  return peak / 2**30
