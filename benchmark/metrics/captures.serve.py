"""CUDA graphs the serving API captured in the run: the program's counter
`serve.captures` (`se3ds_torch.tracing`), one per program key on its
second call. None where the program keeps no such counter."""


def read(record):
  try:
    from se3ds_torch import tracing
  except ImportError:
    return None
  counters = tracing.snapshot()['counters']
  if 'serve.calls' not in counters:
    return None
  return float(counters.get('serve.captures', 0))
