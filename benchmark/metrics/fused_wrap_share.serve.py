"""Share of the served generator's circular pads that the wrap kernel
wrote, in %: 100 x the program's counter `wrap.launches` over
`generator.wrap_pads` (`se3ds_torch.tracing`), over the run (a captured
graph's counts are added again at each of its replays). A circular pad
it did not write went through PyTorch's pad and concatenation, two
copies and a fill, with the partial convolution's masking a multiply of
its own before them. None where the program keeps no such counter."""


def read(record):
  try:
    from se3ds_torch import tracing
  except ImportError:
    return None
  counters = tracing.snapshot()['counters']
  pads = counters.get('generator.wrap_pads', 0)
  if not pads:
    return None
  return 100.0 * counters.get('wrap.launches', 0) / pads
