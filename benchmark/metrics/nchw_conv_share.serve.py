"""Share of the served generator's convolutions that ran on a tensor or a
kernel in contiguous NCHW memory, in %: 100 x the program's counter
`generator.nchw_convs` over `generator.convs` (`se3ds_torch.tracing`),
over the run (a captured graph's convolutions are added again at each of
its replays). Such a convolution makes cuDNN transpose its operands into
NHWC and its output back. None where the program keeps no such
counter."""


def read(record):
  try:
    from se3ds_torch import tracing
  except ImportError:
    return None
  counters = tracing.snapshot()['counters']
  convs = counters.get('generator.convs', 0)
  if not convs:
    return None
  return 100.0 * counters.get('generator.nchw_convs', 0) / convs
