"""Share of the served generator's convolution outputs that the fused
epilogue kernel read, in %: 100 x the program's counter
`generator.fused_convs` over `generator.convs` (`se3ds_torch.tracing`),
over the run (a captured graph's counts are added again at each of its
replays). A convolution output it did not read went through PyTorch's
elementwise ops one by one (renormalisation, bias, BatchNorm,
activation, residual add). None where the program keeps no such
counter."""


def read(record):
  try:
    from se3ds_torch import tracing
  except ImportError:
    return None
  counters = tracing.snapshot()['counters']
  convs = counters.get('generator.convs', 0)
  if not convs or 'generator.fused_convs' not in counters:
    return None
  return 100.0 * counters['generator.fused_convs'] / convs
