"""Seconds of the run's set-up that the serving program spends on itself:
its build (`serve.build`: the weights converted and loaded, the memory
made) and every key's first, eager call and second, capturing call
(`serve.*.eager`, `serve.*.capture`: the kernels' builds, cuDNN's first
choices, the captures), the sum of their host durations in
`se3ds_torch.tracing`. None where the program keeps no such span."""


def read(record):
  try:
    from se3ds_torch import tracing
  except ImportError:
    return None
  spans = tracing.snapshot()['spans']
  if 'serve.build' not in spans:
    return None
  parts = [s for name, s in spans.items() if name == 'serve.build' or (
      name.startswith('serve.') and name.endswith(('.eager', '.capture')))]
  return 1e-3 * sum(sum(s['host_ms']) for s in parts)
