"""The train step's share of the card's TF32 dense peak: the step's
matmul and conv FLOPs without remat's recompute (model FLOPs, counted on
the benchmark's reference step, `drivers/train_step.step_flops`) times
the steps in the traced window, over that window."""

from benchmark import peaks


def read(record):
  summary, counters = record.trace, record.spans.counters
  if summary is None or not counters.get('steps_traced'):
    return None
  flops = counters['flops_per_step'] * counters['steps_traced']
  return 100.0 * flops / summary.window_s / peaks.TF32_FLOPS
