"""The bytes a 'fast' splat call must move: each cloud's points, x, y, z
and the features in float32, read once; each guidance plane, the depth
(where asked for) and the features in float32, written once
(`stage_bytes` of chip_smoke.py)."""

from benchmark import peaks

KERNELS = ('splat_fast', 'resolve_fast')


def splat_bound_bytes(clouds) -> int:
  return sum(c['points'] * (12 + 4 * c['channels'])
             + c['planes'] * c['pixels'] * (4 * c['depth'] + 4 * c['channels'])
             for c in clouds)


def splat_share(record):
  """The 'fast' kernels' share of their roofline over the traced calls:
  the bound's time over the device time of the kernels named
  `splat_fast*` and `resolve_fast*`, in %."""
  summary, counters = record.trace, record.spans.counters
  if summary is None or not counters.get('calls_traced'):
    return None
  kernel_s = sum(s for name, s in summary.ops
                 if any(k in name for k in KERNELS))
  if kernel_s <= 0:
    return None
  bound_s = splat_bound_bytes(counters['splat_clouds']) / peaks.HBM_BYTES_PER_S
  return 100.0 * bound_s * counters['calls_traced'] / kernel_s


def mfu(record, peak: float):
  """The served panoramas' matmul and conv FLOPs (the reference model's
  count) over the traced window, as a share of `peak`, in %."""
  summary, counters = record.trace, record.spans.counters
  if summary is None or not counters.get('panos_traced'):
    return None
  flops = counters['flops_per_pano'] * counters['panos_traced']
  return 100.0 * flops / summary.window_s / peak


def idle(record):
  """1 - device busy / window over the traced calls, in %."""
  summary = record.trace
  if summary is None or summary.window_s <= 0:
    return None
  return 100.0 * (1.0 - summary.busy_s / summary.window_s)
