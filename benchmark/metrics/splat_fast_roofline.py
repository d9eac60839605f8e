"""The 'fast' splat kernels' share of their roofline in the traced calls:
the least time the card could take to move what a call's splats must
move (`rooflines.splat_bound_bytes`), over the device time of the
kernels named `splat_fast*` and `resolve_fast*`."""

from benchmark import rooflines


def read(record):
  return rooflines.splat_share(record)
