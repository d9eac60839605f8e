"""The served panoramas' share of the card's bf16 dense peak: the
generator's matmul and conv FLOPs per panorama (counted on the
benchmark's reference model) times the panoramas of the traced calls,
run back to back, over their window."""

from benchmark import peaks
from benchmark import rooflines


def read(record):
  return rooflines.mfu(record, peaks.BF16_FLOPS)
