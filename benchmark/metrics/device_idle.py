"""The share of the traced window in which no device operation ran:
1 - busy / window (profile_serving's arithmetic). Read for every
`device_idle.<cells>` metric."""

from benchmark import rooflines


def read(record):
  return rooflines.idle(record)
