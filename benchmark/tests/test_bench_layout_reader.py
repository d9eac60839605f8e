"""`nchw_conv_share.serve` on hand-built snapshots of the program's
counters: 100 x `generator.nchw_convs` / `generator.convs`, and nothing
where the program keeps no such counter (a program without the counters,
or without the registry)."""

import sys

import pytest

from benchmark import harness

NAME = 'nchw_conv_share.serve'


def _snapshot(counters):
  return {'counters': counters, 'dropped': 0, 'spans': {}}


@pytest.mark.parametrize('counters,want', [
    ({'serve.calls': 3, 'generator.convs': 843}, 0.0),
    ({'generator.convs': 562, 'generator.nchw_convs': 320},
     100.0 * 320 / 562),
    ({'serve.calls': 3, 'serve.captures': 2}, None),
    ({}, None),
])
def test_reads_the_share_of_nchw_convolutions(monkeypatch, counters, want):
  from se3ds_torch import tracing
  monkeypatch.setattr(tracing, 'snapshot', lambda: _snapshot(counters))
  got = harness.reader(NAME)(None)
  assert got == (None if want is None else pytest.approx(want))


def test_a_program_without_the_registry_reads_nothing(monkeypatch):
  import se3ds_torch
  monkeypatch.delattr(se3ds_torch, 'tracing')
  monkeypatch.setitem(sys.modules, 'se3ds_torch.tracing', None)
  assert harness.reader(NAME)(None) is None
