"""`fused_wrap_share.serve` on hand-built snapshots of the program's
counters: 100 x `wrap.launches` / `generator.wrap_pads`, and nothing
where the program keeps no such counter (a program without the counters,
or without the registry)."""

import sys

import pytest

from benchmark import harness

NAME = 'fused_wrap_share.serve'


def _snapshot(counters):
  return {'counters': counters, 'dropped': 0, 'spans': {}}


@pytest.mark.parametrize('counters,want', [
    ({'generator.wrap_pads': 654, 'wrap.launches': 654}, 100.0),
    ({'generator.wrap_pads': 436, 'wrap.launches': 218,
      'epilogue.launches': 300}, 50.0),
    ({'generator.wrap_pads': 218}, 0.0),
    ({'serve.calls': 3, 'generator.convs': 843,
      'generator.fused_convs': 843}, None),
    ({}, None),
])
def test_reads_the_share_of_pads_the_kernel_wrote(monkeypatch, counters,
                                                  want):
  from se3ds_torch import tracing
  monkeypatch.setattr(tracing, 'snapshot', lambda: _snapshot(counters))
  got = harness.reader(NAME)(None)
  assert got == (None if want is None else pytest.approx(want))


def test_a_program_without_the_registry_reads_nothing(monkeypatch):
  import se3ds_torch
  monkeypatch.delattr(se3ds_torch, 'tracing')
  monkeypatch.setitem(sys.modules, 'se3ds_torch.tracing', None)
  assert harness.reader(NAME)(None) is None
